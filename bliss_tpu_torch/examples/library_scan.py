"""Resumable batch scan of a music library to CSV + feature store, over the
port.

The batch equivalent of the reference's GTK scanner
(reference: python/examples/analyze_gui.py) — same per-song CSV output and
interruption-safe progress, no GUI stack required: re-running the command
skips everything already in the store (content-fingerprinted). It is the
port's ``scan`` command: ``bliss_tpu_torch.cli scan MUSIC_DIR -o CSV
--store .bliss-store``.

Usage: python -m bliss_tpu_torch.examples.library_scan [--device cuda|cpu] MUSIC_DIR [features.csv]
"""

from __future__ import annotations

import argparse
import sys

from bliss_tpu_torch.cli import main as cli_main
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.library_scan",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("music_dir")
    ap.add_argument("out", nargs="?", default="features.csv")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "library_scan")
    return cli_main(["--device", str(device), "scan", args.music_dir, "-o", args.out,
                     "--store", ".bliss-store"])


if __name__ == "__main__":
    sys.exit(main())
