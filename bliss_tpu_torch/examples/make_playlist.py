"""Generate an .m3u playlist ordered by similarity to a seed song, over the
port.

The batch equivalent of the reference's make_m3u_playlist example
(reference: python/examples/make_m3u_playlist.py): instead of analyzing one
song per loop iteration, the whole library is decoded on host threads and
analyzed as device batches; the distance sort runs on the device too. It is
the port's ``playlist`` command.

Usage: python -m bliss_tpu_torch.examples.make_playlist [--device cuda|cpu] SEED_SONG MUSIC_DIR [OUT.m3u]
"""

from __future__ import annotations

import argparse
import sys

from bliss_tpu_torch.cli import main as cli_main
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.make_playlist",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("seed")
    ap.add_argument("music_dir")
    ap.add_argument("out", nargs="?", default="playlist.m3u")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "make_playlist")
    return cli_main(["--device", str(device), "playlist", args.seed, args.music_dir,
                     "-o", args.out])


if __name__ == "__main__":
    sys.exit(main())
