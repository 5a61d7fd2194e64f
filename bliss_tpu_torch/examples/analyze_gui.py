"""Library scanner GUI — thin wrapper over the port's packaged
``bliss_tpu_torch.gui``, on ``--device``.

Rebuild of the reference's GTK scanner (reference:
python/examples/analyze_gui.py). The implementation lives in
``bliss_tpu_torch/gui.py`` (also reachable as ``python -m
bliss_tpu_torch.cli --device cuda gui``); this wrapper keeps the example
beside the others. Without a display it says so and exits 1.

Usage: python -m bliss_tpu_torch.examples.analyze_gui [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from bliss_tpu_torch.gui import (  # noqa: F401  (re-exported, as the JAX example does)
    CSV_DIALECT,
    ScanJob,
    build_app,
    discover_audio_files,
    main as gui_main,
)
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.analyze_gui",
                                 description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return gui_main(device_arg(args.device, "analyze_gui"))


if __name__ == "__main__":
    sys.exit(main())
