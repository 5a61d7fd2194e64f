"""Stage breakdown of the sample-statistics kernel on the card.

    python -m bliss_tpu_torch.ablate [--shape main|script]

Times on one NVIDIA GPU every variant of the measurement kernels: the
stats kernel's stages (A1, beside the shipped K2 ``fused_stats_call``),
the read-and-reduce probes of ``scripts/ablate_fused.py``,
``scripts/ablate_dma.py`` and ``scripts/ablate_packread.py`` (A2), and
the matrix-product reductions with both Chebyshev fits (A3). Each line
gives the time (CUDA events around a run of launches after a warm-up,
divided by their count, median of 5 runs), the bound of
``kernels/bounds.py`` and, for the probes, the input read in GB/s and its
share of the card's 3.35 TB/s; every line ends with the card's name and
power limit as ``nvidia-smi`` prints them.

Shapes: ``main`` is B=64, L=2^23 (the batch the analysis kernels are timed
at; chunks of 2^18 samples), ``script`` the TPU scripts' own B=128,
L=491520 (128 songs of 11 s; chunks of 245760). Both inputs exceed the
card's 50 MB L2. The data is the scripts' own: int16 uniform in
[-3000, 3000), made on the card from a fixed seed, with alpha = 1e-3 and
beta = 1e-5. Without a CUDA device it exits nonzero and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from bliss_tpu_torch.ablate.breakdown import SHAPES, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.ablate", description=__doc__.split("\n")[0])
    p.add_argument("--shape", choices=sorted(SHAPES), default="main")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA device; the stage breakdown is timed on the card",
              file=sys.stderr)
        return 2
    run(args.shape, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
