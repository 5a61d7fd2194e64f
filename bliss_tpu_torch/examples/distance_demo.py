"""Pairwise song comparison (the reference's python/examples/distance.py
analog), over the port: Euclidean distance + cosine similarity between two
files.

Usage: python -m bliss_tpu_torch.examples.distance_demo [--device cuda|cpu] SONG1 SONG2
"""

from __future__ import annotations

import argparse
import sys

import bliss_tpu_torch
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.distance_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("song1")
    ap.add_argument("song2")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "distance_demo")

    s1 = bliss_tpu_torch.analyze(args.song1, device=device)
    s2 = bliss_tpu_torch.analyze(args.song2, device=device)
    print("force vectors:")
    print(" ", args.song1, s1.force_vector.as_array())
    print(" ", args.song2, s2.force_vector.as_array())
    print("distance:          ", bliss_tpu_torch.distance(s1, s2, device=device))
    print("cosine similarity: ", bliss_tpu_torch.cosine_similarity(s1, s2, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
