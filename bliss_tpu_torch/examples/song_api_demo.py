"""Song API walkthrough (the reference's python/examples/bl_song.py analog),
over the port.

Usage: python -m bliss_tpu_torch.examples.song_api_demo [--device cuda|cpu] SONG_FILE
"""

from __future__ import annotations

import argparse
import sys

import bliss_tpu_torch
from bliss_tpu_torch.tools import add_device_arg, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.examples.song_api_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("song_file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "song_api_demo")
    fname = args.song_file

    # Context-managed analysis, dict-style access (reference binding idioms).
    with bliss_tpu_torch.Song(fname, device=device) as song:
        print("title:     ", song["title"])
        print("artist:    ", song["artist"])
        print("duration:  ", song["duration"], "s")
        print("force:     ", song["force"])
        print("vector:    ", song["force_vector"])
        print(
            "class:     ",
            {0: "Loud", 1: "Calm"}.get(song["calm_or_loud"], "Unknown"),
        )

    # Individual analyzers on a decoded song.
    s = bliss_tpu_torch.Song(device=device)
    s.decode(fname)
    print("amplitude: ", s.amplitude_analysis())
    print("frequency: ", s.frequency_analysis())
    print("tempo/atk: ", s.envelope_analysis())
    return 0


if __name__ == "__main__":
    sys.exit(main())
