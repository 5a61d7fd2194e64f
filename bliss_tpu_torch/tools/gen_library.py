"""Bulk synthetic-library generator for end-to-end runs (the port's
counterpart of ``scripts/gen_library.py``: the same files, byte for byte,
for the same ``(n_songs, seconds, seed)``).

Writes N distinct spec-valid FLAC files fast by precomputing a pool of
CRC'd frames: a FLAC frame's bytes depend only on (PCM content, frame
index), so a pool of C content blocks x F positions lets every song be
composed as header + a per-song random sequence of pooled frames — pure
I/O per file instead of per-file CRC work (~100x faster generation).

Usage: python -m bliss_tpu_torch.tools.gen_library <dir> <n_songs> [seconds] [seed]
Importable: make_library(dir, n_songs, seconds=11, seed=0)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from bliss_tpu_torch.io.flac_writer import _BLOCK, frame_bytes, stream_header

SR = 22050


def _content_block(rng: np.random.RandomState) -> np.ndarray:
    """[_BLOCK, 2] int16 of varied musical-ish content."""
    t = np.arange(_BLOCK)
    sig = np.zeros(_BLOCK)
    for _ in range(rng.randint(1, 4)):
        f = rng.uniform(60, 8000)
        sig += rng.uniform(1500, 9000) * np.sin(
            2 * np.pi * f * t / SR + rng.uniform(0, 6.28)
        )
    if rng.rand() < 0.6:  # gated beat envelope
        bpm = rng.uniform(60, 180)
        phase = (t * bpm / 60 / SR) % 1.0
        sig *= 0.3 + 0.7 * (phase < rng.uniform(0.2, 0.6))
    sig += rng.randn(_BLOCK) * rng.uniform(100, 2000)
    left = np.clip(sig, -32767, 32767).astype(np.int16)
    right = np.clip(sig * rng.uniform(0.6, 1.0), -32767, 32767).astype(np.int16)
    return np.stack([left, right], axis=1)


def make_library(
    out_dir: str, n_songs: int, seconds: int = 11, seed: int = 0,
    n_contents: int = 64,
) -> list[str]:
    """Generate ``n_songs`` distinct FLACs of ``seconds`` each; returns the
    file paths. Idempotent per (dir, n, seconds, seed): a marker file skips
    regeneration. Because every per-song frame sequence is drawn from one
    sequential RNG stream, the first n files of an m>=n generation are
    byte-identical to an n generation — so a marker from any PREVIOUS
    LARGER run (same dir/seconds/seed) also satisfies a smaller request,
    letting a run reuse a large library it generated earlier instead of
    paying its I/O again."""
    os.makedirs(out_dir, exist_ok=True)
    marker = os.path.join(out_dir, f".generated-{n_songs}-{seconds}-{seed}")
    paths = [
        os.path.join(out_dir, f"song{i:05d}.flac") for i in range(n_songs)
    ]
    prefix = ".generated-"
    suffix = f"-{seconds}-{seed}"
    for name in os.listdir(out_dir):
        if not (name.startswith(prefix) and name.endswith(suffix)):
            continue
        try:
            m = int(name[len(prefix):-len(suffix)])
        except ValueError:
            continue
        if m >= n_songs and all(os.path.exists(p) for p in paths):
            return paths

    rng = np.random.RandomState(seed)
    n_frames = -(-(seconds * SR) // _BLOCK)
    contents = [_content_block(rng) for _ in range(n_contents)]
    pool = [
        [frame_bytes(contents[ci], fi) for ci in range(n_contents)]
        for fi in range(n_frames)
    ]
    header = stream_header(n_frames * _BLOCK)

    for p in paths:
        seq = rng.randint(0, n_contents, size=n_frames)
        with open(p, "wb") as f:
            f.write(header)
            for fi, ci in enumerate(seq):
                f.write(pool[fi][ci])
    with open(marker, "w") as f:
        f.write("ok\n")
    return paths


def library_pcm(n_songs: int, seconds: int = 11, seed: int = 0,
                n_contents: int = 64) -> list[np.ndarray]:
    """The interleaved int16 PCM of ``make_library``'s songs, in its order,
    without writing or decoding a file: each song is its pooled content
    blocks, frame by frame (FLAC is lossless, so this is what a decoder
    returns for the file)."""
    rng = np.random.RandomState(seed)
    n_frames = -(-(seconds * SR) // _BLOCK)
    contents = [_content_block(rng) for _ in range(n_contents)]
    return [np.concatenate([contents[ci] for ci in rng.randint(0, n_contents, size=n_frames)]
                           ).reshape(-1)
            for _ in range(n_songs)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    d, n = argv[0], int(argv[1])
    secs = int(argv[2]) if len(argv) > 2 else 11
    seed = int(argv[3]) if len(argv) > 3 else 0
    t0 = time.time()
    files = make_library(d, n, secs, seed)
    print(f"{len(files)} songs in {time.time() - t0:.1f}s -> {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
