"""Extended-vector quality benchmark: do the extended features make
measurably better playlists than the core 4-D force vector? (The port's
counterpart of ``scripts/quality_benchmark.py``, with its protocol, songs,
metrics and JSON line.)

Protocol (synthetic song families, fully reproducible):
- F families x M variants of 11-s songs. A family fixes the musical
  identity — beat period, harmonic palette (a pitch-class chord), timbre
  brightness, and noise floor. Variants within a family perturb what a
  re-master / re-encode / alternate take would: noise seed, +-0.5 dB
  level, a few cents of detune, and arpeggio phase.
- Families are constructed to COLLIDE in the core 4-D space: pairs share
  the same beat period and matched band-energy balance but differ in
  pitch-class content (C-major vs F#-major at the same register) — the
  core frequency score can't tell them apart, the chroma/MFCC columns
  can. This mirrors the real failure mode of 4-D bliss playlists
  (harmonically clashing songs at the same tempo/loudness).
- Every song is analyzed by ``features.analyze.analyze_batch_ext`` (core +
  45 extended columns from one device stage), columns are z-scored over
  the library (the standard normalization for mixed-unit vectors), and two
  retrieval metrics are computed for core-4 vs core+extended:
    recall@(M-1): fraction of each song's M-1 nearest neighbors that are
      its own family, averaged (1.0 = perfect playlists);
    separation: mean cross-family distance / mean in-family distance
      (higher = families are better separated than their variants).

The config is the JAX script's, ``AnalysisConfig(tempo_finish=
"device_exact")``, which takes the XLA-path stage; ``run`` takes any other
(``AnalysisConfig.for_gpu()`` runs the prepass and K1 once for the batch).
Prints ONE JSON line. Runs on ``--device`` (default ``cuda``).

Usage: python -m bliss_tpu_torch.tools.quality_benchmark [--families 8]
           [--variants 6] [--seconds 11] [--device cuda|cpu] [--k N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from bliss_tpu_torch.tools import add_device_arg, device_arg

SR = 22050

# pitch-class chords (semitones above A3=220 Hz); pairs 0/1 and 2/3 share
# register + partial count so band-energy balance matches and only the
# pitch classes differ
CHORDS = (
    (0, 4, 7, 12),     # A major
    (6, 10, 13, 18),   # D# major (tritone away — same register)
    (3, 7, 10, 15),    # C major flavor
    (9, 13, 16, 21),   # F# major flavor
)
BEAT_PERIODS = (0.5, 0.8)  # seconds (120 / 75 bpm)


def synth_song(
    family: int, variant: int, seconds: float, rng: np.random.RandomState
) -> np.ndarray:
    """One 11-s stereo-collapsed int16 song for (family, variant)."""
    beat_s = BEAT_PERIODS[family % len(BEAT_PERIODS)]
    chord = CHORDS[(family // len(BEAT_PERIODS)) % len(CHORDS)]
    n = int(seconds * SR)
    t = np.arange(n) / SR
    detune = 2.0 ** (rng.uniform(-5, 5) / 1200.0)  # +-5 cents per variant
    level = 10.0 ** (rng.uniform(-0.5, 0.5) / 20.0)  # +-0.5 dB
    phase = rng.uniform(0, 1)

    # beat envelope: exponential attack-decay at the family's beat period
    beat_pos = (t / beat_s + phase) % 1.0
    env = np.exp(-4.0 * beat_pos) + 0.15

    sig = np.zeros(n)
    for j, semi in enumerate(chord):
        f0 = 220.0 * (2.0 ** (semi / 12.0)) * detune
        # arpeggio: each chord tone pulses on its own beat slot
        slot = ((t / beat_s + phase + j / len(chord)) % 1.0) < 0.5
        for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25)):
            sig += amp * slot * np.sin(2 * np.pi * f0 * h * t + j)
    sig *= env
    sig += rng.randn(n) * 0.02 * sig.std()  # variant noise floor
    sig *= level * 9000.0 / max(np.abs(sig).max(), 1e-9)
    return np.clip(sig, -32768, 32767).astype(np.int16)


def zscore(x: np.ndarray) -> np.ndarray:
    mu = x.mean(axis=0, keepdims=True)
    sd = x.std(axis=0, keepdims=True)
    return (x - mu) / np.maximum(sd, 1e-9)


def retrieval_metrics(
    vecs: np.ndarray, labels: np.ndarray, k: int
) -> tuple[float, float]:
    """(recall@k, separation) for z-scored vectors ``vecs`` [N, D]."""
    v = zscore(vecs)
    d = np.sqrt(
        np.maximum(
            (v**2).sum(1)[:, None]
            + (v**2).sum(1)[None, :]
            - 2.0 * (v @ v.T),
            0.0,
        )
    )
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1)[:, :k]
    same = labels[nn] == labels[:, None]
    recall = float(same.mean())
    finite = np.isfinite(d)
    in_fam = (labels[:, None] == labels[None, :]) & finite
    cross = (labels[:, None] != labels[None, :]) & finite
    separation = float(d[cross].mean() / d[in_fam].mean())
    return recall, separation


def library(families: int, variants: int, seconds: float):
    """The script's songs and their family labels: song (fam, var) from
    ``RandomState(1000 * fam + var)``."""
    songs, labels = [], []
    for fam in range(families):
        for var in range(variants):
            rng = np.random.RandomState(1000 * fam + var)
            songs.append(synth_song(fam, var, seconds, rng))
            labels.append(fam)
    return songs, np.asarray(labels)


def run(families: int = 8, variants: int = 6, seconds: float = 11.0, k: int = 0,
        cfg=None, device="cuda") -> dict:
    """The benchmark on ``device`` under ``cfg`` (default: the script's
    ``AnalysisConfig(tempo_finish="device_exact")``). Returns the script's
    keys with unrounded metrics, and ``features``, the [N, 49] float32
    rows the metrics were computed from."""
    from bliss_tpu_torch.config import AnalysisConfig
    from bliss_tpu_torch.features.analyze import analyze_batch_ext
    from bliss_tpu_torch.features.types import PCMBatch

    songs, labels = library(families, variants, seconds)
    batch = PCMBatch.from_arrays(songs, [int(seconds)] * len(songs), device=device)
    if cfg is None:
        cfg = AnalysisConfig(tempo_finish="device_exact")
    feats = analyze_batch_ext(batch, cfg).cpu().numpy()

    k = k or max(variants - 1, 1)
    recall_core, sep_core = retrieval_metrics(feats[:, :4], labels, k)
    recall_ext, sep_ext = retrieval_metrics(feats, labels, k)
    return {
        "metric": "extended-vector retrieval quality",
        "songs": len(songs),
        "families": families,
        "variants": variants,
        "k": k,
        "recall_at_k_core4": recall_core,
        "recall_at_k_extended": recall_ext,
        "separation_core4": sep_core,
        "separation_extended": sep_ext,
        "extended_wins": bool(recall_ext >= recall_core and sep_ext > sep_core),
        "features": feats,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bliss_tpu_torch.tools.quality_benchmark",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", type=int, default=8)
    ap.add_argument("--variants", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=11.0)
    ap.add_argument("--k", type=int, default=0, help="0 = variants-1")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "quality_benchmark")

    res = run(args.families, args.variants, args.seconds, args.k, device=device)
    digits = {"recall_at_k_core4": 4, "recall_at_k_extended": 4,
              "separation_core4": 3, "separation_extended": 3}
    print(json.dumps({key: round(v, digits[key]) if key in digits else v
                      for key, v in res.items() if key != "features"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
