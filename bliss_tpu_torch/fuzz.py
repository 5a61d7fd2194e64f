"""Differential fuzz of the port, the counterpart of
``scripts/fuzz_differential.py``: random synthetic songs through one of the
port's configs on a device, held to the scalar oracle
``bliss_tpu_torch/oracle.py`` (``analyze_oracle``, in the place of the
reference binary that script runs, which is built from a checkout of the
reference C library that this repository does not carry) or, for
``extended``, to the port's float64 extended stage on the CPU.

    python -m bliss_tpu_torch.fuzz N MODE [--device cuda|cpu] [--seed S]

Modes and gates, as the JAX script's (``scripts/fuzz_differential.py:343-505``;
gates ``:466-468``; a beat is a 4 / duration step of the tempo):

- ``parity``: ``AnalysisConfig.for_parity()``; every column within 1e-3.
- ``device_exact``: ``AnalysisConfig.for_gpu()``, the main path; beats exact
  (under 0.01 of a beat) and the rest within 1e-3.
- ``hybrid``: ``AnalysisConfig(dtype="float32", amplitude_mode="poly",
  fused_kernel=True, tempo_finish="host")``; as ``device_exact``.
- ``streaming``: ``AnalysisConfig(dtype="float32")`` through
  ``analyze_song_streaming``, songs of 120-420 s; as ``device_exact``, and a
  flip of one beat passes when the same song streamed under
  ``for_parity()`` is beat-exact (the JAX script's rule). A case off by more
  beats stays divergent; it is listed in ``known_flips`` when it is a song of
  ``KNOWN_F32_FLIPS``, its ``for_parity()`` stream is beat-exact, and its
  flip is a whole number of beats on the side of, and no further than, the
  one ``bliss_tpu``'s own float32 streaming makes on it.
- ``streaming_strict``: ``for_parity()`` streamed, 120-420 s; beats exact and
  the rest within 1e-3.
- ``extended``: ``for_gpu()`` with ``extended=True``; the 45 columns within
  ``EXTENDED_GATES`` of the float64 stage on the CPU.

Songs come from ``random_song``, a copy of the JAX script's, so a seed gives
that script's songs: every fourth case at 22050 Hz, the others written as
FLAC at 44100, 48000 or 32000 Hz and decoded by the port's decoder (libav's
resampler). Where the decoder cannot be built (no libav development files,
as on the GPU machines), every song is generated at 22050 Hz, and one line
says so. ``device_exact`` and ``hybrid`` run in fixed [16, L] batches at the
pipeline's bucket length (``run_batched_device_fuzz``, the net a benchmark
can call); the others a song at a time. The oracle runs in spawned worker
processes while the device analyzes. The device is the GPU unless the
caller asks for the CPU; without a GPU the run raises, and ``main`` exits
non-zero.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import time
import zlib
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from bliss_tpu_torch import oracle
from bliss_tpu_torch.api import analyze_features
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.extended import EXTENDED_GATES, extended_features
from bliss_tpu_torch.features.streaming import analyze_song_streaming
from bliss_tpu_torch.features.types import PCMBatch, resolve_device
from bliss_tpu_torch.pipeline import _bucket_length

MODES = ("parity", "device_exact", "hybrid", "streaming", "streaming_strict", "extended")
GATE = 5e-4 * 2  # the float32 gate of scripts/fuzz_differential.py:466-468
BEAT_GATE = 0.01  # of a beat
BATCH = 16
RATES = (44100, 48000, 32000)
# a song's seconds, drawn as rng.randint(*SECONDS) (LONG_SECONDS streamed)
SECONDS = (3, 9)
LONG_SECONDS = (120, 420)
# Streamed songs whose float32 energies flip more than one beat against the
# oracle in bliss_tpu as well: (seed, case, zlib.crc32 of the PCM) -> the
# beats that bliss_tpu's analyze_song_streaming under
# AnalysisConfig(dtype="float32") counts off the oracle on the CPU
# (tests/test_torch_fuzz.py::test_the_known_float32_flip_is_bliss_tpus_own
# pins each). Seed 1234's third long song, 284 s generated at 22050 Hz (no
# decoder): epsilon-marginal peaks of a float32 FFT, which for_parity()
# streamed counts exactly.
KNOWN_F32_FLIPS = {(1234, 2, 0x50B2CA6F): -3}


def random_song(rng, seconds, sr=22050):
    """[n, 2] int16 frames of a random mixture of tones, a beat train, a
    noise bed and a silence gap (``scripts/fuzz_differential.py:50-71``,
    the same draws from ``rng``)."""
    n = sr * seconds
    t = np.arange(n)
    sig = np.zeros(n)
    for _ in range(rng.randint(1, 5)):
        f = rng.uniform(60, 8000)
        amp = rng.uniform(1000, 12000)
        sig += amp * np.sin(2 * np.pi * f * t / sr + rng.uniform(0, 6.28))
    if rng.rand() < 0.7:  # beat train
        bpm = rng.uniform(60, 180)
        phase = (t * bpm / 60 / sr) % 1.0
        sig *= 0.4 + 0.6 * (phase < rng.uniform(0.2, 0.6))
    if rng.rand() < 0.8:  # noise bed
        sig += rng.randn(n) * rng.uniform(200, 4000)
    if rng.rand() < 0.5:  # silence gap
        a = rng.randint(0, n // 2)
        sig[a : a + rng.randint(sr // 10, sr)] = 0
    sig *= np.clip(t / (0.02 * sr), 0, 1) * np.clip((n - t) / (0.02 * sr), 0, 1)

    left = np.clip(sig, -32767, 32767).astype(np.int16)
    right = np.clip(sig * rng.uniform(0.5, 1.0), -32767, 32767).astype(np.int16)
    return np.stack([left, right], axis=1)


def mode_config(mode: str) -> AnalysisConfig:
    """The config a mode analyzes under (the JAX script's ``main``)."""
    if mode == "hybrid":
        return AnalysisConfig(dtype="float32", amplitude_mode="poly", fused_kernel=True,
                              tempo_finish="host")
    if mode in ("device_exact", "extended"):
        return AnalysisConfig.for_gpu()
    if mode == "streaming":
        # the config the pipeline streams a long song under
        return AnalysisConfig(dtype="float32")
    if mode in ("parity", "streaming_strict"):
        return AnalysisConfig.for_parity()
    raise ValueError(f"unknown mode {mode!r}: use one of {', '.join(MODES)}")


def _say(verbose: bool):
    return print if verbose else (lambda *a, **k: None)


def _device_text(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _decoder_error() -> str | None:
    """None where the port's decoder builds, else the first line of why."""
    from bliss_tpu_torch.io import native_version

    try:
        native_version()
    except (RuntimeError, OSError) as e:
        return str(e).splitlines()[0]
    return None


def make_cases(n_cases: int, rng, long: bool, say) -> list[tuple[int, np.ndarray, int]]:
    """(case, interleaved int16 PCM at 22050 Hz, duration in whole seconds)
    for each case: 3-8 s songs, or 120-419 s when ``long``."""
    from bliss_tpu_torch.io import decode
    from bliss_tpu_torch.io.flac_writer import write_flac

    err = _decoder_error()
    if err:
        say(f"the port's decoder cannot be built here ({err}): every song is "
            "generated at 22050 Hz")
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n_cases):
            sr = 22050 if i % 4 == 0 or err else RATES[i % 4 - 1]
            seconds = int(rng.randint(*(LONG_SECONDS if long else SECONDS)))
            frames = random_song(rng, seconds, sr=sr)
            if err:
                cases.append((i, frames.reshape(-1), seconds))
                continue
            path = os.path.join(tmp, f"fuzz{i}.flac")
            write_flac(path, frames, sr)
            d = decode(path)
            cases.append((i, d.samples, d.duration))
    return cases


def _oracle_row(samples: np.ndarray, duration: int) -> list[float]:
    r = oracle.analyze_oracle(samples, duration)
    return [r["tempo"], r["amplitude"], r["frequency"], r["attack"]]


class _Oracle:
    """``analyze_oracle`` of each case, in ``workers`` spawned processes
    started at once (in this process when ``workers`` <= 1); ``rows()``
    waits for them. A context manager: leaving it shuts the pool down."""

    def __init__(self, cases, workers: int | None):
        self.cases = cases
        workers = min(8, os.cpu_count() or 1) if workers is None else workers
        self.pool = None
        if workers > 1 and len(cases) > 1:
            self.pool = ProcessPoolExecutor(min(workers, len(cases)),
                                            mp_context=multiprocessing.get_context("spawn"))
            self.futures = [self.pool.submit(_oracle_row, c[1], c[2]) for c in cases]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=True)

    def rows(self) -> np.ndarray:
        if self.pool is None:
            return np.array([_oracle_row(c[1], c[2]) for c in self.cases])
        return np.array([f.result() for f in self.futures])


def _report(mode, cases, ours, ref, say, t0, marginal=(), known=()) -> dict:
    """Deviation per column, the gate of ``mode`` per case; the result dict
    of the JAX script's functions with ``seconds`` (wall) and, for
    ``streaming``, ``marginal`` (one-beat flips that ``for_parity()``
    streamed settles) and ``known_flips`` (the divergent cases whose only
    fault is a flip of ``KNOWN_F32_FLIPS``; see ``_adjudicate``)."""
    devs = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    n_divergent, known_flips = 0, []
    for (i, _, duration), dev in zip(cases, devs):
        beat_dev = dev[0] * duration / 4.0
        # a marginal flip settles the beats only, never another column
        divergent = (dev.max() > GATE) if mode == "parity" else (
            (beat_dev > BEAT_GATE and i not in marginal) or dev[1:].max() > GATE)
        n_divergent += divergent
        if divergent and i in known and dev[1:].max() <= GATE:
            known_flips.append(i)
        flag = " <-- MARGINAL (1-beat f32 flip; parity exact)" if i in marginal and not divergent else (
            f" <-- DIVERGENT ({beat_dev:.2f}-beat f32 flip; parity exact; bliss_tpu's own)"
            if i in known_flips else " <-- DIVERGENT" if divergent else "")
        say(f"case {i:3d}: dev tempo={dev[0]:.2e} amp={dev[1]:.2e} "
            f"freq={dev[2]:.2e} atk={dev[3]:.2e}{flag}")
    out = {
        "cases": len(devs),
        "divergent": int(n_divergent),
        "max_dev": [float(v) for v in devs.max(axis=0)],
        "mode": mode,
        "seconds": time.perf_counter() - t0,
    }
    if mode == "streaming":
        out["marginal"] = len(marginal)
        out["known_flips"] = known_flips
    say(f"\n{out['cases']} cases in {out['seconds']:.1f} s; divergent: {out['divergent']}"
        + (f"; marginal f32 beat flips (parity exact): {len(marginal)}; divergent "
           f"f32 flips (parity exact, bliss_tpu's own): {known_flips}"
           if mode == "streaming" else ""))
    say("max deviation per feature (tempo, amplitude, frequency, attack): "
        f"{devs.max(axis=0)}")
    return out


def run_batched_device_fuzz(
    n_cases: int = 16, mode: str = "device_exact", seed: int = 1234, device="cuda",
    verbose: bool = True, workers: int | None = None,
) -> dict:
    """The fuzz of ``device_exact`` or ``hybrid`` on ``device``, in fixed
    [16, L] batches at ``pipeline._bucket_length`` of the longest song (the
    last batch filled up with its last song), against the oracle. Returns
    ``{"cases", "divergent", "max_dev", "mode", "seconds"}``."""
    if mode not in ("device_exact", "hybrid"):
        raise ValueError(f"run_batched_device_fuzz runs 'device_exact' or 'hybrid', not {mode!r}")
    device = resolve_device(device)
    say = _say(verbose)
    cfg = mode_config(mode)
    t0 = time.perf_counter()
    say(f"device: {_device_text(device)}")
    cases = make_cases(n_cases, np.random.RandomState(seed), False, say)
    L = _bucket_length(max(c[1].shape[0] for c in cases), cfg.pad_multiple)
    say(f"analyzing {len(cases)} songs under {mode}, batches of {BATCH} at L={L}")
    ours = np.zeros((len(cases), 4), np.float32)
    with _Oracle(cases, workers) as oracle_rows:
        for b0 in range(0, len(cases), BATCH):
            chunk = cases[b0:b0 + BATCH]
            arrays = [c[1] for c in chunk] + [chunk[-1][1]] * (BATCH - len(chunk))
            durs = [c[2] for c in chunk] + [chunk[-1][2]] * (BATCH - len(chunk))
            batch = PCMBatch.from_arrays(arrays, durs, pad_multiple=L, device=device)
            ours[b0:b0 + len(chunk)] = analyze_features(batch, cfg)[:len(chunk)]
        ref = oracle_rows.rows()
    return _report(mode, cases, ours, ref, say, t0)


def run_fuzz(
    n_cases: int = 20, mode: str = "parity", seed: int = 1234, device="cuda",
    verbose: bool = True, workers: int | None = None,
) -> dict:
    """The fuzz of ``parity``, ``streaming`` or ``streaming_strict`` on
    ``device``, a song at a time, against the oracle (the JAX script's
    ``main``). Returns ``run_batched_device_fuzz``'s dict."""
    if mode not in ("parity", "streaming", "streaming_strict"):
        raise ValueError(f"run_fuzz runs 'parity', 'streaming' or 'streaming_strict', not {mode!r}")
    device = resolve_device(device)
    say = _say(verbose)
    cfg = mode_config(mode)
    streamed = mode.startswith("streaming")
    t0 = time.perf_counter()
    say(f"device: {_device_text(device)}")
    cases = make_cases(n_cases, np.random.RandomState(seed), streamed, say)
    ours = []
    with _Oracle(cases, workers) as oracle_rows:
        for _, samples, duration in cases:
            if streamed:
                ours.append(analyze_song_streaming(samples, duration, cfg, device=device))
            else:
                batch = PCMBatch.from_arrays([samples], [duration],
                                             pad_multiple=cfg.pad_multiple, device=device)
                ours.append(analyze_features(batch, cfg)[0])
        ref = oracle_rows.rows()
    marginal, known = _adjudicate(cases, ours, ref, seed, device) if mode == "streaming" else ((), ())
    return _report(mode, cases, np.array(ours), ref, say, t0, marginal, known)


def _adjudicate(cases, ours, ref, seed, device) -> tuple[set, set]:
    """The streamed float32 flips that a beat-exact ``for_parity()`` stream
    of the same song settles: ``marginal``, one beat (the JAX script's
    rule: a peak within rounding of the eps threshold); ``known``, a whole
    number of beats on the side of, and no further than, the song's entry
    in ``KNOWN_F32_FLIPS``."""
    marginal, known = set(), set()
    for (i, samples, duration), got, want in zip(cases, ours, ref):
        beats = (float(got[0]) - want[0]) * duration / 4.0
        one = 0.5 < abs(beats) < 1.5
        flip = round(beats)
        pinned = KNOWN_F32_FLIPS.get((seed, i, zlib.crc32(samples.tobytes())), 0)
        if not (one or (abs(beats - flip) < BEAT_GATE and flip * pinned > 0
                        and abs(flip) <= abs(pinned))):
            continue
        p = analyze_song_streaming(samples, duration, AnalysisConfig.for_parity(), device=device)
        if abs(float(p[0]) - want[0]) * duration / 4.0 < BEAT_GATE:
            (marginal if one else known).add(i)
    return marginal, known


def _extended_rows(samples, n_samples, durations, fn) -> np.ndarray:
    """``fn(PCMBatch)`` over fixed batches of 16 (the last filled up with its
    last song) -> [N, 45] float64."""
    outs = []
    for b0 in range(0, samples.shape[0], BATCH):
        sl = slice(b0, b0 + BATCH)
        s, n, d = samples[sl], n_samples[sl], durations[sl]
        pad = BATCH - s.shape[0]
        if pad:
            s = np.concatenate([s, np.repeat(s[-1:], pad, axis=0)])
            n = np.concatenate([n, np.repeat(n[-1:], pad)])
            d = np.concatenate([d, np.repeat(d[-1:], pad)])
        batch = PCMBatch(torch.from_numpy(s), torch.from_numpy(n), torch.from_numpy(d))
        outs.append(np.asarray(fn(batch), np.float64)[: BATCH - pad])
    return np.concatenate(outs)


def run_extended_fuzz(
    n_cases: int = 64, seed: int = 4321, device="cuda", verbose: bool = True,
) -> dict:
    """The 45 extended features of ``for_gpu()`` on ``device`` against the
    port's float64 extended stage on the CPU (``extended_features`` under
    ``AnalysisConfig(dtype="float64")``, per-frame stage in float64), each
    column group within its ``EXTENDED_GATES`` gate, bpm as beats
    (|diff| · duration / 60). Songs at 22050 Hz, straight to PCM, as the JAX
    script's ``run_extended_fuzz``. Returns ``{"cases", "divergent",
    "max_dev_by_group", "mode", "seconds"}``."""
    device = resolve_device(device)
    say = _say(verbose)
    cfg = mode_config("extended")
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    arrays, durations = [], []
    for _ in range(n_cases):
        seconds = int(rng.randint(*SECONDS))
        arrays.append(random_song(rng, seconds).reshape(-1))
        durations.append(seconds)
    L = _bucket_length(max(a.shape[0] for a in arrays), cfg.pad_multiple)
    samples = np.zeros((n_cases, L), dtype=np.int16)
    for i, a in enumerate(arrays):
        samples[i, : a.shape[0]] = a
    n_samples = np.array([a.shape[0] for a in arrays], dtype=np.int32)
    durations = np.array(durations, dtype=np.int32)
    say(f"device: {_device_text(device)}; {n_cases} cases, batches of {BATCH} at L={L}")

    def on_device(batch):
        return analyze_features(PCMBatch(*(x.to(device) for x in batch)), cfg, extended=True)[:, 4:]

    f64 = AnalysisConfig(dtype="float64")
    ours = _extended_rows(samples, n_samples, durations, on_device)
    ref = _extended_rows(samples, n_samples, durations,
                         lambda b: extended_features(b, f64, dtype=torch.float64).numpy())

    dev = np.abs(ours - ref)
    dev[:, 5] *= durations / 60.0  # bpm in beats
    worst = np.zeros(n_cases, dtype=bool)
    max_dev_by_group = {}
    for gname, lo, hi, gate in EXTENDED_GATES:
        g = dev[:, lo:hi]
        max_dev_by_group[gname] = float(g.max())
        bad = (g > gate).any(axis=1)
        worst |= bad
        if bad.any():
            say(f"group {gname}: {int(bad.sum())} case(s) above gate {gate} (max {g.max():.3e})")
    for i in np.flatnonzero(worst):
        say(f"case {i:3d}: DIVERGENT devs={np.round(dev[i], 5).tolist()}")
    out = {"cases": n_cases, "divergent": int(worst.sum()),
           "max_dev_by_group": max_dev_by_group, "mode": "extended",
           "seconds": time.perf_counter() - t0}
    say(f"\n{n_cases} cases in {out['seconds']:.1f} s; divergent: {out['divergent']}")
    say("max |f32 - f64| per group: "
        + ", ".join(f"{k}={v:.2e}" for k, v in max_dev_by_group.items()))
    return out


def main(argv=None) -> int:
    """``python -m bliss_tpu_torch.fuzz N MODE [--device cuda|cpu] [--seed S]
    [--workers W]``: 0 when no case diverges, 1 when one does, 2 without
    the device."""
    p = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.fuzz",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("n_cases", nargs="?", type=int, default=20)
    p.add_argument("mode", nargs="?", default="parity", choices=MODES)
    p.add_argument("--device", default="cuda",
                   help="torch device: the GPU unless 'cpu' is asked for")
    p.add_argument("--seed", type=int, default=None,
                   help="RandomState seed (1234; 4321 for extended, as the JAX script)")
    p.add_argument("--workers", type=int, default=None,
                   help="processes for the oracle (default: the cores, at most 8)")
    args = p.parse_args(argv)
    try:
        if args.mode == "extended":
            res = run_extended_fuzz(args.n_cases, 4321 if args.seed is None else args.seed,
                                    args.device)
        elif args.mode in ("device_exact", "hybrid"):
            res = run_batched_device_fuzz(args.n_cases, args.mode,
                                          1234 if args.seed is None else args.seed,
                                          args.device, workers=args.workers)
        else:
            res = run_fuzz(args.n_cases, args.mode, 1234 if args.seed is None else args.seed,
                           args.device, workers=args.workers)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"fuzz: {e}", file=sys.stderr)
        return 2
    return 1 if res["divergent"] else 0


if __name__ == "__main__":
    sys.exit(main())
