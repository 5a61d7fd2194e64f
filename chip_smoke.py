#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bliss_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compiles ``bliss_tpu_torch/kernels/csrc/fused_all.cu`` for sm_90a
   from the checkout and prints the build time and ptxas report;
3. kernel vs plain: the CUDA kernel of ``fused_all_call`` against
   ``fused_all_reference`` on the same card tensors, (a) on a B=4,
   L=2^18 batch of edge cases and (b) on the main-path batch B=64, L=2^23,
   with the warm median of 5 timings of each;
4. the main path: ``bliss_tpu_torch.api.analyze_pcm`` on the seeded B=64,
   L=2^23 batch, checked finite, launched through the kernel, and held
   against the same path with the plain version in place of the kernel;
5. ``distance_matrix`` of the 64 force vectors against NumPy.

The last two lines of standard output are a JSON line of the kernels and
their timings and the card's name and power limit; the very last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result. Needs one card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 20261016
MAIN_B = 64
MAIN_L = 1 << 23  # the largest batched bucket (bliss_tpu/pipeline.py:48)
MIN_LEN = 6_000_000  # shortest song of the main batch, interleaved samples
SR = 22050


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synth_song(rng: np.random.Generator, n: int) -> np.ndarray:
    """Interleaved int16 PCM: two tones, noise and periodic decaying clicks
    (a beat), with silent lead-in and tail (as tests/conftest.py:59-73,
    plus the clicks)."""
    amp = float(rng.uniform(4000, 14000))
    p1, p2 = int(rng.integers(30, 90)), int(rng.integers(5, 12))
    tone1 = np.sin(2 * np.pi * np.arange(p1, dtype=np.float32) / p1)
    tone2 = np.sin(2 * np.pi * np.arange(p2, dtype=np.float32) / p2)
    sig = amp * np.tile(tone1, n // p1 + 1)[:n]
    sig += 0.3 * amp * np.tile(tone2, n // p2 + 1)[:n]
    sig += rng.standard_normal(n, dtype=np.float32) * (0.05 * amp)
    beat = 2 * int(SR * 60.0 / rng.uniform(70, 170))  # interleaved samples
    click = np.zeros(beat, np.float32)
    k = min(3000, beat)
    click[:k] = (
        1.5 * amp * np.exp(-np.arange(k, dtype=np.float32) / 400.0)
        * rng.standard_normal(k, dtype=np.float32)
    )
    sig += np.tile(click, n // beat + 1)[:n]
    lead = n // 50
    sig[:lead] = 0.0
    sig[-lead:] = 0.0
    return np.clip(sig, -32768, 32767).astype(np.int16)


def main_batch(rng: np.random.Generator):
    lengths = rng.integers(MIN_LEN, MAIN_L + 1, size=MAIN_B)
    lengths[0] = MAIN_L  # the batch fills its bucket, as in the pipeline
    arrays = [synth_song(rng, int(n)) for n in lengths]
    durations = [int(n) // (2 * SR) for n in lengths]
    return arrays, durations


def edge_batch(rng: np.random.Generator):
    L = 1 << 18
    silent = np.zeros(L, np.int16)
    quiet_edges = synth_song(rng, L - 1030)  # n not a multiple of 1024
    loud = rng.integers(-32768, 32768, size=L, dtype=np.int16)  # odd l+r
    clicks = synth_song(rng, L - 4094)
    return [silent, quiet_edges, loud, clicks], [L // (2 * SR)] * 4


def cuda_ms(fn, reps: int = 5) -> float:
    """Warm median over ``reps`` runs, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, ref, denom, tol):
    """Max error of ``got`` vs ``ref`` relative to ``denom``; NaN must sit
    at the same places in both. Returns (max_abs, max_rel)."""
    got, ref, denom = (t.double() for t in (got, ref, denom))
    if not torch.equal(torch.isnan(got), torch.isnan(ref)):
        raise AssertionError(f"{name}: NaN positions differ")
    ok = ~torch.isnan(ref)
    err = (got - ref).abs()[ok]
    rel = err / denom.expand_as(ref)[ok]
    max_abs, max_rel = float(err.max()), float(rel.max())
    if not max_rel <= tol:
        raise AssertionError(f"{name}: max rel err {max_rel:.3e} > {tol:.0e}")
    return max_abs, max_rel


def kernel_vs_plain(fa, batch, label, timed: bool):
    """Checks fused_all_call's kernel against fused_all_reference on the
    same card tensors; returns (errors by output, ms, plain_ms)."""
    from bliss_tpu_torch import constants as C

    x, n = batch.samples, batch.n_samples
    alpha, beta, _ = fa.normalization(x, n)
    n_frames = ((n // C.CHANNELS) // C.WINDOW_SIZE).to(torch.int32)

    def kern():
        return fa.fused_all_call(x, alpha, beta, n_frames)

    def plain():
        return fa.fused_all_reference(x, alpha, beta, n_frames)

    k_out = kern()
    torch.cuda.synchronize()
    p_out = plain()
    torch.cuda.synchronize()
    (kw, kr, ke, kp), (pw, pr, pe, pp) = k_out, p_out
    if not torch.equal(kr, pr):
        raise AssertionError(f"{label}: rownz differs")
    # wsum: per-block float32 sums of weights in [0, 1]; energies (float64
    # in both): relative to |ref| + 1e-3 (tests/test_kernels.py:51-52);
    # power: relative to each song's largest bin. The kernel and the plain
    # version differ only in summation order and FMA contraction.
    errs = {
        "wsum": compare("wsum", kw, pw, pw.abs() + 1.0, 1e-5),
        "energies": compare("energies", ke, pe, pe.abs() + 1e-3, 1e-9),
        "power": compare(
            "power", kp, pp, pp.amax(dim=1, keepdim=True).clamp_min(1e-30), 1e-5
        ),
    }
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
    detail = ", ".join(
        f"{k} max_abs={a:.3e} max_rel={r:.3e}" for k, (a, r) in errs.items()
    )
    log(f"kernel vs plain {label}: rownz identical, {detail}")
    return errs, ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from bliss_tpu_torch import AnalysisConfig, api
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.kernels import _build
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.sim.distance import distance_matrix

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    label = f"[{card}]"
    log(f"card: nvidia-smi {card!r}; torch {kind!r}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load("fused_all")
    fa._library()
    secs, report = _build.BUILD_INFO.get("fused_all", (0.0, "already built"))
    ptxas = " | ".join(
        ln.split("ptxas info    : ")[-1] for ln in report.splitlines()
        if "registers" in ln or "spill" in ln
    )
    log(f"build: fused_all.cu sm_90a in {secs:.1f} s (load {time.perf_counter() - t0:.1f} s); {ptxas}")

    # 3. kernel vs plain
    rng = np.random.default_rng(SEED)
    edge_arrays, edge_durs = edge_batch(rng)
    edge = PCMBatch.from_arrays(edge_arrays, edge_durs, device="cuda")
    kernel_vs_plain(fa, edge, "(a) B=4 L=2^18 edge cases", timed=False)

    t0 = time.perf_counter()
    arrays, durations = main_batch(rng)
    log(f"main batch: B={MAIN_B} L=2^23, lengths {min(map(len, arrays))}.."
        f"{max(map(len, arrays))} samples, generated in {time.perf_counter() - t0:.1f} s")
    batch = PCMBatch.from_arrays(arrays, durations, device="cuda")
    if tuple(batch.samples.shape) != (MAIN_B, MAIN_L):
        raise AssertionError(f"main batch shape {tuple(batch.samples.shape)}")
    errs, ms, plain_ms = kernel_vs_plain(
        fa, batch, "(b) B=64 L=2^23", timed=True
    )
    log(f"fused_all B=64 L=2^23 warm median of 5: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms {label}")

    # 4. the main path, through the user's entry point
    cfg = api.default_config()
    if cfg != AnalysisConfig.for_gpu():
        raise AssertionError(f"default_config() is not for_gpu(): {cfg}")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    out = api.analyze_pcm(arrays, durations, device="cuda")
    cold_s = time.perf_counter() - t0
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = api.analyze_pcm(arrays, durations, device="cuda")
        runs.append(time.perf_counter() - t0)
    launches = fa.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches < 1:
        raise AssertionError("the main path did not launch the fused_all kernel")
    if out.shape != (MAIN_B, 4) or not np.isfinite(out).all():
        raise AssertionError(f"main path output not finite [64, 4]: {out}")
    warm = statistics.median(runs)
    log(f"main path analyze_pcm B=64 L=2^23: first {cold_s:.3f} s, warm median "
        f"of 3 {warm:.3f} s = {MAIN_B / warm:.1f} songs/s (host padding and "
        f"copy included), peak device memory {peak_gib:.2f} GiB, kernel "
        f"launches {launches} {label}")
    device_ms = cuda_ms(lambda: analyze_batch(batch, cfg), reps=3)
    log(f"main path analyze_batch on the card-resident batch: warm median of 3 "
        f"{device_ms:.1f} ms = {MAIN_B / device_ms * 1e3:.1f} songs/s {label}")

    with mock.patch.object(fa, "fused_all_call", fa.fused_all_reference):
        ref = analyze_batch(batch, cfg).cpu().numpy()
    dur = np.asarray(durations, np.float64)
    beats = np.rint((out[:, 0].astype(np.float64) + 30.4) * dur / 4.0)
    if not np.array_equal(out[:, 0], ref[:, 0]):
        bad = np.nonzero(out[:, 0] != ref[:, 0])[0]
        raise AssertionError(f"beat counts differ from the plain path at songs {bad}")
    col_err = np.abs(out[:, 1:] - ref[:, 1:]).max(axis=0)
    if not (col_err <= 1e-3).all():
        raise AssertionError(f"amplitude/frequency/attack differ: {col_err}")
    log(f"main path vs plain-kernel path: beat counts identical "
        f"({int(beats.min())}..{int(beats.max())} per song), max |diff| "
        f"amplitude {col_err[0]:.2e} frequency {col_err[1]:.2e} attack {col_err[2]:.2e}")

    # 5. similarity
    vecs = torch.from_numpy(out).cuda()
    dm = distance_matrix(vecs).cpu().numpy().astype(np.float64)
    v = out.astype(np.float64)
    dm_ref = np.sqrt(((v[:, None, :] - v[None, :, :]) ** 2).sum(-1))
    dm_err = float(np.abs(dm - dm_ref).max())
    # float32 Gram-matrix form: |a|^2 + |b|^2 - 2ab cancels for near pairs
    if not dm_err <= 1e-3:
        raise AssertionError(f"distance_matrix max err {dm_err}")
    log(f"distance_matrix 64x64 vs numpy float64: max abs err {dm_err:.2e}")

    log(json.dumps({"kernels": [{
        "name": "fused_all",
        "route": "cuda",
        "source": "bliss_tpu_torch/kernels/csrc/fused_all.cu",
        "replaces": "bliss_tpu/kernels/fused_all.py:52",
        "launches": launches,
        "max_abs_err": max(a for a, _ in errs.values()),
        "errors": {k: {"max_abs": a, "max_rel": r} for k, (a, r) in errs.items()},
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
