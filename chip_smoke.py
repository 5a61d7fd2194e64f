#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bliss_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compiles ``bliss_tpu_torch/kernels/csrc/fused_all.cu`` (K1, K2,
   K3; it includes ``csrc/stats.cuh`` and ``csrc/power.cuh``) and
   ``csrc/ablate.cu`` (the measurement kernels A1, A2, A3) for
   sm_90a from the checkout, one ``nvcc`` each, started together, and
   prints each build's time and each kernel's ptxas registers and spills;
3. kernel vs plain, each kernel's wrapper against its plain version on the
   same card tensors, (a) on a B=5, L=2^18 batch of edge cases and (b) on
   the main-path batch B=64, L=2^23, with the warm median of 5 timings of
   each: the prepass ``prepass_sums`` (int64 sums identical; the edge batch
   has a silent song and one whose int32 sum wraps); K1 ``fused_all_call``;
   K2 ``fused_stats_call`` (edge batch with and without ``halo0``, and at
   2 and 129 taps); K3 ``stft_power`` (edge batch with
   ``frame_offset`` 0, mid-song and past every song's frames), with K3's
   yardsticks ``torch.matmul`` (a dense DFT) and ``torch.fft.rfft`` of the
   same frames;
4. the main path: ``bliss_tpu_torch.api.analyze_pcm`` on the seeded B=64,
   L=2^23 batch, checked finite, launched through the prepass and K1, and
   held against the same path with the plain versions of the prepass and K1
   in place of the kernels; the card-resident ``analyze_batch`` timed (median,
   least and most of 10) and traced once with ``torch.profiler``: its
   device kernels, their busy time and the device's idle share;
5. the two-kernel path (``for_gpu()`` with ``single_pass=False``) through
   ``analyze_batch`` on the card-resident main batch, launched through K2
   and K3 (and the prepass) only, and the hybrid path (``AnalysisConfig.for_gpu_hybrid()``:
   K2, K3, then the float64 host finish) through ``api.analyze_pcm``; each
   counts the same beats as the main path and as itself with the plain
   versions (of the prepass, K2 and K3) in place of the kernels;
6. ``distance_matrix`` of the 64 force vectors against NumPy;
7. the ablation (``bliss_tpu_torch.ablate``): every variant of A1 (the
   stats kernel's stages), A2 (the read-and-reduce probes) and A3 (the
   matrix-product reductions) against its plain version on the edge batch,
   at the TPU scripts' shape B=128, L=491520 and at B=64, L=2^23, where the
   plain versions and, for the row sums, ``torch.sum`` of the same rows
   are timed too; A3's numerics report against the shipped stats kernel;
   then the ablation's own path,
   ``bliss_tpu_torch.ablate.breakdown.run`` at both shapes, which times every
   variant and must launch each of A1, A2 and A3.

The last two lines of standard output are a JSON line of the kernels and
their timings and the card's name and power limit; the very last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result. Needs one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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
    # loud and positive: its int32 sum wraps; n not a multiple of 8. From a
    # generator of its own, so that the main batch drawn after this one
    # stays what it was before this song was added
    wraps = np.random.default_rng(SEED + 2).integers(20000, 32768, size=L - 3, dtype=np.int16)
    return [silent, quiet_edges, loud, clicks, wraps], [L // (2 * SR)] * 5


def cuda_times(fn, reps: int) -> list[float]:
    """ms of each of ``reps`` warm runs, each timed with CUDA events."""
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
    return times


def cuda_ms(fn, reps: int = 5) -> float:
    """Warm median over ``reps`` runs, each timed with CUDA events."""
    return statistics.median(cuda_times(fn, reps))


def device_trace(fn):
    """One warm run of ``fn`` under ``torch.profiler``, read from its
    exported trace: the span from the call's start on the host to the end
    of its ``torch.cuda.synchronize``, the device's busy time in it (the
    union of its kernels, copies and sets), the idle share of the span, the
    number of kernels and the kernels with the most time. Returns a line of
    text; "not measured" with the reason where the trace holds no device
    record."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("traced_call"):
                fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
    except Exception as exc:  # a trace is a reading, not a gate
        return f"not measured ({type(exc).__name__}: {exc})"
    call = [e for e in events if e.get("ph") == "X" and e.get("name") == "traced_call"
            and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not call or not dev:
        return f"not measured (the trace holds {len(call)} call and {len(dev)} device records)"
    t0 = float(call[0]["ts"])
    t1 = t0 + float(call[0]["dur"])
    busy, end = 0.0, t0
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    by_name: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            n, t = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, t + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    nk = sum(n for n, _ in by_name.values())

    def short(name):
        return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:60]

    return (f"span {(t1 - t0) / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
            f"{1 - busy / (t1 - t0):.3f}; {nk} kernels ({len(by_name)} distinct), "
            f"{len(dev) - nk} copies and sets; most time: " + "; ".join(
                f"{short(name)} x{n} {t / 1e3:.3f} ms" for name, (n, t) in top))


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


def stats_errors(label, k_out, p_out):
    """K1's or K2's (wsum, rownz, energies, ...) against the plain version:
    rownz identical; wsum (per-block float32 sums of weights in [0, 1])
    within 1e-5 of |ref| + 1; energies (float64 in both) within 1e-9 of
    |ref| + 1e-3 (tests/test_kernels.py:51-52). The two differ only in
    summation order and FMA contraction."""
    (kw, kr, ke), (pw, pr, pe) = k_out[:3], p_out[:3]
    if not torch.equal(kr, pr):
        raise AssertionError(f"{label}: rownz differs")
    return {
        "wsum": compare(f"{label} wsum", kw, pw, pw.abs() + 1.0, 1e-5),
        "energies": compare(f"{label} energies", ke, pe, pe.abs() + 1e-3, 1e-9),
    }


def prepass_errors(k_out, p_out):
    """The prepass's int64 sums (of s and of s^2) identical to the plain
    version's: integer sums do not depend on their order."""
    for name, k, p in zip(("sum_s", "sum_s2"), k_out, p_out):
        if k.dtype != torch.int64 or not torch.equal(k, p):
            raise AssertionError(f"prepass {name} differs from the plain version")
    return {"sums": (0.0, 0.0)}


def power_errors(label, kp, pp):
    """The summed spectrum within 1e-5 of each song's largest bin; a song
    with no frame that counts must be zero in both."""
    peak = pp.amax(dim=1, keepdim=True).clamp_min(1e-30)
    return {"power": compare(f"{label} power", kp, pp, peak, 1e-5)}


def kernel_vs_plain(label, kern, plain, errors, timed: bool):
    """Runs a kernel's wrapper and its plain version on the same card
    tensors and holds one to the other with ``errors(k_out, p_out)``;
    returns (errors by output, ms, plain_ms)."""
    k_out = kern()
    torch.cuda.synchronize()
    p_out = plain()
    torch.cuda.synchronize()
    errs = errors(k_out, p_out)
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
    detail = ", ".join(
        f"{k} max_abs={a:.3e} max_rel={r:.3e}" for k, (a, r) in errs.items()
    )
    log(f"kernel vs plain {label}: {detail}")
    return errs, ms, plain_ms


def check_kernels(batch, label, timed: bool, edge: bool):
    """The prepass, K1, K2 and K3 against their plain versions on
    ``batch``; on the edge batch K2 also runs with a loud random halo0 and
    at 2 and 129 taps, and K3 with frame offsets. Returns {kernel: (errors,
    ms, plain_ms)} of the plain-argument runs."""
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft

    x, n = batch.samples, batch.n_samples
    out = {"prepass": kernel_vs_plain(
        f"prepass {label}", lambda: fs.prepass_sums(x, n),
        lambda: fs.prepass_sums_reference(x, n), prepass_errors, timed,
    )}
    alpha, beta, _ = fs.normalization(x, n)
    n_frames = stft.frame_counts(n)

    def k1_errors(k, p):
        return {**stats_errors("fused_all", k, p), **power_errors("fused_all", k[3], p[3])}

    out["fused_all"] = kernel_vs_plain(
        f"fused_all {label}",
        lambda: fa.fused_all_call(x, alpha, beta, n_frames),
        lambda: fa.fused_all_reference(x, alpha, beta, n_frames),
        k1_errors, timed,
    )
    halos = [None]
    if edge:
        rng = np.random.default_rng(SEED + 1)
        halos.append(torch.from_numpy(
            rng.integers(-20000, 20000, size=(x.shape[0], 16), dtype=np.int16)
        ).cuda())
    for halo0 in halos:
        res = kernel_vs_plain(
            f"fused_stats {label}" + (" halo0" if halo0 is not None else ""),
            lambda: fs.fused_stats_call(x, alpha, beta, halo0),
            lambda: fs.fused_stats_reference(x, alpha, beta, halo0),
            lambda k, p: stats_errors("fused_stats", k, p), timed and halo0 is None,
        )
        out.setdefault("fused_stats", res)
    if edge:  # the shortest and the longest FIR the kernel takes
        for taps in (2, 129):
            kw = dict(nb_bands=1, band_taps=taps, filterbank="firwin")
            kernel_vs_plain(
                f"fused_stats {label} taps={taps}",
                lambda: fs.fused_stats_call(x, alpha, beta, **kw),
                lambda: fs.fused_stats_reference(x, alpha, beta, **kw),
                lambda k, p: stats_errors("fused_stats", k, p), False,
            )
    offsets = [None]
    if edge:
        offsets += [0, int(n_frames.min()) // 2, 10_000]  # start, mid-song, past
    def k3_errors(k, p, past):
        if past and not (bool((k == 0).all()) and bool((p == 0).all())):
            raise AssertionError("stft_power: frames past n_frames were counted")
        return power_errors("stft_power", k, p)

    for off in offsets:
        res = kernel_vs_plain(
            f"stft_power {label}" + ("" if off is None else f" frame_offset={off}"),
            lambda: stft.stft_power(x, n, frame_offset=off),
            lambda: stft.stft_power_reference(x, n, frame_offset=off),
            lambda k, p: k3_errors(k, p, off == 10_000), timed and off is None,
        )
        out.setdefault("stft_power", res)
    return out


def ptxas_report(stderr: str) -> str:
    """Each kernel's registers and spills from nvcc's ``-Xptxas -v``
    output, kernel names demangled where ``c++filt`` is present."""
    entries, cur, spill = [], None, ""
    for ln in stderr.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and cur:
            entries.append((cur, ln.split("Used ")[1].split(",")[0], spill))
            cur = None
    names = [e[0] for e in entries]
    if shutil.which("c++filt") and names:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60)
        if out.returncode == 0:
            names = out.stdout.splitlines()
    return " | ".join(
        f"{n.replace('(anonymous namespace)::', '').split('(')[0]}: {regs}, {sp}"
        for n, (_, regs, sp) in zip(names, entries)
    )


def k3_library_ms(batch) -> dict:
    """K3's transform as one PyTorch call on the batch's mono frames [B *
    L/1024, 512], warm median of 5 each (yardsticks the port never calls):
    ``torch.matmul`` by the [512, 512] Hann-folded DFT table (a dense DFT,
    cuBLAS) and ``torch.fft.rfft`` of the Hann-windowed frames (cuFFT)."""
    from bliss_tpu_torch.convert import device_tables
    from bliss_tpu_torch.dsp.intops import c_div

    x = batch.samples
    B, L = x.shape
    pairs = x.reshape(B, L // 1024, 512, 2).to(torch.int32)
    mono = c_div(pairs[..., 0] + pairs[..., 1], 2).to(torch.float32).reshape(-1, 512)
    del pairs
    tabs = device_tables(1, 17, "firwin", x.device)
    out = {"torch.matmul": cuda_ms(lambda: torch.matmul(mono, tabs["dft"]))}
    windowed = mono * tabs["hann"]
    del mono
    out["torch.fft.rfft"] = cuda_ms(lambda: torch.fft.rfft(windowed, dim=-1))
    return out


def ablation_errors(case, got, ref):
    """An ablation variant against its plain version. A1: rownz identical,
    wsum within 1e-5 of |ref| + 1, rows s1..da within 1e-9 of the block's
    sum of z^2 (+1) in float64 (1e-5 for the float32 FIR: FMA contraction
    and summation order); A3: counts identical, wsum as A1, the columns of
    z and delta within 1e-9 of the block's sum of z^2 (+1); A2: within 1e-6
    of each output's sum of |term| (+1), exact where that sum is exact.
    NaN (a silent song's infinite normalization) must sit at the same
    places in both."""
    name, kernel = case["name"], case["kernel"]
    if kernel == "A2":
        return {"out": compare(name, got, ref, case["scale"](), 1e-6)}
    if kernel == "A1":  # rows (s1, s2, sa, d1, d2, da, wsum, rownz) on dim 2
        got, ref = got.transpose(2, 3), ref.transpose(2, 3)
        z2, tol = ref[..., 1:2], 1e-5 if "fir_fp32" in name else 1e-9
    else:  # columns (sum z, sum alt z, sum z^2, d1, d2, da, wsum, count)
        z2, tol = ref[..., 2:3], 1e-9
    one = torch.ones_like(ref[..., 7])
    return {
        "flags": compare(f"{name} nonzero", got[..., 7], ref[..., 7], one, 0.0),
        "wsum": compare(f"{name} wsum", got[..., 6], ref[..., 6], ref[..., 6].abs() + 1.0, 1e-5),
        "stats": compare(f"{name} sums", got[..., :6], ref[..., :6], z2.abs() + 1.0, tol),
    }


# the ablation's row-sum probes -> the rows they sum; torch.sum of those
# rows is the one PyTorch call that computes the same sums
LIBRARY_ROWS = {"S1b one_sum": "x", "S1b sums_stack": "x", "S2 touch i16": "x",
                "S2 touch i32": "x32", "S2 touch f32": "xf", "S3 i16": "x",
                "S3 packed_nounpack": "words"}


def check_ablation(inp, label, timed=False):
    """Each ablation case at ``inp`` against its plain version; with
    ``timed``, also the warm median of 5 of the plain version and, for the
    row-sum probes, of ``torch.sum`` of the same rows. Returns {case name:
    (errors, plain_ms, library_ms)}."""
    from bliss_tpu_torch.ablate import breakdown

    out = {}
    for case in breakdown.cases(inp):
        if case["plain"] is None:
            continue
        got = case["call"]()
        torch.cuda.synchronize()
        ref = case["plain"]()
        torch.cuda.synchronize()
        errs = ablation_errors(case, got, ref)
        del got, ref
        plain_ms = lib_ms = None
        if timed:
            plain_ms = cuda_ms(case["plain"])
            if case["name"] in LIBRARY_ROWS:
                rows = inp[LIBRARY_ROWS[case["name"]]].reshape(inp["B"], -1, 256)
                lib_ms = cuda_ms(lambda: torch.sum(rows, dim=-1, dtype=torch.float32))
        out[case["name"]] = (errs, plain_ms, lib_ms)
        detail = ", ".join(f"{k} max_abs={a:.3e} max_rel={r:.3e}" for k, (a, r) in errs.items())
        if timed:
            detail += f"; plain {plain_ms:.3f} ms" + ("" if lib_ms is None else f", torch.sum {lib_ms:.3f} ms")
        log(f"ablation vs plain {label} {case['name']}: {detail}")
    return out


def batch_inputs(batch) -> dict:
    """``bliss_tpu_torch.ablate``'s inputs from a card-resident batch: one
    chunk a song, alpha and beta from the prepass."""
    from bliss_tpu_torch.ablate import packread
    from bliss_tpu_torch.kernels import fused_stats as fs

    x = batch.samples
    alpha, beta, _ = fs.normalization(x, batch.n_samples)
    return {"B": x.shape[0], "L": x.shape[1], "chunk": x.shape[1], "x": x,
            "x32": x.to(torch.int32), "xf": x.to(torch.float32),
            "words": packread.packed_words(x), "alpha": alpha, "beta": beta}


def beat_counts(out, durations):
    dur = np.asarray(durations, np.float64)
    return np.rint((out[:, 0].astype(np.float64) + 30.4) * dur / 4.0)


def same_scores(label, out, ref, what):
    """Beat counts (the tempo column) identical on every song, the other
    columns within 1e-3."""
    if out.shape != (MAIN_B, 4) or not np.isfinite(out).all():
        raise AssertionError(f"{label} output not finite [64, 4]: {out}")
    if not np.array_equal(out[:, 0], ref[:, 0]):
        bad = np.nonzero(out[:, 0] != ref[:, 0])[0]
        raise AssertionError(f"{label}: beat counts differ from {what} at songs {bad}")
    col_err = np.abs(out[:, 1:] - ref[:, 1:]).max(axis=0)
    if not (col_err <= 1e-3).all():
        raise AssertionError(f"{label}: amplitude/frequency/attack differ from {what}: {col_err}")
    return col_err


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
    from bliss_tpu_torch.features.analyze import _device_stage_packed, _unpack_stage
    from bliss_tpu_torch.features.tempo import envelope_finish_host
    from bliss_tpu_torch.ablate import breakdown, matred, probe
    from bliss_tpu_torch.ablate import fused as ab_fused
    from bliss_tpu_torch.kernels import _build, bounds
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft
    from bliss_tpu_torch.sim.distance import distance_matrix

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    label = f"[{card}]"
    log(f"card: nvidia-smi {card!r}; torch {kind!r}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    # 2. build, one nvcc for each source, started together
    t0 = time.perf_counter()
    _build.build(("fused_all", "ablate"))
    for name in ("fused_all", "ablate"):
        secs, report = _build.BUILD_INFO.get(name, (0.0, "already built"))
        log(f"build: {name}.cu sm_90a in {secs:.1f} s (both built after "
            f"{time.perf_counter() - t0:.1f} s); {ptxas_report(report)}")

    # 3. kernel vs plain
    rng = np.random.default_rng(SEED)
    edge_arrays, edge_durs = edge_batch(rng)
    edge = PCMBatch.from_arrays(edge_arrays, edge_durs, device="cuda")
    check_kernels(edge, "(a) B=5 L=2^18 edge cases", timed=False, edge=True)

    t0 = time.perf_counter()
    arrays, durations = main_batch(rng)
    log(f"main batch: B={MAIN_B} L=2^23, lengths {min(map(len, arrays))}.."
        f"{max(map(len, arrays))} samples, generated in {time.perf_counter() - t0:.1f} s")
    batch = PCMBatch.from_arrays(arrays, durations, device="cuda")
    if tuple(batch.samples.shape) != (MAIN_B, MAIN_L):
        raise AssertionError(f"main batch shape {tuple(batch.samples.shape)}")
    kernels = check_kernels(batch, "(b) B=64 L=2^23", timed=True, edge=False)
    frames = int(stft.frame_counts(batch.n_samples).clamp(max=MAIN_L // 1024).sum())
    valid = int(batch.n_samples.to(torch.int64).clamp(max=MAIN_L).sum())
    works = {
        "prepass": bounds.prepass_work(valid, MAIN_B),
        "fused_all": bounds.fused_all_work(MAIN_B, MAIN_L, frames),
        "fused_stats": bounds.stats_work(MAIN_B, MAIN_L),
        "stft_power": bounds.power_work(frames, MAIN_B),
    }
    k3_calls = k3_library_ms(batch)
    library = {"prepass": None, "fused_all": None, "fused_stats": None,
               "stft_power": k3_calls["torch.matmul"]}
    for name, (_, ms, plain_ms) in kernels.items():
        bound, by = bounds.bound_ms(works[name])
        calls = k3_calls if name == "stft_power" else {}
        log(f"{name} B=64 L=2^23 warm median of 5: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}), library call "
            f"{', '.join(f'{c} {t:.3f} ms' for c, t in calls.items()) or 'none'} {label}")

    # 4. the main path, through the user's entry point; every count is set
    # to 0 just before each path runs and read just after
    cfg = api.default_config()
    if cfg != AnalysisConfig.for_gpu():
        raise AssertionError(f"default_config() is not for_gpu(): {cfg}")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fs.LAUNCHES = fs.PREPASS_LAUNCHES = stft.LAUNCHES = 0
    t0 = time.perf_counter()
    out = api.analyze_pcm(arrays, durations, device="cuda")
    cold_s = time.perf_counter() - t0
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = api.analyze_pcm(arrays, durations, device="cuda")
        runs.append(time.perf_counter() - t0)
    launches = {"fused_all": fa.LAUNCHES, "prepass": fs.PREPASS_LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if fa.LAUNCHES < 1 or fs.PREPASS_LAUNCHES < 1 or fs.LAUNCHES or stft.LAUNCHES:
        raise AssertionError(
            f"the main path launched prepass {fs.PREPASS_LAUNCHES}, fused_all "
            f"{fa.LAUNCHES}, fused_stats {fs.LAUNCHES}, stft_power {stft.LAUNCHES} "
            f"times; want the prepass and K1 only"
        )
    if out.shape != (MAIN_B, 4) or not np.isfinite(out).all():
        raise AssertionError(f"main path output not finite [64, 4]: {out}")
    warm = statistics.median(runs)
    log(f"main path analyze_pcm B=64 L=2^23: first {cold_s:.3f} s, warm median "
        f"of 3 {warm:.3f} s = {MAIN_B / warm:.1f} songs/s (host padding and "
        f"copy included), peak device memory {peak_gib:.2f} GiB, kernel "
        f"launches prepass {fs.PREPASS_LAUNCHES} fused_all {fa.LAUNCHES} {label}")
    times = cuda_times(lambda: analyze_batch(batch, cfg), reps=10)
    device_ms = statistics.median(times)
    log(f"main path analyze_batch on the card-resident batch: warm median of 10 "
        f"{device_ms:.1f} ms = {MAIN_B / device_ms * 1e3:.1f} songs/s (least "
        f"{min(times):.1f}, most {max(times):.1f} ms) {label}")
    log(f"main path analyze_batch trace: {device_trace(lambda: analyze_batch(batch, cfg))} {label}")

    plain_prepass = mock.patch.object(fs, "prepass_sums", fs.prepass_sums_reference)
    with plain_prepass, mock.patch.object(fa, "fused_all_call", fa.fused_all_reference):
        ref = analyze_batch(batch, cfg).cpu().numpy()
    beats = beat_counts(out, durations)
    col_err = same_scores("main path", out, ref, "the plain-kernel path")
    log(f"main path vs plain-kernel path: beat counts identical "
        f"({int(beats.min())}..{int(beats.max())} per song), max |diff| "
        f"amplitude {col_err[0]:.2e} frequency {col_err[1]:.2e} attack {col_err[2]:.2e}")

    # 5. the two-kernel and hybrid paths
    plain_k2_k3 = (
        plain_prepass,
        mock.patch.object(fs, "fused_stats_call", fs.fused_stats_reference),
        mock.patch.object(stft, "stft_power", stft.stft_power_reference),
    )
    two = AnalysisConfig(**{**dataclasses.asdict(cfg), "single_pass": False})
    fa.LAUNCHES = fs.LAUNCHES = fs.PREPASS_LAUNCHES = stft.LAUNCHES = 0
    out2 = analyze_batch(batch, two).cpu().numpy()
    launches["fused_stats"], launches["stft_power"] = fs.LAUNCHES, stft.LAUNCHES
    if fa.LAUNCHES or fs.LAUNCHES < 1 or stft.LAUNCHES < 1 or fs.PREPASS_LAUNCHES < 1:
        raise AssertionError(
            f"the two-kernel path launched prepass {fs.PREPASS_LAUNCHES}, fused_all "
            f"{fa.LAUNCHES}, fused_stats {fs.LAUNCHES}, stft_power {stft.LAUNCHES} "
            f"times; want the prepass, K2 and K3 only"
        )
    with plain_k2_k3[0], plain_k2_k3[1], plain_k2_k3[2]:
        ref2 = analyze_batch(batch, two).cpu().numpy()
    same_scores("two-kernel path", out2, out, "the main path")
    col_err = same_scores("two-kernel path", out2, ref2, "its plain-kernel run")
    times = cuda_times(lambda: analyze_batch(batch, two), reps=10)
    two_ms = statistics.median(times)
    log(f"two-kernel path analyze_batch B=64 L=2^23: launches fused_stats "
        f"{launches['fused_stats']} stft_power {launches['stft_power']}; beat counts "
        f"identical to the main path and its plain-kernel run, max |diff| vs plain "
        f"{col_err.max():.2e}; card-resident warm median of 10 {two_ms:.1f} ms = "
        f"{MAIN_B / two_ms * 1e3:.1f} songs/s (least {min(times):.1f}, most "
        f"{max(times):.1f} ms) {label}")
    log(f"two-kernel path analyze_batch trace: {device_trace(lambda: analyze_batch(batch, two))} {label}")

    hyb = AnalysisConfig.for_gpu_hybrid()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fs.LAUNCHES = fs.PREPASS_LAUNCHES = stft.LAUNCHES = 0
    outh = api.analyze_pcm(arrays, durations, cfg=hyb, device="cuda")
    hyb_launches = (fs.PREPASS_LAUNCHES, fa.LAUNCHES, fs.LAUNCHES, stft.LAUNCHES)
    hyb_peak = torch.cuda.max_memory_allocated() / 2**30
    if hyb_launches[0] < 1 or hyb_launches[1] or hyb_launches[2] < 1 or hyb_launches[3] < 1:
        raise AssertionError(
            f"the hybrid path launched (prepass, K1, K2, K3) {hyb_launches} times")
    with plain_k2_k3[0], plain_k2_k3[1], plain_k2_k3[2]:
        refh = api.analyze_features(batch, hyb)
    same_scores("hybrid path", outh, out, "the main path")
    col_err = same_scores("hybrid path", outh, refh, "its plain-kernel run")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        api.analyze_pcm(arrays, durations, cfg=hyb, device="cuda")
        runs.append(time.perf_counter() - t0)
    stage_s, copy_s, finish_s = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        packed = _device_stage_packed(batch, hyb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = packed.cpu().numpy()
        t2 = time.perf_counter()
        amp_h, freq_h, fa_h = _unpack_stage(host, hyb, MAIN_L)
        envelope_finish_host(fa_h, batch.n_samples.cpu().numpy(), batch.durations.cpu().numpy())
        t3 = time.perf_counter()
        stage_s.append(t1 - t0)
        copy_s.append(t2 - t1)
        finish_s.append(t3 - t2)
    warm_h = statistics.median(runs)
    log(f"hybrid path analyze_pcm B=64 L=2^23: launches (prepass, K1, K2, K3) {hyb_launches}; "
        f"beat counts identical to the main path and its plain-kernel run, max "
        f"|diff| vs plain {col_err.max():.2e}; warm median of 3 {warm_h:.3f} s = "
        f"{MAIN_B / warm_h:.1f} songs/s (host padding and copy included); "
        f"card-resident stages, median of 3: device stage "
        f"{statistics.median(stage_s) * 1e3:.1f} ms, copy back of "
        f"{host.nbytes / 2**20:.1f} MiB {statistics.median(copy_s) * 1e3:.1f} ms, "
        f"float64 host finish {statistics.median(finish_s):.3f} s on "
        f"{os.cpu_count()} host cores; peak device memory {hyb_peak:.2f} GiB {label}")

    # 6. similarity
    vecs = torch.from_numpy(out).cuda()
    dm = distance_matrix(vecs).cpu().numpy().astype(np.float64)
    v = out.astype(np.float64)
    dm_ref = np.sqrt(((v[:, None, :] - v[None, :, :]) ** 2).sum(-1))
    dm_err = float(np.abs(dm - dm_ref).max())
    # float32 Gram-matrix form: |a|^2 + |b|^2 - 2ab cancels for near pairs
    if not dm_err <= 1e-3:
        raise AssertionError(f"distance_matrix max err {dm_err}")
    log(f"distance_matrix 64x64 vs numpy float64: max abs err {dm_err:.2e}")

    # 7. the ablation: each variant against its plain version, then its path
    checked = [check_ablation(batch_inputs(edge), "(a) B=5 L=2^18 edge cases")]
    sinp = breakdown.inputs("script")
    checked.append(check_ablation(sinp, "(b) B=128 L=491520"))
    inp = breakdown.inputs("main")
    main_checked = check_ablation(inp, "(c) B=64 L=2^23", timed=True)
    checked.append(main_checked)
    for shape, x in (("script", sinp), ("main", inp)):
        for deg, hw in ((18, 200), (14, 128)):
            rep = matred.numerics_report(x["x"], x["alpha"], x["beta"], deg, hw)
            log(f"matred numerics report {shape} vs fused_stats_call: {rep}")
    del inp, sinp, x
    ab_fused.LAUNCHES = probe.LAUNCHES = matred.LAUNCHES = 0
    ab_rows = breakdown.run("script", log=log) + breakdown.run("main", log=log)
    launches.update(stats_ablate=ab_fused.LAUNCHES, probe=probe.LAUNCHES,
                    matred_stats=matred.LAUNCHES)
    if not (ab_fused.LAUNCHES and probe.LAUNCHES and matred.LAUNCHES):
        raise AssertionError(
            f"the ablation launched A1 {ab_fused.LAUNCHES}, A2 {probe.LAUNCHES}, A3 "
            f"{matred.LAUNCHES} times; want each at least once"
        )
    log(f"ablation path: launches A1 {ab_fused.LAUNCHES}, A2 {probe.LAUNCHES}, "
        f"A3 {matred.LAUNCHES} {label}")

    entries = []
    for name, (errs, ms, plain_ms) in kernels.items():
        bound, by = bounds.bound_ms(works[name])
        entries.append({
            "name": name, "source": "bliss_tpu_torch/kernels/csrc/"
            + {"stft_power": "power.cuh", "prepass": "prepass.cuh"}.get(name, "fused_all.cu"),
            "replaces": {
                "prepass": "bliss_tpu/kernels/fused_all.py:385 (the XLA prepass; no Pallas kernel)",
                "fused_all": "bliss_tpu/kernels/fused_all.py:52",
                "fused_stats": "bliss_tpu/kernels/fused_stats.py:71",
                "stft_power": "bliss_tpu/kernels/pallas_stft.py:75",
            }[name],
            "max_abs_err": max(a for a, _ in errs.values()),
            "errors": {k: {"max_abs": a, "max_rel": r} for k, (a, r) in errs.items()},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            **({"library_calls_ms": k3_calls} if name == "stft_power" else {}),
        })
    ab_replaces = {
        "stats_ablate": "scripts/ablate_fused.py:36",
        "probe": ("scripts/ablate_fused.py:154, scripts/ablate_dma.py:38, "
                  "scripts/ablate_dma.py:55, scripts/ablate_dma.py:88, "
                  "scripts/ablate_packread.py:51, scripts/ablate_packread.py:64, "
                  "scripts/ablate_packread.py:82"),
        "matred_stats": "scripts/proto_matred.py:57",
    }
    # each ablation kernel's row: its main-path-shaped variant
    main_cases = {"stats_ablate": ("A1", "stats full"), "probe": ("A2", "S2 touch i16"),
                  "matred_stats": ("A3", "S4 matred cheb18/200")}
    for name, (kernel_id, case_name) in main_cases.items():
        rows = [r for r in ab_rows if r["kernel"] == kernel_id]
        row = next(r for r in rows if r["shape"] == "main" and r["name"] == case_name)
        errs = [e for c in checked for n, (errs_n, _, _) in c.items()
                if n in {r["name"] for r in rows} for e in errs_n.values()]
        _, plain_ms, lib_ms = main_checked[case_name]
        library[name] = lib_ms
        entries.append({
            "name": name, "source": "bliss_tpu_torch/kernels/csrc/ablate.cu",
            "replaces": ab_replaces[name],
            "max_abs_err": max(a for a, _ in errs), "max_rel_err": max(r for _, r in errs),
            "ms": row["ms"], "plain_ms": plain_ms,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "variants": {
                f"{r['shape']} {r['name']}": {
                    "ms": r["ms"], "bound_ms": r["bound_ms"],
                    **({"plain_ms": main_checked[r["name"]][1],
                        "library_ms": main_checked[r["name"]][2]}
                       if r["shape"] == "main" else {}),
                } for r in rows
            },
        })
    for e in entries:
        e.update(route="cuda", launches=launches[e["name"]], library_ms=library[e["name"]])
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
