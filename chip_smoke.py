#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bliss_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: compiles ``bliss_tpu_torch/kernels/csrc/fused_all.cu`` (K1, K2,
   K3; it includes ``csrc/stats.cuh`` and ``csrc/power.cuh``) and
   ``csrc/ablate.cu`` (the measurement kernels A1, A2, A3) and
   ``csrc/knn.cu`` (the whole-library k nearest neighbours) for
   sm_90a from the checkout, one ``nvcc`` each, started together, and
   prints each build's time and each kernel's ptxas registers and spills;
3. kernel vs plain, each kernel's wrapper against its plain version on the
   same card tensors, (a) on a B=5, L=2^18 batch of edge cases and (b) on
   the main-path batch B=64, L=2^23, with the warm median of 5 timings of
   each: the prepass ``prepass_sums`` (int64 sums identical; the edge batch
   has a silent song and one whose int32 sum wraps); K1 ``fused_all_call``
   (edge batch with and without ``halo0``, the history a streamed row
   takes); K2 ``fused_stats_call`` (edge batch with and without ``halo0``,
   and at 2 and 129 taps); K3 ``stft_power`` (edge batch with
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
7. the ablation (``bliss_tpu_torch.ablate``): A2's and A3's registers and
   spills from the build report; every variant of A1 (the stats kernel's
   stages), A2 (the read-and-reduce probes) and A3 (the FIR and the
   correction as fp64 tensor-core products) against its plain version on
   the edge batch, at the TPU scripts' shape B=128, L=491520 and at B=64,
   L=2^23, where the plain versions and, for the row sums, ``torch.sum`` of
   the same rows are timed too; on the edge batch also every A2 mode on
   every dtype with stripes that end ragged, and A3 at 2, 17 and 129 taps
   under both fits (timed at B=64, L=2^23 too); A3's numerics report
   against the shipped stats kernel;
   then the ablation's own path,
   ``bliss_tpu_torch.ablate.breakdown.run`` at both shapes, which times every
   variant and must launch each of A1, A2 and A3; the phase's seconds;
8. the library pipeline (``bliss_tpu_torch.pipeline``): (a) its loop after
   decode, ``pipeline._scan``, fed 192 decoded songs of the main batch's
   lengths (the main batch, each song reversed, each rotated by a third) at
   B=64 under ``for_gpu()`` and under ``for_gpu_hybrid()``: every row ok,
   beat counts identical to a card-resident ``analyze_features`` of the same
   songs at L=2^23 and the other columns within 1e-3 (so across the two
   buckets the songs fall into, 6291456 and 2^23), launched through the
   prepass and K1 (main) or the prepass, K2 and K3 (hybrid); it prints the
   ``StageTimer`` report, songs/s and the host-to-device copy of one padded
   batch; (b) where ``pkg-config`` finds libav's development files, files:
   a FLAC library of 8 songs of ~30 s (one at 44.1 kHz) and a broken file,
   scanned by ``analyze_library`` into a ``FeatureStore`` and resumed from
   it, and ``Song`` and ``distance_file`` on two of the files; where it
   does not, one line says the file phase is left out;
9. long songs streamed (``features/streaming.py``): eight ``synth_song``s
   of 2^23 + 1 .. 31752000 interleaved samples (3.2-12 min) and a 60-minute
   mix of 158760000 samples made of them, (a) through ``pipeline._scan``
   with its default ``long_song_samples`` among the main batch's 64 songs,
   under ``for_gpu()`` and ``for_gpu_hybrid()``: every row ok, the
   ``streaming`` stage once a long song, the short songs' rows those of
   phases 4 and 5, and exactly the launches the path makes (the prepass
   and K1, or the prepass, K2 and K3); (b) each streamed row against the
   song whole at B=1 in its bucket (beat counts identical, the rest within
   1e-3); (c) ``chunk_samples`` 2^20 and 2^22 count the same beats; (d) the
   mix streamed with the plain versions of the kernels counts the same
   beats; with the seconds a song of each route, the scan's songs/s and
   minutes of audio a second, its stages, the peak device memory while the
   mix streams, and a ``torch.profiler`` trace of one streamed song;
10. similarity and the CLI (``bliss_tpu_torch.sim``, ``bliss_tpu_torch.cli``),
   with TF32 asserted off: (a) a library of 100 000 rows around phase 4's
   force vectors and, at D = 49, phase 11 (a)'s 45 extended columns of the
   same songs (sigma 3 in every column, 1 000 rows planted as exact copies
   of others), at D = 4 and D = 49: ``nearest_neighbors_all`` (k=5, block 4096) against a
   float64 NumPy brute force on 512 seeded rows and every planted pair (d^2
   within the float32 Gram bound, indices equal where the gaps allow, each
   copy's twin first at <= 1e-2; the k-NN kernel launched once a call),
   the k-NN kernel (``knn_topk``) against its plain version ``_block_topk``
   on the same card rows (d^2 within a bound that the float32 Gram form
   fails, indices equal where the gaps allow; both timed beside the
   kernel's bound), ``nearest_neighbors``, ``playlist_order``
   (ties in index order), ``distance_matrix`` at 10k x 10k and ``kmeans``
   (k=32, 50 iterations: two runs identical, the CPU Lloyd from the card's
   k-means++ seeds within 1e-4), each timed with its peak device memory;
   (b) the CLI's ``store neighbors``, ``dupes``, ``export`` and ``stats`` on
   a 100 000-entry store (neighbors and dupes each through the k-NN kernel); (c) the CLI from 65 FLAC files (one streamed):
   ``scan`` through the prepass and K1 (rows as ``analyze_pcm``'s), then
   ``playlist`` and ``radio`` resumed from the store (``pipeline.iter_decode``
   patched, and logged, where libav's development files are missing);
11. the extended features (``features/extended.py``), run after phase 9
   and before phase 10: (a) ``api.analyze_features(..., extended=True)`` on
   the main batch under ``for_gpu()``, the two-kernel config and
   ``for_gpu_hybrid()``: the prepass and K1 (or K2 and K3) once, as
   without extended; the 4 core columns identical to phases 4 and 5; bpm ·
   duration / 60 the core beat count in every row; the 45 columns within
   ``EXTENDED_GATES`` of the same function with its per-frame stage in
   float64 on the card, and hybrid within them of main; ``analyze_batch``
   with and without extended (CUDA events, median of 5) and the peak device
   memory each adds (the extended path at most 2 GiB more), the stage alone
   and a trace; (b) phase 9's long songs and mix streamed with extended
   under both configs against each song whole at B=1, with the seconds a
   song; (c) one extended scan of phase 8's 192 songs (``pipeline._scan``,
   held within the gates of ``analyze_features``), and, inside phase 10 (c)
   on its files, the CLI's ``scan --extended`` (49-column store rows, the
   plain scan's core rows) and ``radio --extended`` (``kmeans`` of the
   z-scored rows, resumed from the store);
12. the XLA-path config modes (M7; no kernel of their own: PyTorch on the
   card), with TF32 asserted off and no launch of K1, K2 or K3 on any of
   them: (a) ``api.analyze_features`` on the main batch under
   ``AnalysisConfig()`` and under the float32 config ``bliss_tpu`` picks on
   a CPU backend, each held to phase 4's ``for_gpu()`` rows (amplitude,
   frequency, attack within 1e-3; the songs whose beat count differs
   counted, none by more than one, for the float32 working-dtype finish in
   the float64 finish of the same energies, its own flips each within its
   rounding of the envelope), with ``analyze_batch``'s
   warm median of 5, a trace and the peak device memory; (b)
   ``for_parity()`` at B=16, L=2^23, timed the same way, and on 4 of its
   songs cut to 2^21 samples held to ``tests/oracle.py::analyze_oracle``
   (NumPy and SciPy, in 4 spawned processes) and to the port's own CPU run
   (beats identical, scores within 1e-5); (c) the mode matrix at B=4,
   L=2^20 in float64 (amplitude table vs iterative, spectrum fft vs matmul,
   tempo energies parseval vs parseval_framed and fft, the attack of
   fft_strict and its rows against the CPU, the IIR blocked vs scan,
   band_taps=161 against the CPU), and the scan IIR's
   finish at L=2^23 timed once; (d) the CLI's ``analyze --filterbank
   reference36`` through the prepass and K1;
13. the serving layer (M11: ``server.py``, ``http_gateway.py``, the CLI's
   ``doctor``, ``gui.ScanJob``) in-process under ``for_gpu()``: (a) a
   daemon's cold start (a fresh process, nvcc into an empty build
   directory) and warm start (the libraries on disk), each warmup launching
   the prepass and K1 once; the main batch's 64 songs and two of phase 9's
   long songs written as FLAC files (decode and probe patched, and logged,
   where libav's development files are missing); a daemon on a Unix socket
   with a store: ``analyze`` of the 66 files through the prepass and K1
   (rows as ``analyze_pcm``'s of the same PCM and phase 9's streamed rows:
   beats identical, the rest within 1e-3), the same op from the store (no
   launch, no decode), ``distance``, ``playlist`` and ``neighbors`` equal to
   ``sim``'s on the same rows, 20 pings, 4 clients at once on disjoint
   subsets; (b) an HTTP gateway on it: ``/status``, ``/metrics``, a
   ``scan --extended`` streamed as chunked NDJSON progress, then
   ``shutdown`` over HTTP stopping both transports; (c) the ``neighbors``
   op over a 100 000-entry store (= ``nearest_neighbors_all`` over
   ``similarity_rows``, the k-NN kernel once a request) beside the CLI's
   ``store neighbors``; (d) a health
   probe every 0.5 s made to raise a CUDA error text: ``/metrics`` degraded,
   then recovered once; (e) ``doctor --device cuda``; (f) ``ScanJob``
   headless: its CSV rows are (a)'s force vectors;
14. the XLA-path modes streamed (M7b) and ``scripts/kernel_smoke.py``'s
   single-device matrix, with TF32 asserted off: (a) phase 9's long songs
   and mix through ``analyze_song_streaming`` under ``AnalysisConfig()``,
   ``bliss_tpu``'s CPU float32 config, ``for_parity()`` (the 12-minute
   song and the mix), the iterative amplitude with ``parseval_framed``,
   161 taps and F6's ``AnalysisConfig(fused_kernel=True)``: the prepass
   once a song and no K1, K2 or K3 on an XLA-path config (F6's: K2 and K3
   once a group of rows); beats identical to the song whole at B=1 under
   the same config with the float64 finish, and at ``chunk_samples`` 2^20,
   the rest within 1e-3 (1e-5 in float64); seconds a song and peak device
   memory, streamed and whole; a trace of the 12-minute song streamed; and
   ``pipeline._scan`` of three long songs under ``AnalysisConfig()``, each
   streamed; (b) the matrix's 12 single-device rows (bands 1/5/36 x split
   and exact FIR on K2 + K3, bands 1/5/36 on K1, ``stft_conv="fast"`` on
   both, ``for_gpu()`` with extended) on its B=8, L=2^17 batch: finite
   rows, the extended columns in their physical ranges, each config's
   kernels against their plain versions within phase 3's gates, each row
   within the script's rule of its ``bandsN-exact`` anchor, and one song
   streamed in rows of 2^15 counting its beats whole;
15. the mesh (M10, ``bliss_tpu_torch.parallel``), with TF32 asserted off:
   (a) the main batch through ``analyze_sharded`` under ``for_gpu()`` on
   (1, 2), (2, 2) and (1, 4) meshes of the card repeated (and of distinct
   cards where there are as many), every shard on the kernel branch: the
   prepass, K2 and K3 once a shard and no K1, the rows phase 4's (beats
   identical, the rest within 5e-4), the warm median of 5 with CUDA events
   and the peak device memory; (b) K2 with shard 1's real ``halo0`` and K3
   with its ``frame_offset`` against their plain versions within phase 3's
   gates; (c) ``scripts/kernel_smoke.py``'s two sharded rows on a (2, 1)
   mesh against the same configs unsharded; (d) ``for_gpu_hybrid()`` and
   ``extended=True`` on the (2, 2) mesh against phases 5 and 11 (a)
   (EXTENDED_GATES); (e) ``analyze_library(mesh=...)`` of the main batch
   and two long songs (streamed) against the scan without a mesh, a
   daemon built with a (1, 2) mesh, the CLI's ``scan --mesh 1``
   (``pipeline.iter_decode`` patched: no libav here); (f) a world-size-1
   NCCL ``ProcessGroup`` on a file store, its (1, 1) rows the
   ``LocalGroup``'s bit for bit, the group destroyed after; (g)
   ``sharded_distance_topk`` over phase 10's D = 4 library on a (4, 1)
   mesh, equal to ``nearest_neighbors_all``, the k-NN kernel once a shard;
16. the C compat library and the differential fuzz (the rest of M11):
   ``libbliss.so`` and ``abi_check`` built with g++ and gcc from the
   checkout (a missing compiler or ``Python.h`` fails the phase); (a) the library loaded into this process with ``ctypes``,
   ``io.decoder.decode`` patched to hand back 8 of the main batch's songs
   by file name: under ``gpu`` each ``bl_analyze`` launches the prepass and
   K1 once and gives phase 4's rows (beats identical, the rest within
   5e-4); under ``parity``, on 4 of them, the three sorts within 1e-5 of
   ``Song``'s ``for_parity()`` analyses and of ``bl_analyze``'s vectors;
   ``bl_distance`` and ``bl_cosine_similarity`` against ``sim.distance``;
   seconds a song under each mode; (b) ``abi_check`` in a fresh process
   with no environment but the mode, on 2 caller-filled raw songs (its
   cold start, its sorts (a)'s), then on 4 threads x 2 rounds, every
   result the single-thread one; (c) a FLAC file through
   ``bl_audio_decode``: without libav ``BL_UNEXPECTED`` with the decoder's
   message; (d) ``bliss_tpu_torch.fuzz``: 16 ``device_exact``, 16
   ``hybrid``, 4 ``streaming`` and 8 ``extended`` cases, none divergent,
   with cases a second and the largest deviation per column. Where
   ``Python.h`` or a compiler is missing, (a)-(c) print one line naming
   it and (d) runs;
17. the tools and examples (M12: ``bliss_tpu_torch.tools``,
   ``bliss_tpu_torch.examples``), with TF32 asserted off: (a)
   ``tools.quality_benchmark.run`` at 6 x 4 x 5 s and 8 x 6 x 11 s under the
   script's config (the XLA-path stage: the prepass once, no K1, K2 or K3)
   and ``for_gpu()`` (the prepass and K1 once a call), each [N, 49] matrix
   held to the same call on the CPU (beats identical, the core within 5e-4,
   the rest within ``EXTENDED_GATES``, recall and separation within 1e-3),
   the extended columns winning (recall >= core's and >= 0.8, separation
   above core's), and the 6 x 4 x 5 s numbers within 1e-3 of
   ``bliss_tpu``'s (``QUALITY_BLISS_TPU``); (b) ``tools.bench_similarity``
   at N = 100 000, D = 4 and 49, ``correct_row0`` true; (c)
   ``tools.demo_scale`` at its default sizes, its scan of 384 generated
   songs of 11 s through the prepass and K1 once a batch, rows as
   ``analyze_pcm``'s; (d) each of the six examples on a 6-song generated
   library (``library_scan`` and ``make_playlist`` writing the CLI's CSV
   and m3u); (e) ``tests/test_edge_cases.py``'s degenerate songs and four
   more through the prepass and K1 against their plain versions. Where
   libav's development files are missing, (c) and (d) patch
   ``pipeline.iter_decode`` and ``api._decode`` (logged) to read the PCM
   ``gen_library`` wrote.

The script's total time follows. The last two lines of standard output
are a JSON line of the kernels and their timings and the card's name and
power limit; the very last line is
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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
    number of kernels and their summed time, the copies' and sets' summed
    time, and the kernels with the most time. Returns a line of
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

    copy_us = sum(float(e["dur"]) for e in dev if e["cat"] != "kernel")
    return (f"span {(t1 - t0) / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
            f"{1 - busy / (t1 - t0):.3f}; {nk} kernels ({len(by_name)} distinct, "
            f"{sum(t for _, t in by_name.values()) / 1e3:.3f} ms), {len(dev) - nk} copies and "
            f"sets ({copy_us / 1e3:.3f} ms); most time: " + "; ".join(
                f"{short(name)} x{n} {t / 1e3:.3f} ms" for name, (n, t) in top))


def op_table(fn, top: int = 12) -> str:
    """One warm run of ``fn`` under ``torch.profiler``: its device time by
    PyTorch operator (the kernels each operator launched), the ``top``
    operators with the most. A reading, not a gate: "not measured" with the
    reason where the profiler gives no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()

        def device_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        # operators only: each kernel's time is also its own row
        rows = sorted(((e.key, e.count, device_us(e)) for e in prof.key_averages()
                       if e.key.startswith("aten::")), key=lambda r: -r[2])
    except Exception as exc:  # a reading, not a gate
        return f"not measured ({type(exc).__name__}: {exc})"
    total = sum(t for _, _, t in rows)
    if total <= 0:
        return "not measured (key_averages holds no device time)"
    return f"{total / 1e3:.3f} ms of device time: " + "; ".join(
        f"{k} x{c} {t / 1e3:.3f} ms" for k, c, t in rows[:top] if t > 0)


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

    halos = [None]
    if edge:
        rng = np.random.default_rng(SEED + 1)
        halos.append(torch.from_numpy(
            rng.integers(-20000, 20000, size=(x.shape[0], 16), dtype=np.int16)
        ).cuda())
    for halo0 in halos:  # K1 with halo0: what a streamed song's rows take
        res = kernel_vs_plain(
            f"fused_all {label}" + (" halo0" if halo0 is not None else ""),
            lambda: fa.fused_all_call(x, alpha, beta, n_frames, halo0),
            lambda: fa.fused_all_reference(x, alpha, beta, n_frames, halo0),
            k1_errors, timed and halo0 is None,
        )
        out.setdefault("fused_all", res)
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


# the ablation's row-sum probes -> the rows they sum (input, row width);
# torch.sum of those rows is the one PyTorch call that computes the same
# sums (for six_sums, the first of its six; a packed row of 256 words is
# 512 int16 samples)
LIBRARY_ROWS = {"S1b one_sum": ("x", 256), "S1b sums_stack": ("x", 256),
                "S1b six_sums": ("x", 256), "S2 touch i16": ("x", 256),
                "S2 touch i32": ("x32", 256), "S2 touch f32": ("xf", 256),
                "S3 i16": ("x", 256), "S3 packed": ("x", 512),
                "S3 packed_nounpack": ("words", 256)}


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
                key, width = LIBRARY_ROWS[case["name"]]
                rows = inp[key].reshape(inp["B"], -1, width)
                lib_ms = cuda_ms(lambda: torch.sum(rows, dim=-1, dtype=torch.float32))
        out[case["name"]] = (errs, plain_ms, lib_ms)
        detail = ", ".join(f"{k} max_abs={a:.3e} max_rel={r:.3e}" for k, (a, r) in errs.items())
        if timed:
            detail += f"; plain {plain_ms:.3f} ms" + ("" if lib_ms is None else f", torch.sum {lib_ms:.3f} ms")
        log(f"ablation vs plain {label} {case['name']}: {detail}")
    return out


def check_probe_modes(x, label) -> dict:
    """Every A2 mode on every dtype it takes against its plain version, on
    rows of the card-resident int16 ``x`` [B, L] (and their int32 and
    float32 copies, and full-range int32 words, so that their float32 sums
    round), with chunks of 16 and 40 rows: stripes of 32 rows that end
    ragged. Gates as ``ablation_errors``': copies and sums of int16 values
    identical, other sums within 1e-6 of each output's sum of |term| (+1).
    Returns {case: (errors, None, None)}, as ``check_ablation``."""
    from bliss_tpu_torch.ablate import probe

    B, L = x.shape
    rows = x.reshape(B, L // 256, 256)[:, :1000]
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    full = torch.randint(-2**31, 2**31 - 1, rows.shape, dtype=torch.int64, device=x.device,
                         generator=gen).to(torch.int32)
    inputs = {torch.int16: rows, torch.int32: full, torch.float32: rows.to(torch.float32)}
    out = {}
    for dtype, r in inputs.items():
        for mode in probe.MODES:
            if mode == "packed" and dtype != torch.int32:
                continue
            for nblk in (16, 40):
                t = r[:, : r.shape[1] // nblk * nblk].contiguous()
                got = probe.probe(t, nblk, mode)
                torch.cuda.synchronize()
                ref = probe.probe_reference(t, nblk, mode)
                name = f"A2 {mode} {str(dtype)[6:]} nblk={nblk}"
                exact = mode in ("zero", "slice", "convert") or (
                    mode in ("sum1", "packed") and dtype != torch.int32)
                scale = probe.probe_reference(t, nblk, mode, absolute=True).double() + 1.0
                out[name] = ({"out": compare(name, got, ref, scale, 0.0 if exact else 1e-6)},
                             None, None)
    worst = max(r for e, _, _ in out.values() for _, r in e.values())
    log(f"ablation (phase 7) {label}: every A2 mode x dtype ({len(out)} cases, rows "
        f"[{B}, {rows.shape[1]}, 256], chunks of 16 and 40 rows) against the plain versions: "
        f"max rel err {worst:.3e}")
    return out


def check_matred_taps(x, alpha, beta, label) -> dict:
    """A3 at the shortest, the scripts' and the longest FIR (taps 2, 17,
    129) under both Chebyshev fits, on card-resident ``x`` (a silent song's
    columns NaN), against the plain version within ``ablation_errors``'
    gates. Returns {case: (errors, None, None)}, as ``check_ablation``."""
    from bliss_tpu_torch.ablate import matred

    L = x.shape[1]
    out = {}
    for taps in (2, 17, 129):
        for deg, hw in ((18, 200), (14, 128)):
            got = matred.proto_call(x, alpha, beta, deg, hw, chunk=L, taps=taps)
            torch.cuda.synchronize()
            ref = matred.matred_reference(x, alpha, beta, deg, hw, chunk=L, taps=taps)
            name = f"A3 taps={taps} cheb{deg}/{hw}"
            out[name] = (ablation_errors({"name": name, "kernel": "A3"}, got, ref), None, None)
    detail = "; ".join(f"{n} sums max_rel={e['stats'][1]:.3e}" for n, (e, _, _) in out.items())
    log(f"ablation (phase 7) {label}: A3 at taps 2, 17, 129 against the plain version: {detail}")
    return out


def matred_taps_ms(inp, label) -> dict:
    """A3's warm median of 5 at ``inp``'s shape under the shipped fit at 2,
    17 and 129 taps (the FIR's share of its time), each beside its bound.
    Returns {"taps=N": {"ms", "bound_ms"}}."""
    from bliss_tpu_torch.ablate import matred
    from bliss_tpu_torch.kernels import bounds

    x, a, b, B, L = inp["x"], inp["alpha"], inp["beta"], inp["B"], inp["L"]
    out = {}
    for taps in (2, 17, 129):
        ms = cuda_ms(lambda: matred.proto_call(x, a, b, chunk=inp["chunk"], taps=taps))
        out[f"taps={taps}"] = {"ms": ms, "bound_ms": bounds.bound_ms(bounds.matred_work(B, L, taps=taps))[0]}
    log(f"ablation (phase 7) A3 B={B} L={L} by FIR length, warm median of 5: "
        + ", ".join(f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})" for k, v in out.items())
        + f" {label}")
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
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f"{label} output not finite {list(ref.shape)}: {out}")
    if not np.array_equal(out[:, 0], ref[:, 0]):
        bad = np.nonzero(out[:, 0] != ref[:, 0])[0]
        raise AssertionError(f"{label}: beat counts differ from {what} at songs {bad}")
    col_err = np.abs(out[:, 1:] - ref[:, 1:]).max(axis=0)
    if not (col_err <= 1e-3).all():
        raise AssertionError(f"{label}: amplitude/frequency/attack differ from {what}: {col_err}")
    return col_err


def launch_counts() -> dict:
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft

    return {"prepass": fs.PREPASS_LAUNCHES, "fused_all": fa.LAUNCHES,
            "fused_stats": fs.LAUNCHES, "stft_power": stft.LAUNCHES}


def reset_counts() -> None:
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft

    fa.LAUNCHES = fs.LAUNCHES = fs.PREPASS_LAUNCHES = stft.LAUNCHES = 0


STAGES = ("pad", "device_dispatch", "device_finalize", "finalize_wait", "streaming", "scan")


def stage_line(stats: dict) -> str:
    return "; ".join(
        f"{s} {stats[s]['seconds']:.3f} s wall, {stats[s]['cpu_seconds']:.3f} s cpu, "
        f"x{stats[s]['count']}" for s in STAGES if s in stats)


def scan_phase(songs, durs, cfg, name, device, batch_size, label, runs=3, trace=True,
               extended=False):
    """Phase 8 (a): ``pipeline._scan`` (``analyze_library``'s loop after
    decode) on ``songs`` as decoded audio, ``runs`` times, each run held
    against ``api.analyze_features`` of the same songs in batches of
    ``batch_size`` on ``device``, and each run's launches counted: the
    kernels that ``cfg``'s path runs must launch and no other. Then, with
    ``trace``, one more run under ``torch.profiler``. With ``extended``
    (phase 11 (c)) the scan and its yardstick give the 45 extended columns
    too, held within EXTENDED_GATES. Returns the last run's launches."""
    from bliss_tpu_torch import api, pipeline
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.utils import StageTimer

    ref = np.concatenate([
        api.analyze_features(PCMBatch.from_arrays(
            songs[k:k + batch_size], durs[k:k + batch_size], device=device), cfg, extended)
        for k in range(0, len(songs), batch_size)])
    decoded = [DecodedAudio(s, 2, SR, 0, 2, 0, d, f"synth-{i}", "", "", "", "", "")
               for i, (s, d) in enumerate(zip(songs, durs))]
    n = len(decoded)
    buckets = {}
    for d in decoded:
        L = pipeline._bucket_length(d.n_samples, cfg.pad_multiple)
        buckets[L] = buckets.get(L, 0) + 1

    def one_scan():
        result = pipeline.ScanResult([d.filename for d in decoded],
                                     np.full((n, 4), np.nan, np.float32), np.zeros(n, bool), {}, {})
        timer = StageTimer()
        cancelled = pipeline._scan(result, enumerate(decoded), cfg=cfg, batch_size=batch_size,
                                   device=torch.device(device), timer=timer, extended=extended)
        return result, timer.report(), cancelled

    want = {"prepass", "fused_all"} if cfg.single_pass else {"prepass", "fused_stats", "stft_power"}
    for run in range(1, runs + 1):
        reset_counts()
        result, stats, cancelled = one_scan()
        launches = launch_counts()
        if {k for k, v in launches.items() if v} != want:
            raise AssertionError(f"the {name} scan launched {launches}; want {sorted(want)} only")
        if cancelled or result.errors or not result.ok.all():
            raise AssertionError(f"the {name} scan: cancelled {cancelled}, errors {result.errors}, "
                                 f"ok {int(result.ok.sum())} of {n}")
        col_err = same_scores(f"{name} scan", result.features, ref[:, :4],
                              "analyze_features of the same songs at L=2^23")
        what = "pipeline (a)"
        if extended:
            errs = ext_gates(f"{name} extended scan", result.extended, ref[:, 4:], durs)
            bpm_counts_beats(f"{name} extended scan", np.concatenate(
                [result.features, result.extended], axis=1), durs)
            what = f"extended (phase 11) (c) {gates_text(errs)};"
        log(f"{what} {name} scan {run} of {n} songs at B={batch_size}, buckets "
            f"{dict(sorted(buckets.items()))}: launches {launches}; every row ok, beat counts "
            f"identical to analyze_features of the same songs, max |diff| amplitude "
            f"{col_err[0]:.2e} frequency {col_err[1]:.2e} attack {col_err[2]:.2e}; "
            f"{stage_line(stats)}; {n / stats['scan']['seconds']:.1f} songs/s over the scan {label}")
    if trace:
        log(f"pipeline (a) {name} scan trace: {device_trace(one_scan)} {label}")
    return launches


LONG_MIN, LONG_MAX = (1 << 23) + 1, 31_752_000  # 3.2 to 12 min of stereo at 22.05 kHz
MIX_LEN = 158_760_000  # a 60-minute mix


def long_songs(rng: np.random.Generator):
    """Phase 9's songs: eight ``synth_song``s whose lengths run evenly from
    LONG_MIN to LONG_MAX interleaved samples, and a 60-minute mix of MIX_LEN
    samples, the eight rotated by a third each and concatenated."""
    lengths = np.linspace(LONG_MIN, LONG_MAX, 8).round().astype(np.int64)
    songs = [synth_song(rng, int(n)) for n in lengths]
    songs.append(np.concatenate([np.roll(s, s.shape[0] // 3) for s in songs])[:MIX_LEN])
    return songs, [int(s.shape[0]) // (2 * SR) for s in songs]


def stream_rows(songs, durs, cfg, chunk, device):
    """``analyze_song_streaming`` of each song on ``device``: (rows [N, 4],
    seconds of each song, its copy to the device included)."""
    from bliss_tpu_torch.features.streaming import analyze_song_streaming

    rows, secs = [], []
    for s, d in zip(songs, durs):
        t0 = time.perf_counter()
        rows.append(analyze_song_streaming(s, d, cfg, chunk, device=device))
        secs.append(time.perf_counter() - t0)
    return np.stack(rows), secs


def whole_rows(songs, durs, cfg, device):
    """Each song whole and alone, as the bucket path would take it at B=1:
    ``api.analyze_features`` of a [1, L] batch on ``device``, L its pipeline
    bucket. Returns (rows [N, 4], seconds of each song, the copy included)."""
    from bliss_tpu_torch import api, pipeline
    from bliss_tpu_torch.features.types import PCMBatch

    rows, secs = [], []
    for s, d in zip(songs, durs):
        t0 = time.perf_counter()
        x = torch.zeros(1, pipeline._bucket_length(s.shape[0], cfg.pad_multiple),
                        dtype=torch.int16, device=device)
        x[0, : s.shape[0]].copy_(torch.from_numpy(s))
        n_t, d_t = (torch.full((1,), v, dtype=torch.int32, device=device) for v in (s.shape[0], d))
        rows.append(api.analyze_features(PCMBatch(x, n_t, d_t), cfg)[0])
        secs.append(time.perf_counter() - t0)
        del x
    return np.stack(rows), secs


def secs_line(secs) -> str:
    return "[" + ", ".join(f"{s:.3f}" for s in secs) + "] s"


def stream_phase(short, short_durs, short_rows, device, label) -> dict:
    """Phase 9: long songs streamed. (a) ``pipeline._scan`` with the default
    ``long_song_samples`` under ``for_gpu()`` and ``for_gpu_hybrid()`` on
    ``long_songs`` interleaved with the ``short`` songs (which take the
    bucket path on the main thread while the pool thread streams): every row
    ok, the ``streaming`` stage once a long song, the short songs' rows
    ``short_rows[name]``, and exactly the launches the path makes (the
    prepass and K1, or the prepass, K2 and K3: one of each a batch, one
    prepass a long song and one K1 or K2 and K3 a group of its rows);
    (b) each streamed row against the song whole at B=1 in its bucket;
    (c) streaming at ``chunk_samples`` 2^20 and 2^22 counts the same beats;
    (d) the 60-minute mix streamed with the plain versions of the kernels
    counts the same beats. Prints the seconds a song of each route, the
    scan's songs/s and minutes of audio a second, its stages, the peak
    device memory while the mix streams, and a trace of one streamed song.
    Runs on ``device``; returns each config's scan launches, the long songs,
    their durations and their rows from the main scan."""
    from bliss_tpu_torch import AnalysisConfig, pipeline
    from bliss_tpu_torch.features import streaming
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft
    from bliss_tpu_torch.utils import StageTimer

    t0 = time.perf_counter()
    songs, durs = long_songs(np.random.default_rng(SEED + 4))
    n_long = len(songs)
    minutes = sum(s.shape[0] for s in songs) / (2 * SR * 60)
    log(f"streaming (phase 9) songs: {[int(s.shape[0]) for s in songs]} interleaved samples, "
        f"{minutes:.1f} min of audio, generated in {time.perf_counter() - t0:.1f} s")
    # a long song, then 8 short ones, and so on: the pool thread streams
    # while the main thread fills and dispatches buckets
    per = -(-len(short) // n_long)
    order = []
    for i in range(n_long):
        order += [("long", i)] + [("short", k) for k in range(i * per, min(len(short), (i + 1) * per))]
    pcm = {"long": songs, "short": short}
    dur = {"long": durs, "short": short_durs}
    decoded = [DecodedAudio(pcm[kind][i], 2, SR, 0, 2, 0, dur[kind][i], f"{kind}-{i}",
                            "", "", "", "", "") for kind, i in order]
    buckets = {pipeline._bucket_length(s.shape[0], 1024) for s in short}
    CH = streaming.DEFAULT_CHUNK
    group = max(1, streaming.GROUP_SAMPLES // (CH + stft.FRAME))  # rows a launch
    groups = sum(-(-(-(-s.shape[0] // CH)) // group) for s in songs)  # ceil(ceil(n / CH) / group)
    batches = sum(-(-sum(pipeline._bucket_length(s.shape[0], 1024) == L for s in short) // MAIN_B)
                  for L in buckets)
    n = len(decoded)
    # the stream each thread's launches go to (kernels/_build.launch takes
    # the calling thread's current stream)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pool_stream = pool.submit(lambda: torch.cuda.current_stream(device).cuda_stream).result()
    log(f"streaming: the pool thread launches on stream {pool_stream:#x}, the main thread on "
        f"{torch.cuda.current_stream(device).cuda_stream:#x}")
    launches, rows = {}, {}
    cfgs = {"main": AnalysisConfig.for_gpu(), "hybrid": AnalysisConfig.for_gpu_hybrid()}
    for name, cfg in cfgs.items():
        result = pipeline.ScanResult([d.filename for d in decoded],
                                     np.full((n, 4), np.nan, np.float32), np.zeros(n, bool), {}, {})
        timer = StageTimer()
        reset_counts()
        cancelled = pipeline._scan(result, enumerate(decoded), cfg=cfg, batch_size=MAIN_B,
                                   device=torch.device(device), timer=timer)
        launches[name] = launch_counts()
        stats = timer.report()
        k1 = {"fused_all": batches + groups} if cfg.single_pass else {
            "fused_stats": batches + groups, "stft_power": batches + groups}
        want = {"prepass": batches + n_long, "fused_all": 0, "fused_stats": 0, "stft_power": 0, **k1}
        if launches[name] != want:
            raise AssertionError(f"the {name} streaming scan launched {launches[name]}; want {want}")
        if cancelled or result.errors or not result.ok.all() or \
                stats.get("streaming", {}).get("count") != n_long:
            raise AssertionError(f"the {name} streaming scan: cancelled {cancelled}, errors "
                                 f"{result.errors}, ok {int(result.ok.sum())} of {n}, stages {stats}")
        is_long = np.array([kind == "long" for kind, _ in order])
        rows[name] = result.features[is_long]
        short_err = same_scores(f"{name} streaming scan, short songs", result.features[~is_long],
                                short_rows[name], "the main batch's rows")
        audio_min = minutes + sum(s.shape[0] for s in short) / (2 * SR * 60)
        scan_s = stats["scan"]["seconds"]
        log(f"streaming (a) {name} scan of {n_long} long and {len(short)} short songs at B={MAIN_B}: "
            f"launches {launches[name]} (exactly {batches} batches, {n_long} long songs, {groups} "
            f"groups of rows); every row ok, short rows as the main batch's (max |diff| "
            f"{short_err.max():.2e}); {stage_line(stats)}; {n / scan_s:.1f} songs/s, "
            f"{audio_min / scan_s:.1f} min of audio a second over the scan {label}")

    main = cfgs["main"]
    whole, whole_s = whole_rows(songs, durs, main, device)
    for name in cfgs:
        err = same_scores(f"streamed {name} rows", rows[name], whole,
                          "each song whole at B=1 in its bucket")
        log(f"streaming (b) {name}: beat counts identical to each song whole at B=1 in its "
            f"bucket ({', '.join(str(int(b)) for b in beat_counts(rows[name], durs))} beats), "
            f"max |diff| amplitude {err[0]:.2e} frequency {err[1]:.2e} attack {err[2]:.2e}")
    timed = {name: stream_rows(songs, durs, cfg, CH, device) for name, cfg in cfgs.items()}
    r20, s20 = stream_rows(songs, durs, main, 1 << 20, device)
    for what, got in (("2^22", timed["main"][0]), ("2^20", r20)):
        same_scores(f"streaming at chunk_samples {what}", got, rows["main"], "the scan's rows")
    log(f"streaming (c) chunk_samples 2^20 and 2^22: beat counts identical to the scan's rows; "
        f"seconds a song: streamed main {secs_line(timed['main'][1])}, hybrid "
        f"{secs_line(timed['hybrid'][1])}, main at 2^20 {secs_line(s20)}; whole at B=1 in its "
        f"bucket (host pad and copy included) {secs_line(whole_s)} {label}")

    mix, mix_dur = songs[-1], durs[-1]
    plain_prepass = mock.patch.object(fs, "prepass_sums", fs.prepass_sums_reference)
    with plain_prepass, mock.patch.object(fa, "fused_all_call", fa.fused_all_reference):
        plain_main = streaming.analyze_song_streaming(mix, mix_dur, main, device=device)
    with plain_prepass, mock.patch.object(fs, "fused_stats_call", fs.fused_stats_reference), \
            mock.patch.object(stft, "stft_power", stft.stft_power_reference):
        plain_hyb = streaming.analyze_song_streaming(mix, mix_dur, cfgs["hybrid"], device=device)
    err_m = same_scores("the mix with plain kernels", plain_main[None], rows["main"][-1:], "the scan")
    err_h = same_scores("the hybrid mix with plain kernels", plain_hyb[None], rows["hybrid"][-1:],
                        "the scan")
    log(f"streaming (d) the 60-minute mix with the plain prepass and K1 (hybrid: prepass, K2, K3): "
        f"beat counts identical to the scan's, max |diff| {err_m.max():.2e} (hybrid {err_h.max():.2e})")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    streaming.analyze_song_streaming(mix, mix_dur, main, device=device)
    mix_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - before
    reset_counts()
    streaming.analyze_song_streaming(songs[-2], durs[-2], main, device=device)
    one_launches = launch_counts()
    log(f"streaming the 60-minute mix ({MIX_LEN} samples, {MIX_LEN * 2 / 2**20:.0f} MiB): peak "
        f"device memory {peak / 2**30:.3f} GiB above the {before / 2**30:.2f} GiB already held; "
        f"launches {mix_launches}; the {LONG_MAX}-sample song: launches {one_launches} {label}")
    copies = []
    for s in (songs[-2], mix):
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            torch.from_numpy(s).to(device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        copies.append(f"{s.nbytes / 2**20:.1f} MiB {statistics.median(times) * 1e3:.1f} ms")
    log(f"streaming host-to-device copy of a song (pageable, median of 3): the "
        f"{LONG_MAX}-sample song {copies[0]}, the mix {copies[1]} {label}")
    log(f"streaming trace of the {LONG_MAX}-sample song (main): "
        f"{device_trace(lambda: streaming.analyze_song_streaming(songs[-2], durs[-2], main, device=device))} {label}")
    log(f"streaming (phase 9) took {time.perf_counter() - t0:.1f} s")
    return launches, songs, durs, rows["main"]


def libav_present() -> bool:
    """Whether ``pkg-config`` finds the libav development files that the
    port's native decoder builds against."""
    if shutil.which("pkg-config") is None:
        return False
    return subprocess.run(
        ["pkg-config", "--exists", "libavformat", "libavcodec", "libavutil", "libswresample"],
        timeout=60).returncode == 0


def file_phase(rng, device, seconds: float, label: str) -> None:
    """Phase 8 (b): a FLAC library of 8 songs of ``seconds`` each (song 3
    at 44.1 kHz, so that the resampler runs) and a broken file, written
    with the port's ``write_flac``; ``analyze_library`` into a
    ``FeatureStore`` (the broken file in ``errors`` with a NaN row), a
    second scan resumed from the store, then ``Song`` and
    ``distance_file`` on two of the files."""
    import tempfile

    from bliss_tpu_torch import api
    from bliss_tpu_torch.io import decode
    from bliss_tpu_torch.io.flac_writer import write_flac
    from bliss_tpu_torch.pipeline import analyze_library
    from bliss_tpu_torch.store import FeatureStore

    with tempfile.TemporaryDirectory() as d:
        files = []
        for i in range(8):
            sr = 44100 if i == 3 else SR
            n = 2 * int(seconds * sr)
            files.append(os.path.join(d, f"song{i}.flac"))
            write_flac(files[-1], synth_song(rng, n).reshape(-1, 2), sr, tags={"TITLE": f"song {i}"})
        broken = os.path.join(d, "broken.flac")
        with open(broken, "wb") as f:
            f.write(b"fLaC" + bytes(4096))
        files.insert(5, broken)
        t0 = time.perf_counter()
        first = analyze_library(files, store=FeatureStore(os.path.join(d, "store")), device=device)
        first_s = time.perf_counter() - t0
        if list(first.errors) != [broken] or not np.isnan(first.features[5]).all() \
                or first.ok.sum() != 8 or not np.isfinite(first.features[first.ok]).all():
            raise AssertionError(f"file scan: errors {first.errors}, ok {first.ok}, "
                                 f"rows {first.features}")
        again = analyze_library(files, store=FeatureStore(os.path.join(d, "store")), device=device)
        if again.stats.get("device_dispatch", {"count": 0})["count"] or \
                not np.array_equal(again.features, first.features, equal_nan=True):
            raise AssertionError(f"file rescan did not resume every row from the store: {again.stats}")
        if decode(files[3]).resampled != 1:
            raise AssertionError("the 44.1 kHz file was not resampled")
        song = api.Song(files[0], device=device)
        same_scores("Song", song.force_vector.as_array()[None], first.features[:1],
                    "its row in the scan")
        dist = api.distance_file(files[0], files[1], device=device)
        want = float(np.linalg.norm(first.features[0].astype(np.float64) - first.features[1]))
        if not abs(dist - want) <= 1e-3:
            raise AssertionError(f"distance_file {dist} against the scan's rows {want}")
    log(f"pipeline (b) files: 8 FLAC songs of {seconds:.0f} s (one at 44.1 kHz, resampled) and a "
        f"broken file: first scan {first_s:.2f} s, broken file in errors with a NaN row; second "
        f"scan resumed all 8 rows from the store; Song and distance_file ({dist:.4f}) agree with "
        f"the scan's rows; stages {stage_line(first.stats)}; decode {first.stats['decode_cpu_seconds']} "
        f"s cpu {label}")


SIM_N = 100_000  # BASELINE.json config 5, scripts/bench_similarity.py's --n
SIM_DUPES = 1_000
SIM_K, SIM_BLOCK = 5, 4096  # the CLI's store neighbors: --top-k 5, the default block
SIM_QUERIES = 512
SIM_DIMS = (4, 49)  # the force vector; bench_similarity --dim 49 (core + extended)
DM_N = 10_000  # scripts/demo_scale.py:42-43
KM_K, KM_ITERS = 32, 50  # the CLI's radio setting is iters=50 (bliss_tpu/cli.py:330)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_text(device) -> str:
    if torch.device(device).type != "cuda":
        return "peak device memory not measured (no card)"
    return f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def host_times(fn, device, reps: int = 3) -> list[float]:
    """Seconds of each of ``reps`` runs of ``fn`` after a warm one, each
    ended by a synchronize."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def times_text(times) -> str:
    return (f"median of {len(times)} {statistics.median(times):.4f} s (least {min(times):.4f}, "
            f"most {max(times):.4f})")


def sim_library(vectors, n: int, dim: int, n_dupes: int, rng):
    """Phase 10's library, [n, dim] float32: the rows ``vectors`` [V, >= dim]
    (phase 4's force vectors and phase 11's extended columns), cut to their
    first dim columns, first; then each row one of them plus Gaussian noise
    of sigma 3 (scripts/bench_similarity.py:47-50) in every column; then
    ``n_dupes`` rows overwritten as exact copies of as many others. Returns
    (features, pairs [n_dupes, 2] of (source, copy) rows; no row is in two
    pairs)."""
    v = len(vectors)
    pick = rng.integers(v, size=n)
    f = vectors[pick, :4].astype(np.float64) + 3.0 * rng.standard_normal((n, 4))
    if dim > 4:
        f = np.concatenate([f, vectors[pick, 4:dim] + 3.0 * rng.standard_normal((n, dim - 4))], axis=1)
    f[:v] = vectors[:, :dim]
    pairs = (v + rng.choice(n - v, size=2 * n_dupes, replace=False)).reshape(2, n_dupes).T
    f[pairs[:, 1]] = f[pairs[:, 0]]
    return f.astype(np.float32), pairs


def gram_bound(sq, rows, cols, dim: int):
    """The float32 Gram form's error in d^2: (D + 4) 2^-23 (|q|^2 + |f|^2)."""
    return (dim + 4) * 2.0**-23 * (sq[rows] + sq[cols])


def brute_nearest(f64, sq, queries, k: int):
    """Each query row's k + 2 nearest other rows by float64 NumPy: (d^2 by
    differences, ascending, ties by index; their indices)."""
    es, ids = [], []
    for s in range(0, len(queries), 256):
        q = queries[s : s + 256]
        d2 = sq[q][:, None] + sq[None, :] - 2.0 * (f64[q] @ f64.T)
        d2[np.arange(len(q)), q] = np.inf
        cand = np.argpartition(d2, k + 2, axis=1)[:, : k + 2]
        exact = ((f64[q][:, None, :] - f64[cand]) ** 2).sum(-1)
        order = np.lexsort((cand, exact))  # by d^2, then by index
        es.append(np.take_along_axis(exact, order, 1))
        ids.append(np.take_along_axis(cand, order, 1))
    return np.concatenate(es), np.concatenate(ids)


def check_neighbors(f, pairs, d, idx, queries) -> str:
    """``nearest_neighbors_all``'s rows ``queries`` against the float64
    brute force: d^2 of each pair and of the true k nearest within the Gram
    bound, indices equal wherever the gap to the next candidate is more
    than twice the bound; every planted copy finds its twin first at a
    distance <= 1e-2."""
    dim, k = f.shape[1], idx.shape[1]
    f64 = f.astype(np.float64)
    sq = (f64 * f64).sum(1)
    e, ei = brute_nearest(f64, sq, queries, k)
    qi, pi = queries[:, None], idx[queries].astype(np.int64)
    pd2 = d[queries].astype(np.float64) ** 2
    if (pi == qi).any():
        raise AssertionError("nearest_neighbors_all returned a query's own row")
    exact = ((f64[queries][:, None, :] - f64[pi]) ** 2).sum(-1)
    bound, bound_e = gram_bound(sq, qi, pi, dim), gram_bound(sq, qi, ei[:, :k], dim)
    pair_err = float((np.abs(pd2 - exact) / bound).max())
    rank_err = float((np.abs(pd2 - e[:, :k]) / bound_e).max())
    if not (pair_err <= 1 and rank_err <= 1):
        raise AssertionError(f"d^2 off the float64 brute force by {pair_err:.3f} (pairs), "
                             f"{rank_err:.3f} (ranks) of the Gram bound")
    padded = np.concatenate([np.full((len(queries), 1), -np.inf), e[:, : k + 1]], axis=1)
    gap = np.minimum(padded[:, 1:-1] - padded[:, :-2], padded[:, 2:] - padded[:, 1:-1])
    clear = gap > 2 * np.maximum(bound, bound_e)
    bad = int(((pi != ei[:, :k]) & clear).sum())
    if bad:
        raise AssertionError(f"{bad} neighbours differ from the brute force where the gap allows")
    src, dst = pairs[:, 0], pairs[:, 1]
    first_ok = (idx[dst, 0] == src).all() and (idx[src, 0] == dst).all()
    twin_d = np.concatenate([d[dst, 0], d[src, 0]])
    if not (first_ok and twin_d.max() <= 1e-2):
        raise AssertionError(f"planted copies: twin first {first_ok}, largest twin distance {twin_d.max()}")
    return (f"d^2 within {max(pair_err, rank_err):.2e} of the Gram bound; indices equal to the "
            f"brute force at all {int(clear.sum())} of {clear.size} ranks the gap allows; every "
            f"planted copy finds its twin first, largest twin distance {twin_d.max():.2e}")


# launches of the k-NN kernel (kernels/knn.py) by the part that ran it, and
# phase 10 (a)'s kernel-vs-plain record at each width; read into its
# kernels line entry
KNN_LAUNCHES: dict[str, int] = {}
KNN_CHECKS: dict[int, dict] = {}


def knn_counted(part: str, want: int, fn):
    """``fn()`` with the k-NN kernel's launch count set to 0 first and read
    after, into KNN_LAUNCHES[part]; raises unless it launched ``want``
    times (so a route that quietly left the kernel fails)."""
    from bliss_tpu_torch.kernels import knn

    knn.LAUNCHES = 0
    out = fn()
    sync("cuda")
    KNN_LAUNCHES[part] = knn.LAUNCHES
    if knn.LAUNCHES != want:
        raise AssertionError(f"{part}: the k-NN kernel launched {knn.LAUNCHES} times; want {want}")
    return out


def knn_vs_plain(fc, dim: int, label) -> dict:
    """Phase 10 (a)'s kernel row at one width: ``knn_topk`` over all rows of
    the card library ``fc`` against the plain version ``_block_topk`` (k + 1,
    block SIM_BLOCK) on the same card rows. d^2 (each side's float32
    distance squared) within 2^-20 d^2 + (D + 4) 2^-50 (|q|^2 + |f|^2): two
    float64 sums in another order, each rounded to float32, then sqrt; the
    float32 Gram form of the same pairs must fail it. Indices equal
    wherever the plain d^2 of a rank is more than twice the bound from its
    neighbours'. Both timed with CUDA events beside ``bounds.knn_work``'s."""
    from bliss_tpu_torch.kernels import bounds, knn
    from bliss_tpu_torch.sim.distance import _block_topk

    f64 = fc.to(torch.float64)

    def plain(k):
        parts = [_block_topk(f64[b : b + SIM_BLOCK], f64, b, k) for b in range(0, SIM_N, SIM_BLOCK)]
        return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])

    kd, ki = knn.knn_topk(fc, 0, SIM_N, SIM_K)
    pd, pi = plain(SIM_K + 1)
    sq = (f64 * f64).sum(1)
    e = pd.double() ** 2
    got = kd.double() ** 2
    nbr = pi[:, :SIM_K].long()
    bound = 2.0**-20 * e[:, :SIM_K] + (dim + 4) * 2.0**-50 * (sq[:, None] + sq[nbr])
    err = float(((got - e[:, :SIM_K]).abs() / bound).max())
    # the float32 Gram form of the same pairs, the cross term as one product
    q32, f32 = fc[:, None, :], fc[nbr]
    g32 = ((q32 * q32).sum(-1) + (f32 * f32).sum(-1)
           - 2.0 * torch.bmm(q32, f32.transpose(1, 2)).squeeze(1)).double()
    control = float(((g32 - e[:, :SIM_K]).abs() / bound).max())
    padded = torch.cat([torch.full_like(e[:, :1], -np.inf), e], 1)
    bpad = torch.cat([bound, bound[:, -1:]], 1)
    gap = torch.minimum(padded[:, 1:-1] - padded[:, :-2], padded[:, 2:] - padded[:, 1:-1])
    clear = gap > 2 * torch.maximum(bpad[:, :-1], bpad[:, 1:])
    bad = int(((ki != pi[:, :SIM_K]) & clear).sum())
    bit_rows = int(((kd == pd[:, :SIM_K]) & (ki == pi[:, :SIM_K])).all(1).sum())
    if (ki == torch.arange(SIM_N, device=ki.device)[:, None]).any():
        raise AssertionError(f"knn_topk D={dim} returned a query's own row")
    if not (err <= 1 and control > 1 and bad == 0):
        raise AssertionError(f"knn_topk D={dim} vs _block_topk: d^2 {err:.3e} of the bound (the float32 "
                             f"Gram form {control:.3e}), {bad} indices differ where the gap allows")
    del pd, pi, e, got, g32, f32
    ms = cuda_ms(lambda: knn.knn_topk(fc, 0, SIM_N, SIM_K), reps=10)
    plain_ms = cuda_ms(lambda: plain(SIM_K), reps=3)
    bound_ms, by = bounds.bound_ms(bounds.knn_work(SIM_N, dim, SIM_K))
    log(f"similarity (a) N={SIM_N} D={dim} k={SIM_K} knn_topk vs _block_topk on the same card rows: "
        f"d^2 within {err:.3e} of the bound 2^-20 d^2 + (D + 4) 2^-50 (|q|^2 + |f|^2) (the float32 "
        f"Gram form of the same pairs {control:.3e}); indices equal at all {int(clear.sum())} of "
        f"{clear.numel()} ranks the gap allows; {bit_rows} of {SIM_N} rows bit-equal; warm median "
        f"kernel {ms:.3f} ms (10), plain {plain_ms:.3f} ms (3), bound {bound_ms:.3f} ms ({by}) {label}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "d2_err_of_bound": err, "float32_gram_of_bound": control,
            "bit_equal_rows": bit_rows, "ranks_checked": int(clear.sum())}


def library_part(vectors, dim: int, device, label, rng) -> None:
    """Phase 10 (a) at one width ``dim``: ``nearest_neighbors_all``,
    ``nearest_neighbors``, ``playlist_order``, ``distance_matrix`` and
    ``kmeans`` on the SIM_N-row library, each checked and timed, with the
    peak device memory of each."""
    from bliss_tpu_torch.sim import (distance, distance_matrix, kmeans, nearest_neighbors,
                                     nearest_neighbors_all, playlist_order)
    from bliss_tpu_torch.sim.kmeans import assign, init_centroids, lloyd

    f, pairs = sim_library(vectors, SIM_N, dim, SIM_DUPES, rng)
    tag = f"N={SIM_N} D={dim}"
    fc = torch.from_numpy(f).to(device)
    f64 = f.astype(np.float64)
    sync(device)

    reset_peak(device)
    d, idx = (t.cpu().numpy() for t in knn_counted(
        f"library D={dim}", 1, lambda: nearest_neighbors_all(fc, SIM_K, block=SIM_BLOCK)))
    mem = peak_text(device)
    times = host_times(lambda: nearest_neighbors_all(fc, SIM_K, block=SIM_BLOCK), device)
    queries = np.unique(np.concatenate([rng.choice(SIM_N, SIM_QUERIES, replace=False), pairs.ravel()]))
    verdict = check_neighbors(f, pairs, d, idx, queries)
    # the float32 Gram form that bliss_tpu computes, for the planted pairs only
    a, b = (fc[torch.from_numpy(pairs[:, j]).to(device)] for j in (1, 0))
    g32 = (a * a).sum(1) + (b * b).sum(1) - 2.0 * (a @ b.T).diagonal()
    twin32 = g32.clamp_min(0.0).sqrt().cpu().numpy()
    log(f"similarity (a) {tag} nearest_neighbors_all k={SIM_K} block={SIM_BLOCK}: {times_text(times)}; "
        f"{mem}; {len(queries)} query rows ({SIM_QUERIES} seeded, every planted pair) vs float64 NumPy: "
        f"{verdict}; the float32 Gram form for the same pairs: largest twin distance "
        f"{twin32.max():.2e}, {int((twin32 > 1e-2).sum())} of {len(twin32)} above 1e-2 {label}")
    KNN_CHECKS[dim] = knn_vs_plain(fc, dim, label)

    q = int(pairs[0].min())
    twin = int(pairs[0].max())
    reset_peak(device)
    nd, ni = (t.cpu().numpy() for t in nearest_neighbors(fc, fc[q], 10))
    mem = peak_text(device)
    direct = np.sqrt(((f64 - f64[q]) ** 2).sum(1))
    order = np.lexsort((np.arange(SIM_N), direct))[:11]
    tol = (dim + 4) * 2.0**-23 * direct[order[:10]] + 1e-6
    if list(ni[:2]) != [q, twin] or nd[1] != 0 or not (np.abs(nd - direct[order[:10]]) <= tol).all():
        raise AssertionError(f"nearest_neighbors of row {q}: {ni} {nd}")
    gaps = np.minimum(np.diff(np.r_[-np.inf, direct[order]])[:10], np.diff(direct[order]))
    clear = gaps > 2 * tol
    if (ni[clear] != order[:10][clear]).any():
        raise AssertionError(f"nearest_neighbors of row {q}: {ni} against {order[:10]}")
    times = host_times(lambda: nearest_neighbors(fc, fc[q], 10), device)
    log(f"similarity (a) {tag} nearest_neighbors of row {q} (k=10): itself and its copy {twin} first "
        f"at 0, the rest within float32 rounding of the brute force, {int(clear.sum())} of 10 ranks "
        f"clear and equal; {times_text(times)}; {mem} {label}")

    reset_peak(device)
    order = playlist_order(fc, q).cpu().numpy()
    mem = peak_text(device)
    d32 = distance(fc, fc[q][None, :]).cpu().numpy()[order]
    d64 = direct[order]
    ties = d32[1:] == d32[:-1]
    if not (np.array_equal(np.sort(order), np.arange(SIM_N)) and order[0] == q and order[1] == twin
            and (np.diff(d32) >= 0).all() and (np.diff(order)[ties] > 0).all()
            and (np.diff(d64) >= -(dim + 4) * 2.0**-23 * d64[1:]).all()):
        raise AssertionError(f"playlist_order from row {q}: {order[:10]}")
    times = host_times(lambda: playlist_order(fc, q), device)
    log(f"similarity (a) {tag} playlist_order from row {q}: a permutation, the seed then its copy "
        f"{twin} first, {int(ties.sum())} ties in index order, float64 distances non-decreasing "
        f"within float32 rounding; {times_text(times)}; {mem} {label}")

    reset_peak(device)
    sub = fc[:DM_N]
    dm = distance_matrix(sub)
    mem = peak_text(device)
    sq = (f64[:DM_N] ** 2).sum(1)
    e2 = sq[:512, None] + sq[None, :] - 2.0 * (f64[:512] @ f64[:DM_N].T)
    dm_err = float((np.abs(dm[:512].double().cpu().numpy() ** 2 - e2)
                    / gram_bound(sq, np.arange(512)[:, None], np.arange(DM_N)[None, :], dim)).max())
    if not (dm_err <= 1 and torch.equal(dm, dm.T) and bool((dm.diagonal() == 0).all())):
        raise AssertionError(f"distance_matrix {DM_N}x{DM_N}: d^2 error {dm_err} of the Gram bound")
    del dm
    times = host_times(lambda: distance_matrix(sub), device)
    log(f"similarity (a) D={dim} distance_matrix {DM_N}x{DM_N}: rows 0..511 within {dm_err:.2e} of "
        f"the Gram bound, symmetric, zero diagonal; {times_text(times)}; {mem} {label}")

    reset_peak(device)
    start = init_centroids(fc, KM_K, seed=0)
    cents, labels = kmeans(fc, KM_K, iters=KM_ITERS, seed=0)
    mem = peak_text(device)
    again = kmeans(fc, KM_K, iters=KM_ITERS, seed=0)
    seeds_are_rows = all(bool((fc == s).all(1).any()) for s in start)
    if not (torch.equal(cents, again[0]) and torch.equal(labels, again[1]) and seeds_are_rows
            and torch.unique(start, dim=0).shape[0] == KM_K):
        raise AssertionError("kmeans: two runs differ, or the k-means++ seeds are not distinct rows")
    host = torch.from_numpy(f)
    cc = lloyd(host, start.cpu(), KM_ITERS)
    ca = assign(host, cc).numpy()
    cents, labels = cents.cpu().numpy(), labels.cpu().numpy()
    c_err = float((np.abs(cents - cc.numpy()).max(1) / np.abs(cc.numpy()).max(1)).max())
    moved = np.nonzero(labels != ca)[0]
    dc = np.sqrt(((f64[moved][:, None, :] - cc.numpy().astype(np.float64)[None]) ** 2).sum(-1))
    near_tie = np.abs(dc[np.arange(len(moved)), labels[moved]] - dc[np.arange(len(moved)), ca[moved]]) \
        <= 1e-4 * dc[np.arange(len(moved)), ca[moved]]
    if not (c_err <= 1e-4 and near_tie.all()):
        raise AssertionError(f"kmeans on the card vs the CPU Lloyd from its init: centroids "
                             f"{c_err:.2e} relative, {int((~near_tie).sum())} assignments differ")
    times = host_times(lambda: kmeans(fc, KM_K, iters=KM_ITERS, seed=0), device)
    log(f"similarity (a) {tag} kmeans k={KM_K} iters={KM_ITERS}: two runs identical, the k-means++ "
        f"seeds {KM_K} distinct rows; the CPU Lloyd from the card's seeds: centroids within "
        f"{c_err:.2e} relative, {len(moved)} assignments differ (all within 1e-4 of a tie); "
        f"{times_text(times)}; {mem} {label}")


def run_cli(argv) -> tuple[str, float]:
    """``bliss_tpu_torch.cli.main(argv)``: (its standard output, seconds);
    raises unless it returns 0."""
    import contextlib
    import io

    from bliss_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue(), secs


def read_csv(path) -> list[list[str]]:
    import csv

    with open(path, newline="") as fh:
        return list(csv.reader(fh, delimiter=";"))


def store_part(vectors, device, label, rng) -> None:
    """Phase 10 (b): a FeatureStore holding the D = 4 library (names
    lib/songNNNNNN.flac, the planted copies dupes/copyNNNN.flac), then the
    CLI's ``store neighbors --top-k 5``, ``dupes``, ``export`` and ``stats``
    on it, each timed. The neighbours CSV must be ``nearest_neighbors_all``
    over ``similarity_rows`` row for row; ``dupes`` must list every planted
    pair at a distance <= 1e-2."""
    import tempfile

    from bliss_tpu_torch.sim import nearest_neighbors_all
    from bliss_tpu_torch.store import FeatureStore, similarity_rows

    f, pairs = sim_library(vectors, SIM_N, 4, SIM_DUPES, rng)
    names = [f"lib/song{i:06d}.flac" for i in range(SIM_N)]
    for j, c in enumerate(pairs[:, 1]):
        names[c] = f"dupes/copy{j:04d}.flac"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "store")
        t0 = time.perf_counter()
        store = FeatureStore(path)
        for i, (name, v) in enumerate(zip(names, f)):
            store.put(f"k{i:06d}", v, {"filename": name})
        store.flush()
        fill_s = time.perf_counter() - t0
        dev = ["--device", str(device), "store"]
        reset_peak(device)
        _, nb_s = knn_counted("store neighbors", 1, lambda: run_cli(
            dev + ["neighbors", "--top-k", str(SIM_K), path, "-o", os.path.join(d, "n.csv")]))
        mem = peak_text(device)
        _, dp_s = knn_counted("store dupes", 1, lambda: run_cli(dev + ["dupes", path, "-o", os.path.join(d, "d.csv")]))
        _, ex_s = run_cli(dev + ["export", path, "-o", os.path.join(d, "e.csv")])
        stats, st_s = run_cli(dev + ["stats", path])
        rows = read_csv(os.path.join(d, "n.csv"))[1:]
        snames, feats = similarity_rows(FeatureStore(path))
        dist, idx = (t.cpu().numpy() for t in nearest_neighbors_all(feats, SIM_K, device=device))
        want = [[n] + [c for j in range(SIM_K) for c in (snames[idx[i, j]], f"{dist[i, j]:f}")]
                for i, n in enumerate(snames)]
        if rows != want:
            bad = next(i for i, (a, b) in enumerate(zip(rows, want)) if a != b) if len(rows) == len(want) else -1
            raise AssertionError(f"store neighbors CSV differs from nearest_neighbors_all at row {bad}")
        dupes = {frozenset(r[:2]): float(r[2]) for r in read_csv(os.path.join(d, "d.csv"))[1:]}
        planted = [dupes.get(frozenset((names[s], names[c]))) for s, c in pairs]
        if any(x is None or x > 1e-2 for x in planted):
            raise AssertionError(f"store dupes missed {sum(x is None for x in planted)} planted pairs")
        exported = len(read_csv(os.path.join(d, "e.csv"))) - 1
        if exported != SIM_N or f"entries: {SIM_N}" not in stats:
            raise AssertionError(f"store export wrote {exported} rows; stats said {stats!r}")
    log(f"similarity (b) the CLI's store commands on a {SIM_N}-entry store (filled in {fill_s:.2f} s): "
        f"neighbors --top-k {SIM_K} {nb_s:.3f} s (its CSV = nearest_neighbors_all over "
        f"similarity_rows, row for row; {mem}), dupes {dp_s:.3f} s ({len(dupes)} pairs, all "
        f"{SIM_DUPES} planted at <= {max(planted):.2e}), export {ex_s:.3f} s, stats {st_s:.3f} s {label}")


CLI_SONGS, CLI_SECONDS, CLI_LONG_SECONDS = 64, (20.0, 60.0), 240.0


def cli_part(rng, device, label, batch: int = MAIN_B) -> dict:
    """Phase 10 (c): a FLAC library written with the port's ``write_flac``
    (CLI_SONGS ``synth_song``s of CLI_SECONDS and one of CLI_LONG_SECONDS,
    above ``LONG_SONG_SAMPLES``, so that it streams); then the CLI's ``scan
    --store``, ``playlist --store`` and ``radio --store``. Where libav's
    development files are missing, ``pipeline.iter_decode`` is patched (and
    says so) to yield the PCM that was written; the device path is not
    patched. The scan must launch the prepass and K1 and give the rows of
    ``analyze_pcm`` of the same PCM; the playlist and the radio resume every
    row from the store (no launch, no ``device_dispatch``); the m3u order is
    ``playlist_order`` of the scan's rows and the radio's lists are
    ``kmeans``' clusters. Returns the scan's launches."""
    import contextlib
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from bliss_tpu_torch import api, pipeline
    from bliss_tpu_torch.io import DecodedAudio, decode
    from bliss_tpu_torch.io.flac_writer import write_flac
    from bliss_tpu_torch.sim import kmeans, playlist_order

    secs = list(rng.uniform(*CLI_SECONDS, size=CLI_SONGS)) + [CLI_LONG_SECONDS]
    songs = [synth_song(rng, 2 * int(s * SR)) for s in secs]
    with tempfile.TemporaryDirectory() as d:
        lib = os.path.join(d, "lib")
        os.makedirs(lib)
        files = [os.path.join(lib, f"song{i:02d}.flac") for i in range(len(songs))]
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
            list(pool.map(write_flac, files, [s.reshape(-1, 2) for s in songs], [SR] * len(songs),
                          [{"TITLE": f"song {i}"} for i in range(len(songs))]))
        write_s = time.perf_counter() - t0
        real_decode = libav_present()
        if real_decode:
            decoded = {p: decode(p) for p in files}
        else:
            decoded = {p: DecodedAudio(s, 2, SR, 0, 2, 0, int(s.shape[0]) // (2 * SR), p, "",
                                       f"song {i}", "", "", "")
                       for i, (p, s) in enumerate(zip(files, songs))}

        def fake_iter_decode(paths, **kw):
            for p in paths:
                yield p, decoded[p]

        results = []
        real_library = pipeline.analyze_library

        def spy(*args, **kw):
            results.append(real_library(*args, **kw))
            return results[-1]

        patches = [mock.patch.object(pipeline, "analyze_library", spy)]
        if not real_decode:
            log("similarity (c): no libav development files here, so pipeline.iter_decode is "
                "patched in this part to yield the PCM each FLAC file was written from; the "
                "device path is not patched")
            patches.append(mock.patch.object(pipeline, "iter_decode", fake_iter_decode))
        store, csv_path, m3u = (os.path.join(d, x) for x in ("store", "features.csv", "p.m3u"))
        radio_dir = os.path.join(d, "radio")
        os.makedirs(radio_dir)
        dev = ["--device", str(device)]
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            reset_peak(device)
            reset_counts()
            _, scan_s = run_cli(dev + ["scan", lib, "--batch-size", str(batch), "--store", store,
                                       "-o", csv_path])
            scan_launches = launch_counts()
            mem = peak_text(device)
            scan = results[-1]
            reset_counts()
            _, pl_s = run_cli(dev + ["playlist", files[0], lib, "--store", store,
                                     "--batch-size", str(batch), "-o", m3u])
            pl_launches, pl_stats = launch_counts(), results[-1].stats
            reset_counts()
            radio_out, radio_s = run_cli(dev + ["radio", lib, "--clusters", "4", "--store", store,
                                                "--output-dir", radio_dir])
            radio_launches, radio_stats = launch_counts(), results[-1].stats
        if scan.files != files or not scan.ok.all():
            raise AssertionError(f"the CLI scan: files {scan.files[:3]}..., ok {scan.ok}, {scan.errors}")
        want = {"prepass", "fused_all"}
        if {k for k, v in scan_launches.items() if v} != want:
            raise AssertionError(f"the CLI scan launched {scan_launches}; want {sorted(want)} only")
        rows = read_csv(csv_path)[1:]
        force = scan.force()
        if rows != [[p] + [f"{v:f}" for v in (*scan.features[i], force[i])] for i, p in enumerate(files)]:
            raise AssertionError("the scan's CSV is not its ScanResult")
        pcm = [decoded[p] for p in files]

        def pcm_rows(extended=False):
            return np.concatenate([
                api.analyze_pcm([x.samples for x in pcm[k : min(k + batch, len(pcm) - 1)]],
                                [x.duration for x in pcm[k : min(k + batch, len(pcm) - 1)]],
                                device=device, extended=extended)
                for k in range(0, len(pcm) - 1, batch)]
                + [api.analyze_pcm([pcm[-1].samples], [pcm[-1].duration], device=device,
                                   extended=extended)])

        ref = pcm_rows()
        err = same_scores("the CLI scan", scan.features, ref, "analyze_pcm of the same PCM")
        for name, launches, stats in (("playlist", pl_launches, pl_stats), ("radio", radio_launches, radio_stats)):
            if any(launches.values()) or stats.get("device_dispatch", {"count": 0})["count"] or stats["decoded"]:
                raise AssertionError(f"the CLI {name} did not resume every row from the store: "
                                     f"launches {launches}, stages {sorted(stats)}")
        order = playlist_order(scan.features, 0, device=device).cpu().numpy()
        with open(m3u) as fh:
            if fh.read().splitlines() != ["#EXTM3U"] + [os.path.abspath(files[i]) for i in order]:
                raise AssertionError("the playlist m3u is not playlist_order of the scan's rows")
        _, assign = kmeans(scan.features, 4, iters=50, device=device)
        assign = assign.cpu().numpy()
        for c in range(4):
            with open(os.path.join(radio_dir, f"radio-{c:02d}.m3u")) as fh:
                got = fh.read().splitlines()[1:]
            if got != [os.path.abspath(files[i]) for i in np.nonzero(assign == c)[0]]:
                raise AssertionError(f"radio-{c:02d}.m3u is not kmeans' cluster {c}")
        extra = ""
        if real_decode:
            out_a, a_s = run_cli(dev + ["analyze", files[1]])
            out_d, d_s = run_cli(dev + ["distance", files[1], files[2]])
            fv = np.array(out_a.splitlines()[3].split(":")[1].strip(" ()").split(", "), np.float32)
            same_scores("the CLI analyze", fv[None], scan.features[1:2], "its row in the scan")
            dist = float(out_d.splitlines()[0].split(":")[1])
            want_d = float(np.linalg.norm(scan.features[1].astype(np.float64) - scan.features[2]))
            if not abs(dist - want_d) <= 1e-3:
                raise AssertionError(f"the CLI distance {dist} against the scan's rows {want_d}")
            extra = f"; analyze {a_s:.3f} s and distance {d_s:.3f} s agree with the scan's rows"
        ext_line = cli_extended_part(lib, files, [x.duration for x in pcm], pcm_rows(True), scan,
                                     patches, results, d, device, batch, label)
    log(f"similarity (c) the CLI from {len(files)} FLAC files ({min(secs):.1f}-{max(secs[:-1]):.1f} s "
        f"and one of {secs[-1]:.0f} s, streamed; written in {write_s:.1f} s; decode "
        f"{'real' if real_decode else 'patched'}): scan --batch-size {batch} {scan_s:.3f} s "
        f"(launches {scan_launches}; rows = analyze_pcm of the same PCM, beats identical, max |diff| "
        f"{err.max():.2e}; {stage_line(scan.stats)}; {mem}), playlist {pl_s:.3f} s and radio "
        f"--clusters 4 {radio_s:.3f} s ({radio_out.count("tracks")} lists) resumed every row from the store with no "
        f"launch; the m3u is playlist_order of the scan's rows, the radio lists kmeans' clusters"
        f"{extra} {label}")
    log(ext_line)
    return scan_launches


def cli_extended_part(lib, files, durs, ref, scan, patches, results, d, device, batch, label) -> str:
    """Phase 11 (c), on phase 10 (c)'s files and under its patches: the
    CLI's ``scan --extended`` into a store of its own, then ``radio
    --extended`` resumed from it. The scan launches the prepass and K1 only;
    its CSV has the 45 columns after the 6 and its core rows are the plain
    scan's ``scan``; its extended rows lie within EXTENDED_GATES of ``ref``,
    ``analyze_pcm(..., extended=True)`` of the same PCM, and count the core
    beats; its store entries have 49 columns. The radio resumes every row
    and its lists are ``kmeans`` of the z-scored 49-column rows. Returns
    the line to log."""
    import contextlib

    from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES
    from bliss_tpu_torch.sim import kmeans
    from bliss_tpu_torch.store import FeatureStore

    store, csv_path, radio_dir = (os.path.join(d, x) for x in ("ext_store", "ext.csv", "ext_radio"))
    os.makedirs(radio_dir)
    dev = ["--device", str(device)]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        reset_counts()
        _, scan_s = run_cli(dev + ["scan", lib, "--batch-size", str(batch), "--store", store,
                                   "--extended", "-o", csv_path])
        scan_launches = launch_counts()
        escan = results[-1]
        reset_counts()
        _, radio_s = run_cli(dev + ["radio", lib, "--clusters", "4", "--store", store, "--extended",
                                    "--output-dir", radio_dir])
        radio_launches, radio_stats = launch_counts(), results[-1].stats
    if {k for k, v in scan_launches.items() if v} != {"prepass", "fused_all"} or not escan.ok.all():
        raise AssertionError(f"the CLI scan --extended launched {scan_launches}, ok {escan.ok}")
    if not np.array_equal(escan.features, scan.features):
        raise AssertionError("the CLI scan --extended's core rows differ from the plain scan's")
    rows = read_csv(csv_path)
    force = escan.force()
    if rows[0][6:] != list(EXTENDED_FEATURE_NAMES) or rows[1:] != [
            [p] + [f"{v:f}" for v in (*escan.features[i], force[i], *escan.extended[i])]
            for i, p in enumerate(files)]:
        raise AssertionError("the CSV of scan --extended is not its ScanResult")
    errs = ext_gates("the CLI scan --extended", escan.extended, ref[:, 4:], durs)
    bpm_counts_beats("the CLI scan --extended", np.concatenate([escan.features, escan.extended], 1), durs)
    widths = {v.shape[0] for _, v in FeatureStore(store).items()}
    if widths != {49}:
        raise AssertionError(f"the extended store holds rows of widths {widths}")
    if any(radio_launches.values()) or radio_stats.get("device_dispatch", {"count": 0})["count"]:
        raise AssertionError(f"radio --extended did not resume from the store: {radio_launches}")
    full = np.concatenate([escan.features, escan.extended], axis=1)
    z = (full - full.mean(0)) / np.maximum(full.std(0), 1e-6)
    assign = kmeans(z, 4, iters=50, device=device)[1].cpu().numpy()
    for c in range(4):
        with open(os.path.join(radio_dir, f"radio-{c:02d}.m3u")) as fh:
            if fh.read().splitlines()[1:] != [os.path.abspath(files[i]) for i in np.nonzero(assign == c)[0]]:
                raise AssertionError(f"radio --extended's list {c} is not kmeans' cluster {c}")
    return (f"extended (phase 11) (c) the CLI from the same {len(files)} files: scan --extended "
            f"{scan_s:.3f} s (launches {scan_launches}; core rows the plain scan's; {gates_text(errs)} "
            f"of analyze_pcm(extended=True); bpm counts the core beats; 49-column store rows; "
            f"{stage_line(escan.stats)}), radio --extended {radio_s:.3f} s resumed every row, its "
            f"lists kmeans of the z-scored 49-column rows {label}")


def similarity_phase(vectors, device, label) -> dict:
    """Phase 10: similarity and the CLI. (a) the library at SIM_N rows and
    each width of SIM_DIMS; (b) the CLI's store commands; (c) the CLI from
    files. TF32 must be off for the float32 products. Returns the CLI
    scan's launches."""
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is allowed for float32 matmuls; phase 10 needs full float32")
    rng = np.random.default_rng(SEED + 5)
    for dim in SIM_DIMS:
        library_part(vectors, dim, device, label, rng)
    store_part(vectors, device, label, rng)
    launches = cli_part(np.random.default_rng(SEED + 6), device, label)
    log(f"similarity (phase 10) took {time.perf_counter() - t0:.1f} s")
    return launches


def ext_gates(label, got, ref, durations) -> dict:
    """The 45 extended columns ``got`` against ``ref`` [N, 45], each group
    within its EXTENDED_GATES gate (bpm as beats: |diff| · duration / 60);
    both finite. Returns {gate name: (max error, gate)}; raises on a miss."""
    from bliss_tpu_torch.features.extended import EXTENDED_GATES

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or got.shape[1] != 45 or not (np.isfinite(got).all()
                                                            and np.isfinite(ref).all()):
        raise AssertionError(f"{label}: extended rows not finite [N, 45]: {got.shape}, {ref.shape}")
    dur = np.asarray(durations, np.float64)[:, None]
    errs = {}
    for name, lo, hi, gate in EXTENDED_GATES:
        d = np.abs(got[:, lo:hi] - ref[:, lo:hi]) * (dur / 60.0 if lo == 5 else 1.0)
        errs[name] = (float(d.max()), gate)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"{label}: outside EXTENDED_GATES: {bad}")
    return errs


def gates_text(errs) -> str:
    return "max |diff| " + ", ".join(f"{k} {e:.2e} (gate {g:g})" for k, (e, g) in errs.items())


def bpm_counts_beats(label, rows, durations) -> float:
    """bpm · duration / 60 (column 9 of the 49) equals the core's beat count
    (from the tempo column) in every row with a positive duration; returns
    the largest |difference| in beats."""
    dur = np.asarray(durations, np.float64)
    beats = beat_counts(rows, dur)
    got = rows[:, 9].astype(np.float64) * dur / 60.0
    diff = np.abs(got - beats)[dur > 0]
    if not (diff <= 1e-3).all():
        raise AssertionError(f"{label}: bpm · duration / 60 is not the core beat count: {diff.max()}")
    return float(diff.max())


def extended_phase(batch, plain_rows, cfgs, label) -> tuple[dict, dict]:
    """Phase 11 (a): ``api.analyze_features(..., extended=True)`` on the
    card-resident main batch under each of ``cfgs`` (main, two-kernel,
    hybrid): launches the prepass and K1 (or K2 and K3) once, as without
    extended; the 4 core columns identical to ``plain_rows[name]``, the same
    config without extended; bpm counts the core beats; the 45 columns
    within EXTENDED_GATES of the same function with its per-frame stage in
    float64 on the card, and hybrid within them of main. Then each config's
    ``analyze_batch`` with and without extended (CUDA events, median of 5),
    the stage alone, the peak device memory of each, and a trace. Returns
    ({config: rows [B, 49]}, {config: launches})."""
    from bliss_tpu_torch import api
    from bliss_tpu_torch.features import extended as ext
    from bliss_tpu_torch.features.analyze import _device_stage_sums, analyze_batch, analyze_batch_ext
    from bliss_tpu_torch.features.tempo import (
        beat_cols_from_host_aux,
        envelope_finish_device,
        envelope_finish_host,
    )

    t0 = time.perf_counter()
    durs = batch.durations.cpu().numpy()
    rows, launches = {}, {}
    for name, cfg in cfgs.items():
        reset_counts()
        rows[name] = api.analyze_features(batch, cfg, extended=True)
        launches[name] = launch_counts()
        want = {"prepass": 1, "fused_all": 1, "fused_stats": 0, "stft_power": 0} if cfg.single_pass \
            else {"prepass": 1, "fused_all": 0, "fused_stats": 1, "stft_power": 1}
        if launches[name] != want:
            raise AssertionError(f"the extended {name} path launched {launches[name]}; want {want}")
        if rows[name].shape != (MAIN_B, 49) or not np.array_equal(rows[name][:, :4], plain_rows[name]):
            raise AssertionError(f"the extended {name} path's core columns differ from its plain run's")
        bpm_counts_beats(f"the extended {name} path", rows[name], durs)
    main = cfgs["main"]
    amp, freq, fa, sums = _device_stage_sums(batch, main)
    _, _, aux = envelope_finish_device(fa, batch.n_samples, batch.durations, main, return_aux=True)
    f64 = ext.extended_features(batch, main, fa=fa, beat_aux=aux, sums=sums, dtype=torch.float64)
    f64 = f64.cpu().numpy()
    for name in cfgs:
        errs = ext_gates(f"extended {name} vs float64", rows[name][:, 4:], f64, durs)
        log(f"extended (phase 11) (a) {name} B={MAIN_B} L=2^23 through api.analyze_features: "
            f"launches {launches[name]} (as without extended); core columns identical to the "
            f"plain run's; bpm · duration / 60 = the core beats in every row; vs the float64 "
            f"stage on the card: {gates_text(errs)}")
    errs = ext_gates("extended hybrid vs main", rows["hybrid"][:, 4:], rows["main"][:, 4:], durs)
    log(f"extended (phase 11) (a) hybrid vs main: {gates_text(errs)}")

    frames = int(torch.div(batch.n_samples, 1024, rounding_mode="floor").sum())
    counted_gflop = 2.0 * frames * 512 * 514 / 1e9
    log(f"extended (phase 11) (a) the stage's work: {frames} counted frames of "
        f"{MAIN_B * MAIN_L // 1024}; the dense DFT product of the counted frames "
        f"{counted_gflop / 1e3:.3f} TFLOP = {counted_gflop / 67e3 * 1e3:.3f} ms at 67 TFLOP/s fp32; "
        f"the PCM read once {batch.samples.numel() * 2 / 3.35e9:.3f} ms at 3.35 TB/s")
    for name, cfg in cfgs.items():
        times = {}
        peaks = {}
        for what, fn in (("plain", lambda: analyze_batch(batch, cfg)),
                         ("extended", lambda: analyze_batch_ext(batch, cfg))):
            times[what] = cuda_ms(fn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks[what] = (torch.cuda.max_memory_allocated() - before) / 2**30
        added = peaks["extended"] - peaks["plain"]
        if not added <= 2.0:
            raise AssertionError(f"the extended {name} path adds {added:.3f} GiB of peak memory (> 2)")
        log(f"extended (phase 11) (a) {name} analyze_batch B={MAIN_B} L=2^23, CUDA events, warm median "
            f"of 5: {times['plain']:.3f} ms plain, {times['extended']:.3f} ms extended (+"
            f"{times['extended'] - times['plain']:.3f}); peak device memory above the "
            f"{before / 2**30:.2f} GiB held: {peaks['plain']:.3f} GiB plain, {peaks['extended']:.3f} "
            f"GiB extended (+{added:.3f} GiB) {label}")
    hyb = cfgs["hybrid"]
    fa_h = _device_stage_sums(batch, hyb)[2].cpu().numpy()
    n_h, d_h = batch.n_samples.cpu().numpy(), batch.durations.cpu().numpy()
    finish_s = {}
    for what, fn in (("plain", lambda: envelope_finish_host(fa_h, n_h, d_h)),
                     ("with the beat columns", lambda: beat_cols_from_host_aux(
                         envelope_finish_host(fa_h, n_h, d_h, return_aux=True)[2], d_h))):
        fn()
        secs = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t1)
        finish_s[what] = statistics.median(secs)
    log(f"extended (phase 11) (a) the hybrid's float64 host finish, median of 5 on "
        f"{os.cpu_count()} host cores: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in finish_s.items()) + f" {label}")
    stage = cuda_ms(lambda: ext.extended_features(batch, main, fa=fa, beat_aux=aux, sums=sums))
    stage64 = cuda_ms(lambda: ext.extended_features(batch, main, fa=fa, beat_aux=aux, sums=sums,
                                                    dtype=torch.float64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ext.extended_features(batch, main, fa=fa, beat_aux=aux, sums=sums)
    torch.cuda.synchronize()
    stage_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"extended (phase 11) (a) the stage alone (extended_features from the core's energies, "
        f"aux and sums), warm median of 5: {stage:.3f} ms float32, {stage64:.3f} ms float64; "
        f"its peak {stage_peak:.3f} GiB above the {before / 2**30:.2f} GiB held {label}")
    log(f"extended (phase 11) (a) analyze_batch_ext trace: "
        f"{device_trace(lambda: analyze_batch_ext(batch, main))} {label}")
    log(f"extended (phase 11) (a) the stage alone by operator: "
        f"{op_table(lambda: ext.extended_features(batch, main, fa=fa, beat_aux=aux, sums=sums))} "
        f"{label}")
    log(f"extended (phase 11) (a) took {time.perf_counter() - t0:.1f} s")
    return rows, launches


def extended_stream_part(songs, durs, device, label) -> None:
    """Phase 11 (b): phase 9's long songs and the 60-minute mix streamed with
    ``extended=True`` under ``for_gpu()`` and ``for_gpu_hybrid()``, each
    against the song whole at B=1 in its bucket (``analyze_features(...,
    extended=True)``): the core as phase 9 (b) holds it, the 45 columns
    within EXTENDED_GATES, bpm counting the core beats; the seconds a song
    with and without extended, and the launches of one streamed song."""
    from bliss_tpu_torch import AnalysisConfig, api, pipeline
    from bliss_tpu_torch.features import streaming
    from bliss_tpu_torch.features.types import PCMBatch

    t0 = time.perf_counter()
    main = AnalysisConfig.for_gpu()
    whole = []
    for s, d in zip(songs, durs):
        x = torch.zeros(1, pipeline._bucket_length(s.shape[0], main.pad_multiple), dtype=torch.int16,
                        device=device)
        x[0, : s.shape[0]].copy_(torch.from_numpy(s))
        n_t, d_t = (torch.full((1,), v, dtype=torch.int32, device=device) for v in (s.shape[0], d))
        whole.append(api.analyze_features(PCMBatch(x, n_t, d_t), main, extended=True)[0])
        del x
    whole = np.stack(whole)
    for name, cfg in (("main", main), ("hybrid", AnalysisConfig.for_gpu_hybrid())):
        rows, secs = [], []
        for s, d in zip(songs, durs):
            t1 = time.perf_counter()
            rows.append(streaming.analyze_song_streaming(s, d, cfg, extended=True, device=device))
            secs.append(time.perf_counter() - t1)
        rows = np.stack(rows)
        plain = stream_rows(songs, durs, cfg, streaming.DEFAULT_CHUNK, device)[1]
        core = same_scores(f"streamed extended {name}", rows[:, :4], whole[:, :4],
                           "each song whole at B=1")
        errs = ext_gates(f"streamed extended {name}", rows[:, 4:], whole[:, 4:], durs)
        bpm_counts_beats(f"streamed extended {name}", rows, durs)
        log(f"extended (phase 11) (b) {name}: {len(songs)} songs streamed with extended against each "
            f"whole at B=1 in its bucket: beats identical, core max |diff| {core.max():.2e}; "
            f"{gates_text(errs)}; seconds a song, extended {secs_line(secs)}, plain "
            f"{secs_line(plain)} {label}")
    reset_counts()
    streaming.analyze_song_streaming(songs[-2], durs[-2], main, extended=True, device=device)
    log(f"extended (phase 11) (b) the {songs[-2].shape[0]}-sample song streamed with extended: "
        f"launches {launch_counts()}; (b) took {time.perf_counter() - t0:.1f} s")


# --- phase 12: the XLA-path config modes (M7) ---------------------------------

PARITY_B = 16  # for_parity() at B=16, L=2^23
ORACLE_SONGS, ORACLE_L = 4, 1 << 21  # songs held to tests/oracle.py, cut to 2^21 samples
MODES_B, MODES_L = 4, 1 << 20  # the mode matrix


def xla_configs() -> dict:
    """The XLA-path configs phase 12 runs: the package default
    ``AnalysisConfig()`` (float32, the "table" amplitude, the matmul
    spectrum, parseval energies, the working-dtype finish) and the config
    ``bliss_tpu``'s ``default_config()`` picks on a CPU backend
    (``bliss_tpu/api.py:48-52``: float32, "poly", the beat-exact finish)."""
    from bliss_tpu_torch import AnalysisConfig

    return {"default": AnalysisConfig(),
            "jax_cpu_float32": AnalysisConfig(dtype="float32", amplitude_mode="poly",
                                              tempo_finish="device_exact")}


def no_kernel_launch(label: str) -> dict:
    """The launch counts since the last ``reset_counts``: none of K1, K2, K3
    (the XLA-path stage takes the prepass's exact sums only)."""
    launches = launch_counts()
    if launches["fused_all"] or launches["fused_stats"] or launches["stft_power"]:
        raise AssertionError(f"{label} launched {launches}; want no K1, K2 or K3")
    return launches


def f32_finish_flips(batch, cfg):
    """The float32 working-dtype finish of ``cfg``'s energies against the
    float64 finish of the same energies: for each song whose beats differ,
    every slot where the two peak masks differ must lie within the float32
    chain's own rounding of the smoothed envelope (|float64 margin against
    eps| <= max |r2_f32 - r2_f64| of the song). Returns (a line of text, the
    float64 finish's beat counts)."""
    from bliss_tpu_torch import constants as C
    from bliss_tpu_torch.features.analyze import _device_stage
    from bliss_tpu_torch.features.tempo import envelope_finish_device

    fa = _device_stage(batch, cfg)[2]
    n, d = batch.n_samples, batch.durations
    _, _, aux32 = envelope_finish_device(fa, n, d, cfg, return_aux=True)
    exact = dataclasses.replace(cfg, tempo_finish="device_exact")
    _, _, aux64 = envelope_finish_device(fa, n, d, exact, return_aux=True)
    b32, r32, p32, _ = (t.cpu().numpy() for t in aux32)
    b64, r64, p64, _ = (t.cpu().numpy() for t in aux64)
    worst, errs = 0.0, []
    for i in np.nonzero(b32 != b64)[0]:
        errs.append(float(np.abs(r32[i] - r64[i]).max()))
        for j in np.nonzero(p32[i] != p64[i])[0]:
            margin = min(r64[i, j] - r64[i, j - 1], r64[i, j] - r64[i, j + 1]) - C.PEAK_EPSILON
            if abs(margin) > errs[-1]:
                raise AssertionError(f"song {i} slot {j}: a float32 flip of margin {margin:.3e} "
                                     f"beyond the float32 envelope's error {errs[-1]:.3e}")
            worst = max(worst, abs(margin) / errs[-1])
    return (f"the float32 finish vs the float64 finish of the same energies: "
            f"{int((b32 != b64).sum())} songs differ, by {int(np.abs(b32 - b64).max())} beats at "
            f"most, each flipped slot within the float32 envelope's error (largest |margin| / "
            f"error {worst:.3f}; that error {max(errs, default=0.0):.2e} at most)"), b64


def xla_batch_part(arrays, durations, main_rows, device, label) -> None:
    """Phase 12 (a): ``api.analyze_features`` under each of ``xla_configs``
    on the main batch, held to the main path's rows: amplitude, frequency
    and attack within 1e-3; beat counts within +-1, the songs that differ
    counted. Under the float32 working-dtype finish the +-1 holds for the
    float64 finish of the config's own energies, and the float32 finish's
    own flips are checked by ``f32_finish_flips`` (``bliss_tpu``'s float32
    finish counts 21 and 14 beats more than its float64 one on two songs of
    this batch's generator at L=2^23, on the CPU:
    ``tests/test_torch_modes.py::test_float32_finish_at_full_length``). Then
    ``analyze_batch``'s warm median of 5 (CUDA events), a trace and the peak
    device memory."""
    from bliss_tpu_torch import api
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.types import PCMBatch

    batch = PCMBatch.from_arrays(arrays, durations, device=device)
    dur = np.asarray(durations)
    main_beats = beat_counts(main_rows, dur)
    for name, cfg in xla_configs().items():
        reset_peak(device)
        reset_counts()
        rows = api.analyze_features(batch, cfg)
        launches = no_kernel_launch(f"phase 12 (a) {name}")
        mem = peak_text(device)
        if rows.shape != main_rows.shape or not np.isfinite(rows).all():
            raise AssertionError(f"phase 12 (a) {name}: rows not finite {list(main_rows.shape)}")
        col_err = np.abs(rows[:, 1:] - main_rows[:, 1:]).max(axis=0)
        if not (col_err <= 1e-3).all():
            raise AssertionError(f"phase 12 (a) {name}: amplitude/frequency/attack differ from "
                                 f"for_gpu() by {col_err}")
        dbeats = beat_counts(rows, dur) - main_beats
        flips, gated = "", dbeats
        if cfg.tempo_finish == "device":
            flips, b64 = f32_finish_flips(batch, cfg)
            gated = b64 - main_beats
            flips = f"; {flips}; its float64 finish vs for_gpu(): " \
                    f"{int(np.count_nonzero(gated))} songs differ"
        if np.abs(gated).max() > 1:
            raise AssertionError(f"phase 12 (a) {name}: beat counts differ from for_gpu() by up "
                                 f"to {np.abs(gated).max()} (songs {np.nonzero(gated)[0]})")
        ms = device_times(lambda: analyze_batch(batch, cfg), device)
        log(f"xla modes (phase 12) (a) {name} B={len(arrays)} L={batch.samples.shape[1]} through "
            f"api.analyze_features: launches {launches}; vs for_gpu(): max |diff| amplitude "
            f"{col_err[0]:.2e} frequency {col_err[1]:.2e} attack {col_err[2]:.2e}, "
            f"{int(np.count_nonzero(dbeats))} songs count other beats (by "
            f"{int(dbeats.min())}..{int(dbeats.max())}){flips}; analyze_batch card-resident {ms}; "
            f"{mem} {label}")
        log(f"xla modes (phase 12) (a) {name} analyze_batch trace: "
            f"{trace_text(lambda: analyze_batch(batch, cfg), device)} {label}")


def xla_parity_part(arrays, durations, device, label, pool) -> None:
    """Phase 12 (b): ``for_parity()`` through ``api.analyze_features`` at
    B=PARITY_B, L=2^23, timed as (a); then ORACLE_SONGS of its songs cut to
    ORACLE_L samples, held to ``tests/oracle.py::analyze_oracle`` (NumPy and
    SciPy, computed in ``pool`` meanwhile) and to the port's own CPU run of
    the same rows: beats identical, scores within 1e-5."""
    import oracle

    from bliss_tpu_torch import AnalysisConfig, api
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.types import PCMBatch

    cut = [a[:ORACLE_L] for a in arrays[:ORACLE_SONGS]]
    cut_durs = [int(a.shape[0]) // (2 * SR) for a in cut]
    want = pool.map(oracle.analyze_oracle, cut, cut_durs)
    cfg = AnalysisConfig.for_parity()
    batch = PCMBatch.from_arrays(arrays[:PARITY_B], durations[:PARITY_B], device=device)
    reset_peak(device)
    reset_counts()
    rows = api.analyze_features(batch, cfg)
    launches = no_kernel_launch("phase 12 (b) for_parity()")
    mem = peak_text(device)
    if not np.isfinite(rows).all():
        raise AssertionError("phase 12 (b): for_parity() rows not finite")
    ms = device_times(lambda: analyze_batch(batch, cfg), device)
    log(f"xla modes (phase 12) (b) for_parity() B={PARITY_B} L=2^23 through "
        f"api.analyze_features: launches {launches}; analyze_batch card-resident {ms}; {mem} {label}")
    log(f"xla modes (phase 12) (b) for_parity() analyze_batch trace: "
        f"{trace_text(lambda: analyze_batch(batch, cfg), device)} {label}")
    del batch
    t0 = time.perf_counter()
    card = api.analyze_pcm(cut, cut_durs, cfg=cfg, device=device)
    cpu = api.analyze_pcm(cut, cut_durs, cfg=cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    ref = np.array([[w["tempo"], w["amplitude"], w["frequency"], w["attack"]] for w in want],
                   np.float32)
    errs = {}
    for what, other in (("oracle", ref), ("cpu", cpu)):
        if not np.array_equal(beat_counts(card, cut_durs), beat_counts(other, cut_durs)):
            raise AssertionError(f"phase 12 (b): for_parity() beats differ from the {what}'s: "
                                 f"{card[:, 0]} vs {other[:, 0]}")
        errs[what] = np.abs(card[:, 1:].astype(np.float64) - other[:, 1:]).max(axis=0)
        if not (errs[what] <= 1e-5).all():
            raise AssertionError(f"phase 12 (b): for_parity() differs from the {what}'s by {errs[what]}")
    log(f"xla modes (phase 12) (b) for_parity() on {ORACLE_SONGS} songs cut to 2^21 samples: "
        f"beats identical to tests/oracle.py::analyze_oracle and to the port's CPU run "
        f"({cpu_s:.1f} s with the card's); max |diff| (amplitude, frequency, attack) vs the "
        f"oracle {errs['oracle'].tolist()}, vs the CPU run {errs['cpu'].tolist()}")


def xla_modes_part(arrays, durations, main_fa, device, label) -> None:
    """Phase 12 (c): the mode matrix at B=MODES_B, L=MODES_L in float64,
    each pair held as ``tests/test_features_unit.py:44-135`` holds it:
    amplitude table vs iterative (5e-5), spectrum fft vs matmul (1e-6),
    tempo energies parseval vs parseval_framed and fft (1e-9, beats
    identical), the IIR blocked vs scan (1e-9, beats identical). fft_strict
    sums each window's bins in float32 as the reference does, so it may
    flip a marginal beat against parseval's float64 energies (``bliss_tpu``
    does on song 0 of these four, on the CPU): its attack within 1e-3 of
    parseval's, its songs with other beats counted, and its rows identical
    in beats and within 1e-5 to the port's CPU run of the same rows (which
    ``tests/test_torch_modes.py`` holds to ``bliss_tpu``'s). band_taps=161
    against the CPU run the same way. Then the scan IIR's finish at L=2^23
    on the main batch's energies, timed once."""
    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.features.amplitude import amplitude_scores
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.frequency import frequency_scores
    from bliss_tpu_torch.features.tempo import envelope_finish_device, envelope_scores
    from bliss_tpu_torch.features.types import PCMBatch

    cut = [a[:MODES_L] for a in arrays[:MODES_B]]
    durs = [int(a.shape[0]) // (2 * SR) for a in cut]
    batch = PCMBatch.from_arrays(cut, durs, device=device)
    cpu_batch = PCMBatch.from_arrays(cut, durs, device="cpu")
    base = AnalysisConfig(dtype="float64")

    def run(fn, on=batch, **kw):
        out = fn(on, dataclasses.replace(base, **kw))
        return np.stack([t.cpu().numpy() for t in out], 1) if isinstance(out, tuple) \
            else out.cpu().numpy()

    reset_counts()
    t0 = time.perf_counter()
    env = run(envelope_scores)
    t_scan = time.perf_counter()
    scan = run(envelope_scores, iir_mode="scan")
    scan_s = time.perf_counter() - t_scan
    strict = run(envelope_scores, tempo_energy_mode="fft_strict")
    # (what, a, b, gate, beats identical)
    pairs = [
        ("amplitude table vs iterative", run(amplitude_scores, amplitude_mode="table"),
         run(amplitude_scores, amplitude_mode="iterative", strict_accumulation=True), 5e-5, False),
        ("spectrum fft vs matmul", run(frequency_scores, spectrum_mode="fft"),
         run(frequency_scores), 1e-6, False),
        ("tempo energies parseval vs parseval_framed", env,
         run(envelope_scores, tempo_energy_mode="parseval_framed"), 1e-9, True),
        ("tempo energies parseval vs fft", env, run(envelope_scores, tempo_energy_mode="fft"),
         1e-9, True),
        ("attack, parseval vs fft_strict", env[:, 1], strict[:, 1], 1e-3, False),
        ("fft_strict, card vs CPU", strict,
         run(envelope_scores, on=cpu_batch, tempo_energy_mode="fft_strict"), 1e-5, True),
        ("iir blocked vs scan", env, scan, 1e-9, True),
    ]
    wide = dataclasses.replace(base, band_taps=161)
    pairs.append(("band_taps=161, card vs CPU", analyze_batch(batch, wide).cpu().numpy(),
                  analyze_batch(cpu_batch, wide).numpy(), 1e-5, True))
    launches = no_kernel_launch("phase 12 (c)")
    parts = []
    for what, a, b, tol, beats in pairs:
        if beats and not np.array_equal(a[..., 0], b[..., 0]):
            raise AssertionError(f"phase 12 (c) {what}: beats differ: {a[..., 0]} vs {b[..., 0]}")
        err = float(np.abs(a.astype(np.float64) - b).max())
        if not err <= tol:
            raise AssertionError(f"phase 12 (c) {what}: max |diff| {err:.3e} > {tol:.0e}")
        parts.append(f"{what} {err:.2e} (gate {tol:.0e})")
    flips = beat_counts(strict, durs) - beat_counts(env, durs)
    log(f"xla modes (phase 12) (c) B={MODES_B} L=2^20 float64, {time.perf_counter() - t0:.1f} s "
        f"(the scan IIR's envelope_scores {scan_s:.2f} s), launches {launches}: " + "; ".join(parts)
        + f"; fft_strict counts other beats than parseval on {int(np.count_nonzero(flips))} songs "
        f"(by {flips.tolist()})")
    fa, n, d = main_fa
    scan_cfg = dataclasses.replace(base, iir_mode="scan")
    sync(device)
    t0 = time.perf_counter()
    envelope_finish_device(fa, n, d, scan_cfg)
    sync(device)
    log(f"xla modes (phase 12) (c) iir_mode='scan' float64 finish of the main batch's energies "
        f"(B={fa.shape[0]}, {2 * fa.shape[-1]} envelope steps, L=2^23): one run "
        f"{time.perf_counter() - t0:.2f} s, against the blocked finish's "
        f"{device_times(lambda: envelope_finish_device(fa, n, d, base), device)} {label}")


def xla_cli_part(arrays, durations, device, label) -> None:
    """Phase 12 (d), the CLI: ``analyze --filterbank reference36`` (F5) on
    one main-batch song (``api._decode`` patched to give its PCM: the card's
    machine decodes no files), through the prepass and K1, its force vector
    that of ``analyze_pcm`` of the same PCM under the same config."""
    from bliss_tpu_torch import AnalysisConfig, api
    from bliss_tpu_torch.io import DecodedAudio

    song, dur = arrays[1], durations[1]
    audio = DecodedAudio(song, 2, SR, 0, 2, 0, dur, "song.flac", "", "song", "", "", "")
    reset_counts()
    with mock.patch.object(api, "_decode", lambda path: audio):
        out, secs = run_cli(["--device", str(device), "analyze", "song.flac",
                             "--filterbank", "reference36"])
    launches = launch_counts()
    if launches["fused_all"] != 1 or launches["prepass"] != 1:
        raise AssertionError(f"the CLI's reference36 analyze launched {launches}; want the "
                             f"prepass and K1 once")
    line = next(ln for ln in out.splitlines() if ln.startswith("Force vector"))
    got = np.array(line.split(":")[1].strip(" ()").split(", "), np.float64)
    cfg = dataclasses.replace(AnalysisConfig.for_gpu(), filterbank="reference36", nb_bands=None,
                              band_taps=None)
    want = api.analyze_pcm([song], [dur], cfg=cfg, device=device)[0]
    if not np.abs(got - want).max() <= 1e-6:
        raise AssertionError(f"the CLI's reference36 analyze printed {got}, analyze_pcm gives {want}")
    log(f"xla modes (phase 12) (d) the CLI's analyze --filterbank reference36 (36x33 bands, F5): "
        f"{line}, = analyze_pcm's; launches {launches}; {secs:.2f} s {label}")


def device_times(fn, device) -> str:
    """Warm median of 5 by CUDA events, with the least and most."""
    if torch.device(device).type != "cuda":
        fn()
        return "not measured (no card)"
    times = cuda_times(fn, reps=5)
    return (f"warm median of 5 {statistics.median(times):.3f} ms (least {min(times):.3f}, "
            f"most {max(times):.3f})")


def trace_text(fn, device) -> str:
    return device_trace(fn) if torch.device(device).type == "cuda" else "not measured (no card)"


def xla_phase(arrays, durations, main_rows, main_fa, device, label) -> None:
    """Phase 12: the XLA-path config modes (M7), (a)-(d); TF32 must be off."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is allowed; phase 12's float32 products need full float32")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=ORACLE_SONGS, mp_context=ctx) as pool:
        xla_batch_part(arrays, durations, main_rows, device, label)
        xla_parity_part(arrays, durations, device, label, pool)
    xla_modes_part(arrays, durations, main_fa, device, label)
    xla_cli_part(arrays, durations, device, label)
    log(f"xla modes (phase 12) took {time.perf_counter() - t0:.1f} s")


# --- phase 13: the serving layer (M11) ---------------------------------------

SERVE_LONG = 2  # phase 9's long songs written beside the main batch's 64
SERVE_CLIENTS = 4
PING_N = 20

# A daemon's start in a fresh process: build the CUDA libraries into
# sys.argv[1] (empty: nvcc runs; already built: it does not), then warmup;
# the CUDA context's creation is timed apart from the warmup that follows.
WARMUP_CHILD = r"""
import json, sys, time
from pathlib import Path
t0 = time.perf_counter()
import torch
from bliss_tpu_torch.kernels import _build, fused_all, fused_stats
from bliss_tpu_torch.server import AnalysisServer
_build.BUILD_DIR = Path(sys.argv[1])
t1 = time.perf_counter()
torch.ones(1, device="cuda").cpu()
t2 = time.perf_counter()
server = AnalysisServer(device="cuda")
server.warmup()
t3 = time.perf_counter()
print(json.dumps({"import_s": t1 - t0, "context_s": t2 - t1, "warmup_s": t3 - t2,
                  "nvcc_s": {k: v[0] for k, v in _build.BUILD_INFO.items()},
                  "launches": [fused_stats.PREPASS_LAUNCHES, fused_all.LAUNCHES]}))
"""


def warmup_starts(label) -> str:
    """Phase 13 (a)'s cold and warm daemon starts: ``WARMUP_CHILD`` twice in
    fresh processes on one empty build directory, so the first builds the
    CUDA libraries with nvcc and the second finds them on disk. Each must
    launch the prepass and K1 once."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    runs = []
    with tempfile.TemporaryDirectory() as build:
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", WARMUP_CHILD, build], cwd=repo, env=env,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"the warmup child failed: {proc.stderr[-3000:]}")
            runs.append({**json.loads(proc.stdout.splitlines()[-1]),
                         "process_s": time.perf_counter() - t0})
    cold, warm = runs
    if cold["launches"] != [1, 1] or warm["launches"] != [1, 1] or "fused_all" not in cold["nvcc_s"] \
            or warm["nvcc_s"]:
        raise AssertionError(f"warmup starts: {runs}")
    return (f"a daemon's start in a fresh process: cold, CUDA context {cold['context_s']:.3f} s then "
            f"warmup {cold['warmup_s']:.3f} s (nvcc fused_all.cu {cold['nvcc_s']['fused_all']:.1f} s "
            f"of it; process {cold['process_s']:.1f} s, imports {cold['import_s']:.1f} s); libraries "
            f"on disk, context {warm['context_s']:.3f} s then warmup {warm['warmup_s']:.3f} s "
            f"(process {warm['process_s']:.1f} s, imports {warm['import_s']:.1f} s); each warmup "
            f"launched the prepass and K1 once {label}")


def http_call(method, port, path, body=None, timeout=120):
    """(status, body bytes, headers) of one request to the gateway on
    127.0.0.1, through an opener that ignores any proxy setting."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode())
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def serve_socket_part(sock, files, ref, decodes, device, label) -> tuple[np.ndarray, dict]:
    """Phase 13 (a) over the socket: ``analyze`` of every file (the prepass
    and K1 only; rows within the gates of ``ref``), the same op again (from
    the store: no launch, no decode), ``distance``, ``playlist`` and
    ``neighbors`` against the port's ``sim`` on the same vectors, pings and
    SERVE_CLIENTS clients on disjoint subsets. Returns the rows and the
    first op's launches."""
    from bliss_tpu_torch.server import request
    from bliss_tpu_torch.sim import cosine_similarity, distance, nearest_neighbors_all, playlist_order

    n = len(files)
    reset_counts()
    decodes["n"] = 0
    t0 = time.perf_counter()
    r = request({"op": "analyze", "paths": files}, sock, timeout=600)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    if not r["ok"] or r["errors"] or list(r["features"]) != files or decodes["n"] != n:
        raise AssertionError(f"serve (a) analyze: ok {r['ok']}, errors {r.get('errors')}, "
                             f"{len(r.get('features', {}))} rows, {decodes['n']} decodes")
    if not (launches["prepass"] and launches["fused_all"]) or launches["fused_stats"] or launches["stft_power"]:
        raise AssertionError(f"serve (a) analyze launched {launches}; want the prepass and K1 only")
    feats = np.array([r["features"][p] for p in files], np.float32)
    errs = {what: same_scores(f"serve (a) analyze, {what} songs", feats[rows], want, source)
            for what, rows, want, source in ref}
    reset_counts()
    decodes["n"] = 0
    t0 = time.perf_counter()
    again = request({"op": "analyze", "paths": files}, sock, timeout=600)
    warm_s = time.perf_counter() - t0
    if again != r or any(launch_counts().values()) or decodes["n"]:
        raise AssertionError(f"serve (a) the repeat: same answer {again == r}, launches "
                             f"{launch_counts()}, decodes {decodes['n']}")

    va, vb = torch.from_numpy(feats[0]), torch.from_numpy(feats[1])
    dist = request({"op": "distance", "a": files[0], "b": files[1]}, sock, timeout=120)
    if (dist["distance"], dist["similarity"]) != (float(distance(va, vb)), float(cosine_similarity(va, vb))):
        raise AssertionError(f"serve (a) distance {dist} against sim on the same rows")
    pl = request({"op": "playlist", "seed": files[0], "paths": files}, sock, timeout=120)
    order = playlist_order(feats, 0, device=device).cpu().numpy()
    if pl["paths"] != [files[i] for i in order]:
        raise AssertionError("serve (a) playlist is not playlist_order of the same rows")
    nb = request({"op": "neighbors", "top_k": 5}, sock, timeout=120)
    names = sorted(files)
    nd, ni = (x.cpu().numpy() for x in nearest_neighbors_all(
        feats[[files.index(p) for p in names]], 5, device=device))
    if nb["neighbors"] != {p: [{"path": names[ni[i, j]], "distance": float(nd[i, j])} for j in range(5)]
                           for i, p in enumerate(names)}:
        raise AssertionError("serve (a) neighbors is not nearest_neighbors_all of the same rows")

    pings = []
    for _ in range(PING_N):
        t0 = time.perf_counter()
        if not request({"op": "ping"}, sock, timeout=30)["pong"]:
            raise AssertionError("serve (a) ping")
        pings.append((time.perf_counter() - t0) * 1e3)
    answers = {}

    def client(k):
        answers[k] = request({"op": "analyze", "paths": files[k::SERVE_CLIENTS], "id": k}, sock,
                             timeout=600)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    clients_s = time.perf_counter() - t0
    for k in range(SERVE_CLIENTS):
        got = answers.get(k, {})
        if not got.get("ok") or got["id"] != k or got["features"] != {
                p: r["features"][p] for p in files[k::SERVE_CLIENTS]}:
            raise AssertionError(f"serve (a) client {k} of {SERVE_CLIENTS} differs from the single client")
    log(f"serve (a) analyze of {n} files over the socket: cold store {cold_s:.3f} s = "
        f"{n / cold_s:.1f} songs/s (launches {launches}; "
        + "; ".join(f"{w} rows vs {s}: beats identical, max |diff| {e.max():.2e}"
                    for (w, _, _, s), e in zip(ref, errs.values()))
        + f"), warm store {warm_s:.3f} s = {n / warm_s:.1f} songs/s (no launch, no decode); distance, "
        f"playlist and neighbors (top_k 5) equal sim's on the same rows; ping round trip median of "
        f"{PING_N} {statistics.median(pings):.3f} ms (least {min(pings):.3f}, most {max(pings):.3f}); "
        f"{SERVE_CLIENTS} clients at once on disjoint subsets {clients_s:.3f} s, answers the single "
        f"client's {label}")
    return feats, launches


def serve_http_part(gw, lib, n, long_songs, device, label) -> None:
    """Phase 13 (b): the gateway on the same server: ``/status`` (the card),
    ``/metrics``, and ``scan --extended`` with progress as chunked NDJSON,
    re-analyzing every file through the prepass and K1 (the store holds
    4-column rows): one event a batch and a long song, the last at n of n."""
    code, body, _ = http_call("GET", gw.port, "/status")
    st = json.loads(body)
    if code != 200 or st["backend"] != torch.device(device).type or st["devices"] != (
            torch.cuda.device_count() if st["backend"] == "cuda" else 1):
        raise AssertionError(f"serve (b) /status: {code} {st}")
    code, body, _ = http_call("GET", gw.port, "/metrics")
    metrics = body.decode()
    if code != 200 or "bliss_backend_healthy 1" not in metrics or f"bliss_store_entries {n}" not in metrics:
        raise AssertionError(f"serve (b) /metrics: {code} {metrics}")
    reset_counts()
    t0 = time.perf_counter()
    code, body, hdrs = http_call("POST", gw.port, "/", {"op": "scan", "dir": lib, "extended": True,
                                                        "progress": True, "id": "scan"}, timeout=600)
    scan_s = time.perf_counter() - t0
    launches = launch_counts()
    lines = [json.loads(x) for x in body.splitlines() if x.strip()]
    final, events = lines[-1], lines[:-1]
    if code != 200 or hdrs.get("Content-Type") != "application/x-ndjson" or "Content-Length" in hdrs:
        raise AssertionError(f"serve (b) scan: HTTP {code}, headers {hdrs}")
    if not final.get("ok") or final["files"] != n or final["analyzed"] != n or final["errors"]:
        raise AssertionError(f"serve (b) scan's last line: {final}")
    if not events or any(e["event"] != "progress" or e["id"] != "scan" for e in events) \
            or (events[-1]["done"], events[-1]["total"]) != (n, n) or len(events) < 1 + long_songs:
        raise AssertionError(f"serve (b) scan's progress events: {events}")
    if not (launches["prepass"] and launches["fused_all"]) or launches["fused_stats"] or launches["stft_power"]:
        raise AssertionError(f"serve (b) scan launched {launches}; want the prepass and K1 only")
    log(f"serve (b) HTTP: /status backend {st['backend']} devices {st['devices']}, /metrics healthy; "
        f"scan --extended with progress as chunked NDJSON {scan_s:.3f} s: {len(events)} progress "
        f"events, the last {n} of {n}, then ok with {final['analyzed']} analyzed; launches {launches}; "
        f"{final['stats']['decoded']} decoded, {final['stats']['scan_process_cpu_seconds']} s of "
        f"process cpu {label}")


def serve_store_part(vectors, device, label) -> None:
    """Phase 13 (c): the ``neighbors`` op of a daemon over phase 10 (b)'s
    100 000-entry store, held to ``nearest_neighbors_all`` over
    ``similarity_rows``, beside the CLI's ``store neighbors`` on the same
    store."""
    import tempfile

    from bliss_tpu_torch.server import AnalysisServer, request
    from bliss_tpu_torch.sim import nearest_neighbors_all
    from bliss_tpu_torch.store import FeatureStore, similarity_rows

    f, pairs = sim_library(vectors, SIM_N, 4, SIM_DUPES, np.random.default_rng(SEED + 7))
    names = [f"lib/song{i:06d}.flac" for i in range(SIM_N)]
    for j, c in enumerate(pairs[:, 1]):
        names[c] = f"dupes/copy{j:04d}.flac"
    with tempfile.TemporaryDirectory() as d:
        path, sock = os.path.join(d, "store"), os.path.join(d, "s.sock")
        t0 = time.perf_counter()
        store = FeatureStore(path)
        for i, (name, v) in enumerate(zip(names, f)):
            store.put(f"k{i:06d}", v, {"filename": name})
        store.flush()
        fill_s = time.perf_counter() - t0
        server = AnalysisServer(sock, store=FeatureStore(path), device=device)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            if not server.wait_ready(30):
                raise AssertionError("serve (c): the daemon did not bind")
            reset_peak(device)
            times = []

            def ask():
                for _ in range(2):
                    t0 = time.perf_counter()
                    r = request({"op": "neighbors", "top_k": SIM_K}, sock, timeout=600)
                    times.append(time.perf_counter() - t0)
                return r

            r = knn_counted("serve neighbors", 2, ask)
            mem = peak_text(device)
        finally:
            server.stop()
            thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("serve (c): the daemon did not stop")
        snames, feats = similarity_rows(FeatureStore(path))
        dist, idx = (x.cpu().numpy() for x in nearest_neighbors_all(feats, SIM_K, device=device))
        want = {n: [{"path": snames[idx[i, j]], "distance": float(dist[i, j])} for j in range(SIM_K)]
                for i, n in enumerate(snames)}
        if not r["ok"] or r["neighbors"] != want:
            raise AssertionError("serve (c) neighbors differs from nearest_neighbors_all over "
                                 "similarity_rows")
        _, cli_s = run_cli(["--device", str(device), "store", "neighbors", "--top-k", str(SIM_K),
                            path, "-o", os.path.join(d, "n.csv")])
    log(f"serve (c) the daemon's neighbors op (top_k {SIM_K}) over a {SIM_N}-entry store (filled in "
        f"{fill_s:.2f} s): {times[0]:.3f} s, again {times[1]:.3f} s, request to parsed answer "
        f"(= nearest_neighbors_all over similarity_rows; {mem}); the CLI's store neighbors on the "
        f"same store {cli_s:.3f} s {label}")


def serve_health_part(device, label) -> None:
    """Phase 13 (d): a daemon probing the device every 0.5 s; its probe made
    to raise a CUDA error text flips ``/metrics`` to
    ``bliss_backend_healthy 0``, and restored, the daemon recovers once."""
    from bliss_tpu_torch.http_gateway import HttpGateway
    from bliss_tpu_torch.server import AnalysisServer

    server = AnalysisServer(device=device, health_probe_interval=0.5)
    gw = HttpGateway(server, port=0)
    gw.start()

    def lost():
        raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

    def wait_for(*lines):
        deadline = time.perf_counter() + 15
        while time.perf_counter() < deadline:
            text = http_call("GET", gw.port, "/metrics")[1].decode()
            if all(x in text for x in lines):
                return time.perf_counter()
            time.sleep(0.05)
        raise AssertionError(f"serve (d): /metrics never showed {lines}: {text}")

    try:
        wait_for("bliss_backend_healthy 1")
        t0 = time.perf_counter()
        server._probe_op = lost
        down = wait_for("bliss_backend_healthy 0") - t0
        st = json.loads(http_call("GET", gw.port, "/status")[1])["backend_health"]
        del server._probe_op
        t0 = time.perf_counter()
        up = wait_for("bliss_backend_healthy 1", "bliss_backend_recoveries_total 1") - t0
    finally:
        gw.stop()
    if "illegal memory access" not in st["last_error"]:
        raise AssertionError(f"serve (d): /status while degraded: {st}")
    log(f"serve (d) health probe every 0.5 s: a probe raising a CUDA error text showed as "
        f"bliss_backend_healthy 0 after {down:.2f} s; restored, healthy again with recoveries 1 "
        f"after {up:.2f} s {label}")


def serve_doctor_part(device, real_decode, label) -> None:
    """Phase 13 (e): ``doctor`` on the card: the backend and dispatch checks
    pass, the decoder's pass exactly where libav's development files are
    present."""
    import contextlib
    import io

    from bliss_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", str(device), "doctor", "--timeout", "60"])
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    want = {"backend acquisition": True, "device dispatch": True,
            "native decoder build": real_decode, "decode round-trip": real_decode}
    got = {name: f"  ok {name}:" in out for name in want}
    if got != want or rc != (0 if real_decode else 1):
        raise AssertionError(f"serve (e) doctor returned {rc}: {out}")
    for line in out.splitlines():
        log(f"serve (e) doctor | {line[:300]}")
    log(f"serve (e) doctor --device {device}: exit {rc} in {secs:.2f} s; backend and dispatch ok, "
        f"decode checks {'ok' if real_decode else 'failed: no libav development files here'} {label}")


def serve_gui_part(lib, files, feats, device, label) -> None:
    """Phase 13 (f): ``ScanJob`` headless over (a)'s files at B=64: its CSV
    rows (the reference's column order) are (a)'s force vectors."""
    import csv
    import tempfile

    from bliss_tpu_torch import gui

    done = []
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "gui.csv")
        job = gui.ScanJob(lib, out, batch_size=MAIN_B, device=device,
                          on_done=lambda rows, cancelled: done.append((rows, cancelled)))
        t0 = time.perf_counter()
        rows = job.run()
        secs = time.perf_counter() - t0
        with open(out, newline="") as fh:
            data = list(csv.reader(fh, **gui.CSV_DIALECT))
    if rows != len(files) or done != [(len(files), False)] or [r[0] for r in data] != files:
        raise AssertionError(f"serve (f) ScanJob: {rows} rows, done {done}")
    got = np.array([[float(r[3]), float(r[4]), float(r[5]), float(r[2])] for r in data], np.float32)
    if not np.array_equal(got, feats) or {r[1] for r in data} != {"phase 13"}:
        raise AssertionError(f"serve (f) ScanJob's CSV differs from (a)'s rows by "
                             f"{np.abs(got - feats).max():.3e}")
    log(f"serve (f) ScanJob headless at B={MAIN_B}: {rows} CSV rows in {secs:.3f} s, equal to (a)'s "
        f"force vectors {label}")


def serve_phase(arrays, durations, long_pcm, long_durs, long_rows, vectors, device, label) -> dict:
    """Phase 13: the serving layer (M11) in-process on ``device`` under
    ``for_gpu()``: (a) the main batch's 64 songs and SERVE_LONG of phase 9's
    long songs written as FLAC files, a daemon's cold and warm starts
    (``warmup_starts``), then a daemon on a Unix socket with a store
    (``serve_socket_part``); (b) an HTTP gateway on it
    (``serve_http_part``), whose ``shutdown`` stops both transports; (c)
    ``serve_store_part``; (d) ``serve_health_part``; (e)
    ``serve_doctor_part``; (f) ``serve_gui_part``. Where libav's
    development files are missing, ``pipeline.iter_decode`` and the probe
    are patched (and say so) to yield the PCM and tags each file was
    written from; the device path is not patched. Returns (a)'s
    launches."""
    import contextlib
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from bliss_tpu_torch import AnalysisConfig, api, pipeline
    from bliss_tpu_torch.http_gateway import HttpGateway
    from bliss_tpu_torch.io import AudioProbe, DecodedAudio, decode, decoder
    from bliss_tpu_torch.io.flac_writer import write_flac
    from bliss_tpu_torch.server import AnalysisServer
    from bliss_tpu_torch.store import FeatureStore

    t_phase = time.perf_counter()
    if torch.device(device).type == "cuda":
        log(f"serve (a) {warmup_starts(label)}")
    else:
        log("serve (a) a daemon's start in a fresh process: not measured (no card)")
    # a stereo file holds whole frames: a song of odd length gains one
    # silent sample, and that is the PCM both the daemon and its yardstick read
    songs = [s if s.shape[0] % 2 == 0 else np.append(s, np.int16(0))
             for s in list(arrays) + list(long_pcm)]
    durs = list(durations) + list(long_durs)
    n_short = len(arrays)
    real_decode = libav_present()
    with tempfile.TemporaryDirectory() as d:
        lib = os.path.join(d, "lib")
        os.makedirs(lib)
        files = [os.path.join(lib, f"song{i:02d}.flac") for i in range(len(songs))]
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
            list(pool.map(write_flac, files, [s.reshape(-1, 2) for s in songs], [SR] * len(songs),
                          [{"TITLE": f"song {i}", "ALBUM": "phase 13"} for i in range(len(songs))]))
        write_s = time.perf_counter() - t0
        if real_decode:
            pcm = {p: decode(p) for p in files}
        else:
            pcm = {p: DecodedAudio(s, 2, SR, 0, 2, 0, dur, p, "", f"song {i}", "phase 13", "", "")
                   for i, (p, s, dur) in enumerate(zip(files, songs, durs))}
        real_iter_decode = pipeline.iter_decode
        decodes = {"n": 0}

        def counted_iter_decode(paths, **kw):
            paths = list(paths)
            decodes["n"] += len(paths)
            if real_decode:
                return real_iter_decode(paths, **kw)
            return ((p, pcm[p]) for p in paths)

        def fake_probe(path):
            x = pcm[path]
            return AudioProbe(2, SR, 0, 2, 0, x.duration, path, "", x.title, x.album, "", "")

        patches = [mock.patch.object(pipeline, "iter_decode", counted_iter_decode)]
        if not real_decode:
            log("serve (a): no libav development files here, so pipeline.iter_decode and the "
                "decoder's probe are patched in this phase to yield the PCM and tags each FLAC "
                "file was written from; the device path is not patched")
            patches.append(mock.patch.object(decoder, "probe", fake_probe))
        cfg = AnalysisConfig.for_gpu()
        short = [pcm[p] for p in files[:n_short]]
        ref_short = api.analyze_pcm([x.samples for x in short], [x.duration for x in short],
                                    device=device)
        if real_decode:
            long_ref = stream_rows([pcm[p].samples for p in files[n_short:]], long_durs, cfg,
                                   1 << 22, device)[0]
            long_src = "analyze_song_streaming of the decoded PCM"
        else:
            long_ref, long_src = long_rows, "phase 9's streamed rows"
        ref = [("short", slice(0, n_short), ref_short, "analyze_pcm of the same PCM"),
               ("long", slice(n_short, None), long_ref, long_src)]
        sock = os.path.join(d, "s.sock")
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            reset_peak(device)
            server = AnalysisServer(sock, cfg=cfg, store=FeatureStore(os.path.join(d, "store")),
                                    batch_size=MAIN_B, device=device)
            reset_counts()
            t0 = time.perf_counter()
            server.warmup()
            warm_s = time.perf_counter() - t0
            warm_launches = launch_counts()
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            gw = HttpGateway(server, port=0)
            gw.start()
            try:
                if not server.wait_ready(30):
                    raise AssertionError("serve (a): the daemon did not bind")
                log(f"serve (a) {len(files)} FLAC files ({n_short} of the main batch, {len(long_pcm)} "
                    f"long) written in {write_s:.1f} s; decode {'real' if real_decode else 'patched'}; "
                    f"the daemon's warmup in this process (libraries loaded) {warm_s:.3f} s, "
                    f"launches {warm_launches}")
                feats, launches = serve_socket_part(sock, files, ref, decodes, device, label)
                serve_http_part(gw, lib, len(files), len(long_pcm), device, label)
                code, body, _ = http_call("POST", gw.port, "/", {"op": "shutdown"})
                if code != 200 or not json.loads(body)["stopping"] or not server.wait_stopped(30):
                    raise AssertionError(f"serve (b) shutdown over HTTP: {code} {body[:200]}")
                thread.join(timeout=30)
                gw._thread.join(timeout=30)
                if thread.is_alive() or gw._thread.is_alive() or os.path.exists(sock):
                    raise AssertionError("serve (b) shutdown did not stop both transports")
                mem = peak_text(device)
            finally:
                gw.stop()
                thread.join(timeout=30)
            log(f"serve (b) shutdown over HTTP stopped both transports; (a) and (b) {mem} {label}")
            serve_gui_part(lib, files, feats, device, label)
    serve_store_part(vectors, device, label)
    serve_health_part(device, label)
    serve_doctor_part(device, real_decode, label)
    log(f"serve (phase 13) took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- phase 14: the XLA-path modes streamed (M7b), kernel_smoke's matrix -------


def m7b_configs() -> dict:
    """The configs phase 14 (a) streams: ``xla_configs``, ``for_parity()``,
    the iterative amplitude with the framed energies, 161 taps (past the
    kernels' 129), and F6's ``AnalysisConfig(fused_kernel=True)`` (K2 and
    K3 with ``tempo_finish="device"``)."""
    from bliss_tpu_torch import AnalysisConfig

    return {**xla_configs(), "parity": AnalysisConfig.for_parity(),
            "iterative_framed": AnalysisConfig(amplitude_mode="iterative",
                                               tempo_energy_mode="parseval_framed"),
            "taps161": AnalysisConfig(band_taps=161),
            "f6_kernels": AnalysisConfig(fused_kernel=True)}


PARITY_LONG = 2  # for_parity() streams the last two of phase 9's songs: 12 min and the mix


def measured(fn, device):
    """(fn(), seconds, peak device memory in GiB above what was held before,
    or None without a card)."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30 if on_card else None
    return out, secs, peak


def gib_line(peaks) -> str:
    return "not measured (no card)" if None in peaks else \
        "[" + ", ".join(f"{p:.3f}" for p in peaks) + "] GiB"


def stream_modes_part(songs, durs, device, label) -> dict:
    """Phase 14 (a): phase 9's long songs and mix streamed under each of
    ``m7b_configs`` (``for_parity()`` on the 12-minute song and the mix),
    each song against the port's whole-song ``api.analyze_features`` of
    the same song at B=1 in its bucket under the same config with the
    float64 finish: beats identical, the rest within 1e-3 (1e-5 in
    float64); ``chunk_samples`` 2^20 counts the beats of 2^22; each streamed
    song launches the prepass once and, on an XLA-path config, no K1, K2 or
    K3 (F6's kernel config: K2 and K3 once a group of rows). Prints seconds
    a song and peak device memory above what was held, streamed and whole,
    and a trace of the 12-minute song streamed under ``AnalysisConfig()``;
    then ``pipeline._scan`` of three long songs under ``AnalysisConfig()``
    streams each (the ``streaming`` stage 3 times). Returns the launches of
    the streamed runs at 2^22, summed."""
    from bliss_tpu_torch import AnalysisConfig, pipeline
    from bliss_tpu_torch.config import uses_kernels
    from bliss_tpu_torch.features import streaming
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.kernels import stft
    from bliss_tpu_torch.utils import StageTimer

    total = dict.fromkeys(launch_counts(), 0)
    CH = streaming.DEFAULT_CHUNK
    group = max(1, streaming.GROUP_SAMPLES // (CH + stft.FRAME))
    rows_by_cfg = {}
    for name, cfg in m7b_configs().items():
        t0 = time.perf_counter()
        idx = range(len(songs) - PARITY_LONG, len(songs)) if name == "parity" else range(len(songs))
        exact = cfg if cfg.tempo_finish == "host" else dataclasses.replace(
            cfg, tempo_finish="device_exact")
        kernels = uses_kernels(cfg)
        rows, r20, secs, peaks, whole_secs, whole_peaks, per_song = [], [], [], [], [], [], []
        for i in idx:
            s, d = songs[i], durs[i]
            reset_counts()
            row, sec, peak = measured(
                lambda: streaming.analyze_song_streaming(s, d, cfg, device=device), device)
            got = launch_counts()
            groups = -(-(-(-s.shape[0] // CH)) // group)
            want = {"prepass": 1, "fused_all": 0, "fused_stats": groups if kernels else 0,
                    "stft_power": groups if kernels else 0}
            if got != want:
                raise AssertionError(f"phase 14 (a) {name} song {i} launched {got}; want {want}")
            for k, v in got.items():
                total[k] += v
            per_song.append(tuple(got.values()))
            rows.append(row)
            secs.append(sec)
            peaks.append(peak)
            r20.append(streaming.analyze_song_streaming(s, d, cfg, 1 << 20, device=device))
            whole, wsec, wpeak = measured(lambda: whole_rows([s], [d], exact, device)[0][0], device)
            whole_secs.append(wsec)
            whole_peaks.append(wpeak)
            tol = 1e-5 if cfg.dtype == "float64" else 1e-3
            for what, got_row in (("streamed", row), ("streamed at 2^20", r20[-1])):
                err = np.abs(got_row[1:].astype(np.float64) - whole[1:])
                if beat_counts(got_row[None], [d])[0] != beat_counts(whole[None], [d])[0] \
                        or not np.isfinite(got_row).all() or not (err <= tol).all():
                    raise AssertionError(f"phase 14 (a) {name} song {i} {what}: {got_row} against "
                                         f"the song whole {whole} (beats, then within {tol:g})")
        rows = np.stack(rows)
        rows_by_cfg[name] = rows
        err = np.abs(rows[:, 1:] - np.stack(r20)[:, 1:]).max()
        log(f"m7b (phase 14) (a) {name}: {len(rows)} songs streamed "
            f"({', '.join(str(int(b)) for b in beat_counts(rows, [durs[i] for i in idx]))} beats), "
            f"launches a song (prepass, K1, K2, K3) {sorted(set(per_song))}; "
            f"beats identical to each song whole at B=1 under the float64 finish and at "
            f"chunk_samples 2^20 (max |diff| vs 2^20 {err:.2e}); seconds a song streamed "
            f"{secs_line(secs)}, whole {secs_line(whole_secs)}; peak device memory streamed "
            f"{gib_line(peaks)}, whole {gib_line(whole_peaks)}; {time.perf_counter() - t0:.1f} s "
            f"{label}")

    default = AnalysisConfig()
    song12, dur12 = songs[-2], durs[-2]
    log(f"m7b (phase 14) (a) trace of the {song12.shape[0]}-sample song streamed under "
        f"AnalysisConfig(): {trace_text(lambda: streaming.analyze_song_streaming(song12, dur12, default, device=device), device)} {label}")

    three = [DecodedAudio(songs[i], 2, SR, 0, 2, 0, durs[i], f"long-{i}", "", "", "", "", "")
             for i in range(3)]
    result = pipeline.ScanResult([d.filename for d in three], np.full((3, 4), np.nan, np.float32),
                                 np.zeros(3, bool), {}, {})
    timer = StageTimer()
    reset_counts()
    pipeline._scan(result, enumerate(three), cfg=default, batch_size=MAIN_B,
                   device=torch.device(device), timer=timer)
    launches = no_kernel_launch("phase 14 (a) the scan")
    stats = timer.report()
    if stats.get("streaming", {}).get("count") != 3 or not result.ok.all() or \
            launches["prepass"] != 3:
        raise AssertionError(f"phase 14 (a) the scan of three long songs under AnalysisConfig(): "
                             f"ok {result.ok}, launches {launches}, stages {stats}")
    err = same_scores("phase 14 (a) the scan", result.features, rows_by_cfg["default"][:3],
                      "the songs streamed")
    log(f"m7b (phase 14) (a) pipeline._scan of three long songs under AnalysisConfig(): every row "
        f"ok, the streaming stage x{stats['streaming']['count']}, launches {launches}, rows as "
        f"streamed (max |diff| {err.max():.2e}); {stage_line(stats)} {label}")
    return total


def matrix_configs():
    """``scripts/kernel_smoke.py::smoke_configs``'s 12 single-device rows
    (its two ``bandsN-sharded`` rows run on the mesh: phase 15 (c)), as
    (name, the port's config with the same fields, extended)."""
    from bliss_tpu_torch import AnalysisConfig

    base = dict(dtype="float32", amplitude_mode="poly", fused_kernel=True,
                tempo_finish="device_exact")
    banks = ((1, "firwin"), (5, "reference5"), (36, "reference36"))
    cfgs = [(f"bands{nb}-{conv}", AnalysisConfig(**base, fused_conv=conv, filterbank=fbk), False)
            for nb, fbk in banks for conv in ("split", "exact")]
    cfgs += [(f"bands{nb}-single_pass", AnalysisConfig(**base, single_pass=True, filterbank=fbk), False)
             for nb, fbk in banks]
    cfgs += [(f"bands1-stft_fast{'-single_pass' if sp else ''}",
              AnalysisConfig(**base, single_pass=sp, stft_conv="fast"), False) for sp in (False, True)]
    cfgs.append(("bands1-extended", AnalysisConfig.for_gpu(), True))
    return cfgs


def matrix_batch():
    """``scripts/kernel_smoke.py:137-147``'s batch: B=8, L=2^17, a 440 Hz
    tone and noise from ``np.random.RandomState(0)``, song i rolled by 131
    i samples; 3 s each."""
    B, L = 8, 1 << 17
    rng = np.random.RandomState(0)
    t = np.arange(L)
    sig = 5000 * np.sin(2 * np.pi * t * 440 / 22050) + rng.randn(L) * 500
    return [np.clip(np.roll(sig, 131 * i), -32000, 32000).astype(np.int16) for i in range(B)], [3] * B


def extended_sanity(label, ext) -> None:
    """``scripts/kernel_smoke.py::_check_extended_sanity``'s physical ranges
    of the 45 extended columns [B, 45]."""
    nyq = 22050 / 2
    gates = (("zero_crossing_rate", ext[:, 0], 0.0, 1.0), ("loudness_db", ext[:, 1], -200.0, 0.0),
             ("spectral_centroid_hz", ext[:, 2], 0.0, nyq),
             ("spectral_rolloff_hz", ext[:, 3], 0.0, nyq),
             ("spectral_flatness", ext[:, 4], 0.0, 1.001), ("bpm", ext[:, 5], 0.0, 1000.0),
             ("chroma_sum", np.sum(ext[:, -12:], axis=1), 0.999, 1.001))
    for fname, col, lo, hi in gates:
        if not ((col >= lo) & (col <= hi)).all():
            raise AssertionError(f"{label}: extended {fname} outside [{lo}, {hi}]: {col}")


def matrix_kernels(batch, cfg) -> float:
    """The kernels of ``cfg``'s path against their plain versions on
    ``batch``, with the config's filterbank and FIR mode, within phase 3's
    gates; returns the largest relative error."""
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft

    x, n = batch.samples, batch.n_samples
    prepass_errors(fs.prepass_sums(x, n), fs.prepass_sums_reference(x, n))
    alpha, beta, _ = fs.normalization(x, n)
    kw = dict(nb_bands=cfg.nb_bands, band_taps=cfg.band_taps, filterbank=cfg.filterbank)
    if cfg.single_pass:
        n_frames = stft.frame_counts(n)
        k = fa.fused_all_call(x, alpha, beta, n_frames, **kw)
        p = fa.fused_all_reference(x, alpha, beta, n_frames, **kw)
        errs = {**stats_errors("fused_all", k, p), **power_errors("fused_all", k[3], p[3])}
    else:
        errs = stats_errors("fused_stats", fs.fused_stats_call(x, alpha, beta, conv_mode=cfg.fused_conv, **kw),
                            fs.fused_stats_reference(x, alpha, beta, conv_mode=cfg.fused_conv, **kw))
        precise = cfg.stft_conv == "precise"
        errs.update(power_errors("stft_power", stft.stft_power(x, n, precise=precise),
                                 stft.stft_power_reference(x, n, precise=precise)))
    return max(r for _, r in errs.values())


def matrix_part(device, label) -> dict:
    """Phase 14 (b): each of ``matrix_configs`` on ``matrix_batch`` through
    ``api.analyze_features`` (the extended row with ``extended=True``):
    finite rows (the extended columns in their physical ranges), through
    the config's kernels only; one song streamed at ``chunk_samples`` 2^15
    (4 rows) counting the beats of the batch (the rest within 1e-3); the
    config's kernels against their plain versions (not counted); each row
    against its ``bandsN-exact`` anchor under ``kernel_smoke.py``'s rule
    (amplitude, frequency, attack within 2e-3; tempo within two beats).
    Returns the launches of the analyses and streams, summed, and each
    row's."""
    from bliss_tpu_torch import api
    from bliss_tpu_torch.features import streaming
    from bliss_tpu_torch.features.types import PCMBatch

    arrays, durs = matrix_batch()
    batch = PCMBatch.from_arrays(arrays, durs, device=device)
    total = dict.fromkeys(launch_counts(), 0)
    feats, by_row = {}, {}
    for name, cfg, ext in matrix_configs():
        t0 = time.perf_counter()
        reset_counts()
        rows = api.analyze_features(batch, cfg, ext)
        streamed = streaming.analyze_song_streaming(arrays[0], durs[0], cfg, 1 << 15, extended=ext,
                                                    device=device)
        sync(device)
        secs = time.perf_counter() - t0
        launches = launch_counts()
        want = {"prepass", "fused_all"} if cfg.single_pass else {"prepass", "fused_stats", "stft_power"}
        if {k for k, v in launches.items() if v} != want:
            raise AssertionError(f"phase 14 (b) {name} launched {launches}; want {sorted(want)} only")
        for k, v in launches.items():
            total[k] += v
        by_row[name] = launches
        if rows.shape != (len(arrays), 49 if ext else 4) or not np.isfinite(rows).all():
            raise AssertionError(f"phase 14 (b) {name}: rows not finite: {rows[0]}")
        what = ""
        if ext:
            extended_sanity(f"phase 14 (b) {name}", rows[:, 4:])
            bpm_counts_beats(f"phase 14 (b) {name}", rows, durs)
            what = f"; streamed extended {gates_text(ext_gates(name, streamed[None, 4:], rows[:1, 4:], durs[:1]))}"
        err = same_scores(f"phase 14 (b) {name} streamed at 2^15", streamed[None, :4], rows[:1, :4],
                          "the batch's row")
        rel = matrix_kernels(batch, cfg)
        feats[name] = rows[:, :4]
        log(f"kernel matrix (phase 14) (b) {name} B=8 L=2^17: {secs * 1e3:.1f} ms with the stream; "
            f"launches {launches}; kernels vs plain max rel err {rel:.2e}; one song streamed in 4 "
            f"rows of 2^15: its beats, max |diff| {err.max():.2e}{what} {label}")
    dev = {}
    for name, f in feats.items():
        nb = name.split("-")[0]
        if name == f"{nb}-exact":
            continue
        d = np.abs(f - feats[f"{nb}-exact"]).max(axis=0)
        dev[name] = d
        if d[1] > 2e-3 or d[2] > 2e-3 or d[3] > 2e-3 or d[0] > 2 * 4.0 / 3.0:
            raise AssertionError(f"phase 14 (b) {name}: {d} from {nb}-exact (kernel_smoke's rule)")
    log("kernel matrix (phase 14) (b) against each bandsN-exact anchor, max |diff| (tempo, amplitude, "
        "frequency, attack): " + "; ".join(f"{k} " + "/".join(f"{v:.1e}" for v in d) for k, d in dev.items()))
    return total, by_row


def m7b_phase(songs, durs, device, label) -> tuple[dict, dict, dict]:
    """Phase 14: (a) the XLA-path modes streamed (M7b) and (b) the single-
    device rows of ``scripts/kernel_smoke.py``'s matrix, whole and streamed;
    TF32 must be off. Returns each part's launches and (b)'s by row."""
    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is allowed; phase 14's float32 products need full float32")
    a = stream_modes_part(songs, durs, device, label)
    t1 = time.perf_counter()
    b, rows = matrix_part(device, label)
    log(f"m7b (phase 14) took {time.perf_counter() - t0:.1f} s: (a) {t1 - t0:.1f}, "
        f"(b) {time.perf_counter() - t1:.1f}")
    return a, b, rows


# --- phase 15: the mesh (M10) -----------------------------------------------

MESH_SHAPES = ((1, 2), (2, 2), (1, 4))


def mesh_of(shape, device, distinct=False):
    """A ``shape`` mesh of ``device`` repeated (a CUDA device: cuda:0), or
    with ``distinct`` of the first cards."""
    from bliss_tpu_torch.parallel import analysis_mesh

    n = shape[0] * shape[1]
    if distinct:
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        dev = torch.device(device)
        devices = [torch.device("cuda", 0) if dev.type == "cuda" else dev] * n
    return analysis_mesh(*shape, devices=devices)


def mesh_ms(fn, device, reps: int = 5) -> str:
    """``fn``'s warm median of ``reps``: CUDA events on the card, the host's
    clock on the CPU."""
    if torch.device(device).type == "cuda":
        return f"{cuda_ms(fn, reps):.3f} ms (CUDA events)"
    return f"{statistics.median(host_times(fn, device, reps)) * 1e3:.3f} ms (host clock)"


def within(label, got, ref, what, tol=5e-4):
    """``same_scores`` (beats identical), and the other columns within
    ``tol``; returns their max |diff|."""
    err = same_scores(label, got, ref, what)
    if not (err <= tol).all():
        raise AssertionError(f"{label}: amplitude/frequency/attack differ from {what} by {err} > {tol}")
    return err


def mesh_counts(label, n_shards, k1=0) -> dict:
    """The launches since the last ``reset_counts``: the prepass, K2 and K3
    once a shard and K1 ``k1`` times, or raise."""
    got = launch_counts()
    want = {"prepass": n_shards, "fused_all": k1, "fused_stats": n_shards, "stft_power": n_shards}
    if got != want:
        raise AssertionError(f"{label} launched {got}; want {want}")
    return got


def mesh_rows_part(batch, durations, out, device, label) -> dict:
    """Phase 15 (a): the main batch through ``analyze_sharded`` under
    ``for_gpu()`` on each of MESH_SHAPES over one card repeated (and over
    distinct cards where there are enough): every shard on the kernel
    branch, the prepass, K2 and K3 once a shard; the rows phase 4's (beats
    identical, the rest within 5e-4); the warm median of 5, the peak device
    memory. Returns each mesh's launches."""
    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.parallel import analyze_sharded

    cfg = AnalysisConfig.for_gpu()
    meshes = [(f"{d}x{q}", mesh_of((d, q), device)) for d, q in MESH_SHAPES]
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    meshes += [(f"{d}x{q} on {d * q} cards", mesh_of((d, q), device, distinct=True))
               for d, q in MESH_SHAPES if d * q <= cards]
    launches = {}
    for name, mesh in meshes:
        Ls = batch.samples.shape[1] // mesh.shape["seq"]
        reset_peak(device)
        reset_counts()
        rows = analyze_sharded(batch, mesh, cfg)
        launches[name] = mesh_counts(f"mesh (phase 15) (a) {name}", mesh.size)
        peak = peak_text(device)
        err = within(f"mesh (phase 15) (a) {name}", rows, out, "phase 4's unsharded rows")
        log(f"mesh (phase 15) (a) {name} analyze_sharded B={MAIN_B} L=2^23 (shards of {Ls} samples, "
            f"the kernel branch): launches {launches[name]}; beat counts identical to phase 4's "
            f"unsharded rows, max |diff| amplitude {err[0]:.2e} frequency {err[1]:.2e} attack "
            f"{err[2]:.2e}; warm median of 5 {mesh_ms(lambda: analyze_sharded(batch, mesh, cfg), device)} "
            f"(the rows' copy back included), {peak} {label}")
    return launches


def mesh_shard_part(batch, device, label) -> dict:
    """Phase 15 (b): K2 and K3 on shard 1 of the (1, 2) mesh, with its real
    halo0 (shard 0's last 16 samples) and frame offset, against their plain
    versions within phase 3's gates; each timed. Returns {kernel: (errors,
    ms, plain_ms)}."""
    from bliss_tpu_torch.kernels import fused_stats as fs
    from bliss_tpu_torch.kernels import stft
    from bliss_tpu_torch.parallel import shard_batch
    from bliss_tpu_torch.parallel.mesh import pad_batch

    mesh = mesh_of((1, 2), device)
    shards = shard_batch(pad_batch(batch, mesh), mesh)
    first, (shard, n, _) = shards[(0, 0)].samples, shards[(0, 1)]
    Ls = shard.shape[1]
    alpha, beta, _ = fs.normalization(batch.samples, batch.n_samples)  # the shards' sums, psummed
    # shard 1 and the block after it on the ring (shard 0's first hop)
    ext = torch.cat([shard, first[:, :fs.BLK]], dim=1)
    halo0 = first[:, -16:].contiguous()
    if not bool((halo0 != 0).any()):
        raise AssertionError("phase 15 (b): shard 1's halo0 is all zero")
    offset = Ls // stft.FRAME
    timed = torch.device(device).type == "cuda"
    k2 = kernel_vs_plain(
        f"(phase 15) (b) K2 on shard 1 of the 1x2 mesh, B={MAIN_B} L={Ls}+256, a nonzero halo0",
        lambda: fs.fused_stats_call(ext, alpha, beta, halo0),
        lambda: fs.fused_stats_reference(ext, alpha, beta, halo0),
        lambda k, p: stats_errors("phase 15 (b) K2", k, p), timed)
    k3 = kernel_vs_plain(
        f"(phase 15) (b) K3 on shard 1 of the 1x2 mesh, B={MAIN_B} L={Ls}, frame_offset {offset}",
        lambda: stft.stft_power(shard, n, frame_offset=offset),
        lambda: stft.stft_power_reference(shard, n, frame_offset=offset),
        lambda k, p: power_errors("phase 15 (b) K3", k, p), timed)
    if timed:
        log(f"mesh (phase 15) (b) warm median of 5 on shard 1: K2 {k2[1]:.3f} ms (plain {k2[2]:.3f} ms), "
            f"K3 {k3[1]:.3f} ms (plain {k3[2]:.3f} ms) {label}")
    return {"fused_stats": k2, "stft_power": k3}


def mesh_matrix_part(device, label) -> dict:
    """Phase 15 (c): ``scripts/kernel_smoke.py``'s two sharded rows
    (``bands1-sharded``, ``bands5-sharded``) on its B=8, L=2^17 batch over a
    (2, 1) mesh: the prepass, K2 and K3 once a shard, the rows those of the
    same configs unsharded (beats identical, the rest within 5e-4).
    Returns each row's launches."""
    from bliss_tpu_torch import AnalysisConfig, api
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.parallel import analyze_sharded

    arrays, durs = matrix_batch()
    batch = PCMBatch.from_arrays(arrays, durs, device=device)
    mesh = mesh_of((2, 1), device)
    rows = {}
    for nb, fbk in ((1, "firwin"), (5, "reference5")):
        name = f"bands{nb}-sharded"
        cfg = AnalysisConfig(dtype="float32", amplitude_mode="poly", fused_kernel=True,
                             tempo_finish="device_exact", filterbank=fbk)
        reset_counts()
        got = analyze_sharded(batch, mesh, cfg)
        rows[name] = mesh_counts(f"phase 15 (c) {name}", mesh.size)
        err = within(f"phase 15 (c) {name}", got, api.analyze_features(batch, cfg),
                     "the same config unsharded")
        log(f"mesh (phase 15) (c) {name} B=8 L=2^17 on a 2x1 mesh: launches {rows[name]}; beats "
            f"identical to the config unsharded, max |diff| {err.max():.2e} {label}")
    return rows


def mesh_modes_part(batch, durations, outh, ext_rows, device, label) -> None:
    """Phase 15 (d): on the (2, 2) mesh, ``for_gpu_hybrid()`` (the float64
    host finish of the gathered energies) held to phase 5's hybrid rows,
    and ``for_gpu()`` with ``extended=True`` (each shard a streamed row of
    the extended stage) held to phase 11 (a)'s rows within EXTENDED_GATES."""
    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.parallel import analyze_sharded, analyze_sharded_async

    mesh = mesh_of((2, 2), device)
    reset_counts()
    hyb = analyze_sharded(batch, mesh, AnalysisConfig.for_gpu_hybrid())
    counts = mesh_counts("phase 15 (d) hybrid", 4)
    err = within("phase 15 (d) hybrid", hyb, outh, "phase 5's hybrid rows")
    log(f"mesh (phase 15) (d) for_gpu_hybrid() on the 2x2 mesh: launches {counts}; beats identical "
        f"to phase 5's hybrid rows, max |diff| {err.max():.2e} {label}")
    reset_peak(device)
    reset_counts()
    ext = analyze_sharded_async(batch, mesh, AnalysisConfig.for_gpu(), extended=True)()
    counts = mesh_counts("phase 15 (d) extended", 4)
    err = within("phase 15 (d) extended core", ext[:, :4], ext_rows[:, :4], "phase 11 (a)'s rows")
    errs = ext_gates("phase 15 (d) extended", ext[:, 4:], ext_rows[:, 4:], durations)
    bpm_counts_beats("phase 15 (d) extended", ext, durations)
    log(f"mesh (phase 15) (d) for_gpu() extended on the 2x2 mesh: launches {counts}; the core "
        f"columns' beats identical to phase 11 (a)'s, max |diff| {err.max():.2e}; the 45 columns "
        f"{gates_text(errs)}; {peak_text(device)} {label}")


def mesh_entry_part(arrays, durations, longs, long_durs, device, label) -> None:
    """Phase 15 (e), the entry points over a (1, 2) mesh, ``pipeline.
    iter_decode`` patched to yield the songs (the card's machine has no
    libav development files, and the decode is phase 8's and 13's):
    ``analyze_library(mesh=...)`` of the main batch's songs and two of
    phase 9's long songs (streamed on the scan's device) against the same
    scan without the mesh; a daemon built with the mesh answering
    ``analyze``; the CLI's ``scan --mesh 1``. Rows: beats identical, the
    rest within 5e-4."""
    import contextlib
    import csv
    import io
    import tempfile

    from bliss_tpu_torch import cli, pipeline
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.server import AnalysisServer, request

    songs = list(arrays) + list(longs)
    durs = list(durations) + list(long_durs)
    names = [f"song{i:02d}.flac" for i in range(len(songs))]
    pcm = {p: DecodedAudio(s, 2, SR, 0, 2, 0, d, p, "", "", "", "", "")
           for p, s, d in zip(names, songs, durs)}
    mesh = mesh_of((1, 2), device)
    patch = mock.patch.object(pipeline, "iter_decode",
                              lambda paths, **kw: ((p, pcm[p]) for p in paths))
    with patch:
        scans = {}
        for what, m in (("without a mesh", None), ("on the 1x2 mesh", mesh)):
            reset_counts()
            t0 = time.perf_counter()
            r = pipeline.analyze_library(names, batch_size=MAIN_B, mesh=m, device=device,
                                         handle_sigint=False)
            secs = time.perf_counter() - t0
            if not r.ok.all() or r.errors:
                raise AssertionError(f"phase 15 (e) analyze_library {what}: {r.errors}")
            scans[what] = (r, launch_counts(), secs)
        (flat, _, flat_s), (meshed, counts, mesh_s) = scans.values()
        if not (counts["fused_stats"] and counts["stft_power"] and counts["prepass"]):
            raise AssertionError(f"phase 15 (e) the meshed scan launched {counts}")
        if meshed.stats["streaming"]["count"] != len(longs):
            raise AssertionError(f"phase 15 (e) streamed {meshed.stats['streaming']['count']} songs")
        err = within("phase 15 (e) analyze_library", meshed.features, flat.features, "the scan without a mesh")
        log(f"mesh (phase 15) (e) analyze_library(mesh=1x2) of {len(songs)} songs ({len(longs)} long, "
            f"streamed on {device}): launches {counts}; beats identical to the scan without a mesh, "
            f"max |diff| {err.max():.2e}; {mesh_s:.2f} s, {flat_s:.2f} s without the mesh {label}")

        with tempfile.TemporaryDirectory() as d:
            sock = os.path.join(d, "m.sock")
            server = AnalysisServer(sock, batch_size=8, mesh=mesh, device=device)
            server.warmup()
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            try:
                if not server.wait_ready(30):
                    raise AssertionError("phase 15 (e): the meshed daemon did not bind")
                reset_counts()
                r = request({"op": "analyze", "paths": names[:8]}, sock, timeout=600)
                counts = launch_counts()
            finally:
                server.stop()
                t.join(timeout=60)
            if not r.get("ok") or r.get("errors"):
                raise AssertionError(f"phase 15 (e) the meshed daemon: {r}")
            got = np.array([r["features"][p] for p in names[:8]], np.float32)
            err = within("phase 15 (e) daemon", got, flat.features[:8], "the scan without a mesh")
            log(f"mesh (phase 15) (e) a daemon with a 1x2 mesh (warmup through the mesh) answered "
                f"analyze of 8 songs: launches {counts}; beats identical to the unmeshed scan's rows, "
                f"max |diff| {err.max():.2e} {label}")

            out_csv = os.path.join(d, "scan.csv")
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["--device", str(device), "scan", *names[:8], "--mesh", "1",
                               "--batch-size", "8", "-o", out_csv])
            counts = launch_counts()
            with open(out_csv, newline="") as f:
                rows = list(csv.reader(f, delimiter=";"))[1:]
            if rc != 0 or [r_[0] for r_ in rows] != names[:8]:
                raise AssertionError(f"phase 15 (e) scan --mesh 1: rc {rc}, {len(rows)} rows")
            got = np.array([[float(v) for v in r_[1:5]] for r_ in rows])
            # "%f" keeps 6 decimals: the beats as counts, the rest within 5e-4
            ref = flat.features[:8].astype(np.float64)
            if not np.array_equal(beat_counts(got, durs[:8]), beat_counts(ref, durs[:8])):
                raise AssertionError("phase 15 (e) scan --mesh 1: beat counts differ from the unmeshed scan")
            err = np.abs(got[:, 1:] - ref[:, 1:]).max(axis=0)
            if not (err <= 5e-4).all():
                raise AssertionError(f"phase 15 (e) scan --mesh 1: rows differ by {err}")
            log(f"mesh (phase 15) (e) the CLI's scan --mesh 1 of 8 songs: launches {counts}; beats "
                f"identical to the unmeshed scan's rows, max |diff| {err.max():.2e} {label}")


def mesh_nccl_part(batch, device, label) -> None:
    """Phase 15 (f): ``init_distributed`` on a file store at world size 1
    with NCCL, then the main batch over the (1, 1) mesh of its
    ``ProcessGroup``: the rows of the ``LocalGroup`` (1, 1) mesh bit for
    bit; the group is destroyed after."""
    import tempfile

    import torch.distributed as tdist

    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.parallel import analyze_sharded, init_distributed, process_mesh

    cfg = AnalysisConfig.for_gpu()
    local = analyze_sharded(batch, mesh_of((1, 1), device), cfg)
    with tempfile.TemporaryDirectory() as d:
        init_distributed(f"file://{os.path.join(d, 'store')}", 1, 0, device=device)
        try:
            if not tdist.is_initialized():
                raise AssertionError("phase 15 (f): init_distributed formed no group")
            backend = tdist.get_backend()
            reset_counts()
            got = analyze_sharded(batch, process_mesh(1, torch.device(device)), cfg)
            counts = mesh_counts("phase 15 (f)", 1)
        finally:
            tdist.destroy_process_group()
    if not np.array_equal(got, local):
        raise AssertionError(f"phase 15 (f): the ProcessGroup's rows differ from the LocalGroup's by "
                             f"{np.abs(got - local).max()}")
    log(f"mesh (phase 15) (f) a {backend} ProcessGroup of world size 1 (file store): the 1x1 mesh's "
        f"B={MAIN_B} L=2^23 rows equal the LocalGroup's bit for bit; launches {counts}; the group "
        f"destroyed {label}")


def mesh_topk_part(vectors, device, label) -> None:
    """Phase 15 (g): ``sharded_distance_topk`` (k=5) over phase 10's D = 4
    library of SIM_N rows on a (4, 1) mesh: distances and indices equal to
    ``nearest_neighbors_all``'s, with its time beside the unsharded one's."""
    from bliss_tpu_torch.parallel import sharded_distance_topk
    from bliss_tpu_torch.sim import nearest_neighbors_all

    f, _ = sim_library(vectors, SIM_N, 4, SIM_DUPES, np.random.default_rng(SEED + 5))
    fc = torch.from_numpy(f).to(device)
    mesh = mesh_of((4, 1), device)
    d, idx = knn_counted("mesh 4x1", 4, lambda: sharded_distance_topk(fc, mesh, SIM_K, block=SIM_BLOCK))
    d0, idx0 = nearest_neighbors_all(fc, SIM_K, block=SIM_BLOCK)
    if not (torch.equal(d, d0.cpu()) and torch.equal(idx, idx0.cpu())):
        raise AssertionError("phase 15 (g): sharded_distance_topk differs from nearest_neighbors_all")
    t_mesh = times_text(host_times(lambda: sharded_distance_topk(fc, mesh, SIM_K, block=SIM_BLOCK), device))
    t_flat = times_text(host_times(lambda: nearest_neighbors_all(fc, SIM_K, block=SIM_BLOCK), device))
    log(f"mesh (phase 15) (g) sharded_distance_topk N={SIM_N} D=4 k={SIM_K} on a 4x1 mesh: distances "
        f"and indices equal to nearest_neighbors_all's; {t_mesh}; nearest_neighbors_all {t_flat} {label}")


# the scan of tools/demo_scale.py (scripts/demo_scale.py:62-75): songs,
# seconds, batch
SCALE_SCAN = (384, 11, 64)
EXAMPLE_SONGS = 6  # the examples' generated library, of 11 s songs


def edge_songs() -> dict:
    """name -> (int16 PCM, duration): ``tests/test_edge_cases.py``'s five
    degenerate songs (a 700-sample clip, 50 000 silent samples, full-scale
    samples, clips of 30 000 and 20 000 samples) and four more (a silent
    100 000-sample song, a constant 1234, one click, a song of duration 0);
    ``tests/test_torch_edge_cases.py`` holds each to ``bliss_tpu``."""
    click = np.zeros(100_000, np.int16)
    click[50_000] = 20000
    return {
        "tiny_clip": (np.random.RandomState(0).randint(-1000, 1000, size=700).astype(np.int16), 1),
        "silent": (np.zeros(50_000, np.int16), 2),
        "full_scale": (np.random.RandomState(1).choice(
            np.array([-32768, -32767, 32767], np.int16), size=80_000).astype(np.int16), 3),
        "short_clip": (np.random.RandomState(2).randint(-9000, 9000, size=30_000).astype(np.int16), 2),
        "hybrid_short_clip": (np.random.RandomState(3).randint(-9000, 9000, size=20_000)
                              .astype(np.int16), 1),
        "silent_100k": (np.zeros(100_000, np.int16), 2),
        "constant_1234": (np.full(100_000, 1234, np.int16), 4),
        "one_click": (click, 2),
        "duration_0": (synth_song(np.random.default_rng(SEED + 5), 100_000), 0),
    }


def quality_part(device, label) -> dict:
    """Phase 17 (a): ``tools.quality_benchmark.run`` at each of QUALITY_SIZES
    under the script's config (the XLA-path stage: the prepass, no K1, K2 or
    K3) and ``for_gpu()`` (the prepass and K1 once a call), each held to the
    same call on the CPU (beat counts identical, the core columns within
    5e-4, the rest within EXTENDED_GATES, recall and separation within
    1e-3) and to the script's thresholds; at 6 x 4 x 5 s also to
    ``bliss_tpu``'s numbers (QUALITY_BLISS_TPU). Returns launches by run."""
    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.features.analyze import analyze_batch_ext
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.tools import quality_benchmark as qb

    metrics = tuple(QUALITY_BLISS_TPU)
    launches = {}
    for fam, var, secs in QUALITY_SIZES:
        size = f"{fam}x{var}x{secs:g}s"
        t0 = time.perf_counter()
        songs, _ = qb.library(fam, var, secs)
        synth_s = time.perf_counter() - t0
        batch = PCMBatch.from_arrays(songs, [int(secs)] * len(songs), device=device)
        for name, cfg in (("script", AnalysisConfig(tempo_finish="device_exact")),
                          ("for_gpu", AnalysisConfig.for_gpu())):
            what = f"phase 17 (a) {name} {size}"
            reset_counts()
            t0 = time.perf_counter()
            res = qb.run(fam, var, secs, cfg=cfg, device=device)
            run_s = time.perf_counter() - t0
            launches[f"quality_{name}_{size}"] = got = launch_counts()
            want = {"prepass": 1, "fused_all": int(name == "for_gpu"), "fused_stats": 0,
                    "stft_power": 0}
            if got != want:
                raise AssertionError(f"{what} launched {got}; want {want}")
            t0 = time.perf_counter()
            cpu = qb.run(fam, var, secs, cfg=cfg, device="cpu")
            cpu_s = time.perf_counter() - t0
            rows, ref = res["features"], cpu["features"]
            durs = [int(secs)] * rows.shape[0]
            core = within(what, rows[:, :4], ref[:, :4], "the same run on the CPU")
            errs = ext_gates(what, rows[:, 4:], ref[:, 4:], durs)
            diff = {k: abs(res[k] - cpu[k]) for k in metrics}
            if not all(d <= 1e-3 for d in diff.values()):
                raise AssertionError(f"{what}: metrics differ from the CPU's: {diff}")
            if not (res["recall_at_k_extended"] >= res["recall_at_k_core4"]
                    and res["recall_at_k_extended"] >= 0.8
                    and res["separation_extended"] > res["separation_core4"]
                    and res["extended_wins"]):
                raise AssertionError(f"{what}: the extended columns do not win: "
                                     f"{ {k: res[k] for k in metrics} }")
            anchor = ""
            stage = times_text(host_times(lambda: analyze_batch_ext(batch, cfg), device))
            if (fam, var, secs) == QUALITY_SIZES[0]:
                jd = {k: abs(res[k] - QUALITY_BLISS_TPU[k]) for k in metrics}
                if not all(d <= 1e-3 for d in jd.values()):
                    raise AssertionError(f"{what}: metrics differ from bliss_tpu's: {jd}")
                anchor = f"; bliss_tpu's numbers within {max(jd.values()):.2e}"
            log(f"tools (phase 17) (a) quality_benchmark {name} {size} ({res['songs']} songs): "
                f"{run_s:.3f} s on the card (CPU {cpu_s:.3f} s; the songs' synthesis alone "
                f"{synth_s:.3f} s; analyze_batch_ext of the card-resident batch, warm, {stage}); "
                f"recall@{res['k']} core4 "
                f"{res['recall_at_k_core4']:.4f} extended {res['recall_at_k_extended']:.4f}, "
                f"separation core4 {res['separation_core4']:.4f} extended "
                f"{res['separation_extended']:.4f}; launches {got}; rows vs the CPU: beats "
                f"identical, core max |diff| {core.max():.2e}, {gates_text(errs)}; metrics "
                f"within {max(diff.values()):.2e} of the CPU's{anchor} {label}")
    return launches


def similarity_tool_part(device, label) -> None:
    """Phase 17 (b): ``tools.bench_similarity.main`` at its default N = 100 000
    at D = 4 and D = 49: ``correct_row0`` true, the card's line before it."""
    import contextlib
    import io

    from bliss_tpu_torch.tools import bench_similarity

    card = card_line() if torch.device(device).type == "cuda" else None
    for dim in (4, 49):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_similarity.main(["--device", str(device), "--dim", str(dim),
                                        "--n", str(SIM_N)])
        lines = buf.getvalue().strip().splitlines()
        rec = json.loads(lines[-1])
        if rc != 0 or not rec["correct_row0"] or rec["n"] != SIM_N or (
                card is not None and lines[-2] != card):
            raise AssertionError(f"phase 17 (b) bench_similarity --dim {dim}: rc {rc}, {lines}")
        log(f"tools (phase 17) (b) bench_similarity --dim {dim}: {json.dumps(rec)} {label}")


def library_decode(pcm_by_index):
    """A stand-in for ``pipeline.iter_decode`` and ``api._decode`` over a
    ``gen_library`` library: file songNNNNN.flac decodes to
    ``pcm_by_index[NNNNN]``, as the native decoder reads it back
    (``tests/test_torch_tools.py``)."""
    from bliss_tpu_torch.io import DecodedAudio

    def decoded(path):
        samples = pcm_by_index[int(os.path.basename(path)[4:9])]
        return DecodedAudio(samples, 2, SR, 706146, 2, 0, samples.shape[0] // (2 * SR), str(path),
                            "<no artist>", "<no title>", "<no album>", "", "<no genre>")

    def iter_decode(paths, **kw):
        for p in paths:
            yield p, decoded(p)

    return decoded, iter_decode


def decode_patches(pcm_by_index, what) -> list:
    """Where libav's development files are missing, patches of
    ``pipeline.iter_decode`` and ``api._decode`` (logged) that read a
    ``gen_library`` library's PCM; the device path is not patched."""
    from bliss_tpu_torch import api, pipeline

    if libav_present():
        return []
    log(f"tools (phase 17) {what}: no libav development files here, so pipeline.iter_decode "
        f"and api._decode are patched to yield the PCM gen_library wrote each file from; the "
        f"device path is not patched")
    decoded, iter_decode = library_decode(pcm_by_index)
    return [mock.patch.object(pipeline, "iter_decode", iter_decode),
            mock.patch.object(api, "_decode", decoded)]


def demo_scale_part(device, label) -> dict:
    """Phase 17 (c): ``tools.demo_scale.main`` at its default sizes: the
    10k x 10k distance matrix, the all-song top-100 over the card's mesh, the
    100k k-means, and the scan of SCALE_SCAN's library through the prepass
    and K1 once a batch, its rows ``analyze_pcm``'s of the same PCM.
    Returns the scan's launches."""
    import contextlib
    import io

    from bliss_tpu_torch import api, pipeline
    from bliss_tpu_torch.tools import demo_scale
    from bliss_tpu_torch.tools.gen_library import library_pcm

    n, secs, batch = SCALE_SCAN
    if demo_scale.scan.__defaults__[:3] != SCALE_SCAN:
        raise AssertionError(f"demo_scale.scan's sizes {demo_scale.scan.__defaults__} are not "
                             f"SCALE_SCAN {SCALE_SCAN}")
    pcm = library_pcm(n, secs)
    results, scans = [], []
    real_library = pipeline.analyze_library
    patches = decode_patches(pcm, "(c)") + [
        mock.patch.object(pipeline, "analyze_library",
                          lambda *a, **kw: results.append(real_library(*a, **kw)) or results[-1]),
        mock.patch.object(demo_scale, "similarity",
                          lambda *a, _f=demo_scale.similarity, **kw: scans.append(_f(*a, **kw))
                          or scans[-1]),
    ]
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = demo_scale.main(["--device", str(device)])
        total_s = time.perf_counter() - t0
        counts = launch_counts()
    out = buf.getvalue().strip().splitlines()
    (scan,) = results
    if rc != 0 or not scan.ok.all() or len(scan.files) != n:
        raise AssertionError(f"phase 17 (c) demo_scale: rc {rc}, {int(scan.ok.sum())}/{n} ok, "
                             f"{scan.errors}")
    batches = scan.stats["device_dispatch"]["count"]
    want = {"prepass": batches, "fused_all": batches, "fused_stats": 0, "stft_power": 0}
    if counts != want or batches != -(-n // batch):
        raise AssertionError(f"phase 17 (c) the scan launched {counts} in {batches} batches; "
                             f"want {want}")
    ref = np.concatenate([api.analyze_pcm(pcm[k : k + batch], [secs] * len(pcm[k : k + batch]),
                                          device=device) for k in range(0, n, batch)])
    err = within("phase 17 (c) the scan", scan.features, ref, "analyze_pcm of the same PCM", 1e-3)
    times = scans[0]
    log(f"tools (phase 17) (c) demo_scale: {' | '.join(out)}")
    log(f"tools (phase 17) (c) demo_scale (main, {total_s:.1f} s): distance matrix "
        f"{times['distance_matrix'] * 1e3:.3f} ms, top-100 {times['topk'] * 1e3:.3f} ms, k-means "
        f"{times['kmeans'] * 1e3:.3f} ms; the scan of {n} songs of {secs} s: launches {counts} "
        f"({batches} batches), rows = analyze_pcm of the same PCM, beats identical, max |diff| "
        f"{err.max():.2e}; {stage_line(scan.stats)} {label}")
    return counts


def printed_within(label, got, ref):
    """Rows read back from text (the CSV's "%f") against ``ref``: the same
    beat counts (durations of 11 s), the other columns within 1e-3; returns
    their max |diff|."""
    durs = [11] * len(ref)
    if got.shape != ref.shape or not np.array_equal(beat_counts(got, durs), beat_counts(ref, durs)):
        raise AssertionError(f"{label}: beat counts differ from analyze_pcm's rows: {got} {ref}")
    err = np.abs(got[:, 1:] - ref[:, 1:]).max(axis=0)
    if not (err <= 1e-3).all():
        raise AssertionError(f"{label}: differs from analyze_pcm's rows by {err}")
    return err


def examples_part(device, label) -> dict:
    """Phase 17 (d): each example on an EXAMPLE_SONGS-song ``gen_library``
    library (decode patched where libav is missing): ``song_api_demo`` and
    ``distance_demo`` print ``analyze_pcm``'s rows, ``library_scan`` and
    ``make_playlist`` write the CLI's CSV and m3u for the same files,
    ``scan_interactive`` scans into a store and resumes, ``analyze_gui``
    opens the GUI on the card (no display here: it says so) and its
    ``ScanJob`` writes the scan's rows. Returns launches by example."""
    import contextlib
    import csv
    import io
    import tempfile

    from bliss_tpu_torch import api, cli
    from bliss_tpu_torch.examples import (analyze_gui, distance_demo, library_scan,
                                          make_playlist, scan_interactive, song_api_demo)
    from bliss_tpu_torch.tools.gen_library import library_pcm, make_library

    dev = ["--device", str(device)]
    pcm = library_pcm(EXAMPLE_SONGS, 11, seed=1)
    rows = api.analyze_pcm(pcm, [11] * EXAMPLE_SONGS, device=device)
    launches, secs = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d, contextlib.ExitStack() as stack:
        lib = os.path.join(d, "lib")
        files = make_library(lib, EXAMPLE_SONGS, 11, seed=1)
        for p in decode_patches(pcm, "(d)"):
            stack.enter_context(p)
        os.chdir(d)  # library_scan's store is ./.bliss-store
        stack.callback(os.chdir, cwd)

        def run(name, fn, argv):
            buf, err = io.StringIO(), io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                rc = fn(dev + argv)
            secs[name] = time.perf_counter() - t0
            launches[name] = launch_counts()
            return rc, buf.getvalue(), err.getvalue()

        rc, out, _ = run("song_api_demo", song_api_demo.main, [files[0]])
        vec = out.splitlines()[4].split(":", 1)[1].strip()
        got = np.array([float(x.split(":")[1]) for x in vec.strip("{}").split(",")], np.float32)
        if rc != 0 or len(out.splitlines()) != 9:
            raise AssertionError(f"phase 17 (d) song_api_demo: rc {rc}: {out}")
        within("phase 17 (d) song_api_demo", got[None], rows[:1], "analyze_pcm's row")
        rc, out, _ = run("distance_demo", distance_demo.main, files[:2])
        dist = float(out.splitlines()[3].split(":", 1)[1])
        want = float(np.linalg.norm(rows[0].astype(np.float64) - rows[1]))
        if rc != 0 or not abs(dist - want) <= 1e-3:
            raise AssertionError(f"phase 17 (d) distance_demo: rc {rc}, {dist} against {want}")
        rc, _, _ = run("library_scan", library_scan.main, [lib, "example.csv"])
        run_cli(dev + ["scan", lib, "-o", "cli.csv", "--store", "cli-store"])
        scan_rows = read_csv("cli.csv")
        if rc != 0 or read_csv("example.csv") != scan_rows or len(scan_rows) != EXAMPLE_SONGS + 1:
            raise AssertionError("phase 17 (d) library_scan: its CSV is not the CLI scan's")
        csv_rows = np.array([[float(x) for x in r[1:5]] for r in scan_rows[1:]], np.float64)
        err = printed_within("phase 17 (d) library_scan", csv_rows, rows)
        rc, _, _ = run("make_playlist", make_playlist.main, [files[2], lib, "example.m3u"])
        run_cli(dev + ["playlist", files[2], lib, "-o", "cli.m3u"])
        with open("example.m3u") as a, open("cli.m3u") as b:
            m3u = a.read().splitlines()
            if rc != 0 or m3u != b.read().splitlines() or len(m3u) != EXAMPLE_SONGS + 1:
                raise AssertionError("phase 17 (d) make_playlist: its m3u is not the CLI's")
        for attempt in ("first", "resumed"):
            rc, out, _ = run(f"scan_interactive_{attempt}", scan_interactive.main, [lib, "store"])
            if rc != 0 or out.strip() != f"done: {EXAMPLE_SONGS}/{EXAMPLE_SONGS} songs analyzed (0 failed)":
                raise AssertionError(f"phase 17 (d) scan_interactive ({attempt}): rc {rc}: {out}")
        if any(launches["scan_interactive_resumed"].values()):
            raise AssertionError(f"phase 17 (d) scan_interactive resumed with launches "
                                 f"{launches['scan_interactive_resumed']}")
        rc, _, gui_err = run("analyze_gui", analyze_gui.main, [])
        job = analyze_gui.ScanJob(lib, os.path.join(d, "gui.csv"), device=device)
        n_rows = job.run()
        with open(os.path.join(d, "gui.csv"), newline="") as fh:
            gui_rows = list(csv.reader(fh, **analyze_gui.CSV_DIALECT))
        gui_vals = np.array([[float(r[i]) for i in (3, 4, 5, 2)] for r in gui_rows], np.float64)
        if n_rows != EXAMPLE_SONGS or [r[0] for r in gui_rows] != files:
            raise AssertionError(f"phase 17 (d) analyze_gui's ScanJob wrote {n_rows} rows")
        printed_within("phase 17 (d) analyze_gui's ScanJob", gui_vals, rows)
    for name in ("song_api_demo", "distance_demo", "library_scan", "make_playlist",
                 "scan_interactive_first"):
        if {k for k, v in launches[name].items() if v} != {"prepass", "fused_all"}:
            raise AssertionError(f"phase 17 (d) {name} launched {launches[name]}")
    gui_text = gui_err.strip().splitlines()[0] if rc == 1 else f"rc {rc}"
    log(f"tools (phase 17) (d) the examples on {EXAMPLE_SONGS} generated songs of 11 s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; song_api_demo's vector and distance_demo's distance are analyze_pcm's; "
        f"library_scan's CSV = the CLI scan's (max |diff| to analyze_pcm {err.max():.2e}), "
        f"make_playlist's m3u = the CLI playlist's; scan_interactive resumed with no launch; "
        f"analyze_gui: {gui_text!r}, its ScanJob's rows the scan's; launches "
        f"{ {k: v for k, v in launches.items()} } {label}")
    return {k: v for k, v in launches.items() if k != "analyze_gui"}


def edge_part(device, label) -> dict:
    """Phase 17 (e): ``edge_songs`` at B=1 under ``for_gpu()`` through the
    prepass and K1 on the card, against the same call with the plain
    versions of both: the same NaN/inf pattern, beats identical, the finite
    columns within 5e-4 (a constant song's frequency, the log of a ratio of
    float32 rounding noise, within 5e-2 of ``for_parity()`` on the card).
    Returns the launches."""
    from bliss_tpu_torch import AnalysisConfig
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.kernels import fused_all as fa
    from bliss_tpu_torch.kernels import fused_stats as fs

    cfg = AnalysisConfig.for_gpu()
    total = dict.fromkeys(launch_counts(), 0)
    worst, notes = 0.0, []
    for name, (pcm, dur) in edge_songs().items():
        batch = PCMBatch.from_arrays([pcm], [dur], device=device)
        reset_counts()
        got = analyze_batch(batch, cfg).cpu().numpy()[0]
        counts = launch_counts()
        if counts != {"prepass": 1, "fused_all": 1, "fused_stats": 0, "stft_power": 0}:
            raise AssertionError(f"phase 17 (e) {name} launched {counts}")
        for k, v in counts.items():
            total[k] += v
        with mock.patch.object(fs, "prepass_sums", fs.prepass_sums_reference), \
                mock.patch.object(fa, "fused_all_call", fa.fused_all_reference):
            ref = analyze_batch(batch, cfg).cpu().numpy()[0]
        for test in (np.isnan, np.isposinf, np.isneginf):
            if not np.array_equal(test(got), test(ref)):
                raise AssertionError(f"phase 17 (e) {name}: {got} against the plain path's {ref}")
        cols = np.isfinite(ref)
        if name == "constant_1234":
            cols[2] = False
            parity = analyze_batch(batch, AnalysisConfig.for_parity()).cpu().numpy()[0]
            d = abs(float(got[2]) - float(parity[2]))
            if not d <= 5e-2:
                raise AssertionError(f"phase 17 (e) {name}: frequency {got[2]} against "
                                     f"for_parity()'s {parity[2]}")
            notes.append(f"{name}'s frequency {got[2]:.5f} (plain {ref[2]:.5f}, for_parity() "
                         f"{parity[2]:.5f})")
        if (np.isfinite(ref[0]) and got[0] != ref[0]) or not (
                np.abs(got[cols] - ref[cols]) <= 5e-4).all():
            raise AssertionError(f"phase 17 (e) {name}: {got} against the plain path's {ref}")
        worst = max([worst, *np.abs(got[cols] - ref[cols]).tolist()])
    log(f"tools (phase 17) (e) {len(edge_songs())} degenerate songs at B=1 through the prepass and "
        f"K1 against their plain versions: NaN/inf patterns identical, beats identical, max |diff| "
        f"{worst:.2e}; {'; '.join(notes)}; launches {total} {label}")
    return total


def tools_phase(device, label) -> dict:
    """Phase 17: the tools and examples (M12), (a)-(e); TF32 must be off.
    Returns launches by part."""
    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is allowed; phase 17's float32 products need full float32")
    launches = quality_part(device, label)
    t1 = time.perf_counter()
    similarity_tool_part(device, label)
    t2 = time.perf_counter()
    launches["demo_scale_scan"] = demo_scale_part(device, label)
    t3 = time.perf_counter()
    launches.update({f"example_{k}": v for k, v in examples_part(device, label).items()})
    t4 = time.perf_counter()
    launches["edge_songs"] = edge_part(device, label)
    log(f"tools (phase 17) took {time.perf_counter() - t0:.1f} s: (a) {t1 - t0:.1f}, "
        f"(b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, (e) "
        f"{time.perf_counter() - t4:.1f}")
    return launches


def mesh_phase(arrays, durations, out, outh, ext_rows, longs, long_durs, device, label):
    """Phase 15: the mesh (M10), (a)-(g); TF32 must be off. Returns (a)'s
    launches by mesh, (b)'s kernel-vs-plain results and (c)'s launches by
    row."""
    from bliss_tpu_torch.features.types import PCMBatch

    t0 = time.perf_counter()
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is allowed; phase 15's float32 products need full float32")
    batch = PCMBatch.from_arrays(arrays, durations, device=device)
    secs = {}
    launches = mesh_rows_part(batch, durations, out, device, label)
    secs["a"] = time.perf_counter() - t0
    shard = mesh_shard_part(batch, device, label)
    secs["b"] = time.perf_counter() - t0 - sum(secs.values())
    matrix = mesh_matrix_part(device, label)
    secs["c"] = time.perf_counter() - t0 - sum(secs.values())
    mesh_modes_part(batch, durations, outh, ext_rows, device, label)
    secs["d"] = time.perf_counter() - t0 - sum(secs.values())
    mesh_entry_part(arrays, durations, longs, long_durs, device, label)
    secs["e"] = time.perf_counter() - t0 - sum(secs.values())
    if torch.device(device).type == "cuda":
        mesh_nccl_part(batch, device, label)
    else:
        log("mesh (phase 15) (f) the NCCL ProcessGroup: not run (no card)")
    secs["f"] = time.perf_counter() - t0 - sum(secs.values())
    del batch
    mesh_topk_part(ext_rows, device, label)
    secs["g"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"mesh (phase 15) took {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return launches, shard, matrix


# --- phase 16: the C compat library and the differential fuzz (M11) ----------

COMPAT_SONGS = 8  # of the main batch's, through bl_analyze under gpu
COMPAT_PARITY = 4  # of those, under parity too
COMPAT_RAW = 2  # of those, written raw for the fresh process
COMPAT_THREADS, COMPAT_ROUNDS = 4, 2
FUZZ = (("device_exact", 16), ("hybrid", 16), ("streaming", 4), ("streaming_strict", 2),
        ("extended", 8))


def compat_mode(mode: str, device):
    return mock.patch.dict(os.environ, {"BLISS_TPU_TORCH_COMPAT_MODE": mode,
                                        "BLISS_TPU_TORCH_DEVICE": str(device)})


def caller_song(compat, pcm: np.ndarray, duration: int):
    """A caller-filled ``bl_song`` over ``pcm`` (which must outlive it)."""
    song = compat.BlSong()
    song.sample_array = pcm.ctypes.data
    song.nSamples, song.channels, song.sample_rate = pcm.shape[0], 2, SR
    song.nb_bytes_per_sample, song.duration = 2, duration
    return song


def c_sorts(lib, compat, song) -> list[float]:
    """(tempo, amplitude, frequency, attack) from the three sorts."""
    import ctypes

    env = compat.EnvelopeResult()
    amp = lib.bl_amplitude_sort(ctypes.byref(song))
    freq = lib.bl_frequency_sort(ctypes.byref(song))
    lib.bl_envelope_sort(ctypes.byref(song), ctypes.byref(env))
    return [env.tempo, amp, freq, env.attack]


def compat_inproc_part(arrays, durations, out, device, label) -> dict:
    """Phase 16 (a): ``libbliss.so`` loaded into this process with
    ``ctypes``, ``io.decoder.decode`` patched to hand back the main batch's
    first COMPAT_SONGS songs by file name (the card's machine has no libav):
    under ``gpu``, ``bl_analyze`` of each launches the prepass and K1 once
    and gives phase 4's ``analyze_pcm`` rows (beats identical, the rest
    within 5e-4); under ``parity``, on COMPAT_PARITY of them, the three
    sorts lie within 1e-5 of ``Song.amplitude_analysis`` /
    ``frequency_analysis`` / ``envelope_analysis`` under ``for_parity()``
    and of ``bl_analyze``'s vector (beats identical); ``bl_distance`` and
    ``bl_cosine_similarity`` of the gpu vectors within 1e-6 (relative past
    1) of ``sim.distance``'s in float64. Returns launches by mode, seconds
    a song by mode, and the gpu-mode sorts of the first COMPAT_RAW songs."""
    import ctypes

    from bliss_tpu_torch import AnalysisConfig, Song, compat
    from bliss_tpu_torch.io import DecodedAudio, decoder
    from bliss_tpu_torch.sim.distance import cosine_similarity, distance

    lib = compat.load()
    songs = [np.ascontiguousarray(a) for a in arrays[:COMPAT_SONGS]]
    durs = list(durations[:COMPAT_SONGS])
    names = [f"compat{i:02d}.flac" for i in range(len(songs))]
    pcm = {n: DecodedAudio(a, 2, SR, 0, 2, 0, d, n, "", "", "", "", "")
           for n, a, d in zip(names, songs, durs)}
    launches, secs = {}, {}

    def analyze(names_, mode):
        rows, times = [], []
        with compat_mode(mode, device), mock.patch.object(decoder, "decode", lambda p: pcm[p]):
            reset_counts()
            for n in names_:
                song = compat.BlSong()
                before = launch_counts()
                t0 = time.perf_counter()
                rc = lib.bl_analyze(n.encode(), ctypes.byref(song))
                times.append(time.perf_counter() - t0)
                got = {k: v - before[k] for k, v in launch_counts().items()}
                if rc not in (0, 1, 2) or (mode == "gpu" and got != {
                        "prepass": 1, "fused_all": 1, "fused_stats": 0, "stft_power": 0}):
                    raise AssertionError(f"phase 16 (a) {mode}: bl_analyze({n}) returned {rc}, "
                                         f"launched {got}")
                v = song.force_vector
                rows.append([v.tempo, v.amplitude, v.frequency, v.attack])
                lib.bl_free_song(ctypes.byref(song))
            launches[mode] = launch_counts()
        secs[mode] = times
        return np.array(rows, np.float32)

    gpu = analyze(names, "gpu")
    err = within("phase 16 (a) gpu", gpu, out[:len(songs)], "phase 4's analyze_pcm rows")
    parity = analyze(names[:COMPAT_PARITY], "parity")
    parity_cfg = AnalysisConfig.for_parity()
    sorts, ref = [], []
    with compat_mode("parity", device):
        for a, d in zip(songs[:COMPAT_PARITY], durs):
            sorts.append(c_sorts(lib, compat, caller_song(compat, a, d)))
            s = Song(device=device)
            s.sample_array, s.duration = a, d
            t, k = s.envelope_analysis(parity_cfg)
            ref.append([t, s.amplitude_analysis(parity_cfg), s.frequency_analysis(parity_cfg), k])
    sorts, ref = np.array(sorts, np.float32), np.array(ref, np.float32)
    for what, other in (("Song's analyses under for_parity()", ref), ("bl_analyze's vectors", parity)):
        if not (np.array_equal(sorts[:, 0], other[:, 0]) and np.abs(sorts - other).max() <= 1e-5):
            raise AssertionError(f"phase 16 (a) parity: the sorts differ from {what}: "
                                 f"{np.abs(sorts - other).max(axis=0)}")
    with compat_mode("gpu", device):
        raw_sorts = [c_sorts(lib, compat, caller_song(compat, a, d))
                     for a, d in zip(songs[:COMPAT_RAW], durs)]
    worst = 0.0
    for i in range(len(songs)):
        for j in range(i + 1, len(songs)):
            a, b = (compat.ForceVector(*map(float, gpu[k])) for k in (i, j))
            ta, tb = (torch.tensor(gpu[k], dtype=torch.float64, device=device) for k in (i, j))
            for c_val, t_val in ((lib.bl_distance(a, b), distance(ta, tb)),
                                 (lib.bl_cosine_similarity(a, b), cosine_similarity(ta, tb))):
                t_val = float(t_val)
                worst = max(worst, abs(c_val - t_val) / max(1.0, abs(t_val)))
    if not worst <= 1e-6:
        raise AssertionError(f"phase 16 (a): bl_distance / bl_cosine_similarity differ from "
                             f"sim.distance's by {worst:.2e}")
    log(f"compat (phase 16) (a) in process: bl_analyze under gpu on {len(songs)} songs: launches "
        f"{launches['gpu']}, beats identical to phase 4's rows, max |diff| {err.max():.2e}, "
        f"{statistics.median(secs['gpu']):.3f} s a song (median; least {min(secs['gpu']):.3f}, most "
        f"{max(secs['gpu']):.3f}); under parity on {COMPAT_PARITY}: "
        f"{statistics.median(secs['parity']):.3f} s a song (least {min(secs['parity']):.3f}, most "
        f"{max(secs['parity']):.3f}), launches {launches['parity']}, the three sorts within "
        f"{np.abs(sorts - ref).max():.2e} of Song's for_parity() analyses and "
        f"{np.abs(sorts - parity).max():.2e} of bl_analyze's; bl_distance and "
        f"bl_cosine_similarity within {worst:.2e} of sim.distance's {label}")
    return {"launches": launches, "secs": secs, "raw_sorts": np.array(raw_sorts, np.float32)}


def compat_process_part(arrays, durations, raw_sorts, device, tmp, label) -> None:
    """Phase 16 (b) and (c): ``abi_check.c`` compiled with
    ``-DBLISS_COMPAT_NO_LIBAV`` against the library, run in a fresh process
    under ``gpu`` with no environment but the mode, on COMPAT_RAW of the
    main batch's songs written as raw int16 (caller-filled): its cold start
    timed, its sorts (a)'s in-process ones (beats identical, the rest within
    1e-5); then with ``--threads 4 --rounds 2`` under a 300 s timeout, every
    thread's results the single-thread ones, and (c) a FLAC file through
    ``bl_audio_decode``: without libav ``BL_UNEXPECTED`` with the decoder's
    message and ``bl_distance_file`` -2; with libav the file analyzed."""
    from bliss_tpu_torch import compat
    from bliss_tpu_torch.io.flac_writer import write_flac

    exe = compat.abi_check_path()
    raws = []
    for i, (a, d) in enumerate(zip(arrays[:COMPAT_RAW], durations)):
        path = os.path.join(tmp, f"raw{i}.s16")
        a.tofile(path)
        raws += ["--raw", path, str(d)]
    env = {"BLISS_TPU_TORCH_COMPAT_MODE": "gpu"}
    if torch.device(device).type != "cuda":  # a rehearsal: cuda is the default
        env["BLISS_TPU_TORCH_DEVICE"] = str(device)
    t0 = time.perf_counter()
    proc = subprocess.run([exe, *raws], env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = compat.abi_check_lines(proc.stdout)
    cold = float(lines["cold_start"][0][0]) if "cold_start" in lines else None
    if proc.returncode != 0 or len(lines.get("sorts", [])) != COMPAT_RAW:
        raise AssertionError(f"phase 16 (b): abi_check exited {proc.returncode}: "
                             f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    got = np.array([[float(r[2]), float(r[0]), float(r[1]), float(r[3])] for r in lines["sorts"]],
                   np.float32)
    if not (np.array_equal(got[:, 0], raw_sorts[:, 0]) and np.abs(got - raw_sorts).max() <= 1e-5):
        raise AssertionError(f"phase 16 (b): the fresh process's sorts {got} differ from the "
                             f"in-process ones {raw_sorts}")
    log(f"compat (phase 16) (b) abi_check in a fresh process (env: the mode only), gpu, "
        f"{COMPAT_RAW} caller-filled songs: cold start to the first sort's end "
        f"{cold:.3f} s, the process {wall:.2f} s; the sorts within "
        f"{np.abs(got - raw_sorts).max():.2e} of (a)'s in-process ones, beats identical {label}")

    flac = os.path.join(tmp, "song0.flac")
    write_flac(flac, arrays[0].reshape(-1, 2), SR)
    real = libav_present()
    args = raws + ["--bad", flac] + ([flac] if real else []) + [
        "--threads", str(COMPAT_THREADS), "--rounds", str(COMPAT_ROUNDS)]
    t0 = time.perf_counter()
    proc = subprocess.run([exe, *args], env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = compat.abi_check_lines(proc.stdout)
    items = COMPAT_RAW + real
    if proc.returncode != 0 or lines.get("threads") != [[str(COMPAT_THREADS), str(COMPAT_ROUNDS),
                                                         str(items), "0"]]:
        raise AssertionError(f"phase 16 (b) threads: abi_check exited {proc.returncode}: "
                             f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    log(f"compat (phase 16) (b) abi_check --threads {COMPAT_THREADS} --rounds {COMPAT_ROUNDS}: "
        f"{COMPAT_THREADS * COMPAT_ROUNDS * items} calls of {items} songs at once, every result "
        f"the single-thread one bit for bit, no deadlock, {wall:.2f} s {label}")
    (bad,) = lines["bad"]
    if real:
        from bliss_tpu_torch import api
        from bliss_tpu_torch.io import decode

        d = decode(flac)  # the writer fills the last block: the file's own PCM
        row = np.float32(lines["analyze"][0][2:6])
        err = within("phase 16 (c)", row[None, :],
                     api.analyze_pcm([d.samples], [d.duration], device=device),
                     "analyze_pcm of the decoded file")
        what = f"bl_analyze of the FLAC file through the port's decoder: max |diff| {err.max():.2e}"
    else:
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith(f"bliss_tpu_torch compat: {flac}: ")]
        if bad[:4] != ["-2", "-2", "-2", "-2"] or not said:
            raise AssertionError(f"phase 16 (c): without libav, want BL_UNEXPECTED and the "
                                 f"decoder's message: {bad} {proc.stderr[-2000:]}")
        what = ("no libav development files here: bl_audio_decode and bl_analyze return "
                "BL_UNEXPECTED, bl_distance_file and bl_cosine_similarity_file -2, and stderr has "
                f"the decoder's message: {said[0][:160]!r}")
    log(f"compat (phase 16) (c) decode of a FLAC file: {what} {label}")


def fuzz_part(device, label) -> dict:
    """Phase 16 (d): ``bliss_tpu_torch.fuzz`` on the card, each mode of
    FUZZ with no divergent case but the pinned float32 flips of
    ``fuzz.KNOWN_F32_FLIPS``; returns launches by mode."""
    from bliss_tpu_torch import fuzz

    launches = {}
    for mode, n in FUZZ:
        reset_counts()
        if mode in ("device_exact", "hybrid"):
            res = fuzz.run_batched_device_fuzz(n, mode, device=device, verbose=False)
        elif mode == "extended":
            res = fuzz.run_extended_fuzz(n, device=device, verbose=False)
        else:
            res = fuzz.run_fuzz(n, mode, device=device, verbose=False)
        launches[mode] = launch_counts()
        # streaming: a divergent case whose only fault is a flip that
        # bliss_tpu's own float32 streaming makes on the same song, and that
        # its for_parity() stream settles (fuzz.KNOWN_F32_FLIPS, pinned by
        # tests/test_torch_fuzz.py), is reported; any other divergence fails
        known = res.get("known_flips", [])
        if res["cases"] != n or res["divergent"] != len(known):
            raise AssertionError(f"phase 16 (d) fuzz {mode}: {res}")
        want = {"device_exact": ("prepass", "fused_all"), "hybrid": ("prepass", "fused_stats", "stft_power"),
                "extended": ("prepass", "fused_all")}.get(mode, ())
        if any(not launches[mode][k] for k in want):
            raise AssertionError(f"phase 16 (d) fuzz {mode} launched {launches[mode]}")
        dev = res.get("max_dev") or res["max_dev_by_group"]
        dev_text = (", ".join(f"{k} {v:.2e}" for k, v in dev.items()) if isinstance(dev, dict)
                    else "tempo {:.2e} amplitude {:.2e} frequency {:.2e} attack {:.2e}".format(*dev))
        log(f"compat (phase 16) (d) fuzz {mode}: {n} cases, divergent {res['divergent']}"
            + (f" (marginal {res['marginal']}; bliss_tpu's own float32 flips of more than one "
               f"beat, parity exact (fuzz.KNOWN_F32_FLIPS): cases {known})"
               if "marginal" in res else "")
            + f", {res['seconds']:.1f} s = {n / res['seconds']:.2f} cases/s ("
            + ("the CPU's float64 stage" if mode == "extended" else "the oracle's processes")
            + f" and the songs' making included), max |diff| {dev_text}; launches "
            f"{launches[mode]} {label}")
    return launches


def compat_phase(arrays, durations, out, device, label) -> dict:
    """Phase 16: the C compat library (a)-(c) and the fuzz (d). Where the
    library cannot be built for want of ``Python.h`` or a compiler, the
    phase fails. Returns launches by part and mode."""
    import tempfile

    from bliss_tpu_torch import compat

    t0 = time.perf_counter()
    launches = {}
    t_build = time.perf_counter()
    try:
        compat.abi_check_path()
    except compat.MissingBuildTool as e:
        raise AssertionError(f"phase 16: the C library cannot be built: {e}") from e
    log(f"compat (phase 16) libbliss.so and abi_check built in "
        f"{time.perf_counter() - t_build:.1f} s (g++ and gcc)")
    part = compat_inproc_part(arrays, durations, out, device, label)
    launches["compat"] = part["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        compat_process_part(arrays, durations, part["raw_sorts"], device, tmp, label)
    t1 = time.perf_counter()
    launches["fuzz"] = fuzz_part(device, label)
    log(f"compat (phase 16) took {time.perf_counter() - t0:.1f} s: (a)-(c) {t1 - t0:.1f}, "
        f"(d) {time.perf_counter() - t1:.1f}")
    return launches


# --- phase 17: the tools and examples (M12) -------------------------------------

# tools/quality_benchmark.py's runs: tests/test_quality.py's size and the
# script's default
QUALITY_SIZES = ((6, 4, 5.0), (8, 6, 11.0))
# bliss_tpu's analyze_batch_ext_jit under the script's config at 6 x 4 x
# 5 s, through the script's retrieval_metrics on the CPU (held to
# bliss_tpu's output by tests/test_torch_quality.py, as the card has no JAX)
QUALITY_BLISS_TPU = {
    "recall_at_k_core4": 0.5138888888888888,
    "recall_at_k_extended": 0.9027777777777778,
    "separation_core4": 1.8499802350997925,
    "separation_extended": 3.118532180786133,
}


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from bliss_tpu_torch import AnalysisConfig, api
    from bliss_tpu_torch.features.analyze import analyze_batch
    from bliss_tpu_torch.features.types import PCMBatch
    from bliss_tpu_torch.features.analyze import _device_stage, _device_stage_packed, _unpack_stage
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
    _build.build(("fused_all", "ablate", "knn"))
    for name in ("fused_all", "ablate", "knn"):
        secs, report = _build.BUILD_INFO.get(name, (0.0, "already built"))
        log(f"build: {name}.cu sm_90a in {secs:.1f} s (all built after "
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
    # K1's and K2's bounds with the FIR's FMAs on the fp64 tensor cores, as
    # A3 runs them
    tc_bounds = {"fused_all": bounds.bound_ms(bounds.fused_all_work(MAIN_B, MAIN_L, frames, fir_pipe="fp64_tc")),
                 "fused_stats": bounds.bound_ms(bounds.stats_work(MAIN_B, MAIN_L, fir_pipe="fp64_tc"))}
    k3_calls = k3_library_ms(batch)
    library = {"prepass": None, "fused_all": None, "fused_stats": None,
               "stft_power": k3_calls["torch.matmul"]}
    for name, (_, ms, plain_ms) in kernels.items():
        bound, by = bounds.bound_ms(works[name])
        calls = k3_calls if name == "stft_power" else {}
        tc = (f", with the FIR on the fp64 tensor cores {tc_bounds[name][0]:.3f} ms "
              f"({tc_bounds[name][1]})") if name in tc_bounds else ""
        log(f"{name} B=64 L=2^23 warm median of 5: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}){tc}, library call "
            f"{', '.join(f'{c} {t:.3f} ms' for c, t in calls.items()) or 'none'} {label}")

    # 4. the main path, through the user's entry point; every count is set
    # to 0 just before each path runs and read just after
    cfg = api.default_config()
    if cfg != AnalysisConfig.for_gpu():
        raise AssertionError(f"default_config() is not for_gpu(): {cfg}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    reset_counts()
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
    reset_counts()
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
        amp_h, freq_h, fa_h, _ = _unpack_stage(host, hyb, MAIN_L)
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
    t7 = time.perf_counter()
    regs = [e for e in ptxas_report(_build.BUILD_INFO.get("ablate", (0.0, ""))[1]).split(" | ")
            if "probe_kernel" in e or "matred_stats_kernel" in e]
    log(f"ablation (phase 7) A2 and A3 registers and spills (ptxas): "
        f"{' | '.join(regs) if regs else 'no build report: the library was already built'}")
    einp = batch_inputs(edge)
    checked = [check_ablation(einp, "(a) B=5 L=2^18 edge cases"),
               check_probe_modes(einp["x"], "(a) B=5 L=2^18 edge cases"),
               check_matred_taps(einp["x"], einp["alpha"], einp["beta"], "(a) B=5 L=2^18 edge cases")]
    del einp
    sinp = breakdown.inputs("script")
    checked.append(check_ablation(sinp, "(b) B=128 L=491520"))
    inp = breakdown.inputs("main")
    main_checked = check_ablation(inp, "(c) B=64 L=2^23", timed=True)
    checked.append(main_checked)
    a3_taps = matred_taps_ms(inp, label)
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
    log(f"ablation (phase 7) took {time.perf_counter() - t7:.1f} s")

    # 8. the library pipeline: (a) its loop after decode at full width, on
    # the main batch's songs and two variants of each (reversed, rotated by
    # a third): 192 songs, the same lengths, so two full B=64 batches at
    # 2^23 and the rest in the 6291456 and 2^23 buckets
    songs = list(arrays) + [a[::-1].copy() for a in arrays] + [
        np.roll(a, a.shape[0] // 3) for a in arrays]
    scan_launches = {}
    for name, scfg in (("main", cfg), ("hybrid", hyb)):
        scan_launches[name] = scan_phase(songs, durations * 3, scfg, name, "cuda", MAIN_B, label)
    block = batch.samples.cpu().numpy()
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        torch.from_numpy(block).to("cuda")
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    h2d = statistics.median(copies)
    log(f"pipeline (a) host-to-device copy of one padded batch (B=64, L=2^23, "
        f"{block.nbytes / 2**30:.2f} GiB, pageable, inside device_dispatch): median of 3 "
        f"{h2d:.3f} s = {block.nbytes / h2d / 1e9:.2f} GB/s {label}")
    del block, songs
    # (b) files, where the native decoder can be built
    if libav_present():
        file_phase(np.random.default_rng(SEED + 3), "cuda", 30.0, label)
    else:
        log("pipeline (b) files: left out: pkg-config finds no libav development files "
            "(libavformat, libavcodec, libavutil, libswresample) on this machine, so the "
            "native decoder cannot be built here; file decode is checked on the CPU only")

    # 9. long songs streamed, with the main batch's songs among them
    stream_launches, long_pcm, long_durs, long_rows = stream_phase(
        arrays, durations, {"main": out, "hybrid": outh}, "cuda", label)

    # 11. the extended features, before phase 10, whose D = 49 library takes
    # (a)'s rows; (c)'s CLI part runs in phase 10 (c), on its files
    t_ext = time.perf_counter()
    ext_rows, ext_launches = extended_phase(
        batch, {"main": out, "two_kernel": out2, "hybrid": outh},
        {"main": cfg, "two_kernel": two, "hybrid": hyb}, label)
    extended_stream_part(long_pcm, long_durs, "cuda", label)
    serve_long = (long_pcm[:SERVE_LONG], long_durs[:SERVE_LONG], long_rows[:SERVE_LONG])
    songs = list(arrays) + [a[::-1].copy() for a in arrays] + [
        np.roll(a, a.shape[0] // 3) for a in arrays]
    scan_phase(songs, durations * 3, cfg, "main", "cuda", MAIN_B, label, runs=1, trace=False,
               extended=True)
    del songs
    log(f"extended (phase 11) took {time.perf_counter() - t_ext:.1f} s, its CLI part aside")

    # 10. similarity and the CLI, around the main path's rows, with (a)'s
    # extended columns as the D = 49 library's
    cli_launches = similarity_phase(ext_rows["main"], "cuda", label)

    # 12. the XLA-path config modes, held to the main path's rows and energies
    main_fa = (_device_stage(batch, cfg)[2], batch.n_samples, batch.durations)
    del batch
    xla_phase(arrays, durations, out, main_fa, "cuda", label)
    del main_fa

    # 13. the serving layer: the daemon, its HTTP gateway, doctor and the GUI
    serve_launches = serve_phase(arrays, durations, *serve_long, out, "cuda", label)

    # 14. the XLA-path modes streamed (M7b) on phase 9's songs, then the
    # single-device rows of scripts/kernel_smoke.py's matrix
    m7b_launches, matrix_launches, matrix_rows = m7b_phase(long_pcm, long_durs, "cuda", label)

    # 15. the mesh (M10): the main batch over three meshes of the card,
    # kernel_smoke's two sharded rows, the entry points, NCCL, the top-k
    mesh_launches, mesh_shard, mesh_matrix = mesh_phase(
        arrays, durations, out, outh, ext_rows["main"], *serve_long[:2], "cuda", label)
    del long_pcm, serve_long
    # 16. the C compat library and the differential fuzz (M11)
    compat_launches = compat_phase(arrays, durations, out, "cuda", label)
    # 17. the tools and examples (M12)
    tools_launches = tools_phase(torch.device("cuda"), label)
    for row, counts in mesh_matrix.items():
        matrix_rows[row] = counts
        for k, v in counts.items():
            matrix_launches[k] += v

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
            **({"bound_fir_tc_ms": tc_bounds[name][0]} if name in tc_bounds else {}),
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
                if n in {r["name"] for r in rows} or n.startswith(kernel_id + " ")
                for e in errs_n.values()]
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
            } | ({f"main S4 matred {k}": v for k, v in a3_taps.items()}
                 if name == "matred_stats" else {}),
        })
    for e in entries:
        e.update(route="cuda", launches=launches[e["name"]], library_ms=library[e["name"]])
        if e["name"] in scan_launches["main"]:
            e["scan_launches"] = {k: v[e["name"]] for k, v in scan_launches.items()}
            e["stream_launches"] = {k: v[e["name"]] for k, v in stream_launches.items()}
            e["cli_scan_launches"] = cli_launches[e["name"]]
            e["extended_launches"] = {k: v[e["name"]] for k, v in ext_launches.items()}
            e["serve_launches"] = serve_launches[e["name"]]
            e["m7b_launches"] = m7b_launches[e["name"]]
            e["matrix_launches"] = matrix_launches[e["name"]]
            e["matrix_rows"] = [row for row, c in matrix_rows.items() if c[e["name"]]]
            e["mesh_launches"] = {m: c[e["name"]] for m, c in mesh_launches.items()}
            e["compat_launches"] = {m: c[e["name"]] for m, c in compat_launches["compat"].items()}
            e["fuzz_launches"] = {m: c[e["name"]] for m, c in compat_launches["fuzz"].items()}
            e["tools_launches"] = {part: c[e["name"]] for part, c in tools_launches.items()}
            if e["name"] in mesh_shard:
                errs, ms, plain_ms = mesh_shard[e["name"]]
                e["mesh_shard"] = {"max_abs_err": max(a for a, _ in errs.values()),
                                   "ms": ms, "plain_ms": plain_ms}
    # the k-NN kernel's row: phase 10 (a)'s D = 4 check, D = 49 as a variant
    entries.append({
        "name": "knn", "source": "bliss_tpu_torch/kernels/csrc/knn.cu",
        "replaces": "bliss_tpu/sim/distance.py:84 (XLA: a matmul and lax.top_k; no Pallas kernel)",
        **{k: KNN_CHECKS[4][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "variants": {f"N={SIM_N} D={dim} k={SIM_K}": c for dim, c in KNN_CHECKS.items()},
        "route": "cuda", "launches": KNN_LAUNCHES, "library_ms": None,
    })
    log(f"chip_smoke took {time.perf_counter() - t_script:.1f} s, the builds included")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
