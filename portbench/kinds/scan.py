"""Traffic of kind ``scan``: a library scan as ``pipeline.analyze_library``
runs it after decode, through ``pipeline._scan``, over decoded songs held
in host memory (the card's machine has no libav to decode with).

Set-up makes ``songs`` distinct songs of the configuration's lengths on
the device from the seed (``generators.songs``), moves them to one host
array, and scans one batch of each bucket length that they fill. The
window is one ``_scan`` call fed an endless
stream that cycles over the songs in an order drawn from the seed; it
starts when the first song is handed over, and at ``seconds`` the stream
sets ``_scan``'s own ``cancel`` event, so the scan drains its in-flight
batches and returns. ``scan_songs_per_s`` counts every song whose row the
scan completed over all of that time.

Afterwards every completed row of a sample of the songs drawn from the
seed, the longest song among them, is held to the plain float64 reference
(``reference/analysis.py``), computed across the host's cores.
"""

from __future__ import annotations

import multiprocessing
import os
import threading
import time

import numpy as np

from portbench import common, generators, tracing, work
from portbench.reference import analysis

# the numbers compared and their limits (PERF.md gives the readings that
# set them)
LIMITS = {"beat_err": 0.5, "score_err": 5e-3, "nonfinite_rows": 0, "rows_missing": 0}
MAX_RATE = 4000  # songs/s: the result arrays hold this many a second of window


def reference_rows(jobs, round_to=None, c_sums=False) -> list:
    """The reference's [4] row of each (samples, duration) in ``jobs``
    (``round_to`` and ``c_sums`` as ``analysis.force_vector``'s), computed
    in spawned processes, one a core, each single-threaded."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    pool = multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1))
    try:
        return pool.map(analysis.row_of, [(s, d, round_to, c_sums) for s, d in jobs], chunksize=1)
    finally:
        pool.close()
        pool.join()


def batches_of(stream_songs, lengths, batch_size: int, pad_multiple: int) -> list:
    """The batches that ``_scan`` fills from songs handed over in the order
    ``stream_songs``: (bucket length, [stream positions]) of each bucket
    that reached ``batch_size``, in the order they filled."""
    from bliss_tpu_torch.pipeline import _bucket_length

    open_, full = {}, []
    for j, s in enumerate(stream_songs):
        L = _bucket_length(int(lengths[s]), pad_multiple)
        open_.setdefault(L, []).append(j)
        if len(open_[L]) == batch_size:
            full.append((L, open_.pop(L)))
    return full


def compare(features, completed, song_of, ref, durations) -> dict:
    """The numbers that decide ``correct``: over every completed row
    (positions ``completed`` of ``features``) of a song in ``ref``, the
    largest gap to the reference's tempo in beats (``beat_err``: the
    tempo's gap times the song's ``durations`` over 4) and to its
    amplitude, frequency and attack (``score_err``); over all completed
    rows, those with a value that is not finite (``nonfinite_rows``); and
    the rows compared."""
    rows = features[completed].astype(np.float64)
    songs = song_of[completed]
    mask = np.isin(songs, list(ref))
    want = np.array([ref[s] for s in songs[mask]]).reshape(-1, 4)
    gap = np.abs(rows[mask] - want)
    gap = np.where(np.isnan(gap), np.inf, gap)
    beats = gap[:, 0] * durations[songs[mask]] / 4.0
    return {
        "beat_err": float(beats.max(initial=0.0)),
        "score_err": float(gap[:, 1:].max(initial=0.0)),
        "nonfinite_rows": int((~np.isfinite(rows)).any(1).sum()),
        "rows_compared": int(mask.sum()),
    }


def check_songs(n: int, lengths, size: int, seed: int) -> list:
    """``size`` songs drawn from the seed, with the longest."""
    drawn = np.random.default_rng(seed + 1).choice(n, size=min(size, n), replace=False)
    return sorted({int(i) for i in drawn} | {int(np.argmax(lengths))})


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> common.Outcome:
    import torch
    from torch.profiler import record_function

    from bliss_tpu_torch import pipeline
    from bliss_tpu_torch.config import AnalysisConfig
    from bliss_tpu_torch.io import DecodedAudio
    from bliss_tpu_torch.utils import StageTimer

    t_in = time.perf_counter()
    conf, mix = cell.config, cell.traffic
    if conf.get("extended"):
        raise ValueError("the scan's reference has the 4 core columns only")
    cfg = getattr(AnalysisConfig, conf["analysis"])()
    B, sr = conf["batch_size"], conf["sample_rate"]
    lengths = generators.song_lengths(mix["songs"], conf["song_min_samples"], conf["song_max_samples"])
    durations = lengths // (2 * sr)
    library = generators.songs(lengths, seed, device, sample_rate=sr)
    order = np.random.default_rng(seed).permutation(len(lengths))
    decoded = [DecodedAudio(library[i, : lengths[i]], 2, sr, 0, 2, 0, int(durations[i]),
                            f"song-{i}", "", "", "", "", "") for i in range(len(lengths))]
    dev = torch.device(device)

    def scan(stream, n_rows, timer, cancel=None):
        result = pipeline.ScanResult([f"item-{j}" for j in range(n_rows)],
                                     np.full((n_rows, 4), np.nan, np.float32),
                                     np.zeros(n_rows, bool), {}, {})
        pipeline._scan(result, stream, cfg=cfg, batch_size=B, device=dev, timer=timer, cancel=cancel)
        return result

    # warm-up: a full batch of each bucket length
    by_len = {}
    for s in order:
        by_len.setdefault(pipeline._bucket_length(int(lengths[s]), cfg.pad_multiple), []).append(s)
    warm = [by_len[L][j % len(by_len[L])] for L in sorted(by_len) for j in range(B)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    scan(((j, decoded[s]) for j, s in enumerate(warm)), len(warm), StageTimer())
    setup = {"inputs_s": t_warm - t_in, "warm_s": time.perf_counter() - t_warm}

    capacity = int(MAX_RATE * seconds) + 4 * B
    cancel = threading.Event()
    clock = {}

    def stream():
        for j in range(capacity):
            now = time.perf_counter()
            if j == 0:
                clock["t0"] = now
            elif now - clock["t0"] >= seconds:
                cancel.set()
            clock["handed"] = j + (not cancel.is_set())
            yield j, decoded[order[j % len(order)]]

    timer = common.span_timer(StageTimer, annotate=trace)

    def window():
        with record_function(tracing.WINDOW):
            result = scan(stream(), capacity, timer, cancel)
            return result, time.perf_counter()

    if trace:
        (result, t1), tr = tracing.profiled(window)
    else:
        (result, t1), tr = window(), None
    t0 = clock["t0"]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    song_of = order[np.arange(capacity) % len(order)]
    filled = batches_of(song_of[: clock["handed"]], lengths, B, cfg.pad_multiple)
    dispatched = np.array(sorted(j for _, js in filled for j in js), np.int64)
    completed = np.flatnonzero(result.ok)
    stages = {k: {"seconds": timer.seconds[k], "count": timer.counts[k]} for k in timer.seconds}
    songs = check_songs(len(lengths), lengths, mix["check_songs"], seed)
    ref = reference_rows([(decoded[i].samples, int(durations[i])) for i in songs])
    got = compare(result.features, completed, song_of, dict(zip(songs, ref)), durations)
    got["rows_missing"] = int((~result.ok[dispatched]).sum())
    return common.Outcome(
        metrics={"scan_songs_per_s": len(completed) / (t1 - t0)},
        checks=[common.Check(name, got[name], limit) for name, limit in LIMITS.items()],
        attempted=len(dispatched),
        failed=got["rows_missing"] + len(result.errors),
        memory_peak_bytes=peak,
        setup_s=t0 - t_start,
        context={
            "setup": setup,
            "stages": stages,
            "pad_each": [round(b - a, 4) for name, _, a, b in timer.spans if name == "pad"],
            "dispatch_each": [round(b - a, 4) for name, _, a, b in timer.spans
                              if name == "device_dispatch"],
            "batches": len(filled),
            "least_s": work.device_pass_least_s(
                [[int(lengths[song_of[j]]) for j in js] for _, js in filled]),
            "rows_compared": got["rows_compared"],
            "completed": len(completed),
        },
        trace=tr,
    )
