"""The batch analysis pipeline: audio files -> force vectors, at scale (the
port of ``bliss_tpu/pipeline.py``).

  [host threads]  decode + canonicalize PCM  (libav, GIL released)
        v  bounded prefetch
  [host]          bucket into fixed (batch, length) shapes
        v  host-to-device copy, asynchronous launches
  [GPU]           the prepass and K1 (main path), or K2 and K3 (hybrid)
        v
  [pool thread]   device-to-host copy, float64 host finish (hybrid),
                  feature store, progress

Per-song failure isolation: an undecodable file yields a NaN feature row and
an entry in ScanResult.errors instead of aborting the batch (the batch
analog of the reference GUI's skip-bad-files behavior). With a FeatureStore,
already-analyzed files (by content fingerprint) are skipped — resumable
library scans.

A song longer than ``long_song_samples`` skips the buckets: the pool thread
streams it alone through ``features/streaming.analyze_song_streaming``, whose
cost grows with the song rather than with a bucket of 64 such songs.

``extended=True`` adds the 45 extended features (``features/extended.py``)
to every row, from the same device pass and envelope finish, on every route
(batch, hybrid, streamed); store entries then hold the 49 columns.

With a ``mesh`` (``parallel.analysis_mesh``) every bucket is analyzed over
it (``parallel.analyze_sharded_async``); a long song still streams alone,
on the scan's ``device``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np
import torch

from bliss_tpu_torch.config import AnalysisConfig, check_supported
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_ext, launch_hybrid
from bliss_tpu_torch.features.streaming import analyze_song_streaming, streaming_supports
from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES, PCMBatch, resolve_device
from bliss_tpu_torch.io import iter_decode
from bliss_tpu_torch.store.feature_store import FeatureStore
from bliss_tpu_torch.utils import StageTimer, get_logger, log_event

logger = get_logger("bliss_tpu_torch.pipeline")

# Songs longer than this (interleaved samples, ~3 min) route through the
# chunked streaming path. Single source of truth — api.py re-exports it for
# the Song API's identical routing decision.
LONG_SONG_SAMPLES = 1 << 23


@dataclasses.dataclass
class ScanResult:
    files: list[str]
    features: np.ndarray  # [N, 4] float32; NaN rows for failed songs
    ok: np.ndarray  # [N] bool
    errors: dict[str, str]
    stats: dict
    extended: np.ndarray | None = None  # [N, len(EXTENDED_FEATURE_NAMES)]

    def force(self) -> np.ndarray:
        t, a, f, k = (self.features[:, i] for i in range(4))
        return np.maximum(t, 0) + a + f + np.maximum(k, 0)


def _dispatch_analysis(
    samples: np.ndarray,
    n_samples: np.ndarray,
    durations: np.ndarray,
    cfg: AnalysisConfig,
    device: torch.device,
    extended: bool = False,
    mesh=None,
):
    """Start device analysis of a padded host batch; returns a callable that
    blocks and yields the [B, 4] float32 features (the async half), [B, 49]
    with ``extended``. With a ``mesh`` the batch is analyzed over it
    (``parallel.analyze_sharded_async``), each shard copied from the host
    to its own device.

    The PCM is copied to ``device`` here (from pageable memory, so the
    copy blocks this thread); the launches that follow are asynchronous on
    the current stream, so the caller can pad and launch the next batch
    while a pool thread runs the callable. The callable holds the device
    result and host arrays only, never the batch: its device-to-host copy,
    and for a ``tempo_finish="host"`` config the float64 envelope finish,
    run on whichever thread calls it."""
    if mesh is not None:
        from bliss_tpu_torch.parallel import analyze_sharded_async

        host = PCMBatch(*(torch.from_numpy(a) for a in (samples, n_samples, durations)))
        return analyze_sharded_async(host, mesh, cfg, extended)
    batch = PCMBatch(
        torch.from_numpy(samples).to(device),
        torch.from_numpy(n_samples).to(device),
        torch.from_numpy(durations).to(device),
    )
    if cfg.tempo_finish == "host":
        # one packed float64 output = one device->host copy per batch
        finish = launch_hybrid(batch, cfg, extended)
        return lambda: finish(n_samples, durations)
    fut = analyze_batch_ext(batch, cfg) if extended else analyze_batch(batch, cfg)
    return lambda: fut.cpu().numpy()


def _bucket_length(n: int, pad_multiple: int) -> int:
    """Quantize padded lengths to sqrt(2)-spaced buckets so the number of
    distinct batch shapes stays O(log(max_len)) across a library."""
    n = max(n, pad_multiple)
    exact = max(2 * pad_multiple, 1 << math.ceil(math.log2(n)))
    half = exact // 2 + exact // 4  # 0.75 * exact, between the powers of two
    cand = half if n <= half else exact
    return ((cand + pad_multiple - 1) // pad_multiple) * pad_multiple


def analyze_library(
    files: list[str],
    *,
    cfg: AnalysisConfig | None = None,
    batch_size: int = 64,
    store: FeatureStore | None = None,
    mesh=None,
    num_decode_workers: int | None = None,
    progress=None,
    extended: bool = False,
    cancel=None,
    handle_sigint: bool = True,
    long_song_samples: int | None = LONG_SONG_SAMPLES,
    device="cuda",
) -> ScanResult:
    """Analyze a library of audio files on ``device`` (the GPU unless the
    caller asks for the CPU; raises RuntimeError when no GPU is present);
    returns features in input order.

    Songs longer than ``long_song_samples`` interleaved samples are
    streamed one by one (``features/streaming.py``) on the finalize thread
    instead of padded into a bucket; their time shows as the ``streaming``
    stage. ``None`` sends every song through the buckets. With a ``mesh``
    (``parallel.analysis_mesh``) the buckets are analyzed over it, and a
    long song still streams alone on ``device``.

    progress: optional callback (done, total, message). With
    ``extended=True`` the 45 extended features are computed in the same
    device pass and returned in ``ScanResult.extended``; store entries then
    carry the 49-column vector, and a cached entry is taken only when its
    width is the scan's.

    Cancellation (the batch analog of the reference GUI's worker-thread
    cancel Event, reference python/examples/analyze_gui.py:51-58): pass a
    ``cancel`` threading.Event, or — when running on the main thread with
    ``handle_sigint`` — press Ctrl-C once. Either way the scan stops taking
    new work, DRAINS the in-flight device batches, flushes the store, and
    returns the partial ScanResult with ``stats["cancelled"] = True``; a
    re-run with the same store resumes losslessly. A second Ctrl-C raises
    KeyboardInterrupt immediately.
    """
    device = resolve_device(device)
    if cfg is None:
        from bliss_tpu_torch.api import default_config

        cfg = default_config()
    # refuse an unported config before any decode, and before a store
    # could save another config's vectors under this config's key
    check_supported(cfg)
    timer = StageTimer()
    # process-wide CPU (user+sys, ALL threads incl. decode workers, the
    # finalize pool, and any library-internal helpers): the one number
    # per-thread clocks cannot undercount — the robust total for capacity
    # projections (per-thread stage cpu_seconds give the breakdown)
    import resource as _resource

    _ru0 = _resource.getrusage(_resource.RUSAGE_SELF)
    n_total = len(files)
    width = 4 + (len(EXTENDED_FEATURE_NAMES) if extended else 0)
    result = ScanResult(
        list(files),
        np.full((n_total, 4), np.nan, np.float32),
        np.zeros(n_total, bool),
        {},
        {},
        np.full((n_total, width - 4), np.nan, np.float32) if extended else None,
    )
    features, ok, errors = result.features, result.ok, result.errors
    done = 0

    # --- feature-store lookups (resume) -------------------------------------
    # Entries are keyed by (content fingerprint, analysis config): a scan
    # with a different filterbank/dtype/kernel path must re-analyze rather
    # than silently reuse vectors from another configuration — even
    # "equivalent" float32 paths can flip an epsilon-marginal beat. Only
    # pad_multiple is excluded: padding leaves a song's beats as they are
    # and moves its float32 amplitude by summation order only (tested).
    # The config has bliss_tpu's fields, so for_gpu() and for_tpu() share
    # a key, and a store written by either package resumes in the other.
    cfg_fields = dataclasses.asdict(cfg)
    cfg_fields.pop("pad_multiple", None)
    cfg_key = hashlib.sha1(repr(sorted(cfg_fields.items())).encode()).hexdigest()[:8]

    todo: list[int] = []
    fps: dict[int, str] = {}
    if store is not None:
        with timer.stage("fingerprint"):
            for i, f in enumerate(files):
                try:
                    # stat-prescreened: unchanged files (size+mtime) reuse
                    # their cached content hash without re-reading bytes
                    fp = store.fingerprint(f) + "-" + cfg_key
                except OSError as e:
                    errors[f] = f"stat/read failed: {e}"
                    continue
                fps[i] = fp
                cached = store.get(fp)
                if cached is not None and cached.shape[0] == width:
                    features[i] = cached[:4]
                    if extended:
                        result.extended[i] = cached[4:]
                    ok[i] = True
                else:
                    todo.append(i)
        done = int(ok.sum())
        log_event(
            logger, "store lookup", cached=done, todo=len(todo), total=n_total
        )
    else:
        todo = [i for i, f in enumerate(files) if f not in errors]

    # keep ~one batch of decoded songs in flight so device waits never
    # starve the decoders (iter_decode's window is workers * prefetch, so
    # divide by the EFFECTIVE worker count or a many-core host would buffer
    # workers * batch_size songs)
    eff_workers = num_decode_workers or min(32, (os.cpu_count() or 8))
    decode_perf: dict = {}
    stream = iter_decode(
        [files[i] for i in todo],
        num_workers=num_decode_workers,
        prefetch=max(2, batch_size // eff_workers),
        on_error="skip",
        perf=decode_perf,
    )
    cancelled = _scan(
        result,
        ((j, decoded) for j, (_, decoded) in zip(todo, stream)),
        cfg=cfg,
        batch_size=batch_size,
        device=device,
        timer=timer,
        done=done,
        store=store,
        fps=fps,
        progress=progress,
        cancel=cancel,
        handle_sigint=handle_sigint,
        long_song_samples=long_song_samples,
        extended=extended,
        mesh=mesh,
    )

    stats = timer.report()
    stats["errors"] = len(errors)
    stats["cancelled"] = cancelled
    # summed per-file decode wall time across worker threads (core-seconds)
    stats["decode_core_seconds"] = round(
        decode_perf.get("decode_seconds", 0.0), 4
    )
    # summed per-file thread CPU time: what the decode actually COSTS in
    # core-seconds, independent of scheduler contention — capacity
    # projections must divide this, not wall (on a contended host the wall
    # number absorbs time spent descheduled behind the pad/dispatch work)
    stats["decode_cpu_seconds"] = round(
        decode_perf.get("decode_cpu_seconds", 0.0), 4
    )
    stats["decoded"] = decode_perf.get("decoded", 0)
    _ru1 = _resource.getrusage(_resource.RUSAGE_SELF)
    stats["scan_process_cpu_seconds"] = round(
        (_ru1.ru_utime - _ru0.ru_utime) + (_ru1.ru_stime - _ru0.ru_stime), 4
    )
    log_event(logger, "scan complete", total=n_total, ok=int(ok.sum()), **{
        k: v["seconds"] for k, v in timer.report().items()
    })
    result.stats = stats
    return result


def _scan(
    result: ScanResult,
    decoded_stream,
    *,
    cfg: AnalysisConfig,
    batch_size: int,
    device: torch.device,
    timer: StageTimer,
    done: int = 0,
    store: FeatureStore | None = None,
    fps: dict[int, str] | None = None,
    progress=None,
    cancel=None,
    handle_sigint: bool = False,
    long_song_samples: int | None = LONG_SONG_SAMPLES,
    extended: bool = False,
    mesh=None,
) -> bool:
    """``analyze_library``'s loop after decode: takes ``(index, DecodedAudio
    | None)`` pairs in scan order (None: the file failed to decode), buckets
    them, dispatches full buckets and the rest at the end, streams each song
    longer than ``long_song_samples`` on the pool thread, and writes each
    song's row, ``ok`` flag or error into ``result`` (and ``store``, for the
    indices in ``fps``); with ``extended`` also each song's extended row
    into ``result.extended`` (made NaN here if it is None), and 49-column
    store entries; with a ``mesh``, the buckets go over it and the long
    songs stream on ``device``. Returns whether the scan was cancelled."""
    check_supported(cfg)
    files, features, ok, errors = result.files, result.features, result.ok, result.errors
    if extended and result.extended is None:
        result.extended = np.full((len(files), len(EXTENDED_FEATURE_NAMES)), np.nan, np.float32)
    fps = fps or {}
    n_total = len(files)

    def _progress(msg):
        if progress:
            progress(done, n_total, msg)

    # --- decode stream -> buckets -> device ---------------------------------
    # Device work is dispatched asynchronously: up to `max_in_flight` batches
    # compute/transfer while host threads keep decoding. The blocking half
    # (device fetch + host envelope finish) runs on a background thread so
    # the decode stream never stalls behind a device wait.
    from concurrent.futures import ThreadPoolExecutor

    buckets: dict[int, list] = {}
    in_flight: list = []  # (entries, L or "stream", Future[features])
    max_in_flight = 2
    finalize_pool = ThreadPoolExecutor(max_workers=1)

    def dispatch_bucket(L: int, entries: list) -> None:
        pad = batch_size - len(entries)
        arrays = [d.samples for _, d in entries]
        durs = [d.duration for _, d in entries]
        if pad:
            arrays += [np.zeros(1024, np.int16)] * pad
            # dummy rows: a blip avoids degenerate all-zero songs
            for a in arrays[len(entries):]:
                a[100] = 1000
            durs += [1] * pad
        with timer.stage("pad"):
            # np.zeros + row copy, deliberately. The "obvious" win —
            # np.empty + per-row fill + tail zero, writing each byte once —
            # measures ~45% faster in steady-state microbenchmarks but has
            # a catastrophic first-call mode on fresh mmap'd pages (12 s
            # for one 128 MB batch vs 0.1 s, measured for bliss_tpu's
            # pipeline; huge-page/host allocation stalls when every page is
            # dirtied sequentially). zeros() never touches the tail pages beyond
            # each row's PCM, so it faults less and is consistently fast.
            # Negative result recorded so it isn't retried.
            samples = np.zeros((batch_size, L), np.int16)
            for r, a in enumerate(arrays):
                samples[r, : a.shape[0]] = a
            n_samples = np.array([a.shape[0] for a in arrays], np.int32)
            durations = np.array(durs, np.int32)
        with timer.stage("device_dispatch"):
            fin = _dispatch_analysis(samples, n_samples, durations, cfg, device, extended, mesh)

        def timed_fin(fin=fin):
            # time INSIDE the pool thread: thread_time() from the main
            # thread would charge ~0 CPU to the finalize stage (the fetch
            # copy and any float64 host finish burn their CPU here, not
            # in the fut.result() wait)
            with timer.stage("device_finalize"):
                return fin()

        in_flight.append((entries, L, finalize_pool.submit(timed_fin)))
        while len(in_flight) > max_in_flight:
            finalize_oldest()

    def finalize_oldest() -> None:
        nonlocal done
        entries, L, fut = in_flight.pop(0)
        with timer.stage("finalize_wait"):
            # main-thread wait (wall only meaningful; its cpu_seconds ~ 0
            # by construction — the work is timed in the pool thread)
            feats = fut.result()
        for (i, d), row in zip(entries, feats):
            features[i] = row[:4]
            if extended:
                result.extended[i] = row[4:]
            ok[i] = True
            done += 1
            if store is not None and i in fps:
                store.put(
                    fps[i],
                    row,
                    {
                        "filename": files[i],
                        "title": d.title,
                        "artist": d.artist,
                        "album": d.album,
                        "genre": d.genre,
                        "tracknumber": d.tracknumber,
                    },
                )
        if store is not None:
            with timer.stage("store_flush"):
                store.flush()
        _progress(f"analyzed batch of {len(entries)} (L={L})")

    # --- cancellation: Ctrl-C (main thread) or a caller-supplied Event ------
    import signal
    import threading

    sigint_seen = threading.Event()
    prev_handler = None
    handler_installed = False  # signal.signal can RETURN None (handler
    # installed outside Python), so track installation separately to
    # restore unconditionally

    def _on_sigint(signum, frame):
        if sigint_seen.is_set():  # second Ctrl-C: abort for real
            raise KeyboardInterrupt
        sigint_seen.set()
        _progress("cancelling: draining in-flight batches (Ctrl-C again to abort)")

    def _cancelled() -> bool:
        return sigint_seen.is_set() or (cancel is not None and cancel.is_set())

    if handle_sigint and threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGINT, _on_sigint)
        handler_installed = True

    try:
        with timer.stage("scan"):
            for j, decoded in decoded_stream:
                if _cancelled():
                    break
                if decoded is None:
                    errors[files[j]] = "decode failed"
                    done += 1
                    _progress(f"skipped {files[j]}")
                    continue
                if (
                    long_song_samples is not None
                    and decoded.n_samples > long_song_samples
                    and streaming_supports(cfg)
                ):
                    # streamed alone on the finalize thread, so the decode
                    # stream and the batches keep flowing; its row rides
                    # the in_flight/finalize_oldest path like a batch's
                    def _stream_one(d=decoded):
                        with timer.stage("streaming"):
                            return analyze_song_streaming(
                                d.samples, d.duration, cfg, extended=extended, device=device
                            )[None, :]

                    in_flight.append(
                        ([(j, decoded)], "stream", finalize_pool.submit(_stream_one))
                    )
                    while len(in_flight) > max_in_flight:
                        finalize_oldest()
                    continue
                L = _bucket_length(decoded.n_samples, cfg.pad_multiple)
                buckets.setdefault(L, []).append((j, decoded))
                if len(buckets[L]) == batch_size:
                    dispatch_bucket(L, buckets.pop(L))
            if not _cancelled():
                for L in sorted(buckets):
                    dispatch_bucket(L, buckets.pop(L))
            else:
                # decoded-but-undispatched songs are dropped; they resume
                # from the store on the next run
                buckets.clear()
            while in_flight:
                finalize_oldest()
    finally:
        if handler_installed:
            signal.signal(
                signal.SIGINT,
                prev_handler if prev_handler is not None else signal.SIG_DFL,
            )
        finalize_pool.shutdown(wait=False)
        if store is not None:
            store.flush()
    return _cancelled()
