"""Command-line interface of the port (counterpart of ``bliss_tpu/cli.py``,
with the same commands, arguments and output):

  analyze        — per-song report           (reference: examples/analyze.c)
  distance       — pairwise distance+cosine  (reference: examples/distance.c)
  ml-analyze     — CSV for ML pipelines      (reference: examples/ml_analyze.c)
  detect-gapless — gapless transition check  (reference: examples/detect-gapless.c)
  playlist       — seed-song .m3u playlist   (reference: python/examples/make_m3u_playlist.py)
  scan           — batch-analyze a library to CSV with resume + progress
                   (reference: python/examples/analyze_gui.py, sans GTK)
  radio          — k-means auto-playlists over the library
  store          — feature-store stats / compact / export / prune /
                   neighbors / dupes
  gui            — tkinter library scanner (the reference's GTK GUI)
  doctor         — environment checks: native decoder, decode round trip,
                   CUDA backend, device dispatch, store
  serve          — the resident analysis daemon (JSON lines over a socket,
                   and/or HTTP)
  call           — send one JSON request to a running daemon
  version        — framework + native decoder versions

Every command that analyzes or compares songs, ``gui`` and ``serve`` run on
``--device`` (default ``cuda``, env fallback ``BLISS_TPU_TORCH_DEVICE``);
without a GPU such a command fails unless it is given ``--device cpu``, and
never falls back to the CPU; ``doctor`` reports the device's checks as
failed instead. ``--extended`` adds the 45 extended features to ``analyze``'s
report, ``scan``'s CSV and store rows, and ``radio``'s clustering.
``--bands`` and ``--filterbank firwin|reference5|reference36`` select the
tempo filterbank. ``--mesh N`` or ``NxM`` (``ml-analyze``, ``playlist``,
``scan``, ``radio``, ``serve``) analyzes the buckets over an N x M
('data' x 'seq') device mesh (``bliss_tpu_torch.parallel``): the first N·M
CUDA devices under ``--device cuda``, the CPU repeated N·M times under
``--device cpu``, as JAX's virtual host devices. A config that
``check_supported`` refuses exits with status 2 before any decode, store
write or bind.

Run: python -m bliss_tpu_torch.cli <command> ...
"""

from __future__ import annotations

import argparse
import csv
import mimetypes
import os
import sys

import numpy as np
import torch

from bliss_tpu_torch.config import check_supported
from bliss_tpu_torch.features.types import resolve_device


def is_audio_filename(name: str) -> bool:
    """Mimetype-based audio filter shared by every scanner surface (the
    filter the reference playlist example uses)."""
    t, _ = mimetypes.guess_type(name)
    return bool(t) and t.startswith("audio")


def _collect_audio_files(paths: list[str]) -> list[str]:
    """Expand directories into audio files by mimetype."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                for n in sorted(names):
                    if is_audio_filename(n):
                        out.append(os.path.join(root, n))
        else:
            out.append(p)
    return out


def _device(args) -> torch.device:
    """``--device`` as a torch device; a CUDA device without a GPU stops
    the command with ``resolve_device``'s error."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bliss-tpu-torch: {e}") from None


def _band_config(args):
    """AnalysisConfig honoring --bands / --filterbank (None = defaults)."""
    import dataclasses

    from bliss_tpu_torch.api import default_config

    cfg = default_config()
    kw = {}
    if getattr(args, "filterbank", None):
        # reset the resolved shape so the new filterbank re-resolves it
        # (an explicit conflicting --bands still errors in __post_init__)
        kw["filterbank"] = args.filterbank
        kw["nb_bands"] = None
        kw["band_taps"] = None
    if getattr(args, "bands", None):
        kw["nb_bands"] = args.bands
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _parse_mesh(spec, device: torch.device):
    """'4' -> 4-way data parallel; '4x2' -> (data=4, seq=2) mesh, over the
    first CUDA devices under a CUDA ``device``, over ``device`` repeated
    otherwise (the CPU's counterpart of JAX's virtual host devices)."""
    if not spec:
        return None
    from bliss_tpu_torch.parallel import analysis_mesh

    parts = spec.lower().split("x")
    try:
        if len(parts) > 2:
            raise ValueError("too many axes")
        n_data = int(parts[0])
        n_seq = int(parts[1]) if len(parts) > 1 else 1
        if n_data < 1 or n_seq < 1:
            raise ValueError("an empty axis")
    except ValueError:
        raise SystemExit(
            f"--mesh {spec!r}: expected 'N' or 'NxM' (data x seq shards)"
        )
    need = n_data * n_seq
    if device.type != "cuda":
        return analysis_mesh(n_data, n_seq, devices=[device] * need)
    have = torch.cuda.device_count()
    if need > have:
        raise SystemExit(f"--mesh {spec!r} needs {need} devices, have {have}")
    return analysis_mesh(n_data, n_seq, devices=[torch.device("cuda", i) for i in range(need)])


def _unported(args) -> str | None:
    """Why ``args`` asks for a config ``check_supported`` refuses, or
    None."""
    if hasattr(args, "filterbank"):
        try:
            check_supported(_band_config(args))
        except ValueError as e:
            return str(e)
    return None


def _add_band_opts(parser) -> None:
    parser.add_argument(
        "--bands", type=int, default=None,
        help="multi-band tempo front-end: number of firwin bands (the"
        " reference cut multi-band 'for CPU-consumption reasons')",
    )
    parser.add_argument(
        "--filterbank", default=None,
        choices=["firwin", "reference5", "reference36"],
        help="filterbank design; reference5/reference36 are the reference's own"
        " coefficient tables",
    )


def _add_mesh_opt(parser) -> None:
    parser.add_argument(
        "--mesh", default=None,
        help="shard analysis over a device mesh: '4' = 4-way data parallel,"
        " '4x2' = 4 data x 2 sequence shards (--device cpu: the CPU repeated)",
    )


def cmd_analyze(args) -> int:
    from bliss_tpu_torch import api

    device = _device(args)
    status = 0
    for f in args.files:
        try:
            s = api.analyze(f, cfg=_band_config(args), device=device)
        except Exception as e:  # noqa: BLE001 - CLI reports and continues
            print(f"Couldn't analyze {f}: {e}", file=sys.stderr)
            status = 1
            continue
        label = {0: "Loud", 1: "Calm"}.get(s.calm_or_loud, "Unknown")
        fv = s.force_vector
        print(f"Analysis for music: {f}")
        print("Note: every value here is *after* resampling")
        print(f"Force: {s.force:f}")
        print(
            f"Force vector: ({fv.tempo:f}, {fv.amplitude:f}, "
            f"{fv.frequency:f}, {fv.attack:f})"
        )
        print(f"Channels: {s.channels}")
        print(f"Number of samples: {s.nSamples}")
        print(f"Sample rate: {s.sample_rate}")
        print(f"Bitrate: {s.bitrate}")
        print(f"Number of bytes per sample: {s.nb_bytes_per_sample}")
        print(f"Calm or loud: {label}")
        print(f"Duration: {s.duration}")
        print(f"Artist: {s.artist}")
        print(f"Title: {s.title}")
        print(f"Album: {s.album}")
        print(f"Track number: {s.tracknumber}")
        print(f"Genre: {s.genre}")
        if args.extended:
            for name, value in s.extended_analysis(_band_config(args), device=device).items():
                print(f"{name}: {value:f}")
    return status


def cmd_distance(args) -> int:
    from bliss_tpu_torch import api

    device = _device(args)
    s1 = api.analyze(args.file1, device=device)
    s2 = api.analyze(args.file2, device=device)
    d = api.distance(s1, s2, device=device)
    c = api.cosine_similarity(s1, s2, device=device)
    print(f"Distance between the two songs: {d:f}")
    print(f"Cosine similarity between the two songs: {c:f}")
    return 0


def cmd_ml_analyze(args) -> int:
    from bliss_tpu_torch.io import probe
    from bliss_tpu_torch.pipeline import analyze_library

    device = _device(args)
    mesh = _parse_mesh(args.mesh, device)
    files = _collect_audio_files(args.files)
    result = analyze_library(files, batch_size=args.batch_size, mesh=mesh, device=device)
    out = open(args.output, "w", newline="") if args.output else sys.stdout
    try:
        # csv.writer quotes a title containing the ';' delimiter (byte-
        # identical to the reference's raw printf otherwise,
        # reference examples/ml_analyze.c:18-20)
        w = csv.writer(out, delimiter=";")
        for i, f in enumerate(files):
            if not result.ok[i]:
                continue
            title = os.path.splitext(os.path.basename(f))[0]
            if args.tags:
                try:
                    # metadata-only probe: no second PCM decode per song
                    title = probe(f).title
                except Exception:  # noqa: BLE001
                    pass
            t, a, fr, k = result.features[i]
            w.writerow([title] + [f"{v:f}" for v in (t, a, fr, k)])
    finally:
        if args.output:
            out.close()
    return 0


def cmd_detect_gapless(args) -> int:
    from bliss_tpu_torch.io import decode

    s1 = decode(args.file1)
    s2 = decode(args.file2)
    tail = s1.samples[-2:].astype(np.float32)
    head = s2.samples[:2].astype(np.float32)
    print("Song 1")
    print(int(tail[0]))
    print(int(tail[1]))
    print("Song 2")
    print(int(head[0]))
    print(int(head[1]))
    diffs = [1.0, 1.0]
    for ch in (0, 1):
        if abs(tail[ch]) >= 5 and abs(head[ch]) >= 5:
            diffs[ch] = abs((tail[ch] - head[ch]) / 32767.0)
    print(f"Difference between two songs (channel 1): {diffs[0]:f}")
    print(f"Difference between two songs (channel 2): {diffs[1]:f}")
    if min(diffs) < args.threshold:
        print("Gapless!")
        return 1
    print("Not Gapless.")
    return 0


def cmd_playlist(args) -> int:
    from bliss_tpu_torch.pipeline import analyze_library
    from bliss_tpu_torch.sim import playlist_order
    from bliss_tpu_torch.store import FeatureStore

    device = _device(args)
    mesh = _parse_mesh(args.mesh, device)
    files = _collect_audio_files(args.paths)
    if args.seed not in files:
        files = [args.seed] + files
    store = FeatureStore(args.store) if args.store else None
    result = analyze_library(
        files, store=store, batch_size=args.batch_size, mesh=mesh, device=device
    )
    valid = [i for i in range(len(files)) if result.ok[i]]
    feats = result.features[valid]
    seed_pos = valid.index(files.index(args.seed))
    order = playlist_order(feats, seed_pos, device=device).cpu().numpy()
    with open(args.output, "w") as f:
        f.write("#EXTM3U\n")
        for idx in order[: args.length or len(order)]:
            f.write(os.path.abspath(files[valid[idx]]) + "\n")
    print(f"wrote {args.output} ({len(order)} tracks, seed {args.seed})")
    return 0


def cmd_scan(args) -> int:
    from bliss_tpu_torch.pipeline import analyze_library
    from bliss_tpu_torch.store import FeatureStore

    device = _device(args)
    mesh = _parse_mesh(args.mesh, device)
    files = _collect_audio_files(args.paths)
    store = FeatureStore(args.store) if args.store else None

    def progress(done, total, msg):
        pct = 100.0 * done / max(total, 1)
        print(f"\r[{pct:5.1f}%] {done}/{total} {msg[:60]:60s}", end="", file=sys.stderr)

    result = analyze_library(
        files, cfg=_band_config(args), store=store,
        batch_size=args.batch_size, progress=progress, extended=args.extended,
        mesh=mesh, device=device,
    )
    print("", file=sys.stderr)
    from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES

    with open(args.output, "w", newline="") as f:
        # csv.writer so a filename containing ';' is quoted, not column-
        # shifting (byte-identical to raw joins otherwise)
        w = csv.writer(f, delimiter=";")
        header = ["filename", "tempo", "amplitude", "frequency", "attack", "force"]
        if args.extended:
            header += list(EXTENDED_FEATURE_NAMES)
        w.writerow(header)
        force = result.force()
        for i, name in enumerate(files):
            if not result.ok[i]:
                continue
            t, a, fr, k = result.features[i]
            row = [name] + [f"{v:f}" for v in (t, a, fr, k, force[i])]
            if args.extended:
                row += [f"{v:f}" for v in result.extended[i]]
            w.writerow(row)
    bad = [f for f in result.errors]
    print(
        f"scanned {int(result.ok.sum())}/{len(files)} songs -> {args.output}"
        + (f" ({len(bad)} failed)" if bad else "")
    )
    if result.stats.get("cancelled"):
        print(
            "scan cancelled; completed work is in the store — rerun the "
            "same command to resume",
            file=sys.stderr,
        )
        return 130
    return 0


def cmd_radio(args) -> int:
    from bliss_tpu_torch.pipeline import analyze_library
    from bliss_tpu_torch.sim import kmeans
    from bliss_tpu_torch.store import FeatureStore

    device = _device(args)
    mesh = _parse_mesh(args.mesh, device)
    files = _collect_audio_files(args.paths)
    store = FeatureStore(args.store) if args.store else None
    result = analyze_library(
        files, cfg=_band_config(args), store=store,
        batch_size=args.batch_size, extended=args.extended, mesh=mesh, device=device,
    )
    valid = [i for i in range(len(files)) if result.ok[i]]
    feats = result.features[valid]
    if args.extended:
        # z-score the richer vectors so every feature contributes equally
        full = np.concatenate([feats, result.extended[valid]], axis=1)
        mu, sd = full.mean(0), full.std(0)
        feats = (full - mu) / np.maximum(sd, 1e-6)
    _, assign = kmeans(feats, k=args.clusters, iters=50, device=device)
    assign = assign.cpu().numpy()
    for c in range(args.clusters):
        out = os.path.join(args.output_dir, f"radio-{c:02d}.m3u")
        members = [valid[i] for i in np.where(assign == c)[0]]
        with open(out, "w") as f:
            f.write("#EXTM3U\n")
            for m in members:
                f.write(os.path.abspath(files[m]) + "\n")
        print(f"{out}: {len(members)} tracks")
    return 0


def _open_output(path: str):
    return sys.stdout if path == "-" else open(path, "w", newline="")


def _nearest(args, feats, k):
    """(distances, indices) [N, k] of every store row's k nearest others,
    on ``--device``, copied back once."""
    from bliss_tpu_torch.sim import nearest_neighbors_all

    dists, idx = nearest_neighbors_all(feats, k, device=_device(args))
    return dists.cpu().numpy(), idx.cpu().numpy()


def cmd_store(args) -> int:
    """Inspect / maintain a feature store."""
    from bliss_tpu_torch.store import FeatureStore, similarity_rows

    store = FeatureStore(args.store)
    if args.action == "stats":
        widths = {}
        for _, v in store.items():
            widths[v.shape[0]] = widths.get(v.shape[0], 0) + 1
        shards = [
            f for f in os.listdir(args.store) if f.endswith(".npz")
        ]
        print(f"entries: {len(store)}")
        print(f"shards:  {len(shards)}")
        for w, c in sorted(widths.items()):
            kind = "core" if w == 4 else f"core+extended({w - 4})"
            print(f"  width {w} ({kind}): {c}")
        return 0
    if args.action == "compact":
        before = len(
            [f for f in os.listdir(args.store) if f.endswith(".npz")]
        )
        store.compact()
        after = len(
            [f for f in os.listdir(args.store) if f.endswith(".npz")]
        )
        print(f"compacted {before} shard(s) -> {after}")
        return 0
    if args.action == "export":
        # warm-store CSV: everything a `scan` run writes, straight from the
        # store with zero decode/analysis, plus the metadata tags. The csv
        # module quotes tag values that contain the ';' delimiter (the
        # reference GUI's csv.writer does the same for its comma CSV,
        # reference python/examples/analyze_gui.py:37-41).
        from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES

        rows = store.snapshot()
        has_ext = any(v.shape[0] > 4 for _, v, _ in rows)
        tag_cols = ("title", "artist", "album", "genre", "tracknumber")
        out = _open_output(args.output)
        try:
            w = csv.writer(out, delimiter=";")
            header = ["filename", *tag_cols,
                      "tempo", "amplitude", "frequency", "attack", "force"]
            if has_ext:
                header += list(EXTENDED_FEATURE_NAMES)
            w.writerow(header)
            for key, v, meta in rows:
                t, a, fr, k = (float(x) for x in v[:4])
                # same aggregation as ScanResult.force / force_and_class
                # (reference: src/analyze.c:67-79)
                force = float(np.maximum(t, 0.0) + a + fr + np.maximum(k, 0.0))
                row = [
                    str(meta.get("filename", key)),
                    *(str(meta.get(c, "")) for c in tag_cols),
                    *(f"{x:f}" for x in (t, a, fr, k, force)),
                ]
                if has_ext:
                    ext = [f"{float(x):f}" for x in v[4:]]
                    ext += [""] * (len(EXTENDED_FEATURE_NAMES) - len(ext))
                    row += ext
                w.writerow(row)
        finally:
            if out is not sys.stdout:
                out.close()
        if args.output != "-":
            print(f"exported {len(rows)} entries -> {args.output}")
        return 0
    if args.action == "neighbors":
        # every song's k closest others, straight from the warm store with
        # zero re-analysis: blocked distance products and top-k on the
        # device over the whole library
        if args.top_k < 1:
            print(f"--top-k must be >= 1 (got {args.top_k})", file=sys.stderr)
            return 2
        names, feats = similarity_rows(store)
        if len(names) < 2:
            print("need at least 2 store entries", file=sys.stderr)
            return 2
        k = min(args.top_k, len(names) - 1)
        dists, idx = _nearest(args, feats, k)
        out = _open_output(args.output)
        try:
            w = csv.writer(out, delimiter=";")
            w.writerow(["filename"] + [
                c for j in range(k)
                for c in (f"neighbor{j + 1}", f"distance{j + 1}")
            ])
            for i, name in enumerate(names):
                cells = []
                for j in range(k):
                    cells += [names[idx[i, j]], f"{dists[i, j]:f}"]
                w.writerow([name] + cells)
        finally:
            if out is not sys.stdout:
                out.close()
        if args.output != "-":
            print(f"wrote {len(names)} x top-{k} neighbors -> {args.output}")
        return 0
    if args.action == "dupes":
        # perceptual duplicates from the warm store: pairs closer than
        # --threshold in force-vector space. Bit-identical copies never
        # even appear here (the store is content-keyed, so they collapse
        # to one entry) — this finds different ENCODINGS/masters of the
        # same recording; unrelated songs are many units apart.
        names, feats = similarity_rows(store)
        if len(names) < 2:
            print("need at least 2 store entries", file=sys.stderr)
            return 2
        k = min(max(args.top_k, 1), len(names) - 1)
        dists, idx = _nearest(args, feats, k)
        pairs: dict[tuple[int, int], float] = {}
        for i in range(len(names)):
            for j in range(k):
                d = float(dists[i, j])
                if d <= args.threshold:
                    a, b = sorted((i, int(idx[i, j])))
                    pairs[(a, b)] = min(d, pairs.get((a, b), np.inf))
        out = _open_output(args.output)
        try:
            w = csv.writer(out, delimiter=";")
            w.writerow(["song_a", "song_b", "distance"])
            for (a, b), d in sorted(pairs.items(), key=lambda kv: kv[1]):
                w.writerow([names[a], names[b], f"{d:f}"])
        finally:
            if out is not sys.stdout:
                out.close()
        if args.output != "-":
            print(f"wrote {len(pairs)} candidate pair(s) -> {args.output}")
        return 0
    if args.action == "prune":
        # drop entries whose source file no longer exists on disk; entries
        # with no recorded filename (pre-metadata stores) are kept
        gone = [
            key
            for key, _ in list(store.items())
            if store.metadata(key).get("filename")
            and not os.path.exists(store.metadata(key)["filename"])
        ]
        for key in gone:
            store.remove(key)
        if gone:
            store.compact()
        print(f"pruned {len(gone)} entries ({len(store)} remain)")
        return 0
    print(f"unknown store action {args.action}", file=sys.stderr)
    return 2


def cmd_version(args) -> int:
    import bliss_tpu_torch
    from bliss_tpu_torch.io import native_version

    print(f"bliss-tpu-torch {bliss_tpu_torch.version()} (decoder: {native_version()})")
    return 0


def cmd_doctor(args) -> int:
    """Diagnose the runtime environment: native build, decode round-trip,
    CUDA backend acquisition and device dispatch latency on ``--device``
    (each bounded by ``--timeout``: a wedged device must FAIL the check, not
    hang the doctor), optional store health. Exit 0 iff every check
    passes."""
    import threading
    import time

    failures = 0

    def check(name, fn, detail_fmt=str):
        nonlocal failures
        try:
            detail = fn()
        except Exception as e:  # noqa: BLE001 — each check reports its own
            failures += 1
            print(f"FAIL {name}: {type(e).__name__}: {e}")
        else:
            print(f"  ok {name}: {detail_fmt(detail)}")

    def bounded(fn, seconds):
        """Run fn on a side thread with a wall-clock bound."""
        box = []

        def run():
            try:
                box.append(("ok", fn()))
            except Exception as e:  # noqa: BLE001 — re-raised below
                box.append(("err", e))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(seconds)
        if not box:
            raise TimeoutError(
                f"still blocked after {seconds:.0f}s (hung device?)"
            )
        kind, val = box[0]
        if kind == "err":
            raise val
        return val

    import bliss_tpu_torch

    print(f"bliss-tpu-torch {bliss_tpu_torch.version()} (torch {torch.__version__},"
          f" CUDA {torch.version.cuda})")

    def _native():
        from bliss_tpu_torch.io import native_version

        return native_version()

    check("native decoder build", _native)

    def _roundtrip():
        import tempfile

        from bliss_tpu_torch.io import decode
        from bliss_tpu_torch.io.flac_writer import write_flac

        pcm = (np.random.RandomState(0).randn(22050, 2) * 3000).astype(
            np.int16
        )
        with tempfile.TemporaryDirectory() as tmp:
            p = os.path.join(tmp, "doctor.flac")
            write_flac(p, pcm, 22050)
            d = decode(p)
        if d.sample_rate != 22050 or d.n_samples < 2 * 22050:
            raise RuntimeError(
                f"decode mismatch: rate={d.sample_rate} n={d.n_samples}"
            )
        return f"1s FLAC encode->decode ({d.n_samples} samples)"

    check("decode round-trip", _roundtrip)

    def _backend():
        def acquire():
            dev = resolve_device(args.device)
            if dev.type != "cuda":
                return f"{dev.type} (1 device(s))"
            return (f"cuda ({torch.cuda.device_count()} device(s)); {dev}: "
                    f"{torch.cuda.get_device_name(dev)}")

        return bounded(acquire, args.timeout)

    check("backend acquisition", _backend)

    def _dispatch():
        def once():
            dev = resolve_device(args.device)
            t0 = time.perf_counter()
            x = torch.ones(1, dtype=torch.float32).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if float(x.cpu()[0]) != 1.0:
                raise RuntimeError("the round trip changed the value")
            return f"host->{dev}->host in {(time.perf_counter() - t0) * 1e3:.1f} ms"

        return bounded(once, args.timeout)

    check("device dispatch", _dispatch)

    if args.store:
        def _store():
            from bliss_tpu_torch.store import FeatureStore

            store = FeatureStore(args.store)
            return f"{len(store)} entr{'y' if len(store) == 1 else 'ies'}"

        check("feature store", _store)

    print("all checks passed" if not failures
          else f"{failures} check(s) FAILED")
    return 0 if not failures else 1


def cmd_gui(args) -> int:
    from bliss_tpu_torch.gui import main as gui_main

    return gui_main(_device(args))


def cmd_call(args) -> int:
    import json
    import socket as _socket

    from bliss_tpu_torch.server import request

    if (args.socket is None) == (args.port is None):
        raise SystemExit("call: pass exactly one of --socket / --port")
    raw = args.request
    if raw is None or raw == "-":
        raw = sys.stdin.read()
    try:
        req = json.loads(raw)
    except ValueError as e:
        raise SystemExit(f"call: request is not valid JSON: {e}")
    try:
        resp = request(
            req, args.socket, port=args.port, timeout=args.timeout,
            on_event=lambda e: print(json.dumps(e), file=sys.stderr),
        )
    except _socket.timeout:
        raise SystemExit(
            f"call: no response after {args.timeout:g}s — the daemon may "
            "still be working (raise --timeout, or add \"progress\": true "
            "to scan requests to keep the connection active)"
        )
    print(json.dumps(resp, indent=2, sort_keys=True))
    return 0 if resp.get("ok") else 1


def cmd_serve(args) -> int:
    from bliss_tpu_torch.server import AnalysisServer
    from bliss_tpu_torch.store import FeatureStore

    if args.socket is not None and args.port is not None:
        raise SystemExit("serve: pass at most one of --socket / --port")
    if args.socket is None and args.port is None and args.http_port is None:
        raise SystemExit("serve: pass --socket, --port, or --http-port")
    device = _device(args)  # no GPU: stop before any store, warmup or bind
    mesh = _parse_mesh(args.mesh, device)
    server = AnalysisServer(
        args.socket,
        port=args.port,
        cfg=_band_config(args),
        store=FeatureStore(args.store) if args.store else None,
        batch_size=args.batch_size,
        mesh=mesh,
        health_probe_interval=args.health_probe or None,
        device=device,
    )
    if not args.no_warmup:
        print("warming up (building and launching the kernels)...", file=sys.stderr)
        server.warmup()
    gateway = None
    if args.http_port is not None:
        from bliss_tpu_torch.http_gateway import HttpGateway

        try:
            gateway = HttpGateway(server, args.http_port)
        except OSError as e:
            raise SystemExit(f"serve: --http-port {args.http_port}: {e}")
        gateway.start()
        print(f"http on 127.0.0.1:{gateway.port}", file=sys.stderr)
    if args.socket is None and args.port is None:
        # HTTP-only: the gateway thread serves; block until shutdown
        print("serving (Ctrl-C to stop)", file=sys.stderr)
        try:
            server.wait_stopped()
        except KeyboardInterrupt:
            pass
        gateway.stop()
        return 0
    # bind before announcing so an ephemeral --port 0 prints the REAL port
    try:
        server.bind()
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}")
    where = args.socket or f"127.0.0.1:{server.port}"
    print(f"serving on {where} (Ctrl-C to stop)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    finally:
        if gateway is not None:
            gateway.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bliss-tpu-torch",
        description="music analysis on an NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument(
        "--device",
        default=os.environ.get("BLISS_TPU_TORCH_DEVICE", "cuda"),
        help="torch device the analysis and similarity run on ('cuda',"
        " 'cuda:1', 'cpu'); without a GPU, 'cuda' fails rather than running"
        " on the CPU (env fallback: BLISS_TPU_TORCH_DEVICE)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="analyze songs and print reports")
    a.add_argument("files", nargs="+")
    a.add_argument(
        "--extended", action="store_true",
        help="also print the extended feature set",
    )
    _add_band_opts(a)
    a.set_defaults(fn=cmd_analyze)

    d = sub.add_parser("distance", help="distance + cosine similarity of two songs")
    d.add_argument("file1")
    d.add_argument("file2")
    d.set_defaults(fn=cmd_distance)

    m = sub.add_parser("ml-analyze", help="CSV: title;tempo;amplitude;frequency;attack")
    m.add_argument("files", nargs="+")
    m.add_argument("-o", "--output", default=None)
    m.add_argument("--tags", action="store_true", help="use title tags")
    m.add_argument("--batch-size", type=int, default=16)
    _add_mesh_opt(m)
    m.set_defaults(fn=cmd_ml_analyze)

    g = sub.add_parser("detect-gapless", help="detect gapless album transitions")
    g.add_argument("file1")
    g.add_argument("file2")
    g.add_argument("--threshold", type=float, default=0.01)
    g.set_defaults(fn=cmd_detect_gapless)

    pl = sub.add_parser("playlist", help="write an .m3u ordered by similarity to a seed")
    pl.add_argument("seed")
    pl.add_argument("paths", nargs="+")
    pl.add_argument("-o", "--output", default="playlist.m3u")
    pl.add_argument("--length", type=int, default=None)
    pl.add_argument("--store", default=None, help="feature store dir (resume)")
    pl.add_argument("--batch-size", type=int, default=16)
    _add_mesh_opt(pl)
    pl.set_defaults(fn=cmd_playlist)

    sc = sub.add_parser("scan", help="batch-analyze a library to CSV (resumable)")
    sc.add_argument("paths", nargs="+")
    sc.add_argument("-o", "--output", default="features.csv")
    sc.add_argument("--store", default=None, help="feature store dir (resume)")
    sc.add_argument("--batch-size", type=int, default=16)
    sc.add_argument(
        "--extended", action="store_true",
        help="also compute the extended feature set",
    )
    _add_mesh_opt(sc)
    _add_band_opts(sc)
    sc.set_defaults(fn=cmd_scan)

    r = sub.add_parser("radio", help="k-means auto-playlists over a library")
    r.add_argument("paths", nargs="+")
    r.add_argument("--clusters", type=int, default=4)
    r.add_argument("--output-dir", default=".")
    r.add_argument("--store", default=None)
    r.add_argument("--batch-size", type=int, default=16)
    r.add_argument(
        "--extended", action="store_true",
        help="cluster on the z-scored extended feature vectors",
    )
    _add_mesh_opt(r)
    _add_band_opts(r)
    r.set_defaults(fn=cmd_radio)

    st = sub.add_parser("store", help="feature-store maintenance")
    st.add_argument(
        "--output", "-o", default="-",
        help="export: CSV path ('-' = stdout)",
    )
    st.add_argument(
        "--top-k", type=int, default=5,
        help="neighbors/dupes: how many nearest songs per entry to consider",
    )
    st.add_argument(
        "--threshold", type=float, default=1.0,
        help="dupes: max force-vector distance to call a pair duplicates "
        "(identical audio = 0; re-encodes/remasters land well under 1; "
        "unrelated songs are many units apart)",
    )
    st.add_argument(
        "action",
        choices=["stats", "compact", "export", "prune", "neighbors", "dupes"],
    )
    st.add_argument("store", help="store directory")
    st.set_defaults(fn=cmd_store)

    gu = sub.add_parser(
        "gui", help="tkinter library scanner (the reference's GTK GUI)"
    )
    gu.set_defaults(fn=cmd_gui)

    dr = sub.add_parser(
        "doctor",
        help="diagnose the environment: native build, decode round-trip, "
        "bounded CUDA backend/dispatch probes on --device, store health",
    )
    dr.add_argument(
        "--timeout", type=float, default=60.0,
        help="seconds before a device probe is declared hung",
    )
    dr.add_argument("--store", default=None, help="also check this store")
    dr.set_defaults(fn=cmd_doctor)

    sv = sub.add_parser(
        "serve",
        help="persistent analysis daemon (JSON-lines over a socket) on --device",
    )
    sv.add_argument("--socket", help="Unix socket path to listen on")
    sv.add_argument(
        "--port", type=int,
        help="loopback TCP port instead of a Unix socket (0 = ephemeral)",
    )
    sv.add_argument(
        "--http-port", type=int,
        help="also (or only) serve HTTP on this loopback port: POST / with "
        "a request object, GET /ping /status /metrics (0 = ephemeral)",
    )
    sv.add_argument("--store", help="feature-store directory (cache)")
    sv.add_argument("--batch-size", type=int, default=64)
    sv.add_argument(
        "--no-warmup", action="store_true",
        help="skip the startup analysis of a synthetic clip (which builds the"
        " CUDA kernels if needed and launches them once)",
    )
    sv.add_argument(
        "--health-probe", type=float, default=0.0, metavar="SECONDS",
        help="probe the device every SECONDS with a host->device->host round"
        " trip: detects a lost or poisoned CUDA context and marks a degraded"
        " daemon recovered without waiting for traffic (0 = off)",
    )
    _add_mesh_opt(sv)
    _add_band_opts(sv)
    sv.set_defaults(fn=cmd_serve)

    cl = sub.add_parser(
        "call",
        help="send one JSON request to a running serve daemon",
    )
    cl.add_argument("--socket", help="daemon Unix socket path")
    cl.add_argument("--port", type=int, help="daemon loopback TCP port")
    cl.add_argument(
        "--timeout", type=float, default=600.0,
        help="seconds to wait for the response (a big scan without "
        "progress events can exceed the default 600)",
    )
    cl.add_argument(
        "request", nargs="?",
        help="JSON request object ('-' or omitted = read from stdin), "
        "e.g. '{\"op\": \"status\"}'",
    )
    cl.set_defaults(fn=cmd_call)

    v = sub.add_parser("version", help="print versions")
    v.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = _unported(args)
    if refused:
        print(f"bliss-tpu-torch {args.cmd}: {refused}", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
