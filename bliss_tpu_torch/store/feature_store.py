"""Resumable feature store: content-addressed force vectors on disk.

A copy of ``bliss_tpu/store/feature_store.py`` with the same on-disk
format: a store written by either package loads in the other.

The reference has no checkpoint/resume; its GUI example approximates it by
flushing one CSV row per song (reference: python/examples/analyze_gui.py:
37-49). Here resumability is first-class: features are keyed by a content
hash of the audio file, so interrupted library scans skip completed work,
renamed files keep their analysis, and re-encoded files re-analyze.

Layout (scales to 100k+ songs with O(dirty) flushes):
- ``shard-*.npz``            one NPZ per flush (keys + feature rows)
- ``shards.jsonl``           append-only shard index, one line per shard
- ``meta.jsonl``             append-only metadata, one JSON line per put;
                             later lines win on reload
- flushes therefore APPEND everywhere — no O(N) rewrite per batch (the
  pre-round-3 layout rewrote a monolithic meta.json each flush, quadratic
  over a long scan). ``compact()`` merges shards and dedups the logs;
  ``flush`` auto-compacts past ``auto_compact_shards``.

Legacy stores (index.json + meta.json) load transparently and convert to
the append-only layout on the next compact().

Warm re-scans are stat-prescreened: a ``statcache.jsonl`` sidecar maps
``path -> (size, mtime_ns, fingerprint)`` so an unchanged file's content
hash is reused from a single ``stat()`` call instead of re-reading its
bytes — the daily "re-scan my library" workload does near-zero I/O. Any
stat change (size or mtime) falls back to content hashing, so a touched
or re-encoded file re-fingerprints (and, if the content changed,
re-analyzes).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import numpy as np


def file_fingerprint(path: str, quick: bool = True) -> str:
    """Content hash of an audio file. ``quick`` hashes size + head/tail
    blocks (robust to renames, cheap on large libraries); quick=False hashes
    the full file."""
    st = os.stat(path)
    h = hashlib.sha256()
    h.update(str(st.st_size).encode())
    with open(path, "rb") as f:
        if quick:
            h.update(f.read(1 << 16))
            if st.st_size > (1 << 17):
                f.seek(-(1 << 16), os.SEEK_END)
                h.update(f.read(1 << 16))
        else:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()[:32]


def similarity_rows(store: "FeatureStore") -> tuple[list[str], np.ndarray]:
    """``(names, [N, 4] core features)`` for whole-library similarity ops
    (cli ``store neighbors``, the serve daemon's ``neighbors`` op).

    One row per song: store entries are keyed by (content hash, analysis
    config), so a file scanned under several configs — e.g. a core pass
    then an ``--extended`` re-scan — owns several entries with identical
    core features. Stacking them all would make every such song its own
    nearest neighbor at distance 0, so rows are deduped by display name,
    keeping the widest (most feature-rich) vector, latest key on ties.
    """
    best: dict[str, np.ndarray] = {}
    for key, vec, meta in store.snapshot():
        name = str(meta.get("filename", key))
        prev = best.get(name)
        if prev is None or vec.shape[0] >= prev.shape[0]:
            best[name] = vec
    names = sorted(best)
    if not names:
        return names, np.zeros((0, 4), np.float32)
    return names, np.stack([best[n][:4] for n in names]).astype(np.float32)


class FeatureStore:
    """Persistent {fingerprint: (force_vector, metadata)} map."""

    def __init__(self, path: str, auto_compact_shards: int = 64):
        self.path = path
        self.auto_compact_shards = auto_compact_shards
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()
        self._features: dict[str, np.ndarray] = {}
        self._meta: dict[str, dict] = {}
        self._dirty: set[str] = set()
        self._dirty_meta: set[str] = set()
        self._shards: list[str] = []
        # path -> [size, mtime_ns, fingerprint]; later lines win on reload
        self._statcache: dict[str, list] = {}
        self._dirty_stat: set[str] = set()
        self._load()

    # --- paths ---------------------------------------------------------------

    def _shard_log(self) -> str:
        return os.path.join(self.path, "shards.jsonl")

    def _meta_log(self) -> str:
        return os.path.join(self.path, "meta.jsonl")

    def _stat_log(self) -> str:
        return os.path.join(self.path, "statcache.jsonl")

    # --- load ----------------------------------------------------------------

    def _load(self) -> None:
        shards: list[str] = []
        legacy_idx = os.path.join(self.path, "index.json")
        if os.path.exists(legacy_idx):
            with open(legacy_idx) as f:
                shards.extend(json.load(f).get("shards", []))
        if os.path.exists(self._shard_log()):
            with open(self._shard_log()) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        shards.append(json.loads(line)["shard"])
        seen = set()
        self._shards = [s for s in shards if not (s in seen or seen.add(s))]
        for shard in self._shards:
            p = os.path.join(self.path, shard)
            if not os.path.exists(p):
                continue
            with np.load(p, allow_pickle=False) as z:
                keys = [k for k in z["keys"]]
                feats = z["features"]
            for k, v in zip(keys, feats):
                self._features[str(k)] = v
        legacy_meta = os.path.join(self.path, "meta.json")
        if os.path.exists(legacy_meta):
            with open(legacy_meta) as f:
                self._meta = json.load(f)
        if os.path.exists(self._meta_log()):
            with open(self._meta_log()) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._meta[rec.pop("_key")] = rec
        if os.path.exists(self._stat_log()):
            with open(self._stat_log()) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._statcache[rec["path"]] = [
                        rec["size"], rec["mtime_ns"], rec["fp"]
                    ]

    # --- stat-prescreened fingerprinting --------------------------------------

    def fingerprint(self, path: str) -> str:
        """Content fingerprint of ``path``, prescreened by ``stat()``: if
        (size, mtime_ns) are unchanged since the last scan, the cached hash
        is returned without reading the file — a warm library re-scan does
        one stat per file instead of re-reading every file's bytes (the
        reference GUI re-pays full analysis on every scan, reference:
        python/examples/analyze_gui.py:37-49). Any stat change falls back
        to content hashing; content is still the identity (a renamed file
        re-stats but maps to its existing features via the content hash)."""
        st = os.stat(path)
        key = (st.st_size, st.st_mtime_ns)
        with self._lock:
            rec = self._statcache.get(path)
            if rec is not None and (rec[0], rec[1]) == key:
                return rec[2]
        fp = file_fingerprint(path)
        with self._lock:
            self._statcache[path] = [st.st_size, st.st_mtime_ns, fp]
            self._dirty_stat.add(path)
        return fp

    # --- map interface -------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        return key in self._features

    def __len__(self) -> int:
        return len(self._features)

    def get(self, key: str) -> np.ndarray | None:
        return self._features.get(key)

    def put(self, key: str, features: np.ndarray, meta: dict | None = None) -> None:
        with self._lock:
            self._features[key] = np.asarray(features, np.float32)
            if meta:
                self._meta[key] = meta
                self._dirty_meta.add(key)
            self._dirty.add(key)

    # --- persistence ---------------------------------------------------------

    def flush(self) -> None:
        """Persist pending entries: one new shard + appended log lines.
        Cost is O(dirty entries), independent of store size. Auto-compacts
        when the shard count passes ``auto_compact_shards``."""
        with self._lock:
            if self._dirty_stat:
                with open(self._stat_log(), "a") as f:
                    for p in sorted(self._dirty_stat):
                        s, m, fp = self._statcache[p]
                        f.write(
                            json.dumps(
                                {"path": p, "size": s, "mtime_ns": m, "fp": fp}
                            )
                            + "\n"
                        )
                self._dirty_stat.clear()
            if not self._dirty:
                return
            by_width: dict[int, list[str]] = {}
            for k in sorted(self._dirty):
                by_width.setdefault(self._features[k].shape[0], []).append(k)
            stamp = int(time.time() * 1000)
            for width, keys in sorted(by_width.items()):
                feats = np.stack([self._features[k] for k in keys])
                # the running shard ordinal keeps names unique even when two
                # flushes (or two widths) land in the same millisecond —
                # otherwise os.replace would silently clobber the first shard
                shard = f"shard-{stamp:x}-{len(self._shards)}-w{width}-{len(keys)}.npz"
                tmp = os.path.join(self.path, shard + ".tmp")
                with open(tmp, "wb") as f:
                    np.savez_compressed(
                        f, keys=np.array(keys), features=feats
                    )
                os.replace(tmp, os.path.join(self.path, shard))
                with open(self._shard_log(), "a") as f:
                    f.write(json.dumps({"shard": shard}) + "\n")
                self._shards.append(shard)

            if self._dirty_meta:
                with open(self._meta_log(), "a") as f:
                    for k in sorted(self._dirty_meta):
                        f.write(
                            json.dumps({"_key": k, **self._meta[k]}) + "\n"
                        )
                self._dirty_meta.clear()
            self._dirty.clear()

            need_compact = len(self._shards) > self.auto_compact_shards
        if need_compact:
            self.compact()

    def compact(self) -> None:
        """Merge all shards into one per row width; dedup + rewrite the
        logs; drop any legacy index.json/meta.json. (Widths can mix when a
        store holds both core 4-wide and extended rows — e.g. a re-scan
        with --extended into an existing store — so each width compacts to
        its own shard; np.stack over mixed shapes would crash.)"""
        with self._lock:
            if not (
                self._features or self._shards or self._meta
                or self._statcache
            ):
                return  # nothing live and nothing on disk to clean up
            by_width: dict[int, list[str]] = {}
            for k in sorted(self._features):
                by_width.setdefault(self._features[k].shape[0], []).append(k)
            new_shards = []
            stamp = int(time.time() * 1000)
            for width, keys in sorted(by_width.items()):
                feats = np.stack([self._features[k] for k in keys])
                shard = f"shard-compact-{stamp:x}-w{width}-{len(keys)}.npz"
                with open(os.path.join(self.path, shard + ".tmp"), "wb") as f:
                    np.savez_compressed(
                        f, keys=np.array(keys), features=feats
                    )
                os.replace(
                    os.path.join(self.path, shard + ".tmp"),
                    os.path.join(self.path, shard),
                )
                new_shards.append(shard)
            old = [s for s in self._shards if s not in new_shards]
            with open(self._shard_log() + ".tmp", "w") as f:
                for shard in new_shards:
                    f.write(json.dumps({"shard": shard}) + "\n")
            os.replace(self._shard_log() + ".tmp", self._shard_log())
            self._shards = new_shards

            with open(self._meta_log() + ".tmp", "w") as f:
                for k in sorted(self._meta):
                    f.write(json.dumps({"_key": k, **self._meta[k]}) + "\n")
            os.replace(self._meta_log() + ".tmp", self._meta_log())
            self._dirty_meta.clear()

            # dedup the stat cache (drop superseded lines + vanished files)
            with open(self._stat_log() + ".tmp", "w") as f:
                for p in sorted(self._statcache):
                    if not os.path.exists(p):
                        continue
                    s, m, fp = self._statcache[p]
                    f.write(
                        json.dumps(
                            {"path": p, "size": s, "mtime_ns": m, "fp": fp}
                        )
                        + "\n"
                    )
            os.replace(self._stat_log() + ".tmp", self._stat_log())
            self._dirty_stat.clear()

            for stale in old + ["index.json", "meta.json"]:
                try:
                    os.remove(os.path.join(self.path, stale))
                except OSError:
                    pass

    def remove(self, key: str) -> bool:
        """Drop an entry from the in-memory map. Returns whether it existed.
        The on-disk logs still hold the old rows until the next ``compact()``
        (which rewrites only live entries) — callers pruning many entries
        should compact once afterwards."""
        with self._lock:
            found = key in self._features
            self._features.pop(key, None)
            self._meta.pop(key, None)
            self._dirty.discard(key)
            self._dirty_meta.discard(key)
            return found

    def items(self):
        return self._features.items()

    def snapshot(self) -> list[tuple[str, np.ndarray, dict]]:
        """Consistent point-in-time ``[(key, features, meta)]`` list, sorted
        by key. Safe to call while another thread is ``put``-ing (iterating
        ``items()`` directly during a concurrent scan raises
        'dictionary changed size during iteration')."""
        with self._lock:
            return [
                (k, self._features[k], self._meta.get(k, {}))
                for k in sorted(self._features)
            ]

    def metadata(self, key: str) -> dict:
        return self._meta.get(key, {})

    @property
    def shard_count(self) -> int:
        return len(self._shards)
