"""Content-keyed, resumable run journal for DSE sweeps.

Every evaluated design point is one JSON record::

    {"key": <sha1>, "point": {...}, "family": ..., "total_ns": ...}

``key`` is a SHA-1 over the *content* of the evaluation — network, mode,
strategy, search budget parameters, seed and the built ``ArchSpec``'s
``to_key()`` — mirroring the engine's content-keyed caches: any run that
would produce bit-identical results shares the key, regardless of which
process (or which explorer, or which machine) produced it. Re-running a
sweep therefore serves already-scored points from the journal and
performs zero new mapping searches.

Storage is pluggable (``JournalBackend``):

* ``FileBackend`` — the classic single local JSONL file. Appends flush
  eagerly so concurrent readers and killed runs observe a prefix of
  complete lines; loading tolerates a truncated final line, and later
  lines win on key collisions, so re-appends are harmless.
* ``SharedDirBackend`` — an object-store emulation over a shared
  directory (NFS mount, fuse-mounted bucket, ...): each writer appends
  to a private staging file and *publishes* whole shards by atomic
  rename into ``<root>/shards/``. Readers list the directory and merge
  all published shards later-wins by content key, so a reader never
  observes a partially-written shard and N machines can feed one sweep.
  This is the substrate of the distributed sweep subsystem
  (``repro_torch.dse.distrib``, DESIGN.md Section 10).

Both backends support ``compact()``: rewrite the store keeping exactly
one line per content key (later-wins) and dropping any truncated tail,
so long-lived shared journals don't grow unboundedly.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

from .. import obs


def content_key(network: str, mode: str, strategy: str, seed: int,
                n_candidates: int, max_steps: int, refine_passes: int,
                arch_key: str, objective: str = "latency") -> str:
    """Stable identity of one (network, search config, arch) evaluation.

    ``objective`` enters the blob only when it deviates from "latency"
    (the implicit objective of every pre-energy journal), so those
    journals keep serving latency sweeps for modes whose records are
    unchanged — while every other objective gets distinct keys.

    Transform-mode keys additionally carry ``energy_rev=1``: the
    energy-aware search changed what a transform evaluation *records*
    (``energy_pj`` now includes relocation energy, plus the
    ``move_energy_pj``/``edp_ns_pj``/``objective_value`` columns), and a
    resumed sweep must never mix pre-energy records with fresh ones on
    the same frontier. Original/overlap evaluations never relocate, so
    their records — and keys — are untouched."""
    blob_dict = {"network": network, "mode": mode, "strategy": strategy,
                 "seed": seed, "n_candidates": n_candidates,
                 "max_steps": max_steps, "refine_passes": refine_passes,
                 "arch_key": arch_key}
    if objective != "latency":
        blob_dict["objective"] = objective
    if mode == "transform":
        blob_dict["energy_rev"] = 1
    blob = json.dumps(blob_dict, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()


def _parse_lines(fh) -> Iterator[Dict]:
    """Complete, keyed records of one JSONL stream (truncated tail and
    junk lines are skipped — the killed-mid-append contract)."""
    for line in fh:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # truncated tail of a killed run
        if isinstance(rec, dict) and "key" in rec:
            yield rec


class JournalBackend:
    """Storage protocol behind ``RunJournal``.

    ``load`` returns the merged later-wins view; ``append`` stages one
    record; ``publish`` makes staged records visible to *other* readers
    (a no-op for backends whose appends are immediately visible);
    ``compact`` rewrites the store to one line per key and returns
    ``(lines_before, lines_after)``."""

    def load(self) -> Dict[str, Dict]:
        """Full merged later-wins view, ``{content key: record}``."""
        raise NotImplementedError

    def append(self, rec: Dict) -> None:
        """Stage one record for this writer."""
        raise NotImplementedError

    def publish(self) -> None:
        """Make staged records visible to other readers (no-op where
        appends already are)."""
        pass

    def load_new(self) -> Dict[str, Dict]:
        """Records that appeared since the last ``load``/``load_new``.
        Backends without a cheaper answer may return the full view —
        ``RunJournal.refresh`` only merges, never drops."""
        return self.load()

    def compact(self) -> Tuple[int, int]:
        """Rewrite the store to one line per key; returns
        ``(lines_before, lines_after)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support compaction")


class FileBackend(JournalBackend):
    """Single local JSONL file; appends are eagerly flushed."""

    def __init__(self, path: str):
        self.path = path
        self._needs_newline = False
        if os.path.exists(path):
            with open(path, "rb") as bf:
                bf.seek(0, os.SEEK_END)
                if bf.tell() > 0:
                    bf.seek(-1, os.SEEK_END)
                    # a truncated tail must not swallow the next append
                    self._needs_newline = bf.read(1) != b"\n"

    def load(self) -> Dict[str, Dict]:
        """Parse the file later-wins (truncated tail tolerated)."""
        out: Dict[str, Dict] = {}
        if os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as fh:
                for rec in _parse_lines(fh):
                    out[rec["key"]] = rec
        return out

    def append(self, rec: Dict) -> None:
        """Append one JSON line, eagerly flushed (concurrent readers
        and killed runs observe a prefix of complete lines)."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as fh:
            if self._needs_newline:
                fh.write("\n")
                self._needs_newline = False
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
            fh.flush()

    def compact(self) -> Tuple[int, int]:
        """Atomically rewrite the file with one line per key."""
        if not os.path.exists(self.path):
            return (0, 0)
        with open(self.path, "r", encoding="utf-8") as fh:
            n_before = sum(1 for line in fh if line.strip())
        merged = self.load()
        tmp = self.path + ".compact.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in merged.values():  # original append order
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        os.replace(tmp, self.path)
        self._needs_newline = False
        return (n_before, len(merged))


class SharedDirBackend(JournalBackend):
    """Object-store-style shared directory of immutable record shards.

    Writers never touch a shared file in place: ``append`` stages records
    in a private ``.staging/<writer>.jsonl``, and ``publish`` moves the
    staged batch into ``shards/`` under a fresh name with ``os.replace``
    (atomic on POSIX), so readers only ever see complete shards. The
    merged view is later-wins by content key over shards in sorted-name
    order — and since keys are *content* keys of deterministic
    evaluations, colliding records are identical and the merge order is
    immaterial; later-wins is pure deduplication. A writer crash loses at
    most its unpublished staging file, which the distributed lease
    protocol re-steals (``repro_torch.dse.distrib.lease``)."""

    def __init__(self, root: str, writer_id: Optional[str] = None):
        self.root = root
        self.writer_id = writer_id or f"w{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._n_published = 0
        self._staged = 0
        # shards are immutable once published, so a reader only ever
        # needs to read each shard once — load_new() keeps refresh O(new
        # shards), not O(all shards), which matters in worker poll loops
        self._seen_shards: set = set()
        os.makedirs(self.shard_dir, exist_ok=True)
        os.makedirs(self._staging_dir, exist_ok=True)

    @property
    def shard_dir(self) -> str:
        """Directory of the published (immutable) record shards."""
        return os.path.join(self.root, "shards")

    @property
    def _staging_dir(self) -> str:
        return os.path.join(self.root, ".staging")

    @property
    def _staging_path(self) -> str:
        return os.path.join(self._staging_dir, f"{self.writer_id}.jsonl")

    def shards(self) -> List[str]:
        """Published shard paths in sorted-name (merge) order."""
        try:
            names = sorted(os.listdir(self.shard_dir))
        except FileNotFoundError:
            return []
        return [os.path.join(self.shard_dir, n) for n in names
                if n.endswith(".jsonl")]

    def load(self) -> Dict[str, Dict]:
        """Full merge of every published shard (resets the incremental
        ``load_new`` cursor)."""
        self._seen_shards = set()
        return self.load_new()

    def load_new(self) -> Dict[str, Dict]:
        """Merge only shards published since the previous read."""
        out: Dict[str, Dict] = {}
        for path in self.shards():
            if path in self._seen_shards:
                continue
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    for rec in _parse_lines(fh):
                        out[rec["key"]] = rec
            except FileNotFoundError:
                continue  # compacted away under us; its keys are merged
            self._seen_shards.add(path)
        return out

    def append(self, rec: Dict) -> None:
        """Stage one record privately; ``publish`` makes it visible."""
        with open(self._staging_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
            fh.flush()
        self._staged += 1

    def publish(self) -> None:
        """Atomic-rename the staged batch into the shared shard dir."""
        if self._staged == 0:
            return
        name = f"shard-{self.writer_id}-{self._n_published:06d}.jsonl"
        os.replace(self._staging_path, os.path.join(self.shard_dir, name))
        self._n_published += 1
        self._staged = 0

    def compact(self) -> Tuple[int, int]:
        """Merge every published shard into one, then drop the originals.

        Publish-before-delete ordering keeps the merged view a superset
        of the old one at every instant, so concurrent readers are safe;
        concurrent *writers* keep publishing fresh shards untouched."""
        old = self.shards()
        n_before = 0
        merged: Dict[str, Dict] = {}
        for path in old:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    for rec in _parse_lines(fh):
                        n_before += 1
                        merged[rec["key"]] = rec
            except FileNotFoundError:
                continue
        if not old:
            return (0, 0)
        tmp = os.path.join(self._staging_dir,
                           f"compact-{self.writer_id}.jsonl")
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in merged.values():
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        os.replace(tmp, os.path.join(
            self.shard_dir, f"shard-compact-{uuid.uuid4().hex[:8]}.jsonl"))
        for path in old:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        return (n_before, len(merged))


class RunJournal:
    """Append-only record store keyed on ``content_key`` values.

    Construct with a ``path`` (the classic local-JSONL journal), an
    explicit ``backend``, or neither (in-memory only — tests, throwaway
    sweeps). ``refresh()`` re-merges records other writers have
    published since load; ``publish()`` exposes this writer's staged
    records to them (both no-ops where the backend needs none).

    Thread-safe: every mutating or reading method serializes on one
    internal ``RLock``, so a journal shared across service job threads
    (``repro_torch.serve``) never interleaves ``record``/``publish``/
    ``compact`` mid-write. Records are content-keyed and deterministic,
    so lock ordering can never change *what* is stored — only that each
    store happens whole."""

    def __init__(self, path: Optional[str] = None,
                 backend: Optional[JournalBackend] = None):
        assert path is None or backend is None, \
            "pass a path or a backend, not both"
        if backend is None and path is not None:
            backend = FileBackend(path)
        self.backend = backend
        self.path = getattr(backend, "path", None)
        self._lock = threading.RLock()
        self._records: Dict[str, Dict] = backend.load() if backend else {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._records

    def __iter__(self) -> Iterator[Dict]:
        with self._lock:
            return iter(list(self._records.values()))

    def get(self, key: str) -> Optional[Dict]:
        """The record stored under a content key, or None."""
        with self._lock:
            return self._records.get(key)

    def record(self, key: str, rec: Dict) -> Dict:
        """Store (and stage to the backend, if any) one record."""
        rec = {"key": key, **{k: v for k, v in rec.items() if k != "key"}}
        with self._lock:
            self._records[key] = rec
            if self.backend is not None:
                self.backend.append(rec)
        obs.inc("journal.records")
        return rec

    def publish(self) -> None:
        """Make records staged by ``record`` visible to other readers."""
        if self.backend is not None:
            t0 = time.perf_counter()
            with self._lock:
                self.backend.publish()
            obs.observe("journal.publish_seconds",
                        time.perf_counter() - t0)

    def refresh(self) -> int:
        """Merge records published by other writers; returns how many
        keys were new to this view. Locally-recorded entries survive
        (content keys make any collision bit-identical anyway)."""
        if self.backend is None:
            return 0
        t0 = time.perf_counter()
        with self._lock:
            fresh = self.backend.load_new()
            n_new = 0
            for k, rec in fresh.items():
                if k not in self._records:
                    n_new += 1
                self._records[k] = rec
        obs.observe("journal.refresh_seconds", time.perf_counter() - t0)
        obs.inc("journal.refresh_new", n_new)
        return n_new

    def compact(self) -> Tuple[int, int]:
        """Rewrite the backing store dropping superseded later-wins
        duplicates and any truncated tail; returns (lines_before,
        lines_after). Staged records are published first, so the
        rebuilt in-memory view never loses a ``record`` this writer
        made but had not yet made visible (shared-dir backends stage;
        file backends publish as a no-op). In-memory journals have
        nothing to compact."""
        with self._lock:
            if self.backend is None:
                return (len(self._records), len(self._records))
            self.backend.publish()
            out = self.backend.compact()
            self._records = self.backend.load()
            return out
