"""File-based work-stealing primitives for the distributed sweep.

Everything here speaks plain directory-on-a-shared-filesystem (the same
substrate ``SharedDirBackend`` uses for records), so "a cluster" can be
N processes on one box, N boxes on NFS, or a fuse-mounted bucket — no
coordinator RPC, no daemon. Layout under the sweep root::

    batches/<batch_id>.json   work manifests (atomic-rename published)
    leases/<batch_id>.json    live claims  {worker, expires_at}
    done/<batch_id>.json      completion markers
    STOP                      coordinator -> workers: sweep over

The safety story is built from two POSIX guarantees:

* ``O_CREAT | O_EXCL`` — exactly one worker wins a fresh lease.
* ``os.replace`` is atomic — manifests/markers are never seen partially
  written, and *stealing* an expired lease is a rename race that exactly
  one thief can win (everyone else gets ``FileNotFoundError``).

Leases carry a wall-clock expiry. A worker renews its lease after every
point it evaluates; if a worker dies mid-batch its lease stops being
renewed, expires, and any other worker steals the batch and re-evaluates
it from scratch (unpublished work is lost by design — evaluations are
deterministic and content-keyed, so a re-run is bit-identical and the
merged journal deduplicates).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

STOP_NAME = "STOP"


def atomic_write_json(path: str, obj: Dict) -> None:
    """Publish a JSON file readers can never observe half-written."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, sort_keys=True)
        fh.flush()
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Dict]:
    """Best-effort read: None for missing or (transiently) unparsable."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            obj = json.load(fh)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None
    return obj if isinstance(obj, dict) else None


def request_stop(root: str) -> None:
    """Post the STOP marker. The body carries a fresh token so workers
    can tell *this* sweep's STOP from a stale one a previous sweep left
    behind in a reused directory (see ``stop_token``)."""
    atomic_write_json(os.path.join(root, STOP_NAME),
                      {"stop": True, "token": uuid.uuid4().hex})


def clear_stop(root: str) -> None:
    """Remove a previous sweep's STOP marker (coordinator start-up)."""
    try:
        os.remove(os.path.join(root, STOP_NAME))
    except FileNotFoundError:
        pass


def stop_token(root: str) -> Optional[str]:
    """The current STOP marker's token (None if no STOP is posted).
    A worker snapshots this at startup and treats only a *different*
    token as a live stop request: a stale STOP from a finished sweep on
    a reused directory must not make an early-started worker exit
    before its coordinator even arrives (the coordinator clears and
    re-posts STOP with a fresh token)."""
    body = read_json(os.path.join(root, STOP_NAME))
    if body is None:
        return None
    return str(body.get("token", "legacy"))


def stop_requested(root: str) -> bool:
    """True iff a STOP marker exists (any token — callers who must
    distinguish sweeps compare the token themselves)."""
    return os.path.exists(os.path.join(root, STOP_NAME))


def post_manifest(root: str, manifest: Dict) -> str:
    """Publish one batch manifest; returns its batch id."""
    bid = manifest["batch_id"]
    atomic_write_json(os.path.join(root, "batches", f"{bid}.json"),
                      manifest)
    return bid


def list_manifests(root: str) -> List[Dict]:
    """All published manifests, in sorted-name (= deterministic) order."""
    bdir = os.path.join(root, "batches")
    try:
        names = sorted(os.listdir(bdir))
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        if not n.endswith(".json"):
            continue
        m = read_json(os.path.join(bdir, n))
        if m is not None and "batch_id" in m:
            out.append(m)
    return out


class ManifestCache:
    """Incremental manifest reader for worker poll loops.

    Manifests are immutable once published (atomic rename, never
    rewritten), so each file needs reading exactly once; a poll is then
    one ``listdir`` plus reads of only the *new* names. Without this,
    N idle workers re-reading every manifest each poll turn the shared
    filesystem into the sweep's bottleneck."""

    def __init__(self, root: str):
        self._dir = os.path.join(root, "batches")
        self._by_name: Dict[str, Dict] = {}

    def scan(self) -> List[Dict]:
        """All manifests, sorted by name; immutable ones are read at
        most once and served from the cache afterwards."""
        try:
            names = sorted(os.listdir(self._dir))
        except FileNotFoundError:
            return []
        for n in names:
            if n.endswith(".json") and n not in self._by_name:
                m = read_json(os.path.join(self._dir, n))
                if m is not None and "batch_id" in m:
                    self._by_name[n] = m
        return [self._by_name[n] for n in names if n in self._by_name]


class LeaseBoard:
    """Claim / renew / steal / complete batches for one worker identity."""

    def __init__(self, root: str, worker_id: str,
                 ttl_s: float = 60.0):
        self.root = root
        self.worker_id = worker_id
        self.ttl_s = ttl_s
        #: plain counters, harvested into per-worker metrics shards by
        #: ``worker_loop`` (no process-global telemetry here — thread-mode
        #: workers would double-count a shared registry)
        self.n_stolen = 0
        self.n_claims = 0
        self.n_expired = 0
        # done markers are write-once: cache positives, re-check misses
        self._done_cache: set = set()
        os.makedirs(os.path.join(root, "leases"), exist_ok=True)
        os.makedirs(os.path.join(root, "done"), exist_ok=True)

    def _lease_path(self, batch_id: str) -> str:
        return os.path.join(self.root, "leases", f"{batch_id}.json")

    def _done_path(self, batch_id: str) -> str:
        return os.path.join(self.root, "done", f"{batch_id}.json")

    def is_done(self, batch_id: str) -> bool:
        """True once the batch has a write-once done marker (cached —
        done markers never disappear)."""
        if batch_id in self._done_cache:
            return True
        if os.path.exists(self._done_path(batch_id)):
            self._done_cache.add(batch_id)
            return True
        return False

    def read_lease(self, batch_id: str) -> Optional[Dict]:
        """The batch's current lease body, or None if unclaimed."""
        return read_json(self._lease_path(batch_id))

    def try_claim(self, batch_id: str) -> bool:
        """Claim the batch, stealing an expired lease if one is in the
        way. Returns True iff this worker now holds the lease."""
        if self.is_done(batch_id):
            return False
        path = self._lease_path(batch_id)
        cur = read_json(path)
        if cur is not None:
            if cur.get("expires_at", 0.0) > time.time():
                return False       # live lease held by someone else
            self.n_expired += 1
            # expired: exactly one thief wins this rename
            tomb = f"{path}.stolen-{uuid.uuid4().hex[:8]}"
            try:
                os.replace(path, tomb)
            except FileNotFoundError:
                return False       # raced: released or already stolen
            try:
                os.remove(tomb)
            except FileNotFoundError:
                pass
            self.n_stolen += 1
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False           # raced: someone re-claimed first
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(self._lease_body(), fh)
            fh.flush()
        self.n_claims += 1
        return True

    def _owns(self, batch_id: str) -> bool:
        cur = read_json(self._lease_path(batch_id))
        return cur is not None and cur.get("worker") == self.worker_id

    def renew(self, batch_id: str) -> bool:
        """Push the expiry out; called after every evaluated point so a
        *live* worker on a long batch is never mistaken for a dead one.
        Ownership is re-checked first, so a holder whose lease expired
        and was stolen mid-point almost always sees the thief's lease
        and backs off (returns False). The check is best-effort, not
        atomic with the write — a steal landing in between leaves two
        workers believing they hold the batch. That costs duplicate
        mapping searches, never correctness: evaluations are
        deterministic and the journal merge dedups by content key."""
        if not self._owns(batch_id):
            return False
        atomic_write_json(self._lease_path(batch_id), self._lease_body())
        return True

    def release(self, batch_id: str) -> None:
        """Drop the lease — only if still ours (see ``renew``)."""
        if not self._owns(batch_id):
            return
        try:
            os.remove(self._lease_path(batch_id))
        except FileNotFoundError:
            pass

    def mark_done(self, batch_id: str, meta: Optional[Dict] = None) -> None:
        """Write the batch's done marker (write-once; atomic rename)."""
        body = {"worker": self.worker_id}
        if meta:
            body.update(meta)
        atomic_write_json(self._done_path(batch_id), body)

    def _lease_body(self) -> Dict:
        return {"worker": self.worker_id,
                "expires_at": time.time() + self.ttl_s}
