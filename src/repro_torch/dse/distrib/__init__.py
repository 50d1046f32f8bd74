"""Distributed sweep subsystem: shared-journal work-stealing DSE.

Many workers — threads, local processes, or ``dse-worker`` processes on
other machines — share one sweep through a plain directory: record
shards (``persist.SharedDirBackend``), batch manifests, and expiring
leases (``lease.LeaseBoard``). The coordinator drives the same pure
proposal streams as the serial path, so N workers reproduce the
1-worker Pareto frontier bit-exactly. See DESIGN.md Section 10.
"""
from .coordinator import (DistribConfig, WORKER_MODES, batch_id_for,
                          run_coordinator, run_distributed)
from .lease import (LeaseBoard, atomic_write_json, clear_stop,
                    list_manifests, post_manifest, read_json,
                    request_stop, stop_requested)
from .worker import (WorkerConfig, dcfg_from_manifest,
                     evaluate_manifest_item, worker_entry, worker_loop)

__all__ = [n for n in dir() if not n.startswith("_")]
