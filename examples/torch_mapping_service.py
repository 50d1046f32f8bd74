"""Quickstart: mapping-as-a-service (deployment-time DSE), through the
PyTorch port's ``repro_torch.serve.MappingService`` (no JAX needed).

    PYTHONPATH=src python examples/torch_mapping_service.py

Stands up a local ``MappingService``, answers one deployment request —
"best dram_pim (arch, mapping) pair for resnet18" — then demonstrates
the three serving layers that make repeat traffic cheap:

1. an exact repeat is answered from the response memo (no sweep),
2. a fresh service on the same journal (a restart) replays every point
   from the content-keyed journal with **zero new mapping searches**
   and a byte-identical frontier,
3. a deadline-bounded request returns the best-so-far frontier.

The journal lives in a temp dir so the example is self-contained;
point ``MappingService(journal_path=...)`` somewhere persistent for a
real deployment. Over HTTP, ``repro_torch.serve.MappingHTTPServer``
serves the same wire forms. DESIGN.md Section 11 has the contract.
"""
import os
import tempfile

from repro_torch.serve import MappingRequest, MappingService


def main():
    tmp = tempfile.mkdtemp(prefix="mapping_service_")
    journal = os.path.join(tmp, "service.jsonl")
    req = MappingRequest(network="resnet18", family="dram_pim",
                         explorer="grid", budget=8, n_candidates=4,
                         max_steps=1024)

    print(f"request: network={req.network} family={req.family} "
          f"budget={req.budget} (key {req.cache_key()[:12]})")

    svc = MappingService(journal_path=journal)
    try:
        cold = svc.request(req)
        print(f"cold:    served_from={cold.served_from} "
              f"evaluated={cold.evaluated} wall_s={cold.wall_s:.1f}")
        print(f"         best={cold.best['arch_name']} "
              f"latency_ms={cold.best['total_ns'] / 1e6:.3f} "
              f"area_mm2={cold.best['area_mm2']:.2f} "
              f"(frontier of {len(cold.frontier_points)})")

        memo = svc.request(req)
        print(f"repeat:  served_from={memo.served_from} — no sweep ran, "
              f"the stored response was replayed "
              f"(sweeps={svc.stats['sweeps']})")
    finally:
        svc.close()

    # "restart": a brand-new service over the same journal file
    svc = MappingService(journal_path=journal)
    try:
        warm = svc.request(req)
        print(f"restart: served_from={warm.served_from} "
              f"evaluated={warm.evaluated} "
              f"from_journal={warm.from_journal} — zero new searches")
        assert warm.evaluated == 0
        assert warm.frontier_json == cold.frontier_json
        print("         frontier byte-identical to the cold run")

        rush = svc.request(MappingRequest(
            network=req.network, family=req.family, explorer="grid",
            budget=64, n_candidates=4, max_steps=1024, deadline_s=2.0))
        print(f"rush:    budget=64 deadline_s=2.0 -> "
              f"proposed={rush.proposed} deadline_hit={rush.deadline_hit} "
              f"best={rush.best['arch_name']} (best-so-far answer)")
    finally:
        svc.close()


if __name__ == "__main__":
    main()
