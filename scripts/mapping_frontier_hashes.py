#!/usr/bin/env python3
"""The sha256 of the Pareto frontier of four full-size mapping requests.

    PYTHONPATH=src python scripts/mapping_frontier_hashes.py \\
        [--package repro_torch|repro]

Answers each request of ``REQUESTS`` cold, through the chosen package's
``MappingService`` (a fresh journal in a temporary directory), and
prints one line per request: the network, the winning arch,
``evaluated``, the host wall seconds and the sha256 of the response's
``frontier_json``. The frontier bytes are deterministic, so
two packages, or two machines, that print equal hashes gave the same
answer. ``chip_smoke.py``'s mapping phase answers the same requests with
the port on the GPU machine.
"""
import argparse
import hashlib
import importlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

#: the paper's own workload, then the zoo at full size: the dense model
#: the serve path runs, the SSM's prefill and the MoE's decode step
REQUESTS = (
    dict(network="resnet18", explorer="grid", budget=4),
    dict(network="granite_8b:prefill@2048", explorer="grid", budget=4),
    dict(network="mamba2_780m:prefill@2048", explorer="grid", budget=4),
    dict(network="deepseek_moe_16b:decode@1024", explorer="grid", budget=4),
)


def frontier_sha256(resp) -> str:
    """sha256 of a response's canonical frontier bytes."""
    return hashlib.sha256(resp.frontier_json.encode()).hexdigest()


def answer(serve, root: str, kw: dict):
    """One cold request through a fresh service journaled under ``root``:
    (response, host wall seconds)."""
    svc = serve.MappingService(
        journal_path=os.path.join(root, "journal.jsonl"),
        shared_root=os.path.join(root, "shared"))
    try:
        t0 = time.perf_counter()
        resp = svc.request(serve.MappingRequest(**kw))
        return resp, time.perf_counter() - t0
    finally:
        svc.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="repro_torch",
                    choices=("repro_torch", "repro"))
    args = ap.parse_args(argv)
    serve = importlib.import_module(f"{args.package}.serve")
    with tempfile.TemporaryDirectory() as root:
        for kw in REQUESTS:
            resp, wall = answer(serve, root, kw)
            print(f"{kw['network']}: best {resp.best['arch_name']} "
                  f"evaluated {resp.evaluated} served_from "
                  f"{resp.served_from} wall {wall:.3f} s sha256 "
                  f"{frontier_sha256(resp)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
