"""The port's Fast-OverlaPIM mapper against the reference's, on the CPU.

``repro_torch`` keeps its own copy of the numpy mapper (``core/``,
``dse/``, ``obs/``, ``workloads/``, ``serve/{jobs,service,transport}.py``).
Each test feeds one input to both packages and asserts equal output:
lowered layers and edges, per-layer search results and loop nests,
byte-identical ``frontier_json``, journals each package serves from the
other's, HTTP bodies and ``distributed=2`` sweeps. Every service gets its
own journal and shared dir under ``tmp_path`` (never the default
``dse_runs/``), so a cold answer is a search on both sides. The drift
guard holds every copied module's code (docstrings aside) to the
reference's, apart from the differences listed in ``INTENDED``.
"""
import ast
import dataclasses
import glob
import json
import os
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from repro import core as ref_core  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro import workloads as ref_workloads  # noqa: E402
from repro.core import interface as ref_interface  # noqa: E402
from repro.core import workload as ref_workload  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.core import interface, workload  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MAPPER_DIRS = ("obs", "core", "dse", "dse/distrib", "workloads")
MAPPER_MODULES = sorted(
    os.path.relpath(p, os.path.join(SRC, "repro"))
    for d in MAPPER_DIRS
    for p in glob.glob(os.path.join(SRC, "repro", d, "*.py"))) + [
        "serve/jobs.py", "serve/service.py", "serve/transport.py"]

#: Intended code differences of the port's mapper from the reference's:
#: module -> [(reference source text, port source text)]. A change to the
#: port's copy that is not listed here fails the drift guard.
INTENDED = {
    "core/workload.py": [("repro.workloads failed to ",
                          "repro_torch.workloads failed to ")],
}

#: scenario names beyond the 40 canonical ones: chained blocks, and the
#: ``seq=`` / ``kv_len=`` / ``blocks=`` keywords of ``describe``
EXTRA_SCENARIOS = [
    ("granite_8b_smoke:prefill@64x3", {}),
    ("deepseek_moe_16b_smoke:decode@16x2", {}),
    ("zamba2_1_2b_smoke", {"seq": 48}),
    ("whisper_base_smoke:decode", {"kv_len": 24, "blocks": 2}),
    ("llava-next-34b:prefill@128", {}),
]

REQUESTS = [
    dict(network="resnet18"),
    dict(network="deepseek_moe_16b_smoke:prefill@64"),
    dict(network="mamba2_780m_smoke:decode@16"),
    dict(network="whisper_base_smoke:prefill@64"),
    dict(network="granite_8b_smoke:prefill@64x2", objective="edp",
         explorer="evolve", budget=6, include_mapping=True),
]


def _kw(**over):
    kw = dict(explorer="grid", budget=4, n_candidates=4, max_steps=1024)
    kw.update(over)
    return kw


def _service(pkg, root, name):
    return pkg.MappingService(
        journal_path=os.path.join(root, f"{name}.jsonl"),
        shared_root=os.path.join(root, f"{name}_shared"))


def _no_wall(x):
    """``x`` with every ``wall_s`` (the only host-clock field) dropped."""
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


def _desc(d):
    layers = [dataclasses.astuple(layer) for layer in d.layers]
    edges = [[(e.producer, type(e.cmap).__name__, vars(e.cmap)) for e in es]
             for es in d.edges]
    return d.name, layers, edges


def _cold(pkg, root, name, kw):
    svc = _service(pkg, root, name)
    try:
        resp = svc.request(pkg.MappingRequest(**kw))
    finally:
        svc.close()
    assert resp.served_from == "search" and resp.evaluated > 0
    return resp


@pytest.mark.parametrize(
    "name", ref_workloads.list_scenarios()
    + ref_workloads.list_scenarios(smoke=True))
def test_canonical_scenarios_lower_equal(name):
    assert workloads.list_scenarios() + workloads.list_scenarios(
        smoke=True) == ref_workloads.list_scenarios() + \
        ref_workloads.list_scenarios(smoke=True)
    assert _desc(workloads.describe_scenario(name)) == _desc(
        ref_workloads.describe_scenario(name))


@pytest.mark.parametrize("name,kw", EXTRA_SCENARIOS)
def test_scenario_keywords_lower_equal(name, kw):
    got = _desc(core.describe(name, **kw))
    assert got == _desc(ref_core.describe(name, **kw))
    assert len(got[1]) > 0


@pytest.mark.parametrize("name", sorted(ref_workload.NETWORKS))
def test_core_networks_equal(name):
    assert sorted(workload.NETWORKS) == sorted(ref_workload.NETWORKS)
    assert _desc(core.describe(name)) == _desc(ref_core.describe(name))


def test_describe_bert_equal():
    kw = dict(seq=128, d_model=256, heads=4)
    assert _desc(interface.describe_bert(**kw)) == _desc(
        ref_interface.describe_bert(**kw))


def _results(pkg, net, mode):
    d = pkg.describe(net)
    out = []
    for fn, use_engine in ((pkg.optimize_network, False),
                           (pkg.optimize_network_engine, True)):
        cfg = pkg.SearchConfig(n_candidates=4, max_steps=1024, mode=mode,
                               use_engine=use_engine)
        r = fn(d.layers, d.edges, pkg.dram_pim(), cfg)
        out.append((r.total_ns, r.per_layer_ns, r.summary(), [
            (lr.mapping.pretty(), dataclasses.astuple(lr.perf), lr.start_ns,
             lr.end_ns, lr.finish_ns.tolist(), lr.transformed, lr.moved_frac,
             lr.moved_bytes, lr.move_energy_pj) for lr in r.layers]))
    return out


@pytest.mark.parametrize("mode", ref_core.MODES)
@pytest.mark.parametrize("net", ["resnet18", "granite_8b_smoke:prefill@64"])
def test_whole_network_search_equal(net, mode):
    assert core.MODES == ref_core.MODES
    ref, got = _results(ref_core, net, mode), _results(core, net, mode)
    assert got == ref
    assert ref[0] == ref[1]     # the engine's totals equal its oracle's


@pytest.mark.parametrize("kw", REQUESTS, ids=lambda kw: kw["network"])
def test_cold_request_byte_identical(kw, tmp_path):
    kw = _kw(**kw)
    ref = _cold(ref_serve, str(tmp_path), "ref", kw)
    got = _cold(serve, str(tmp_path), "port", kw)
    assert got.frontier_json == ref.frontier_json
    assert _no_wall(got.to_dict()) == _no_wall(ref.to_dict())
    assert (got.mapping is not None) == kw.get("include_mapping", False)


@pytest.mark.parametrize("first,second", [(ref_serve, serve),
                                          (serve, ref_serve)],
                         ids=["ref_to_port", "port_to_ref"])
def test_journal_served_across_packages(first, second, tmp_path):
    kw = _kw(network="mamba2_780m_smoke:prefill@64")
    cold = _cold(first, str(tmp_path), "j", kw)
    svc = _service(second, str(tmp_path), "j")
    try:
        warm = svc.request(second.MappingRequest(**kw))
    finally:
        svc.close()
    assert warm.served_from == "journal" and warm.evaluated == 0
    assert warm.frontier_json == cold.frontier_json
    assert _no_wall(warm.best) == _no_wall(cold.best)


def _metric_names(text):
    return sorted({ln.split("{")[0].split(" ")[0]
                   for ln in text.splitlines()
                   if ln and not ln.startswith("#")})


def test_http_bodies_equal(tmp_path):
    body = json.dumps(_kw(network="olmo_1b_smoke:decode@16")).encode()
    out = []
    for pkg, name in ((ref_serve, "ref"), (serve, "port")):
        srv = pkg.MappingHTTPServer(_service(pkg, str(tmp_path), name),
                                    port=0).start()
        try:
            r = urllib.request.Request(
                srv.url + "/v1/mapping", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=60.0) as resp:
                assert resp.status == 200
                answer = json.loads(resp.read())
            with urllib.request.urlopen(srv.url + "/v1/metrics",
                                        timeout=10.0) as resp:
                names = _metric_names(resp.read().decode())
        finally:
            srv.close()
            srv.service.close()
        assert answer["served_from"] == "search" and answer["evaluated"] > 0
        out.append((_no_wall(answer), names))
    assert out[1] == out[0]
    assert out[0][1] and all(n.startswith("repro_") for n in out[0][1])


def test_distributed_equals_serial(tmp_path):
    # the fork below happens in a process whose torch thread pool exists
    x = torch.randn(64, 64)
    assert torch.isfinite(x @ x).all()
    kw = _kw(network="resnet18")
    serial = _cold(serve, str(tmp_path), "serial", kw)
    dist = _cold(serve, str(tmp_path), "dist", dict(kw, distributed=2))
    assert dist.frontier_json == serial.frontier_json
    ref = _cold(ref_serve, str(tmp_path), "ref", dict(kw, distributed=2))
    assert dist.frontier_json == ref.frontier_json


def _code(path):
    """``ast.dump`` of a module with every docstring removed."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant) and \
                    isinstance(first.value.value, str):
                node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_mapper_module_set_equal():
    port = sorted(
        os.path.relpath(p, os.path.join(SRC, "repro_torch"))
        for d in MAPPER_DIRS
        for p in glob.glob(os.path.join(SRC, "repro_torch", d, "*.py"))) + [
            "serve/jobs.py", "serve/service.py", "serve/transport.py"]
    assert port == MAPPER_MODULES and len(MAPPER_MODULES) == 35
    assert set(INTENDED) <= set(MAPPER_MODULES)


@pytest.mark.parametrize("rel", MAPPER_MODULES)
def test_mapper_code_equals_reference(rel):
    ref = _code(os.path.join(SRC, "repro", rel))
    for before, after in INTENDED.get(rel, []):
        assert before in ref, (rel, before)
        ref = ref.replace(before, after)
    assert _code(os.path.join(SRC, "repro_torch", rel)) == ref


def test_serve_exports_reference_names():
    assert serve.__all__ == ref_serve.__all__
    assert all(hasattr(serve, n) for n in serve.__all__)
