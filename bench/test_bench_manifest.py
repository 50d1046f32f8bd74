"""The manifest and the files it names: names and units within the
allowed characters, every cell resolving to its files by name, and a new
cell, mix and metric added as files alone."""
import dataclasses
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import harness, manifest  # noqa: E402
from bench.smoke import shrink  # noqa: E402

MAN = manifest.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_has_the_contract_keys_and_only_them():
    assert set(MAN) == KEYS
    assert MAN["command"][:2] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert manifest.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text
        for key in ("config", "traffic"):
            if key in e:
                assert manifest.NAME.match(e[key])


def test_every_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in moved.get("workloads", cells), (m["name"], w)


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_every_workload_resolves_to_its_files(workload):
    cell = manifest.cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.kind in harness.KINDS
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for traced in (False, True):
        metrics = cell.metrics(traced)
        assert metrics
        for m in metrics:
            assert callable(manifest.reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2


def test_configs_state_their_sources_and_cuts():
    for c in MAN["configs"]:
        body = json.loads((manifest.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert set(body["reduced"]) <= set(body)
        assert 1 <= len(body["source"]) <= 200
        assert "assumed" in body and "departures" in body


def test_a_new_cell_mix_and_metric_are_files_alone(tmp_path):
    """A throwaway workload from files in a temporary checkout: a new mix
    and a new metric reader, found by name, with no code edited."""
    root = tmp_path
    shutil.copytree(manifest.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "olmo_1b.tiny_prefill",
                             "config": "olmo_1b", "traffic": "tiny_prefill",
                             "chips": 1, "why": "throwaway"})
    man["per_layer"].append({"name": "calls_seen", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving engine",
                             "moves": "serve_tokens_per_s",
                             "workloads": ["olmo_1b.tiny_prefill"]})
    for m in man["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("olmo_1b.tiny_prefill")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "bench" / "traffic" / "tiny_prefill.json").write_text(json.dumps(
        {"kind": "serve", "why": "throwaway", "batch": 2, "prompt": 16,
         "new_tokens": 2, "check_requests": 2, "trace_units": 2}))
    (root / "bench" / "limits" / "olmo_1b.tiny_prefill.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    (root / "bench" / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.starts)\n")
    cell = manifest.cell("olmo_1b.tiny_prefill", root)
    cell = shrink(cell)
    res, _ = harness.run(cell, 7, 0.2, True, "cpu")
    assert res["metrics"]["calls_seen"]["value"] >= 1
    res, _ = harness.run(cell, 7, 0.2, False, "cpu")
    assert "serve_tokens_per_s" in res["metrics"]
    assert "calls_seen" not in res["metrics"]
    assert dataclasses.asdict(cell)["traffic"]["prompt"] == 16
