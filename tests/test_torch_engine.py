"""PyTorch port's serving Engine vs the JAX Engine on the CPU, and the
port's package boundary (no JAX, nothing of ``repro``)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import convert, model_zoo  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines(arch, **scfg):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32")
    cfg = configs.get_config(arch, smoke=True).with_(compute_dtype="float32")
    jparams = jax_zoo.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return (JaxEngine(jcfg, jparams, scfg=JaxServeConfig(**scfg)),
            Engine(cfg, params, ServeConfig(**scfg), device="cpu"))


def _prompts(vocab, b=2, s=16):
    return np.random.RandomState(0).randint(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite_8b", "olmo_1b"])
def test_greedy_tokens_match_jax_engine(arch):
    jeng, eng = _engines(arch, max_seq=40, max_new_tokens=8)
    prompts = _prompts(eng.cfg.vocab)
    want = jeng.generate(prompts)
    got = eng.generate(prompts)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_eos_masking_matches_jax_engine():
    jeng, eng = _engines("granite_8b", max_seq=40, max_new_tokens=8)
    prompts = _prompts(eng.cfg.vocab)
    eos = int(jeng.generate(prompts)[0, 2])
    for e in (jeng, eng):
        e.scfg.eos_id = eos
    want = jeng.generate(prompts)
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_temperature_sampling_deterministic_per_seed():
    cfg = configs.get_config("olmo_1b", smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab)

    def run(seed):
        return Engine(cfg, params, ServeConfig(
            max_seq=32, max_new_tokens=8, temperature=1.0, seed=seed),
            device="cpu").generate(prompts)

    a, b = run(1), run(1)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab)).all()
    assert not np.array_equal(a, run(2))


def test_engine_rejects_overlong_request():
    cfg = configs.get_config("granite_8b", smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=20, max_new_tokens=8),
                 device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(_prompts(cfg.vocab, s=13))
    assert eng.generate(_prompts(cfg.vocab, s=12)).shape == (2, 8)


def test_engine_on_cuda_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("granite_8b", smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.main(["--arch", "granite_8b"])


def test_serve_launcher_on_cpu(capsys):
    serve_launcher.main(["--arch", "granite_8b", "--device", "cpu",
                         "--batch", "2", "--new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq0", "seq1"]


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port, and chip_smoke.py, in a fresh process:
    neither jax nor any ``repro`` module gets imported."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "n = sum(m.startswith('repro_torch.') for m in sys.modules)\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120).stdout
    n, bad = out.strip().split(" ", 1)
    assert bad == "[]" and int(n) >= 20
