"""PyTorch port's serving Engine vs the JAX Engine on the CPU, and the
port's package boundary (no JAX, nothing of ``repro``)."""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

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


def _frames(cfg, b=2):
    """The audio family's encoder input [B, T, D] (None for the others)."""
    if cfg.family != "audio":
        return None
    return np.random.RandomState(1).randn(b, cfg.enc_frames,
                                          cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("arch", ["granite_8b", "olmo_1b", "stablelm_3b",
                                  "phi3_mini_3_8b", "mamba2_780m",
                                  "zamba2_1_2b", "granite_moe_1b_a400m",
                                  "deepseek_moe_16b", "whisper_base",
                                  "llava_next_34b"])
def test_greedy_tokens_match_jax_engine(arch):
    jeng, eng = _engines(arch, max_seq=40, max_new_tokens=8)
    prompts = _prompts(eng.cfg.vocab)
    frames = _frames(eng.cfg)
    want = jeng.generate(prompts, frames)
    got = eng.generate(prompts, frames)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_engine_frames_only_for_audio():
    """``generate(prompts, frames)``: the audio family needs frames, the
    others refuse them. The reference Engine, given no frames for
    whisper_base, fails (its launcher passes none, so it cannot serve
    that family); the port's launcher draws them from its seed."""
    jeng, eng = _engines("whisper_base", max_seq=24, max_new_tokens=2)
    prompts = _prompts(eng.cfg.vocab)
    with pytest.raises(ValueError, match="needs frames"):
        eng.generate(prompts)
    with pytest.raises(Exception):
        jeng.generate(prompts)
    cfg = configs.get_config("llava_next_34b", smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    lm_eng = Engine(cfg, params, ServeConfig(max_seq=24, max_new_tokens=2),
                    device="cpu")
    with pytest.raises(ValueError, match="audio family"):
        lm_eng.generate(prompts, np.zeros((2, 4, cfg.d_model), np.float32))


def test_whisper_greedy_tokens_may_fall_in_the_padded_vocab():
    """encdec masks no padded-vocab column (as the reference), so greedy
    decoding can emit ids in [vocab, padded_vocab): the smoke weights do,
    and the JAX Engine emits the same ids."""
    jeng, eng = _engines("whisper_base", max_seq=40, max_new_tokens=8)
    prompts = _prompts(eng.cfg.vocab)
    frames = _frames(eng.cfg)
    got = eng.generate(prompts, frames)
    np.testing.assert_array_equal(got, jeng.generate(prompts, frames))
    assert (got < eng.cfg.padded_vocab).all()
    assert (got >= eng.cfg.vocab).any()


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


def test_bf16_engine_keeps_reference_fp32_leaves():
    """A bf16 Engine casts the weights but keeps the leaves the reference
    keeps in fp32: norm scales and the SSM's dt_bias, A_log, D and
    gn_scale (A = -exp(A_log), softplus(dt + dt_bias) and the decode's
    D * x stay fp32, as in the reference)."""
    cfg = configs.get_config("zamba2_1_2b", smoke=True)
    assert cfg.compute_dtype == "bfloat16"
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=24, max_new_tokens=2),
                 device="cpu")
    ssm = eng.params["layers"]["ssm"]
    for key in ("dt_bias", "A_log", "D", "gn_scale"):
        assert ssm[key].dtype == torch.float32, key
    for key in ("wx", "wB", "conv_x", "wo"):
        assert ssm[key].dtype == torch.bfloat16, key
    assert eng.params["layers"]["ssm_norm"].dtype == torch.float32
    shared = eng.params["shared_attn"]
    assert shared["norm"].dtype == shared["mlp_norm"].dtype == torch.float32
    assert shared["attn"]["wq"].dtype == torch.bfloat16
    out = eng.generate(_prompts(cfg.vocab, s=16))
    assert out.shape == (2, 2) and ((out >= 0) & (out < cfg.vocab)).all()


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_ssm_engine_rejects_prompt_off_the_chunk(arch):
    """S % min(ssm_chunk, S) must be 0, as the reference asserts."""
    cfg = configs.get_config(arch, smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=40, max_new_tokens=2),
                 device="cpu")
    with pytest.raises(ValueError, match="SSD chunk"):
        eng.generate(_prompts(cfg.vocab, s=cfg.ssm_chunk + 4))
    assert eng.generate(_prompts(cfg.vocab, s=2 * cfg.ssm_chunk)).shape == \
        (2, 2)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_serve_launcher_ssm_on_cpu(arch, capsys):
    serve_launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq0", "seq1"]


@pytest.mark.parametrize("arch", ["whisper_base", "llava_next_34b"])
def test_serve_launcher_encdec_vlm_on_cpu(arch, capsys):
    """``launch.serve --arch whisper_base|llava_next_34b --device cpu``:
    whisper's frames come from the seed (the reference launcher passes
    none)."""
    serve_launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq0", "seq1"]


def test_port_imports_no_jax_and_nothing_of_repro(tmp_path):
    """Every module of the port (the training half's ``train/``,
    ``data/`` and ``launch/train.py`` and the mapper's ``core/``,
    ``dse/``, ``obs/``, ``workloads/`` and ``serve/service.py`` included),
    chip_smoke.py and the kernels' profile scripts
    (``scripts/profile_*.py``), in a fresh process, which then lowers a zoo
    scenario and answers a mapping request (the mapper's lazy imports):
    neither jax nor any ``repro`` module gets imported."""
    scripts = sorted(glob.glob(os.path.join(ROOT, "scripts", "profile_*.py")))
    assert len(scripts) >= 3, scripts
    code = (
        "import importlib, importlib.util, os, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for i, path in enumerate([{os.path.join(ROOT, 'chip_smoke.py')!r}]"
        f" + {scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from repro_torch.core.interface import describe\n"
        "assert len(describe('granite_8b_smoke:prefill@64').layers) > 0\n"
        "from repro_torch.serve import MappingRequest, MappingService\n"
        f"root = {str(tmp_path)!r}\n"
        "svc = MappingService(journal_path=os.path.join(root, 'j.jsonl'), "
        "shared_root=os.path.join(root, 'shared'))\n"
        "r = svc.request(MappingRequest(network='mamba2_780m_smoke:decode@16', "
        "explorer='grid', budget=2, n_candidates=2, max_steps=256))\n"
        "svc.close()\n"
        "assert r.served_from == 'search' and r.evaluated > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "need = ['repro_torch.train.' + m for m in ('optimizer', "
        "'checkpoint', '_msgpack', 'trainer')] + ["
        "'repro_torch.data.synthetic', 'repro_torch.launch.train'] + ["
        "'repro_torch.' + m for m in ('obs.metrics', 'core.engine', "
        "'core.search', 'dse.explore', 'dse.distrib.coordinator', "
        "'workloads.lowering', 'workloads.scenarios', 'serve.service', "
        "'serve.jobs', 'serve.transport')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "n = sum(m.startswith('repro_torch.') for m in sys.modules)\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120).stdout
    n, bad = out.strip().split(" ", 1)
    assert bad == "[]" and int(n) >= 89
