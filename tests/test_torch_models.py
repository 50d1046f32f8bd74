"""PyTorch port's dense LM vs the JAX reference on the CPU.

Weights are built once by the reference ``init_params`` and carried
across with ``params_from_numpy``; tokens come from numpy. Logits are
compared in fp32 (``compute_dtype="float32"``) within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import inputs as jax_inputs  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common, convert, inputs, model_zoo  # noqa: E402

DENSE = ["granite_8b", "olmo_1b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, **kw):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32", **kw)
    cfg = configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32", **kw)
    jparams = jax_zoo.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.params_from_numpy(cfg, tree, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_registry_matches(arch, smoke):
    want = jax_configs.get_config(arch, smoke=smoke)
    got = configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.padded_vocab, got.d_inner, got.ssm_heads) == \
        (want.hd, want.padded_vocab, want.d_inner, want.ssm_heads)
    assert configs.ALIASES == jax_configs.ALIASES
    assert configs.cell_status(arch, "long_500k") == \
        jax_configs.cell_status(arch, "long_500k")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(param_dtype):
    cfg_j = jax_configs.get_config("granite_8b", smoke=True).with_(
        param_dtype=param_dtype)
    cfg = configs.get_config("granite_8b", smoke=True).with_(
        param_dtype=param_dtype)
    jparams = jax_zoo.init_params(cfg_j, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = convert.params_from_numpy(cfg, tree, "cpu")
    flat_j, flat_t = {}, {}
    common.tree_map(lambda path, a: flat_j.__setitem__(path, a), tree)
    common.tree_map(lambda path, t: flat_t.__setitem__(path, t), params)
    assert flat_t.keys() == flat_j.keys()
    for key, want in flat_j.items():
        got = flat_t[key]
        assert got.shape == want.shape and got.dtype == getattr(
            torch, want.dtype.name)
        ints = (np.int16, torch.int16) if want.dtype.itemsize == 2 \
            else (np.int32, torch.int32)
        np.testing.assert_array_equal(got.view(ints[1]).numpy(),
                                      want.view(ints[0]))
    assert cfg.params_count(params) == cfg_j.params_count(jparams)


def test_params_from_numpy_rejects_other_config():
    jcfg, cfg, jparams, _ = _pair("granite_8b")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    for other in (cfg.with_(n_layers=3), cfg.with_(d_model=128)):
        with pytest.raises(ValueError):
            convert.params_from_numpy(other, tree, "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (2, 12)).astype(np.int32)
    want, _ = jax_zoo.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model_zoo.forward(cfg, params,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert float(aux) == 0.0
    if cfg.padded_vocab != cfg.vocab:
        assert (_np(got)[..., cfg.vocab:] == -1e9).all()

    jl, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(toks), 24)
    tl, tc = model_zoo.prefill(cfg, params, torch.from_numpy(toks), 24)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tc["layers"]["k"]),
                               _np(jc["layers"]["k"]), **TOL)
    for _ in range(2):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jl, jc = jax_zoo.decode_step(jcfg, jparams, jc, jnp.asarray(nxt))
        tl, tc = model_zoo.decode_step(cfg, params, tc,
                                       torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert tc["pos"] == int(jc["pos"])


def test_olmo_vocab_mask_is_live():
    cfg = configs.get_config("olmo_1b")
    assert cfg.padded_vocab == 50688 != cfg.vocab


def test_engine_prefill_decode_consistency():
    """Twin of tests/test_train_substrate.py: the greedy continuation
    from prefill equals the teacher-forced argmax of the full forward at
    the same position (KV-cache correctness)."""
    cfg = configs.get_config("olmo_1b", smoke=True)
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (1, 12)).astype(np.int32))
    logits_full, _ = model_zoo.forward(cfg, params, {"tokens": prompt})
    logits_pf, _ = model_zoo.prefill(cfg, params, prompt, max_seq=32)
    assert int(torch.argmax(logits_pf[0])) == \
        int(torch.argmax(logits_full[0, -1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_jax(dtype):
    cfg = configs.get_config("granite_8b", smoke=True)
    jcfg = jax_configs.get_config("granite_8b", smoke=True)
    rng = np.random.RandomState(2)
    xj = jnp.asarray(rng.randn(2, 5, 4, cfg.hd) * 3).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    scale = rng.randn(cfg.hd).astype(np.float32)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    f32 = lambda a: np.asarray(a, np.float32) if not isinstance(  # noqa
        a, torch.Tensor) else a.float().numpy()
    np.testing.assert_allclose(
        f32(common.rmsnorm(xt, torch.from_numpy(scale))),
        f32(jax_common.rmsnorm(xj, jnp.asarray(scale))), **tol)
    np.testing.assert_allclose(f32(common.layernorm_np(xt)),
                               f32(jax_common.layernorm_np(xj)), **tol)
    pos = np.arange(5) + 7
    cj, sj = jax_common.rope_freqs(jcfg, jnp.asarray(pos))
    ct, st = common.rope_freqs(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(f32(ct), f32(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(common.apply_rope(xt, ct, st)),
                               f32(jax_common.apply_rope(xj, cj, sj)), **tol)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(mlp_kind):
    from repro.models import mlp as jax_mlp
    from repro_torch.models import mlp
    jcfg, cfg, _, _ = _pair("granite_8b", mlp=mlp_kind)
    p = jax_mlp.init_mlp(jcfg, jax.random.PRNGKey(1))
    x = np.random.RandomState(4).randn(2, 3, cfg.d_model).astype(np.float32)
    want = jax_mlp.mlp(jcfg, p, jnp.asarray(x))
    got = mlp.mlp(cfg, {k: torch.from_numpy(np.array(v))
                        for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_inputs_bit_identical():
    cfg = configs.get_config("granite_8b", smoke=True)
    jcfg = jax_configs.get_config("granite_8b", smoke=True)
    want = jax_inputs.make_train_batch(jcfg, 3, 9, seed=5)
    got = inputs.make_train_batch(cfg, 3, 9, seed=5)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(
        inputs.make_decode_tokens(cfg, 4, seed=6).numpy(),
        np.asarray(jax_inputs.make_decode_tokens(jcfg, 4, seed=6)))


@pytest.mark.parametrize("arch", ["mamba2_780m", "granite_moe_1b_a400m",
                                  "whisper_base", "llava_next_34b"])
def test_other_families_raise(arch):
    cfg = configs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_zoo.init_cache(cfg, 1, 8)
