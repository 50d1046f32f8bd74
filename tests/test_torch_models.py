"""PyTorch port's LMs (dense, moe, ssm, hybrid) vs the JAX reference on
the CPU (the encoder-decoder and the VLM: tests/test_torch_encdec.py).

Weights are built once by the reference ``init_params`` and carried
across with ``params_from_numpy``; tokens come from numpy. Logits are
compared in fp32 (``compute_dtype="float32"``) within 1e-4.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import inputs as jax_inputs  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common, convert, inputs, model_zoo  # noqa: E402

DENSE = ["granite_8b", "olmo_1b", "stablelm_3b", "phi3_mini_3_8b"]
MOE = ["granite_moe_1b_a400m", "deepseek_moe_16b"]
SSM = ["mamba2_780m", "zamba2_1_2b"]
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
    """Every field the reference's ModelConfig has is equal; the fields
    only the port has (the leading-dense layout, the held experts, the
    top-k renormalisation and the balance loss's form; the typed hybrid
    layout and its multipliers; the published config.json keys) hold
    their defaults in every registry config."""
    want = jax_configs.get_config(arch, smoke=smoke)
    got = configs.get_config(arch, smoke=smoke)
    theirs = dataclasses.asdict(want)
    mine = dataclasses.asdict(got)
    assert {k: mine[k] for k in theirs} == theirs
    defaults = {f.name: f.default for f in dataclasses.fields(got)
                if f.name not in theirs}
    assert set(defaults) == {"first_dense_layers", "dense_d_ff",
                             "experts_held", "moe_norm_topk",
                             "router_aux", "layer_types",
                             "embedding_multiplier", "residual_multiplier",
                             "attention_multiplier", "logits_scaling",
                             *common.PUBLISHED}
    assert {k: mine[k] for k in defaults} == defaults
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


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_prefill_decode_match_jax(arch):
    """Logits and aux (0 for dense; the layers' summed load-balancing
    terms for moe) of forward, then prefill and two decode steps."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (2, 12)).astype(np.int32)
    want, want_aux = jax_zoo.forward(jcfg, jparams,
                                     {"tokens": jnp.asarray(toks)})
    got, aux = model_zoo.forward(cfg, params,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")
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


# ---------------------------------------------------------------------------
# ssm (Mamba-2) and hybrid (Zamba-2)
# ---------------------------------------------------------------------------

def _flat(tree):
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    common.tree_map(lambda path, a: out.__setitem__(path, a), tree)
    return out


def _assert_ssm_cache_matches(tc, jc):
    for key in ("state", "conv_x", "conv_B", "conv_C"):
        got, want = tc["layers"][key], jc["layers"][key]
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if "attn" in jc:
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc["attn"][key]),
                                       _np(jc["attn"][key]), **TOL)
    assert tc["pos"] == int(jc["pos"])


@pytest.mark.parametrize("arch", SSM)
def test_ssm_forward_prefill_decode_match_jax(arch):
    """Forward, prefill and decode logits within 1e-4 in fp32, and the
    decode cache after prefill and after each step (SSM state, pre-conv
    conv buffers, the hybrid's shared KV slots)."""
    jcfg, cfg, jparams, params = _pair(arch)
    toks = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (2, 32)).astype(np.int32)
    want, _ = jax_zoo.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model_zoo.forward(cfg, params,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert float(aux) == 0.0

    jl, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(toks), 40)
    tl, tc = model_zoo.prefill(cfg, params, torch.from_numpy(toks), 40)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_ssm_cache_matches(tc, jc)
    for _ in range(3):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jl, jc = jax_zoo.decode_step(jcfg, jparams, jc, jnp.asarray(nxt))
        tl, tc = model_zoo.decode_step(cfg, params, tc,
                                       torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        _assert_ssm_cache_matches(tc, jc)


@pytest.mark.parametrize("prompt_len", [1, 2, 3, 5])
def test_ssm_cache_from_short_prompt_matches_jax(prompt_len):
    """Prompts shorter than, equal to and longer than ssm_conv - 1: the
    conv buffers hold the last pre-conv, pre-SiLU projections,
    left-padded with zeros (repro/models/lm.py:334-361)."""
    from repro.models import lm as jax_lm
    from repro_torch.models import ssm
    jcfg, cfg, jparams, params = _pair("mamba2_780m")
    rng = np.random.RandomState(prompt_len)
    h = rng.randn(2, prompt_len, cfg.d_model).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["ssm"])
    want = jax_lm._ssm_cache_from_prefill(
        jcfg, jlp, jnp.asarray(h),
        {"conv_x": jnp.zeros((), jnp.float32)})
    lp = {k: t[0] for k, t in params["layers"]["ssm"].items()}
    lc = ssm.init_ssm_cache(cfg, 2)
    for t in lc.values():
        t.fill_(7.0)  # prefill overwrites every entry, padding included
    _, got = ssm.mamba2_prefill(cfg, lp, torch.from_numpy(h), lc)
    for key in ("state", "conv_x", "conv_B", "conv_C"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL)
    if prompt_len < cfg.ssm_conv - 1:
        assert (got["conv_x"][:, :cfg.ssm_conv - 1 - prompt_len] == 0).all()


def test_hybrid_kv_slot_layout_matches_jax():
    """ceil(L / attn_every) shared KV slots, slot idx // attn_every written
    after layer idx with idx % attn_every == attn_every - 1: at zamba2's
    38 layers and attn_every 6 that is 7 slots, 6 used."""
    full = configs.get_config("zamba2_1_2b")
    jfull = jax_configs.get_config("zamba2_1_2b")
    shapes = jax.eval_shape(lambda: jax_zoo.init_cache(jfull, 2, 64))
    cache = model_zoo.init_cache(full, 2, 64, device="meta")
    assert _flat(cache["attn"]).keys() == {"k", "v"}
    for key in ("k", "v"):
        assert tuple(cache["attn"][key].shape) == shapes["attn"][key].shape \
            == (7, 2, 64, full.n_kv_heads, full.hd)
    for key in ("state", "conv_x", "conv_B", "conv_C"):
        assert tuple(cache["layers"][key].shape) == \
            shapes["layers"][key].shape
        assert cache["layers"][key].dtype == getattr(
            torch, shapes["layers"][key].dtype.name)

    jcfg, cfg, jparams, params = _pair("zamba2_1_2b", n_layers=38,
                                       attn_every=6)
    toks = np.random.RandomState(1).randint(0, cfg.vocab,
                                            (1, 16)).astype(np.int32)
    jl, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(toks), 20)
    tl, tc = model_zoo.prefill(cfg, params, torch.from_numpy(toks), 20)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_ssm_cache_matches(tc, jc)
    used = [bool(tc["attn"]["k"][slot].abs().sum() > 0) for slot in range(7)]
    assert used == [True] * 6 + [False]


@pytest.mark.parametrize("arch", DENSE + SSM + ["deepseek_moe_16b",
                                                 "granite_moe_1b_a400m",
                                                 "whisper_base",
                                                 "llava_next_34b"])
def test_keeps_fp32_is_the_reference_rule(arch):
    """keeps_fp32 names exactly the leaves the reference creates in fp32
    when param_dtype is bfloat16, and the converter keeps them so; for
    the moe archs that includes the router (repro/models/mlp.py:52), for
    whisper_base the encoder-decoder's six norm kinds."""
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        param_dtype="bfloat16")
    cfg = configs.get_config(arch, smoke=True).with_(param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_zoo.init_params(jcfg, jax.random.PRNGKey(0)))
    flat = _flat(tree)
    for path, arr in flat.items():
        assert common.keeps_fp32(path) == (arr.dtype == np.float32), path
    params = convert.params_from_numpy(cfg, tree, "cpu",
                                       dtype=torch.bfloat16)
    for path, t in _flat(params).items():
        assert t.dtype == (torch.float32 if common.keeps_fp32(path)
                           else torch.bfloat16), path
    if cfg.is_ssm_family:
        assert {p.rsplit("/", 1)[-1] for p in flat
                if common.keeps_fp32(p) and "/ssm/" in p} == \
            {"dt_bias", "A_log", "D", "gn_scale"}
    if cfg.family == "moe":
        assert common.keeps_fp32("layers/moe/router")
        assert flat["layers/moe/router"].dtype == np.float32
    if cfg.family == "audio":
        assert {p.rsplit("/", 1)[-1] for p in flat
                if common.keeps_fp32(p)} == {
            "attn_norm", "ffn_norm", "self_norm", "cross_norm", "enc_norm",
            "final_norm"}


@pytest.mark.parametrize("arch", SSM)
def test_ssm_init_params_tree_matches_jax(arch):
    """The port's own init draws the reference's tree: same paths,
    shapes and dtypes, and the same constant leaves."""
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jax_configs.get_config(arch, smoke=True)
    want = _flat(jax.tree_util.tree_map(
        np.asarray, jax_zoo.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _flat(model_zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert got[path].dtype == getattr(torch, arr.dtype.name), path
        if path.rsplit("/", 1)[-1] in ("dt_bias", "A_log", "D", "gn_scale"):
            np.testing.assert_array_equal(_np(got[path]), arr)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_prompt_not_multiple_of_chunk_raises(arch):
    """The reference asserts S % min(ssm_chunk, S) == 0; the port raises
    a ValueError saying so, and does not pad."""
    cfg = configs.get_config(arch, smoke=True).with_(compute_dtype="float32")
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, cfg.ssm_chunk + 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        model_zoo.prefill(cfg, params, toks, 64)
    logits, _ = model_zoo.prefill(cfg, params, toks[:, :7], 64)
    assert logits.shape == (1, cfg.padded_vocab)
