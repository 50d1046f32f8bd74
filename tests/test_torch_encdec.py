"""The PyTorch port's encoder-decoder (whisper_base) and VLM
(llava_next_34b) against the JAX package on the CPU, and the attention
keywords both need (cross-attention, RoPE positions, head overrides).

Weights are built once by the reference ``init_params`` and carried
across with ``params_from_numpy``; inputs come from seeded numpy. fp32
compute, within 1e-4.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import inputs as jax_inputs  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention, common, convert  # noqa: E402
from repro_torch.models import encdec, inputs, model_zoo  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER, LLAVA = "whisper_base", "llava_next_34b"


@functools.lru_cache(maxsize=None)
def _jax_init(arch, param_dtype="float32"):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32", param_dtype=param_dtype)
    return jcfg, jax.jit(lambda k: jax_zoo.init_params(jcfg, k))(
        jax.random.PRNGKey(0))


def _pair(arch):
    """(jax cfg, port cfg, jax params, port params), fp32 compute."""
    jcfg, jparams = _jax_init(arch)
    cfg = configs.get_config(arch, smoke=True).with_(compute_dtype="float32")
    return jcfg, cfg, jparams, convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _flat(tree):
    out = {}
    common.tree_map(lambda path, a: out.__setitem__(path, a), tree)
    return out


def _flat_jax(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(cfg, b=2, s=12, seed=0):
    """tokens, labels and the family's extra input (frames [B, T, D] for
    audio, extra_embeds [B, img_tokens, D] for vlm), numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.randn(b, cfg.enc_frames,
                                  cfg.d_model).astype(np.float32)
    else:
        out["extra_embeds"] = rng.randn(b, cfg.img_tokens,
                                        cfg.d_model).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# parameters and inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_encdec_init_tree_matches_jax(param_dtype):
    """The port's own init draws the reference's tree (paths, shapes,
    dtypes; norm scales fp32 ones), and ``params_from_numpy`` carries the
    reference's tree across bit-exact."""
    jcfg, jparams = _jax_init(WHISPER, param_dtype)
    cfg = configs.get_config(WHISPER, smoke=True).with_(
        compute_dtype="float32", param_dtype=param_dtype)
    want = _flat_jax(jparams)
    got = _flat(model_zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert got[path].dtype == getattr(torch, arr.dtype.name), path
        if "norm" in path:
            assert (got[path] == 1).all(), path
    conv = _flat(convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    for path, arr in want.items():
        ints = (np.int16, torch.int16) if arr.dtype.itemsize == 2 \
            else (np.int32, torch.int32)
        np.testing.assert_array_equal(conv[path].view(ints[1]).numpy(),
                                      arr.view(ints[0]), err_msg=path)
    assert cfg.params_count(conv) == jcfg.params_count(jparams)


@pytest.mark.parametrize("field", ["n_layers", "enc_layers"])
def test_params_from_numpy_checks_encoder_and_decoder_depth(field):
    """A tree whose ``decoder/`` (n_layers) or ``encoder/`` (enc_layers)
    stacks another depth than the config's is refused."""
    _, cfg, jparams, _ = _pair(WHISPER)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    other = cfg.with_(**{field: getattr(cfg, field) + 1})
    with pytest.raises(ValueError, match="stacks 2 layers"):
        convert.params_from_numpy(other, tree, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_train_batch_bit_identical(dtype):
    jcfg = jax_configs.get_config(WHISPER, smoke=True).with_(
        compute_dtype=dtype)
    cfg = configs.get_config(WHISPER, smoke=True).with_(compute_dtype=dtype)
    want = jax_inputs.make_train_batch(jcfg, 3, 9, seed=5)
    got = inputs.make_train_batch(cfg, 3, 9, seed=5)
    assert got.keys() == want.keys() == {"tokens", "labels", "frames"}
    assert got["frames"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got["frames"].float().numpy(),
                                  np.asarray(want["frames"], np.float32))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

def test_encode_and_forward_match_jax():
    jcfg, cfg, jparams, params = _pair(WHISPER)
    batch = _batch(cfg)
    want = jax_encdec.encode(jcfg, jparams, jnp.asarray(batch["frames"]))
    got = encdec.encode(cfg, params, torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want, want_aux = jax_zoo.forward(jcfg, jparams, _jax(batch))
    got, aux = model_zoo.forward(cfg, params, _torch(batch))
    assert got.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_loss_and_grads_match_jax(arch):
    """loss, metrics and every gradient leaf against
    jax.value_and_grad(model_zoo.loss_fn), frames or extra_embeds in the
    batch; each layer recomputed in the backward on the port's side."""
    jcfg, cfg, jparams, params = _pair(arch)
    batch = _batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_zoo.loss_fn(jcfg, p, b), has_aux=True))(
            jparams, _jax(batch))
    loss, metrics, grads = steps.value_and_grad(cfg, params, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL)
    want, got = _flat_jax(jgrads), _flat(grads)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(_np(got[path]), want[path], err_msg=path,
                                   **TOL)
        assert np.abs(want[path]).sum() > 0, path


def _assert_kv_close(got, want):
    for key in ("k", "v"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL)


def test_prefill_and_decode_match_jax():
    """model_zoo.prefill (frames) and 3 greedy decode steps: logits, the
    self and cross caches, pos."""
    jcfg, cfg, jparams, params = _pair(WHISPER)
    batch = _batch(cfg)
    jl, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(batch["tokens"]), 24,
                             frames=jnp.asarray(batch["frames"]))
    tl, tc = model_zoo.prefill(cfg, params, torch.from_numpy(batch["tokens"]),
                               24, frames=torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_kv_close(tc["cross"], jc["cross"])
    _assert_kv_close(tc["self"], jc["self"])
    for _ in range(3):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jl, jc = jax_zoo.decode_step(jcfg, jparams, jc, jnp.asarray(nxt))
        tl, tc = model_zoo.decode_step(cfg, params, tc,
                                       torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        _assert_kv_close(tc["self"], jc["self"])
        _assert_kv_close(tc["cross"], jc["cross"])
        assert tc["pos"] == int(jc["pos"])


def test_audio_prefill_primes_only_the_cross_cache():
    """The reference's audio prefill (repro/models/model_zoo.py:56-65),
    copied: the self-attention cache stays all zeros and pos stays 0, so
    the first decoded token sits at position 0 and attends to itself
    only; the cross cache holds every frame's keys and values."""
    _, cfg, _, params = _pair(WHISPER)
    batch = _torch(_batch(cfg))
    _, cache = model_zoo.prefill(cfg, params, batch["tokens"], 24,
                                 frames=batch["frames"])
    assert cache["pos"] == 0
    assert not cache["self"]["k"].any() and not cache["self"]["v"].any()
    assert tuple(cache["cross"]["k"].shape) == (
        cfg.n_layers, 2, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
    assert cache["cross"]["k"].abs().sum(dim=(2, 3, 4)).all()
    _, cache = model_zoo.decode_step(cfg, params, cache,
                                     torch.zeros(2, dtype=torch.int32))
    assert cache["pos"] == 1
    assert cache["self"]["k"][:, :, 0].abs().sum() > 0
    assert not cache["self"]["k"][:, :, 1:].any()


def test_prefill_runs_the_encoder_once(monkeypatch):
    """The reference runs the encoder twice per audio prefill (priming,
    then forward); the port runs it once and feeds both. Cache and
    logits equal the two-run composition (prime_cross_cache + forward)
    bitwise."""
    _, cfg, _, params = _pair(WHISPER)
    batch = _torch(_batch(cfg))
    calls = []
    real = encdec.encode

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(encdec, "encode", spy)
    logits, cache = model_zoo.prefill(cfg, params, batch["tokens"], 24,
                                      frames=batch["frames"])
    assert len(calls) == 1
    two = model_zoo.init_cache(cfg, 2, 24)
    two = encdec.prime_cross_cache(cfg, params, two, batch["frames"])
    full, _ = encdec.forward(cfg, params, batch["tokens"], batch["frames"])
    assert len(calls) == 3
    assert torch.equal(logits, full[:, -1])
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert torch.equal(cache[part][key], two[part][key])


def test_padded_vocab_logits_unmasked_as_reference():
    """encdec masks no padded-vocab column (no _vocab_mask): whisper's
    51865 pads to 52224, and the padding's logits are the unembedding's,
    as in JAX; so a greedy argmax may be an id >= vocab, which the smoke
    weights show."""
    assert configs.get_config(WHISPER).padded_vocab == 52224
    jcfg, cfg, jparams, params = _pair(WHISPER)
    batch = _batch(cfg)
    want, _ = jax_zoo.forward(jcfg, jparams, _jax(batch))
    got, _ = model_zoo.forward(cfg, params, _torch(batch))
    pad = _np(got)[..., cfg.vocab:]
    assert pad.shape[-1] == cfg.padded_vocab - cfg.vocab > 0
    assert np.isfinite(pad).all() and (np.abs(pad) < 1e3).all()
    np.testing.assert_allclose(pad, _np(want)[..., cfg.vocab:], **TOL)
    assert (np.argmax(_np(got), -1) >= cfg.vocab).any()


def test_prime_cross_cache_refuses_other_frame_count():
    _, cfg, _, params = _pair(WHISPER)
    cache = model_zoo.init_cache(cfg, 2, 24)
    frames = torch.zeros((2, cfg.enc_frames - 1, cfg.d_model))
    with pytest.raises(ValueError, match="cross cache"):
        encdec.prime_cross_cache(cfg, params, cache, frames)


def test_lm_refuses_the_audio_family():
    """``lm`` builds decoder-only LMs; the audio family is ``encdec``'s
    (model_zoo dispatches it there), so lm's init raises for it, as the
    reference's ``_init_layer`` does."""
    from repro_torch.models import lm
    cfg = configs.get_config(WHISPER, smoke=True)
    with pytest.raises(ValueError, match="not a decoder-only LM"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))


def test_prefill_frames_only_for_audio():
    _, cfg, _, params = _pair(WHISPER)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs frames"):
        model_zoo.prefill(cfg, params, toks, 8)
    _, lcfg, _, lparams = _pair(LLAVA)
    with pytest.raises(ValueError, match="audio family"):
        model_zoo.prefill(lcfg, lparams, toks, 8,
                          frames=torch.zeros((1, 2, lcfg.d_model)))


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------

def test_vlm_image_embeds_path():
    """Twin of tests/test_models_smoke.py::test_vlm_image_embeds_path,
    held to JAX: extra_embeds prepended, their positions dropped from the
    logits [B, S, Vp], the padded vocab masked."""
    jcfg, cfg, jparams, params = _pair(LLAVA)
    batch = _batch(cfg)
    want, _ = jax_zoo.forward(jcfg, jparams, _jax(batch))
    got, aux = model_zoo.forward(cfg, params, _torch(batch))
    assert got.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert float(aux) == 0
    assert (_np(got)[..., cfg.vocab:] == -1e9).all()
    plain, _ = model_zoo.forward(cfg, params, {"tokens": torch.from_numpy(
        batch["tokens"])})
    assert not torch.allclose(plain, got, **TOL)


def test_vlm_prefill_decode_match_jax():
    """llava's token-only serving path (the reference's): prefill and two
    decode steps, logits and the KV cache."""
    jcfg, cfg, jparams, params = _pair(LLAVA)
    toks = _batch(cfg)["tokens"]
    jl, jc = jax_zoo.prefill(jcfg, jparams, jnp.asarray(toks), 16)
    tl, tc = model_zoo.prefill(cfg, params, torch.from_numpy(toks), 16)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_kv_close(tc["layers"], jc["layers"])
    for _ in range(2):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jl, jc = jax_zoo.decode_step(jcfg, jparams, jc, jnp.asarray(nxt))
        tl, tc = model_zoo.decode_step(cfg, params, tc,
                                       torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        _assert_kv_close(tc["layers"], jc["layers"])


# ---------------------------------------------------------------------------
# attention keywords
# ---------------------------------------------------------------------------

def _attn_pair(arch, seed=1, **overrides):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32", **overrides)
    cfg = configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32", **overrides)
    return jcfg, cfg, np.random.RandomState(seed)


def _attn_params(jcfg, n_heads=None, n_kv=None):
    p = jax_attention.init_attn(jcfg, jax.random.PRNGKey(2), n_heads=n_heads,
                                n_kv=n_kv)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("case", ["cross", "positions", "heads"])
def test_attention_keywords_match_jax(case):
    """cross: ``kv_x`` with Sq != Skv (non-causal, no RoPE although the
    config uses it); positions: RoPE at ``positions`` for q and
    ``kv_positions`` for k; heads: ``n_heads``/``n_kv`` overriding the
    config's (GQA 8/2)."""
    jcfg, cfg, rng = _attn_pair("granite_8b")
    assert cfg.use_rope
    kw, jkw = {}, {}
    n_heads = n_kv = None
    x = rng.randn(2, 6, cfg.d_model).astype(np.float32)
    if case == "cross":
        kv_x = rng.randn(2, 10, cfg.d_model).astype(np.float32)
        kw, jkw = ({"causal": False, "kv_x": torch.from_numpy(kv_x)},
                   {"causal": False, "kv_x": jnp.asarray(kv_x)})
    elif case == "positions":
        pos, kpos = np.arange(6) + 5, np.arange(6) * 2 + 1
        kw = {"positions": torch.from_numpy(pos),
              "kv_positions": torch.from_numpy(kpos)}
        jkw = {"positions": jnp.asarray(pos),
               "kv_positions": jnp.asarray(kpos)}
    else:
        n_heads, n_kv = 8, 2
        jcfg, cfg, _ = _attn_pair("granite_8b", head_dim=cfg.hd)
        kw = jkw = {"n_heads": n_heads, "n_kv": n_kv}
    jp, tp = _attn_params(jcfg, n_heads, n_kv)
    want = jax_attention.attention(jcfg, jp, jnp.asarray(x), **jkw)
    got = attention.attention(cfg, tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if case == "cross":  # RoPE skipped: not the self-attention of kv_x
        assert got.shape == (2, 6, cfg.d_model)


def test_prefill_and_decode_attention_keywords_match_jax():
    """prefill_into_cache and decode_attention with ``n_heads``/``n_kv``,
    and decode_attention's ``rope=False`` on a RoPE config (whisper's
    decoder passes it; the config does not use RoPE, granite's does)."""
    jcfg, cfg, rng = _attn_pair("granite_8b")
    jcfg, cfg, _ = _attn_pair("granite_8b", head_dim=cfg.hd)
    jp, tp = _attn_params(jcfg, 8, 2)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    jcache = jax_attention.init_kv_cache(2, 8, 2, cfg.hd, jnp.float32)
    tcache = attention.init_kv_cache(2, 8, 2, cfg.hd, torch.float32)
    jy, jcache = jax_attention.prefill_into_cache(
        jcfg, jp, jnp.asarray(x), jcache, n_heads=8, n_kv=2)
    ty, tcache = attention.prefill_into_cache(
        cfg, tp, torch.from_numpy(x), tcache, n_heads=8, n_kv=2)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _assert_kv_close(tcache, jcache)
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    for pos, rope in ((5, None), (6, False)):
        jy, jcache = jax_attention.decode_attention(
            jcfg, jp, jnp.asarray(x1), jcache, pos, n_heads=8, n_kv=2,
            rope=rope)
        ty, tcache = attention.decode_attention(
            cfg, tp, torch.from_numpy(x1), tcache,
            torch.tensor(pos, dtype=torch.int32), n_heads=8, n_kv=2,
            rope=rope)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        _assert_kv_close(tcache, jcache)


def test_prefill_attend_refuses_causal_with_sq_ne_skv():
    """The kernel end-aligns causal queries, the CPU path start-aligns
    them: a causal call with Sq != Skv raises on both devices' path;
    non-causal Sq != Skv and causal Sq == Skv run."""
    q = torch.randn(1, 4, 2, 16)
    kv = torch.randn(1, 9, 2, 16)
    with pytest.raises(ValueError, match="causal attention with 4 queries "
                                         "and 9 keys"):
        attention._prefill_attend(q, kv, kv, True)
    assert attention._prefill_attend(q, kv, kv, False).shape == (1, 4, 2, 16)
    assert attention._prefill_attend(q, q, q, True).shape == (1, 4, 2, 16)
