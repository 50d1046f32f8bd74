"""The PyTorch port's training half against the JAX package on the CPU:
loss and gradients, remat policies, AdamW and the train steps, the
synthetic stream, the msgpack codec and ``.rpck`` checkpoints across the
two packages, and the port's Trainer (twins of the two reference
trainer tests, which fail under this jax) and launchers."""
import functools
import glob
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import convert, model_zoo  # noqa: E402
from repro_torch.models.common import tree_get, tree_map  # noqa: E402
from repro_torch.train import _msgpack  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,  # noqa: E402
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, lr_schedule,
                                         topk_compress)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 parity, as the forward's


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jcfg = jax_configs.get_config(arch, smoke=True).with_(
        compute_dtype="float32")
    return jcfg, jax.jit(lambda k: jax_zoo.init_params(jcfg, k))(
        jax.random.PRNGKey(0))


def _pair(arch):
    """(jax cfg, port cfg, jax params, port params) in fp32 compute; the
    port's params are a fresh copy (the port's steps update in place)."""
    jcfg, jparams = _jax_init(arch)
    cfg = configs.get_config(arch, smoke=True).with_(compute_dtype="float32")
    params = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _batch(vocab, b=2, s=32, seed=0, mask=False):
    toks = np.random.RandomState(seed).randint(
        0, vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (np.random.RandomState(seed + 1).rand(b, s) > 0.3
                       ).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat_jax(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree):
    out = {}
    tree_map(lambda path, t: out.__setitem__(path, t.detach().numpy()),
             tree)
    return out


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mask", [("granite_8b", False),
                                       ("olmo_1b", False),
                                       ("olmo_1b", True),
                                       ("stablelm_3b", False),
                                       ("phi3_mini_3_8b", False),
                                       ("mamba2_780m", False),
                                       ("zamba2_1_2b", False),
                                       ("granite_moe_1b_a400m", False),
                                       ("deepseek_moe_16b", True)])
def test_loss_and_grads_match_jax(arch, mask):
    """loss, metrics and every gradient leaf against
    jax.value_and_grad(repro.models.model_zoo.loss_fn) within 1e-4 in
    fp32; olmo's unread norm scales get zero gradients on both sides."""
    jcfg, cfg, jparams, params = _pair(arch)
    batch = _batch(cfg.vocab, mask=mask)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_zoo.loss_fn(jcfg, p, b), has_aux=True))(
            jparams, _jax(batch))
    loss, metrics, grads = steps.value_and_grad(cfg, params, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL)
    want, got = _flat_jax(jgrads), _flat_torch(grads)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **TOL)
    if arch == "olmo_1b":
        assert not got["layers/attn_norm"].any()
    if "moe" in arch:
        assert float(metrics["aux"]) > 0 and got["layers/moe/router"].any()


@pytest.mark.parametrize("arch", ["granite_8b", "zamba2_1_2b",
                                  "deepseek_moe_16b"])
def test_remat_policies_identical(arch):
    """full, dots and mlp recompute different parts of a layer; the loss
    and every gradient are bitwise the same."""
    _, cfg, _, params = _pair(arch)
    batch = _torch(_batch(cfg.vocab))
    runs = [steps.value_and_grad(cfg.with_(remat_policy=pol), params, batch)
            for pol in ("full", "dots", "mlp")]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        tree_map(lambda path, g: torch.testing.assert_close(
            g, tree_get(runs[0][2], path), rtol=0, atol=0), grads)


def test_remat_policy_unknown_raises():
    _, cfg, _, params = _pair("olmo_1b")
    with pytest.raises(ValueError, match="remat_policy"):
        steps.value_and_grad(cfg.with_(remat_policy="none"), params,
                             _torch(_batch(cfg.vocab)))


def test_forward_without_grad_does_not_checkpoint(monkeypatch):
    """Remat only when autograd records: a forward under no_grad never
    enters torch.utils.checkpoint."""
    from repro_torch.models import lm
    calls = []
    monkeypatch.setattr(lm, "checkpoint",
                        lambda *a, **k: calls.append(1) or None)
    _, cfg, _, params = _pair("olmo_1b")
    with torch.no_grad():
        model_zoo.forward(cfg, params, _torch(_batch(cfg.vocab)))
    assert calls == []


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1), dict(lr=3e-4, warmup_steps=0,
                                           total_steps=7)):
        cfg, jcfg = OptimizerConfig(**kw), jax_opt.OptimizerConfig(**kw)
        for step in (0, 1, 5, 10, 11, 60, 110, 200):
            got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jax_opt.lr_schedule(jcfg, jnp.asarray(
                    step))), rtol=1e-6)
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(lr_schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(lr_schedule(cfg, 110)) == pytest.approx(0.1, abs=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0),
         "b": {"c": torch.full((4,), 4.0, dtype=torch.bfloat16)}}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert clipped["b"]["c"].dtype == torch.float32
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm(g, 100.0)
    assert torch.equal(same["a"], g["a"])


def test_adamw_decreases_quadratic():
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    for _ in range(60):
        params, state, _ = adamw_update(cfg, params, {"w": 2 * params["w"]},
                                        state)
    assert float(params["w"].abs().max()) < 1.0
    assert int(state["step"]) == 60 and state["step"].dtype == torch.int32


def test_adamw_matches_jax_and_decays_gradless_leaves():
    """Five AdamW updates on a random tree with bf16 and fp32 leaves
    against the reference; a None gradient is a zero gradient, so that
    leaf still decays (as JAX's zero gradient does)."""
    rng = np.random.RandomState(0)
    shapes = {"w": (8, 5), "n": {"scale": (5,)}, "e": (3, 4)}
    p0 = tree_map(lambda _, s: rng.randn(*s).astype(np.float32), shapes)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    jcfg = jax_opt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    params = tree_map(lambda _, a: torch.from_numpy(a.copy()), p0)
    params["e"] = params["e"].to(torch.bfloat16)
    jparams = tree_map(lambda _, a: jnp.asarray(a), p0)
    jparams["e"] = jparams["e"].astype(jnp.bfloat16)
    state, jstate = init_opt_state(params), jax_opt.init_opt_state(jparams)
    for i in range(5):
        g = tree_map(lambda _, s: rng.randn(*s).astype(np.float32) * 3,
                     shapes)
        grads = tree_map(lambda _, a: torch.from_numpy(a), g)
        grads["n"]["scale"] = None
        jg = tree_map(lambda _, a: jnp.asarray(a), g)
        jg["n"]["scale"] = jnp.zeros(shapes["n"]["scale"])
        params, state, m = adamw_update(cfg, params, grads, state)
        jparams, jstate, jm = jax_opt.adamw_update(jcfg, jparams, jg, jstate)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert params["e"].dtype == torch.bfloat16
    for got, want in ((params, jparams), (state, jstate)):
        want = _flat_jax(want)
        for path, t in _flat_torch(tree_map(lambda _, t: t.float(),
                                            got)).items():
            np.testing.assert_allclose(t, np.asarray(want[path], np.float32),
                                       rtol=1e-5, atol=1e-6, err_msg=path)
    assert not np.allclose(params["n"]["scale"].numpy(), p0["n"]["scale"])


def test_topk_compress_keeps_ties_as_jax():
    g = np.arange(100, dtype=np.float32) - 50
    for arr, frac in ((g, 0.1), (np.array([3., -3., 1., 3., 0.5, -2.],
                                          np.float32), 0.3)):
        got = topk_compress(torch.from_numpy(arr), frac=frac).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_opt.topk_compress(jnp.asarray(arr), frac)))
    ties = topk_compress(torch.tensor([3., -3., 1., 3., 0.5, -2.]), 0.3)
    assert int((ties != 0).sum()) == 3   # k = 1, three tied magnitudes


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _assert_state_close(params, opt, jparams, jopt):
    """Params within 1e-5 after lr-1e-3 steps (Adam moves each weight by
    about lr * m/sqrt(v); a gradient that differs in its last bits moves
    it by far less, measured at most 6e-6 here); moments within 1e-4
    relative plus an absolute floor below their smallest scale."""
    want = _flat_jax({"params": jparams, "opt": jopt})
    got = _flat_torch({"params": params, "opt": opt})
    assert set(got) == set(want)
    for path, w in want.items():
        tol = dict(rtol=1e-5, atol=1e-5) if path.startswith("params") \
            else dict(rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


@pytest.mark.parametrize("arch", ["olmo_1b", "granite_8b",
                                  "granite_moe_1b_a400m"])
def test_train_steps_match_jax(arch):
    """Three make_train_step steps against the reference's, jitted with
    no mesh: metrics within 1e-4; params and moments (_assert_state_close)."""
    jcfg, cfg, jparams, params = _pair(arch)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_opt.OptimizerConfig(**OPT)))
    step = steps.make_train_step(cfg, OptimizerConfig(**OPT))
    jopt, opt = jax_opt.init_opt_state(jparams), init_opt_state(params)
    for i in range(3):
        batch = _batch(cfg.vocab, b=4, s=16, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, _jax(batch))
        params, opt, m = step(params, opt, _torch(batch))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=k, **TOL)
    _assert_state_close(params, opt, jparams, jopt)


@pytest.mark.parametrize("arch", ["stablelm_3b", "phi3_mini_3_8b"])
def test_train_step_matches_jax_above_gradient_noise(arch):
    """One make_train_step step against the reference's. The two smoke
    configs (the same shapes) have gradient elements at fp32 noise: at
    layers/mlp/w2[0, 89, 52] JAX gives -2.27e-8 and the port -2.80e-8,
    against a leaf maximum of 0.056. Adam's first update there is
    lr_t * g / (|g| + eps) with eps 1e-8, so that noise moves the param
    by ~2e-5 on one side and not the other; over three steps it reaches
    the moments of the same hidden unit, which is why these configs are
    not in test_train_steps_match_jax. Here: metrics within 1e-4, every
    gradient within 1e-4 of its leaf's maximum, the moments as
    _assert_state_close holds them, and every param within its 1e-5
    except where the JAX gradient is nonzero but below 1e-6 of its
    leaf's maximum; such elements are few, and both gradients there are
    noise."""
    jcfg, cfg, jparams, params = _pair(arch)
    batch = _batch(cfg.vocab, b=4, s=16, seed=0)
    _, jgrads = jax.value_and_grad(
        lambda p, b: jax_zoo.loss_fn(jcfg, p, b), has_aux=True)(
            jparams, _jax(batch))
    _, _, grads = steps.value_and_grad(cfg, params, _torch(batch))
    jgrads, grads = _flat_jax(jgrads), _flat_torch(grads)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_opt.OptimizerConfig(**OPT)))
    step = steps.make_train_step(cfg, OptimizerConfig(**OPT))
    jparams, jopt, jm = jstep(jparams, jax_opt.init_opt_state(jparams),
                              _jax(batch))
    params, opt, m = step(params, init_opt_state(params), _torch(batch))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    want = _flat_jax({"params": jparams, "opt": jopt})
    got = _flat_torch({"params": params, "opt": opt})
    noise = 0
    for path, g in jgrads.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[path], g, rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
        quiet = (g != 0) & (np.abs(g) < 1e-6 * scale)
        noise += int(quiet.sum())
        assert (np.abs(grads[path][quiet]) < 1e-5 * scale).all(), path
        p = "params/" + path
        np.testing.assert_allclose(got[p][~quiet], want[p][~quiet],
                                   rtol=1e-5, atol=1e-5, err_msg=p)
        for moment in ("mu", "nu"):
            np.testing.assert_allclose(
                got[f"opt/{moment}/{path}"], want[f"opt/{moment}/{path}"],
                rtol=1e-4, atol=1e-8, err_msg=moment + path)
    assert 0 < noise < 1e-3 * sum(g.size for g in jgrads.values())


def _extra(cfg, batch, b, seed=5):
    """The audio family's frames or the vlm's image embeddings (fp32,
    from numpy), added to ``batch``."""
    name, n = {"audio": ("frames", cfg.enc_frames),
               "vlm": ("extra_embeds", cfg.img_tokens)}[cfg.family]
    batch[name] = np.random.RandomState(seed).randn(
        b, n, cfg.d_model).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["whisper_base", "llava_next_34b"])
def test_encdec_vlm_train_steps_match_jax(arch):
    """Three make_train_step steps of whisper_base (with encoder frames)
    and llava_next_34b (with image embeddings prepended) against the
    reference's, jitted with no mesh: metrics within 1e-4, params and
    moments as ``_assert_state_close``."""
    jcfg, cfg, jparams, params = _pair(arch)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_opt.OptimizerConfig(**OPT)))
    step = steps.make_train_step(cfg, OptimizerConfig(**OPT))
    jopt, opt = jax_opt.init_opt_state(jparams), init_opt_state(params)
    for i in range(3):
        batch = _extra(cfg, _batch(cfg.vocab, b=2, s=16, seed=i), 2, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, _jax(batch))
        params, opt, m = step(params, opt, _torch(batch))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=k, **TOL)
    _assert_state_close(params, opt, jparams, jopt)


def test_grad_accum_step_matches_jax():
    """One 2-micro-batch accumulation step against the reference's:
    loss is the mean of the micro losses, gradients their fp32 mean."""
    jcfg, cfg, jparams, params = _pair("granite_8b")
    jstep = jax.jit(jax_steps.make_grad_accum_train_step(
        jcfg, 2, jax_opt.OptimizerConfig(**OPT)))
    step = steps.make_grad_accum_train_step(cfg, 2, OptimizerConfig(**OPT))
    batch = {k: v.reshape(2, 2, -1)
             for k, v in _batch(cfg.vocab, b=4, s=16).items()}
    jparams, jopt, jm = jstep(jparams, jax_opt.init_opt_state(jparams),
                              _jax(batch))
    params, opt, m = step(params, init_opt_state(params), _torch(batch))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    _assert_state_close(params, opt, jparams, jopt)
    # the accumulated step is the mean of the two micro-steps' gradients
    g = [steps.value_and_grad(cfg, convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, _pair("granite_8b")[2]),
        "cpu"), {k: torch.from_numpy(v[i]) for k, v in batch.items()})
        for i in range(2)]
    np.testing.assert_allclose(float(m["loss"]),
                               (float(g[0][0]) + float(g[1][0])) / 2,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (1234, 0, 0, 1), (9, 17, 0, 1), (9, 3, 1, 2), (7, 5, 3, 4)])
def test_synthetic_batches_byte_identical(seed, step, shard, n_shards):
    d = dict(seed=seed, batch=8, seq=32)
    jcfg = jax_configs.get_config("olmo_1b", smoke=True)
    cfg = configs.get_config("olmo_1b", smoke=True)
    want = jax_synthetic.SyntheticStream(
        jcfg, jax_synthetic.DataConfig(**d), shard, n_shards).batch_at(step)
    got = SyntheticStream(cfg, DataConfig(**d), shard, n_shards).batch_at(
        step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    assert got["tokens"].shape == (8 // n_shards, 32)


# ---------------------------------------------------------------------------
# msgpack and .rpck checkpoints
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.RandomState(0)
    big = rng.randn(300).astype(np.float32)
    yield {"meta": {"step": 8, "mesh": [1, 1], "arch": "olmo_1b_smoke",
                    "device": "cuda"},
           "trees": {"params": {f"layers/{i}": {
               "dtype": "<f4", "shape": [300], "data": big.tobytes()}
               for i in range(20)}}}
    yield [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
           2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
           -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0]
    yield {"s": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000],
           "b": [b"", b"x" * 255, b"x" * 256, b"x" * 70000],
           "m": [{str(i): i for i in range(n)} for n in (15, 16, 70000)],
           "l": [list(range(n)) for n in (15, 16, 70000)]}


@pytest.mark.parametrize("which", range(3))
def test_msgpack_matches_msgpack(which):
    """The port's codec gives msgpack.packb(..., use_bin_type=True)'s
    bytes and decodes them (and its own) to the same value."""
    msgpack = pytest.importorskip("msgpack")
    obj = list(_payloads())[which]
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_msgpack_refuses_truncated_and_trailing():
    data = _msgpack.packb({"a": b"x" * 300})
    with pytest.raises(ValueError):
        _msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(data + b"\x00")


def _port_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": {"b": torch.tensor([1.5, -2.25, 3.0, 7.0],
                                    dtype=torch.bfloat16),
                  "step": torch.tensor(5, dtype=torch.int32)}}


def _jax_tree():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "n": {"b": jnp.asarray([1.5, -2.25, 3.0, 7.0], jnp.bfloat16),
                  "step": jnp.asarray(5, jnp.int32)}}


def _same(port, jtree):
    for path, w in _flat_jax(jtree).items():
        t = tree_get(port, path)
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      w.astype(np.float32), err_msg=path)


def test_rpck_from_jax_restores_in_port(tmp_path):
    jax_ckpt.save(str(tmp_path), 7, {"params": _jax_tree()}, meta={"x": 1})
    step, trees, meta = ckpt.restore(str(tmp_path),
                                     {"params": _port_tree()})
    assert step == 7 and meta["x"] == 1
    _same(trees["params"], _jax_tree())


def test_rpck_from_port_restores_in_jax(tmp_path):
    """The port's file (RPCK2) restores in the reference; the two
    packages' payloads are the same msgpack bytes."""
    path = ckpt.save(str(tmp_path / "port"), 3, {"params": _port_tree()},
                     meta={"arch": "t"})
    with open(path, "rb") as f:
        assert f.read(5) == b"RPCK2"
    step, trees, meta = jax_ckpt.restore(
        str(tmp_path / "port"),
        {"params": jax.eval_shape(lambda: _jax_tree())})
    assert step == 3 and meta["arch"] == "t"
    _same(_port_tree(), trees["params"])
    assert trees["params"]["n"]["b"].dtype == jnp.bfloat16
    jpath = jax_ckpt.save(str(tmp_path / "jax"), 3,
                          {"params": _jax_tree()}, meta={"arch": "t"})
    if jax_ckpt.zstandard is None:  # both zlib: compare the payloads
        assert ckpt._load_file(path) == ckpt._load_file(jpath)


def test_rpck_corrupt_or_truncated_newest_skipped(tmp_path):
    t = _port_tree()
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, {"params": t})
    files = sorted(glob.glob(str(tmp_path / "*.rpck")))
    with open(files[-1], "wb") as f:
        f.write(b"garbage")
    with open(files[-2], "r+b") as f:
        f.truncate(os.path.getsize(files[-2]) - 10)
    res = ckpt.restore(str(tmp_path), {"params": t})
    assert res is not None and res[0] == 1
    # another shape is not this model's checkpoint: skipped too
    other = {**t, "a": torch.zeros(3, 2)}
    assert ckpt.restore(str(tmp_path), {"params": other}) is None


def test_rpck_missing_codec_raises(tmp_path):
    t = _port_tree()
    ckpt.save(str(tmp_path), 3, {"params": t})
    blob = ckpt._MAGIC + struct.pack("<Q", 4) + b"zzzz"
    with open(str(tmp_path / "ckpt_00000009.rpck"), "wb") as f:
        f.write(blob)
    if ckpt.zstandard is None:
        with pytest.raises(ckpt.MissingCodecError):
            ckpt.restore(str(tmp_path), {"params": t})
    else:  # codec available: the forged file is plain corruption
        assert ckpt.restore(str(tmp_path), {"params": t})[0] == 3


def test_rpck_prune_and_latest(tmp_path):
    t = _port_tree()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    for s in range(5):
        ckpt.save(str(tmp_path), s, {"params": t})
    ckpt.prune(str(tmp_path), keep=2)
    assert len(glob.glob(str(tmp_path / "*.rpck"))) == 2
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert not glob.glob(str(tmp_path / "*.tmp"))


# ---------------------------------------------------------------------------
# Trainer and launchers
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases():
    """Twin of test_train_substrate.py::test_trainer_loss_decreases, on
    the port's trainer (bf16 compute, on the CPU)."""
    cfg = configs.get_config("olmo_1b", smoke=True)
    tr = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=5,
                                      total_steps=30),
                 TrainerConfig(steps=30, log_every=5),
                 DataConfig(batch=8, seq=64), device="cpu")
    tr.run()
    hist = tr.metrics_history
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.98
    # every step is timed, with no deadline set
    assert len(tr.step_seconds) == 30 and min(tr.step_seconds) > 0
    assert tr.final_state is not None


def test_trainer_failure_restart_resumes(tmp_path):
    """Twin of test_train_substrate.py::test_trainer_failure_restart_resumes:
    an injected failure at step 9, then a fresh trainer resumes from the
    step-8 checkpoint and ends at 12; the resumed run equals an unbroken
    one bitwise."""
    cfg = configs.get_config("olmo_1b", smoke=True)
    kw = dict(opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=12),
              dcfg=DataConfig(batch=4, seq=32), device="cpu")

    def trainer(d):
        return Trainer(cfg, tcfg=TrainerConfig(
            steps=12, ckpt_dir=str(d), ckpt_every=4, log_every=4), **kw)

    t1 = trainer(tmp_path / "a")
    with pytest.raises(RuntimeError, match="injected failure"):
        t1.run(fail_at=9)
    assert ckpt.latest_step(str(tmp_path / "a")) == 8
    t2 = trainer(tmp_path / "a")
    t2.run()
    assert t2.step == 12
    assert ckpt.latest_step(str(tmp_path / "a")) == 12
    t3 = trainer(tmp_path / "b")
    t3.run()
    for got, want in zip(t2.final_state, t3.final_state):
        tree_map(lambda path, t: torch.testing.assert_close(
            t, tree_get(want, path), rtol=0, atol=0), got)


def test_whisper_trainer_resumes_bitwise(tmp_path):
    """whisper_base smoke through the port's Trainer on the CPU (the
    synthetic stream draws its frames): 4 steps with a checkpoint at 2, a
    restart from it equal to the unbroken run bitwise, and a falling
    loss."""
    cfg = configs.get_config("whisper_base", smoke=True)
    kw = dict(opt_cfg=OptimizerConfig(lr=3e-3, warmup_steps=1,
                                      total_steps=4),
              dcfg=DataConfig(batch=4, seq=16), device="cpu")

    def trainer(d):
        return Trainer(cfg, tcfg=TrainerConfig(
            steps=4, ckpt_dir=str(d), ckpt_every=2, log_every=1), **kw)

    t1 = trainer(tmp_path / "a")
    with pytest.raises(RuntimeError, match="injected failure"):
        t1.run(fail_at=3)
    t2 = trainer(tmp_path / "a")
    t2.run()
    t3 = trainer(tmp_path / "b")
    t3.run()
    losses = [h["loss"] for h in t3.metrics_history]
    assert len(losses) == 4 and losses[-1] < losses[0]
    for got, want in zip(t2.final_state, t3.final_state):
        tree_map(lambda path, t: torch.testing.assert_close(
            t, tree_get(want, path), rtol=0, atol=0), got)


def test_train_launcher_whisper_on_cpu(tmp_path, capsys):
    """``launch.train --arch whisper_base --device cpu`` (the smoke
    config, frames drawn by the stream) trains and checkpoints."""
    d = str(tmp_path)
    train_launcher.main(["--arch", "whisper_base", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt", d])
    assert ckpt.latest_step(d) == 2
    assert "'loss'" in capsys.readouterr().out


def test_train_launcher_model_parallel_needs_torchrun():
    with pytest.raises(SystemExit, match="torchrun"):
        train_launcher.main(["--device", "cpu", "--model-parallel", "2"])


def test_trainer_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(configs.get_config("olmo_1b", smoke=True))


def test_train_then_serve_ckpt_launchers(tmp_path, capsys):
    """launch.train writes checkpoints; launch.serve --ckpt serves the
    newest one's params (the tokens differ from the random weights')."""
    d = str(tmp_path)
    train_launcher.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt", d])
    assert ckpt.latest_step(d) == 3
    args = ["--device", "cpu", "--batch", "2", "--new-tokens", "4"]
    serve_launcher.main(args + ["--ckpt", d])
    out = capsys.readouterr().out
    assert "restored params of step 3" in out
    with pytest.raises(SystemExit, match="no valid checkpoint"):
        serve_launcher.main(args + ["--ckpt", str(tmp_path / "empty")])
