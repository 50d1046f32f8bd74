"""The PyTorch port's MoE (``repro_torch.models.mlp``) against the JAX
package on the CPU.

Weights come from the reference ``init_moe``/``init_params`` and are
carried across as numpy; inputs come from a numpy seed. Everything runs
in fp32: routing (``gate_idx``, ``pos``, ``keep``, the capacity) must be
equal, probabilities and gates within 1e-6, outputs within 2e-5 and aux
within 1e-5 relative (the reference's own gather-vs-einsum tolerances,
``tests/test_models_smoke.py``), gradients within 1e-4.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, mlp, model_zoo  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

MOE = ["granite_moe_1b_a400m", "deepseek_moe_16b"]
Y_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    return (jax_configs.get_config(arch, smoke=True).with_(**kw),
            configs.get_config(arch, smoke=True).with_(**kw))


def _moe_params(jcfg, seed=1):
    """(reference init_moe tree, the same weights as torch tensors)."""
    jp = jax_mlp.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, tree_map(lambda _, a: torch.from_numpy(np.array(a)),
                        jax.tree_util.tree_map(np.asarray, jp))


def _x(cfg, b=2, s=16, seed=2):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


def _flat(tree):
    out = {}
    tree_map(lambda path, a: out.__setitem__(path, a), tree)
    return out


def _topk_margin(probs, k):
    """Smallest gap between neighbours among each token's k+1 largest
    probabilities: the margin a top-k flip would have crossed."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1][..., :k + 1]
    return float(np.abs(np.diff(top, axis=-1)).min())


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def test_init_mlp_overrides():
    """d_model/d_ff override the config's widths, as in the reference."""
    jcfg, cfg = _cfgs("deepseek_moe_16b")
    want = jax_mlp.init_mlp(jcfg, jax.random.PRNGKey(0), d_model=48,
                            d_ff=80)
    got = mlp.init_mlp(cfg, torch.Generator().manual_seed(0), d_model=48,
                       d_ff=80)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()} == \
        {"w1": (48, 80), "w3": (48, 80), "w2": (80, 48)}
    default = mlp.init_mlp(cfg, torch.Generator().manual_seed(0))
    assert tuple(default["w1"].shape) == (cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_moe_tree_matches_jax(arch, param_dtype):
    """Keys, shapes and dtypes of init_moe and of the whole model's
    params; the router stays fp32 whatever param_dtype is; deepseek's
    shared expert is n_shared_experts * d_ff wide."""
    jcfg, cfg = _cfgs(arch, param_dtype=param_dtype)
    dt = getattr(torch, param_dtype)
    want = _flat(jax_mlp.init_moe(jcfg, jax.random.PRNGKey(0), dtype=getattr(
        jnp, param_dtype)))
    got = _flat(mlp.init_moe(cfg, torch.Generator().manual_seed(0), dtype=dt))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert got[path].dtype == getattr(torch, arr.dtype.name), path
    assert got["router"].dtype == torch.float32
    if cfg.n_shared_experts:
        assert tuple(got["shared/w1"].shape) == (
            cfg.d_model, cfg.n_shared_experts * cfg.d_ff)
    whole_want = _flat(jax.eval_shape(
        lambda: jax_zoo.init_params(jcfg, jax.random.PRNGKey(0))))
    whole = _flat(model_zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    assert whole.keys() == whole_want.keys()
    for path, sd in whole_want.items():
        assert tuple(whole[path].shape) == sd.shape, path
        assert whole[path].dtype == getattr(torch, sd.dtype.name), path


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_round_trip_bit_exact(arch):
    """params_from_numpy carries the [L, E, D, F] expert stacks (bf16)
    and the fp32 router across bit for bit."""
    jcfg, cfg = _cfgs(arch, param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax_zoo.init_params(
        jcfg, jax.random.PRNGKey(3)))
    got = _flat(convert.params_from_numpy(cfg, tree, "cpu"))
    for path, want in _flat(tree).items():
        t = got[path]
        assert t.shape == want.shape and t.dtype == getattr(
            torch, want.dtype.name), path
        ints = (np.int16, torch.int16) if want.dtype.itemsize == 2 \
            else (np.int32, torch.int32)
        np.testing.assert_array_equal(t.view(ints[1]).numpy(),
                                      want.view(ints[0]), err_msg=path)
    L, E = cfg.n_layers, cfg.n_experts
    assert tuple(got["layers/moe/w1"].shape) == (L, E, cfg.d_model, cfg.d_ff)
    assert tuple(got["layers/moe/w2"].shape) == (L, E, cfg.d_ff, cfg.d_model)
    assert got["layers/moe/router"].dtype == torch.float32


def test_active_params_count():
    """Total less the routed experts except their top_k/E share; the
    shared expert counts in full. Full configs via shapes only."""
    counts = {}
    for arch in MOE + ["olmo_1b"]:
        jcfg = jax_configs.get_config(arch)
        shapes = jax.eval_shape(
            lambda: jax_zoo.init_params(jcfg, jax.random.PRNGKey(0)))
        meta = jax.tree_util.tree_map(
            lambda s: torch.empty(s.shape, device="meta"), shapes)
        cfg = configs.get_config(arch)
        counts[arch] = (cfg.params_count(meta),
                        model_zoo.active_params_count(cfg, meta))
    assert counts["olmo_1b"][0] == counts["olmo_1b"][1]
    for arch in MOE:
        cfg = configs.get_config(arch)
        L, E, D, Fe = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
        routed = L * 3 * E * D * Fe
        total, active = counts[arch]
        assert active == total - routed + routed * cfg.top_k // E
    assert counts["granite_moe_1b_a400m"] == (1386005504, 480035840)
    assert counts["deepseek_moe_16b"] == (16879568896, 2830747648)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("moe_shards,cf,b,s", [
    (1, 1.25, 2, 16), (2, 1.25, 2, 16), (2, 0.5, 2, 16), (1, 0.5, 2, 16),
    (3, 1.25, 2, 17),   # 34 tokens: 3 does not divide them, so one shard
    (4, 1.25, 1, 1),    # one token: capacity min(k, 1)
])
def test_route_matches_jax(arch, moe_shards, cf, b, s):
    """_route's integer outputs equal the reference's (gate_idx, pos,
    keep, the capacity, the choices per expert); probs and gates within
    1e-6. A top-k flip reports the margin that caused it."""
    jcfg, cfg = _cfgs(arch, moe_shards=moe_shards, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = _x(cfg, b, s)
    t = b * s
    ns = moe_shards if t % moe_shards == 0 else 1
    assert mlp._shards(cfg, t) == ns
    xt = x.reshape(ns, t // ns, cfg.d_model)
    probs, gates, idx, pos, keep, cap, onehot = jax_mlp._route(
        jcfg, jp, jnp.asarray(xt))
    tprobs, tgates, tidx, tpos, tkeep, tcap, counts = mlp._route(
        cfg, tp, torch.from_numpy(xt))
    assert tcap == cap == mlp.capacity(cfg, t // ns)
    margin = _topk_margin(probs, cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx),
                                  err_msg=f"top-k margin {margin:.3e}")
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(onehot).sum(axis=(1, 2)))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates),
                               rtol=1e-6, atol=1e-6)
    if cf == 0.5 and s > 1:
        assert not bool(tkeep.all())       # the case drops choices


# ---------------------------------------------------------------------------
# moe: outputs, aux, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("moe_shards,cf", [(1, 1.25), (2, 0.5), (3, 1.25)])
def test_moe_matches_jax(arch, impl, moe_shards, cf):
    """The port's moe_gather / moe_einsum against the reference's ``moe``
    (which dispatches to the same impl): y within 2e-5, aux within 1e-5
    relative."""
    jcfg, cfg = _cfgs(arch, moe_impl=impl, moe_shards=moe_shards,
                      capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = _x(cfg)
    want_y, want_aux = jax_mlp.moe(jcfg, jp, jnp.asarray(x))
    fn = mlp.moe_gather if impl == "gather" else mlp.moe_einsum
    got_y, got_aux = fn(cfg, tp, torch.from_numpy(x))
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert got_aux.dtype == torch.float32 and float(got_aux) > 0
    dispatched, _ = mlp.moe(cfg, tp, torch.from_numpy(x))
    assert torch.equal(dispatched, got_y)


def test_moe_gather_equals_einsum():
    """Twin of the reference's test: both dispatch implementations route
    identically, so give the same outputs (deepseek smoke, shared expert,
    moe_shards 2)."""
    jcfg, cfg = _cfgs("deepseek_moe_16b", moe_shards=2)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(cfg))
    yg, ag = mlp.moe_gather(cfg, tp, x)
    ye, ae = mlp.moe_einsum(cfg, tp, x)
    torch.testing.assert_close(yg, ye, **Y_TOL)
    np.testing.assert_allclose(float(ag), float(ae), rtol=1e-5)


def test_moe_capacity_drops_consistently():
    """Twin of the reference's test at capacity_factor 0.5 (granite smoke,
    no shared expert). Dropped choices keep gate 0 and add nothing: a
    token all of whose choices were dropped gets y = 0 exactly."""
    jcfg, cfg = _cfgs("granite_moe_1b_a400m", capacity_factor=0.5)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(cfg, 2, 32, seed=3))
    yg, _ = mlp.moe_gather(cfg, tp, x)
    ye, _ = mlp.moe_einsum(cfg, tp, x)
    torch.testing.assert_close(yg, ye, **Y_TOL)
    _, gates, _, _, keep, _, _ = mlp._route(cfg, tp, x.reshape(1, 64, -1))
    assert bool((gates[~keep] == 0).all())
    none_kept = ~keep.any(-1)[0]
    assert bool(none_kept.any())
    assert bool((yg.reshape(64, -1)[none_kept] == 0).all())


def test_moe_empty_slots_read_the_zero_row():
    """Empty slots read the zero sentinel: with one token each expert has
    min(k, 1) = 1 slot, and the experts it did not choose get xe = 0
    (granite smoke)."""
    _, cfg = _cfgs("granite_moe_1b_a400m")
    _, tp = _moe_params(_cfgs("granite_moe_1b_a400m")[0])
    seen = {}
    real = mlp._experts

    def spy(params, xe, dtype):
        seen["xe"] = xe
        return real(params, xe, dtype)

    x = torch.from_numpy(_x(cfg, 1, 1))
    try:
        mlp._experts = spy
        mlp.moe_gather(cfg, tp, x)
    finally:
        mlp._experts = real
    xe = seen["xe"][0]                            # [E, cap, D]
    filled = xe.abs().sum(-1) > 0                 # [E, cap]
    assert xe.shape[1] == mlp.capacity(cfg, 1) == 1     # min(k, tl)
    assert int(filled.sum()) == cfg.top_k
    assert bool((xe[filled] == x.reshape(1, -1)).all())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_grads_match_jax(arch, impl, cf):
    """Gradients of sum(y * w) + aux with respect to x and every moe
    leaf (router, experts, shared expert) against jax.grad of the
    reference, within 1e-4."""
    jcfg, cfg = _cfgs(arch, moe_impl=impl, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = _x(cfg)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_mlp.moe(jcfg, p, xx)
        return (y * jnp.asarray(w)).sum() + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_map(lambda _, t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = mlp.moe(cfg, leaves, xt)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = _flat(jax.tree_util.tree_map(np.asarray, jgp))
    got = _flat(leaves)
    assert got.keys() == want.keys()
    for path, g in want.items():
        np.testing.assert_allclose(got[path].grad.numpy(), g, err_msg=path,
                                   **GRAD_TOL)
    assert float(got["router"].grad.abs().sum()) > 0


def test_row_gather_backward_is_autograds_scatter():
    """_RowGather's backward (a gather summed over a fixed number of
    readers) gives what autograd of the forward gather (a scatter-add)
    gives, on both of moe_gather's uses."""
    jcfg, cfg = _cfgs("deepseek_moe_16b", capacity_factor=0.5)
    _, tp = _moe_params(jcfg)
    x = torch.from_numpy(_x(cfg)).requires_grad_()
    dy = torch.from_numpy(np.random.RandomState(7).randn(
        *x.shape).astype(np.float32))
    y, _ = mlp.moe_gather(cfg, tp, x)
    got, = torch.autograd.grad(y, x, dy)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, src, idx, inv):
            ctx.save_for_backward(idx)
            ctx.shape = src.shape
            return mlp._take_rows(src, idx)

        @staticmethod
        def backward(ctx, dout):
            idx, = ctx.saved_tensors
            ns, n, d = ctx.shape
            pad = torch.zeros(ns, n + 1, d, dtype=dout.dtype)
            pad.scatter_add_(1, idx[..., None].expand(-1, -1, d), dout)
            return pad[:, :n], None, None

    real = mlp._RowGather
    try:
        mlp._RowGather = Plain
        y2, _ = mlp.moe_gather(cfg, tp, x)
        want, = torch.autograd.grad(y2, x, dy)
    finally:
        mlp._RowGather = real
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
