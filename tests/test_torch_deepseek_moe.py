"""DeepSeekMoE in the port (``repro_torch.models``: the leading dense
layer, the dropless MoE over a share of the experts, the sequence-level
balance loss) against its plain float32 reference
(``repro_torch.models.moe_ref``) on the CPU, at smoke widths with seeded
weights.

Everything runs in float32, so the port and the reference differ only in
the order of their sums: logits and losses agree within 1e-5, gradients
within 1e-4 of each leaf's largest entry.
"""
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.launch import spans, steps  # noqa: E402
from repro_torch.models import lm, mlp, model_zoo, moe_ref  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    """deepseek_moe_16b's smoke widths in the published layout: one dense
    layer of its own width, then MoE layers of 8 routed experts (top 3,
    not renormalised), 2 shared, the sequence-level balance loss."""
    base = dict(n_layers=3, first_dense_layers=1, dense_d_ff=192,
                n_experts=8, top_k=3, n_shared_experts=2,
                moe_norm_topk=False, router_aux="seq", moe_impl="dropless",
                compute_dtype="float32")
    base.update(kw)
    return configs.get_config("deepseek_moe_16b", smoke=True).with_(**base)


def _params(cfg, seed=0):
    return model_zoo.init_params(cfg, torch.Generator().manual_seed(seed))


def _batch(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, cfg.vocab, (b, s + 1), generator=g)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _flat(tree):
    out = {}
    tree_map(lambda path, t: out.__setitem__(path, t), tree)
    return out


def _ref_grads(cfg, params, batch, **share):
    leaves = tree_map(lambda _, t: t.detach().clone().requires_grad_(),
                      params)
    total, ce, aux = moe_ref.loss(cfg, leaves, batch, **share)
    total.backward()
    return total, ce, aux, {k: v.grad for k, v in _flat(leaves).items()}


@pytest.mark.parametrize("held", [8, 4])
@pytest.mark.parametrize("remat", ["full", "mlp"])
def test_program_matches_the_reference(held, remat):
    cfg = _cfg(experts_held=held, remat_policy=remat)
    params, batch = _params(cfg), _batch(cfg)
    logits, aux = lm.forward(cfg, params, batch["tokens"])
    want, want_aux = moe_ref.forward(cfg, params, batch["tokens"], held)
    torch.testing.assert_close(logits[..., :cfg.vocab], want, **TOL)
    torch.testing.assert_close(aux, want_aux, **TOL)
    assert float(want_aux) > 0
    loss, metrics, grads = steps.value_and_grad(cfg, params, batch)
    total, ce, aux, ref_grads = _ref_grads(cfg, params, batch, held=held)
    torch.testing.assert_close(loss, total.detach(), **TOL)
    torch.testing.assert_close(metrics["ce"], ce.detach(), **TOL)
    torch.testing.assert_close(metrics["aux"], aux.detach(), **TOL)
    grads = _flat(grads)
    assert grads.keys() == ref_grads.keys()
    for k, want in ref_grads.items():
        scale = float(want.abs().max()) + 1e-12
        err = float((grads[k] - want).abs().max())
        assert err <= 1e-4 * scale + 1e-7, (k, err, scale)


def _layer_input(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, 16, cfg.d_model), generator=g)


def test_the_shares_add_up_to_the_uncut_layer():
    """The layer's 8 experts in 4 shares of 2: each share's routed part
    (the program's, and the reference's) plus the shared expert counted
    once equals the uncut reference layer. A share holds the router's
    first columns, so share j sees the router's columns rolled by 2 j."""
    cfg = _cfg()
    p = _flat(_params(cfg))
    layer = {k[len("moe_layers/moe/"):]: v[0] for k, v in p.items()
             if k.startswith("moe_layers/moe/")}
    moe_p = {k: v for k, v in layer.items() if "/" not in k}
    moe_p["shared"] = {k[len("shared/"):]: v for k, v in layer.items()
                       if k.startswith("shared/")}
    x = _layer_input(cfg)
    with torch.no_grad():
        whole, _ = moe_ref.moe_layer(cfg, moe_p, x)
        shared = moe_ref.swiglu(moe_p["shared"], x)
        prog = ref = shared
        for j in range(4):
            part = {k: moe_p[k][2 * j:2 * j + 2] for k in ("w1", "w3", "w2")}
            part["router"] = moe_p["router"].roll(-2 * j, dims=1)
            y, _ = mlp.moe(cfg.with_(experts_held=2), part, x)
            prog = prog + y
            ref = ref + moe_ref.moe_layer(cfg, part, x, held=2,
                                          shared=False)[0]
    torch.testing.assert_close(prog, whole, **TOL)
    torch.testing.assert_close(ref, whole, **TOL)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_dropless_equals_gather_when_nothing_is_dropped(norm_topk):
    """With every expert held and a capacity of every (token, choice),
    the gather dispatch drops nothing: both give the same output, aux
    and gradients."""
    cfg = _cfg(moe_norm_topk=norm_topk, router_aux="gshard",
               capacity_factor=8.0)
    p = _flat(_params(cfg))
    layer = {k[len("moe_layers/moe/"):]: v[0] for k, v in p.items()
             if k.startswith("moe_layers/moe/")}
    tree = {k: v for k, v in layer.items() if "/" not in k}
    tree["shared"] = {k[len("shared/"):]: v for k, v in layer.items()
                      if k.startswith("shared/")}
    assert mlp.capacity(cfg, 32) == 32 * cfg.top_k
    out = {}
    for impl in ("dropless", "gather"):
        leaves = tree_map(lambda _, t: t.clone().requires_grad_(), tree)
        x = _layer_input(cfg).requires_grad_()
        y, aux = mlp.moe(cfg.with_(moe_impl=impl), leaves, x)
        (y.square().sum() + aux).backward()
        out[impl] = (y.detach(), aux.detach(), x.grad,
                     {k: v.grad for k, v in _flat(leaves).items()})
    (y1, a1, dx1, g1), (y2, a2, dx2, g2) = out["dropless"], out["gather"]
    torch.testing.assert_close(y1, y2, **TOL)
    torch.testing.assert_close(a1, a2, **TOL)
    torch.testing.assert_close(dx1, dx2, **TOL)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-4, atol=1e-5)


def test_a_router_skewed_to_one_expert_drops_no_row():
    """Every token's first choice is expert 2 (the inputs share a
    direction that its router column picks out):
    the dropless layer computes every held (token, choice) and equals the
    reference, where the capacity-bounded gather drops most of expert
    2's rows."""
    cfg = _cfg(experts_held=4)
    p = _flat(_params(cfg))
    tree = {k[len("moe_layers/moe/"):]: v[0] for k, v in p.items()
            if k.startswith("moe_layers/moe/") and "shared" not in k}
    x = _layer_input(cfg) + 1.0
    tree["router"] = tree["router"].clone()
    tree["router"][:, 2] = 1.0
    probs = torch.softmax(x @ tree["router"], -1)
    idx = torch.topk(probs, cfg.top_k, -1).indices
    assert bool((idx[..., 0] == 2).all())
    held_pairs = int((idx < 4).sum())
    spans.reset_counters()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        y, _ = mlp.moe(cfg, tree, x)
    got = spans.counters()
    spans.reset_counters()
    assert got["moe.routed_rows"] == [held_pairs]
    assert got["moe.rows_by_expert"][2] == x.shape[0] * x.shape[1]
    assert sum(got["moe.rows_by_expert"]) == held_pairs
    assert got["moe.readbacks"] == [1]
    want, _ = moe_ref.moe_layer(cfg, tree, x, held=4)
    torch.testing.assert_close(y, want, **TOL)
    # the gather dispatch's slots for expert 2, were it held there
    assert mlp.capacity(cfg, 32) < x.shape[0] * x.shape[1]


def test_two_runs_of_one_seed_are_bitwise_equal():
    cfg = _cfg(experts_held=4)
    params, batch = _params(cfg), _batch(cfg)
    a = steps.value_and_grad(cfg, params, batch)
    b = steps.value_and_grad(cfg, _params(cfg), batch)
    assert torch.equal(a[0], b[0])
    fa, fb = _flat(a[2]), _flat(b[2])
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_counters_are_off_outside_a_profile():
    cfg = _cfg()
    spans.reset_counters()
    lm.forward(cfg, _params(cfg), _batch(cfg)["tokens"])
    assert spans.counters() == {}


def test_the_leading_dense_layout():
    cfg = _cfg(experts_held=4)
    shapes = _flat(model_zoo.param_shapes(cfg))
    assert shapes["layers/attn/wq"].shape[0] == 3
    assert tuple(shapes["dense_layers/mlp/w1"].shape) == (1, 64, 192)
    assert tuple(shapes["moe_layers/moe/w1"].shape) == (2, 4, 64, 64)
    assert tuple(shapes["moe_layers/moe/router"].shape) == (2, 64, 8)
    assert tuple(shapes["moe_layers/moe/shared/w2"].shape) == (2, 128, 64)
    with pytest.raises(ValueError, match="first_dense_layers"):
        model_zoo.param_shapes(cfg.with_(first_dense_layers=3))
    with pytest.raises(ValueError, match="9 experts held of 8"):
        model_zoo.param_shapes(cfg.with_(experts_held=9))
    with pytest.raises(ValueError, match="dropless"):
        mlp.moe(cfg.with_(moe_impl="gather"), {"router": torch.zeros(64, 8)},
                torch.zeros(1, 2, 64))


@pytest.mark.parametrize("kw", [
    dict(), dict(first_dense_layers=0, moe_impl="gather"),
    dict(first_dense_layers=0, experts_held=0)])
def test_the_mesh_trainer_refuses_the_new_layout(kw):
    """Leading dense layers, a share of the experts and the dropless
    dispatch, each alone too."""
    cfg = _cfg(**{"experts_held": 4, **kw})
    with pytest.raises(ValueError, match="one device"):
        Trainer(cfg, dcfg=DataConfig(batch=2, seq=16),
                mesh=types.SimpleNamespace(device_type="cpu"))
