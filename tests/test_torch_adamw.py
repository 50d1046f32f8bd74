"""AdamW's two passes (``repro_torch.kernels.adamw``) on the CPU: the
plain versions against the torch update they were moved from, bit for
bit; the clip's plan of partial sums; what the ops take and refuse; and
``adamw_update`` routed through the ops. The kernels themselves run in
``tests/test_torch_cuda.py``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from repro_torch.kernels import adamw  # noqa: E402
from repro_torch.kernels.adamw import ops  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update, init_opt_state,
                                         lr_schedule)


# the torch update as it was before the ops, kept verbatim as the oracle
def _old_global_norm(leaves):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _old_clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _old_leaf_update(cfg, p, g, m, v, scale, lr, bc1, bc2):
    g = g.float() * scale              # clipped, one leaf at a time
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    u.add_(cfg.weight_decay * p32)
    return p32 - lr * u


def _old_adamw_update(cfg, params, grads, state):
    grads = tree_map(lambda path, g: g if g is not None else torch.zeros_like(
        _get(params, path), dtype=torch.float32), grads)
    gnorm = _old_global_norm(tree_leaves(grads))
    scale = _old_clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]),
                          tree_leaves(state["nu"])):
        p.copy_(_old_leaf_update(cfg, p, g, m, v, scale, lr, bc1, bc2))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


# ragged leaves: one element, 4k + 3, a chunk and a bit, zeros, empty
RAGGED = [((1,), "float32", "float32"), ((4 * 37 + 3,), "float32", "float32"),
          ((3, 5, 7), "bfloat16", "float32"), ((2, 4099), "float32",
                                                "bfloat16"),
          ((16384 + 5,), "bfloat16", "bfloat16"), ((0,), "float32",
                                                   "float32")]


def _leaf(rng, shape, pd, gd, zero_grad=False):
    p = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        getattr(torch, pd))
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(
        getattr(torch, gd))
    if zero_grad:
        g.zero_()
    return p, g


@pytest.mark.parametrize("zero_grad", [False, True])
@pytest.mark.parametrize("shape,pd,gd", RAGGED)
def test_step_ref_is_bitwise_the_old_leaf_update(shape, pd, gd, zero_grad):
    """Three steps of ``adamw_step_ref`` give the old ``_leaf_update``'s p,
    m and v bit for bit, in p's dtype, from bf16 or fp32 p and g."""
    rng = np.random.RandomState(sum(shape) + zero_grad)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    p, g = _leaf(rng, shape, pd, gd, zero_grad)
    p_old = p.clone()
    m, v = (torch.zeros(shape) for _ in range(2))
    m_old, v_old = m.clone(), v.clone()
    scale = torch.tensor(0.37)
    for k in range(1, 4):
        lr = lr_schedule(cfg, k)
        t = torch.tensor(float(k))
        bc1, bc2 = 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t)
        adamw.adamw_step_ref(cfg, p, g, m, v, scale, lr, bc1, bc2)
        p_old.copy_(_old_leaf_update(cfg, p_old, g, m_old, v_old, scale, lr,
                                     bc1, bc2))
    for a, b in ((p, p_old), (m, m_old), (v, v_old)):
        _same(a, b)
    assert p.dtype == getattr(torch, pd)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_sumsq_ref_is_bitwise_the_old_global_norm(clip):
    rng = np.random.RandomState(1)
    leaves = [_leaf(rng, shape, pd, gd)[1] for shape, pd, gd in RAGGED]
    leaves.append(torch.zeros(7))
    norm, scale = ops.adamw_sumsq(leaves, clip)
    want = _old_global_norm(leaves)
    _same(torch.sqrt(adamw.sumsq_ref(leaves)), want)
    _same(norm, want)
    _same(scale, _old_clip_scale(want, clip))
    _same(adamw.clip_scale_ref(want, clip), _old_clip_scale(want, clip))
    assert (float(scale) == 1.0) == (clip > float(norm))


SIZES = [[1], [16384], [16385, 1, 0, 3], [2048, 50688 * 2048, 7],
         [0, 0], [16384 * 3 - 1, 4 * 16384 + 3, 5]]


@pytest.mark.parametrize("sizes", SIZES)
def test_sumsq_plan_gives_every_element_one_slot(sizes):
    """Chunk c of leaf i sums into slot first_i + c: every element of every
    leaf lands in exactly one slot, every slot holds 1 to ``SUMSQ_CHUNK``
    elements of one leaf, and the slots run 0 .. total - 1 in leaf
    order."""
    chunk = ops.SUMSQ_CHUNK
    plan, total = ops.sumsq_slots(sizes)
    assert len(plan) == len(sizes)
    owner = np.full(total, -1)
    held = np.zeros(total, dtype=np.int64)
    nxt = 0
    for i, (n, (first, slots)) in enumerate(zip(sizes, plan)):
        assert first == nxt and slots == -(-n // chunk)
        nxt += slots
        # the slot of each element, by its chunk (elements of a chunk
        # counted together: the big leaves hold a hundred million)
        starts = np.arange(0, n, chunk)
        idx = first + starts // chunk
        assert (owner[idx] == -1).all()
        owner[idx] = i
        held[idx] += np.minimum(chunk, n - starts)
    assert nxt == total
    assert (owner >= 0).all() and (held >= 1).all() and (held <= chunk).all()
    assert held.sum() == sum(sizes)


def test_sumsq_plan_depends_on_the_sizes_alone():
    sizes = [3, 16384 * 2 + 1, 0, 99, 16384]
    plan, total = ops.sumsq_slots(sizes)
    assert (plan, total) == ops.sumsq_slots(list(sizes))
    assert total == sum(-(-n // ops.SUMSQ_CHUNK) for n in sizes)
    for perm in ([4, 3, 2, 1, 0], [1, 0, 4, 2, 3]):
        got, tot = ops.sumsq_slots([sizes[i] for i in perm])
        assert tot == total
        assert [s for _, s in got] == [plan[i][1] for i in perm]


def test_ops_take_the_plain_versions_on_cpu_and_launch_nothing():
    rng = np.random.RandomState(2)
    cfg = OptimizerConfig()
    p, g = _leaf(rng, (5, 3), "float32", "bfloat16")
    m, v = torch.zeros(5, 3), torch.zeros(5, 3)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    scalars = [torch.tensor(x) for x in (0.5, 1e-3, 0.1, 0.05)]
    before = (ops.adamw_step.launches, ops.adamw_sumsq.launches)
    ops.adamw_step(cfg, p, g, m, v, *scalars)
    adamw.adamw_step_ref(cfg, p2, g, m2, v2, *scalars)
    for a, b in ((p, p2), (m, m2), (v, v2)):
        _same(a, b)
    ops.adamw_sumsq([g, p], 1.0)
    assert (ops.adamw_step.launches, ops.adamw_sumsq.launches) == before


def _step_args(**change):
    args = dict(p=torch.zeros(8, 4), g=torch.zeros(8, 4),
                m=torch.zeros(8, 4), v=torch.zeros(8, 4),
                scale=torch.tensor(1.0), lr=torch.tensor(1e-3),
                bc1=torch.tensor(0.1), bc2=torch.tensor(0.05))
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(p=torch.zeros(4, 8).t()), "contiguous"),
    (dict(g=torch.zeros(8, 8)[:, ::2]), "contiguous"),
    (dict(g=torch.zeros(8, 4, dtype=torch.float16)), "float16"),
    (dict(p=torch.zeros(8, 4, dtype=torch.float64)), "float64"),
    (dict(m=torch.zeros(8, 4, dtype=torch.bfloat16)), "bfloat16"),
    (dict(v=torch.zeros(32)), "shape mismatch"),
    (dict(lr=torch.tensor(1e-3, dtype=torch.float64)), "scalars"),
    (dict(bc1=torch.zeros(2)), "scalars"),
    ({}, "CUDA"),
])
def test_step_kernel_refuses_what_it_does_not_take(change, match):
    """The kernel's checks, run before any launch: a CUDA input of these
    kinds raises (and CPU tensors are no CUDA tensors)."""
    with pytest.raises(ValueError, match=match):
        ops.admit_step(**_step_args(**change))


@pytest.mark.parametrize("leaf,match", [
    (torch.zeros(4, 8).t(), "contiguous"),
    (torch.zeros(3, dtype=torch.float16), "float16"),
    (torch.zeros(3), "CUDA"),
])
def test_sumsq_kernel_refuses_what_it_does_not_take(leaf, match):
    with pytest.raises(ValueError, match=match):
        ops.admit_sumsq([torch.zeros(5), leaf])


def test_step_op_refuses_a_recorded_gradient():
    args = _step_args(p=torch.zeros(8, 4, requires_grad=True))
    with pytest.raises(NotImplementedError, match="no_grad"):
        ops.adamw_step(OptimizerConfig(), **args)


def _tree(rng):
    shapes = {"w": (8, 5), "n": {"scale": (5,)}, "e": (3, 4), "one": (1,),
              "odd": (4 * 9 + 3,)}
    params = tree_map(lambda _, s: torch.from_numpy(
        rng.randn(*s).astype(np.float32)), shapes)
    params["e"] = params["e"].to(torch.bfloat16)
    return shapes, params


def test_adamw_update_is_bitwise_the_old_update():
    """Five steps of ``adamw_update`` through the ops give the old torch
    update's params, moments, norm and lr bit for bit on the CPU, a None
    gradient and a bf16 param and gradient included."""
    rng = np.random.RandomState(3)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                          clip_norm=2.0)
    shapes, params = _tree(rng)
    old = tree_map(lambda _, t: t.clone(), params)
    state, old_state = init_opt_state(params), init_opt_state(old)
    for _ in range(5):
        g = tree_map(lambda _, s: torch.from_numpy(
            rng.randn(*s).astype(np.float32)), shapes)
        g["e"] = g["e"].to(torch.bfloat16)
        g["n"]["scale"] = None
        params, state, m = adamw_update(cfg, params, dict(g), state)
        old, old_state, om = _old_adamw_update(cfg, old, dict(g), old_state)
        for k in ("grad_norm", "lr"):
            _same(m[k], om[k])
    for a, b in zip(tree_leaves({"p": params, "mu": state["mu"],
                                 "nu": state["nu"]}),
                    tree_leaves({"p": old, "mu": old_state["mu"],
                                 "nu": old_state["nu"]})):
        _same(a, b)
    assert int(state["step"]) == 5


def test_adamw_update_runs_one_clip_pass_and_one_step_a_leaf(monkeypatch):
    """On plain leaves ``adamw_update`` takes the norm from one
    ``adamw_sumsq`` call over every leaf and updates each leaf with one
    ``adamw_step`` call, in the params' order."""
    calls = {"sumsq": [], "step": []}
    sumsq, step = optimizer.adamw_sumsq, optimizer.adamw_step

    def count_sumsq(leaves, clip):
        leaves = list(leaves)
        calls["sumsq"].append(len(leaves))
        return sumsq(leaves, clip)

    def count_step(cfg, p, *rest):
        calls["step"].append(tuple(p.shape))
        return step(cfg, p, *rest)

    monkeypatch.setattr(optimizer, "adamw_sumsq", count_sumsq)
    monkeypatch.setattr(optimizer, "adamw_step", count_step)
    _, params = _tree(np.random.RandomState(4))
    grads = tree_map(lambda _, t: torch.ones_like(t), params)
    state = init_opt_state(params)
    adamw_update(OptimizerConfig(), params, grads, state)
    leaves = list(tree_leaves(params))
    assert calls["sumsq"] == [len(leaves)]
    assert calls["step"] == [tuple(p.shape) for p in leaves]
