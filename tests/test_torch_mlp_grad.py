"""The fused MLP's gradient on the CPU: the plain backward
``fused_mlp_bwd`` under its contract (g and u as the forward kept them,
or recomputed) against jax.vjp of the reference's kernel oracle and of
its model MLP, a CPU emulation of the backward kernels' rounding
(``csrc/fused_mlp_bwd.cu``) at olmo_1b's K:F ratio and of dx's stream-K
sum at llava_next_34b's, the kernels' work split (``bwd_plan``), and the
launch counters on CPU tensors. The kernels themselves run in
tests/test_torch_cuda.py.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.fused_mlp import fused_mlp_ref as jax_fused_mlp_ref  # noqa: E402
from repro.models.mlp import mlp as jax_mlp  # noqa: E402
from repro_torch.kernels.fused_mlp import (FusedMLP, fused_mlp,  # noqa: E402
                                           fused_mlp_backward, fused_mlp_ref)
from repro_torch.kernels.fused_mlp.ops import (bwd_plan,  # noqa: E402
                                               fused_mlp_bwd, split_mask)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # the repo's bf16 kernel tolerance


def _arrays(rng, m, k, f):
    """fp32 x [M, K], W1/W3 [K, F], W2 [F, K] (fan-in scaled), dy [M, K]."""
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, f) * k ** -0.5).astype(np.float32),
            (rng.randn(k, f) * k ** -0.5).astype(np.float32),
            (rng.randn(f, k) * f ** -0.5).astype(np.float32),
            rng.randn(m, k).astype(np.float32))


def _vjp(fn, args, cot):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("saved", ["given", "recomputed"])
def test_plain_backward_matches_jax_oracle_vjp(saved):
    """In fp32, ``fused_mlp_bwd`` against jax.vjp of the reference's
    kernel oracle (repro.kernels.fused_mlp.ref.fused_mlp_ref) with g = x W1
    and u = x W3 given as the forward keeps them, and recomputed (None,
    as the CPU Function passes)."""
    rng = np.random.RandomState(0)
    x, w1, w3, w2, dy = _arrays(rng, 24, 64, 192)
    tx, t1, t3, t2, tdy = (torch.from_numpy(a) for a in (x, w1, w3, w2, dy))
    g, u = (tx @ t1, tx @ t3) if saved == "given" else (None, None)
    got = fused_mlp_bwd(tx, t1, t3, t2, tdy, g, u)
    want = _vjp(jax_fused_mlp_ref, (x, w1, w3, w2), dy)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w, **FP32_TOL)


def test_plain_backward_matches_jax_model_mlp_vjp():
    """In fp32, ``fused_mlp_bwd`` given g and u against jax.vjp of the
    reference's model MLP (repro.models.mlp.mlp) with olmo_1b_smoke's
    SwiGLU config, on x [B, S, D] flattened to the kernel's [M, K]."""
    cfg = jax_get_config("olmo_1b", smoke=True)
    assert cfg.mlp == "swiglu"
    rng = np.random.RandomState(1)
    b, s, d, f = 2, 12, cfg.d_model, cfg.d_ff
    x, w1, w3, w2, dy = _arrays(rng, b * s, d, f)
    want = _vjp(lambda x_, a, c, e: jax_mlp(cfg, {"w1": a, "w3": c,
                                                  "w2": e}, x_),
                (x.reshape(b, s, d), w1, w3, w2), dy.reshape(b, s, d))
    tx, t1, t3, t2, tdy = (torch.from_numpy(a) for a in (x, w1, w3, w2, dy))
    got = fused_mlp_bwd(tx, t1, t3, t2, tdy, tx @ t1, tx @ t3)
    np.testing.assert_allclose(got[0].numpy(), want[0].reshape(b * s, d),
                               **FP32_TOL)
    for gt, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gt.numpy(), w, **FP32_TOL)


def test_given_g_and_u_equal_recompute_bitwise():
    """Given g and u that equal the recompute, the plain backward's
    answer does not change by a bit (float64 and bf16)."""
    rng = np.random.RandomState(2)
    arrays = _arrays(rng, 16, 64, 128)
    for dtype in (torch.float64, torch.bfloat16):
        x, w1, w3, w2, dy = (torch.from_numpy(a).to(dtype) for a in arrays)
        given = fused_mlp_bwd(x, w1, w3, w2, dy, x @ w1, x @ w3)
        again = fused_mlp_bwd(x, w1, w3, w2, dy)
        assert all(torch.equal(a, b) for a, b in zip(given, again))


def _kernel_emulation(x, w1, w3, w2, dy, pieces=1):
    """What csrc/fused_mlp_bwd.cu computes, in fp32 on the CPU from
    bf16-valued operands: g and u as the forward keeps them (bf16), dh in
    fp32 (never stored), h, dg and du rounded to bf16 once, dx one fp32
    accumulator over both of its products, every gradient rounded to bf16
    once. With ``pieces`` > 1, dx's reduction over (dg, du) is cut into
    that many ranges of whole 64-deep k-blocks, as a stream-K launch cuts
    it (``bwd_plan``): each range an fp32 partial, added as the kernel
    adds them (to the last range's, from the one before it down to the
    first) and rounded once."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    g, u = bf(x @ w1), bf(x @ w3)
    dh = dy @ w2.T
    sig = torch.sigmoid(g)
    sg = g * sig
    h = bf(sg * u)
    dg = bf(dh * u * sig * (1 + g * (1 - sig)))
    du = bf(dh * sg)
    lhs, rhs = torch.cat([dg, du], 1), torch.cat([w1, w3], 1)
    kblocks = lhs.shape[1] // 64
    cuts = [kblocks * i // pieces * 64 for i in range(pieces + 1)]
    parts = [lhs[:, a:b] @ rhs[:, a:b].T for a, b in zip(cuts, cuts[1:])]
    dx = parts[-1]
    for part in reversed(parts[:-1]):
        dx = dx + part
    return bf(dx), bf(x.T @ dg), bf(x.T @ du), bf(h.T @ dy)


@pytest.mark.parametrize("m,k,f,pieces", [
    pytest.param(1, 512, 2048, 1, id="1"),
    pytest.param(100, 512, 2048, 1, id="100"),
    # llava_next_34b's K:F = 7168:20480 = 7:20, dx cut in three
    pytest.param(128, 448, 1280, 3, id="llava_ratio_dx_split"),
])
def test_bwd_kernel_rounding_at_olmo_ratio(m, k, f, pieces):
    """CPU evidence for the backward kernels' precision at olmo_1b's
    K:F = 1:4 (K 512, F 2048) with chip_smoke.py's input distribution:
    the emulation of their rounding against autograd of the fp32
    ``fused_mlp_ref`` on the same bf16-valued inputs, each gradient
    scaled by its largest magnitude, within the repo's bf16 tolerance
    (the bound ``test_functions_match_autograd_of_plain_bf16`` holds the
    plain backward to; the kernels round g, u, h, dg and du once each,
    about one bf16 step); and at llava_next_34b's K:F with dx's reduction
    summed as a stream-K launch sums it, in fixed-order fp32 partials
    rounded once."""
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(a).to(torch.bfloat16).float()
            for a in _arrays(rng, m, k, f)]
    got = _kernel_emulation(*args, pieces=pieces)
    leaves = [t.clone().requires_grad_() for t in args[:4]]
    want = torch.autograd.grad(fused_mlp_ref(*leaves), leaves, args[4])
    for gt, w in zip(got, want):
        top = w.abs().max()
        torch.testing.assert_close(gt / top, w / top, **BF16_TOL)


@pytest.mark.parametrize("m,k,f,split", [
    (640, 7168, 20480, ("dh", "dx")),   # llava_next_34b's train step
    (768, 7168, 20480, ("dx",)),        # six row tiles: dh's 480 fill
    (8192, 2048, 8192, ()),             # olmo_1b: whole tiles everywhere
])
def test_bwd_plan_fills_every_wave(m, k, f, split):
    """The backward kernels' work split (``bwd_plan``) on an H100's 132
    SMs: every launch's last wave at least 85% full, stream-K exactly
    where whole 128-row tiles would leave it emptier (llava_next_34b's dx:
    140 tiles, 53%; dh: 400 tiles, 76%), and olmo_1b's launches on the
    whole-tile split of the first design (dx 512 tiles, 3.9 waves)."""
    plan = bwd_plan(m, k, f, 132)
    assert [launch.name for launch in plan] == ["dh", "dw2", "dx", "dw13"]
    assert tuple(launch.name for launch in plan if launch.stream_k) == split
    assert all(launch.fill >= 0.85 for launch in plan), plan
    assert split_mask(plan) == sum(1 << i for i, launch in enumerate(plan)
                                   if launch.name in split)
    if not split:
        assert [launch.tiles for launch in plan] == [
            -(-m // 128) * (f // 256), (f // 128) * (k // 256),
            -(-m // 128) * (k // 256), (k // 128) * (f // 128)]


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors the Function and the backward run the plain
    versions: neither launch counter moves."""
    rng = np.random.RandomState(4)
    x, w1, w3, w2, dy = (torch.from_numpy(a) for a in _arrays(rng, 8, 64,
                                                                128))
    before = (fused_mlp.launches, fused_mlp.bwd_launches)
    args = [t.requires_grad_() for t in (x, w1, w3, w2)]
    torch.autograd.grad(FusedMLP.apply(*args), args, dy)
    fused_mlp_backward(x.detach(), w1.detach(), w3.detach(), w2.detach(),
                       dy)
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == before
    assert fused_mlp.bwd_launches == 0

