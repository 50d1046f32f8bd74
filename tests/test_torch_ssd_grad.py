"""The SSD scan under autograd (``SSDScan``, ``ssd_scan_bwd``) against
finite differences and the JAX reference on the CPU; the reference's
NaN gradient at the full configs' chunk, which the port does not copy;
and the kernels' admission of the smoke configs' shapes by padding,
which the full configs never pay for.

The Function's forward on CPU tensors is the op's plain version
(``ssd_ref``); its backward is the explicit torch chain rule that runs
after the kernel on the card.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn.ops import padded_head_dim as flash_pad  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import padded_dims as mlp_pad  # noqa: E402
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import padded_head_dim as ssd_pad  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import model_zoo, ssm  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

FULL = ["granite_8b", "olmo_1b", "phi3_mini_3_8b", "stablelm_3b",
        "zamba2_1_2b", "mamba2_780m", "llava_next_34b"]


def _ssd_arrays(rng, b, s, h, g, n, p):
    """Model-layout SSD inputs as float64 numpy arrays: x, B, C normal,
    dt = softplus(normal) > 0, A = -exp(0.2 normal) < 0."""
    return (rng.randn(b, s, h, p), np.log1p(np.exp(rng.randn(b, s, h))),
            -np.exp(rng.randn(h) * 0.2), rng.randn(b, s, g, n),
            rng.randn(b, s, g, n))


def _t(arrs, dtype=torch.float64, grad=False):
    return [torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_(grad)
            for a in arrs]


# ---------------------------------------------------------------------------
# the Function against finite differences (float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups,chunk,outputs", [(2, 4, "both"),
                                                 (2, 4, "y"),
                                                 (4, 12, "both")])
def test_ssd_scan_function_gradcheck(groups, chunk, outputs):
    """SSDScan's explicit backward against finite differences of its
    forward (the plain version on CPU tensors), in float64: two groups
    over four heads (dB and dC summed over each group's heads) and three
    chunks (the state recurrence run in reverse), or a group per head and
    one chunk; a gradient on the final state, or with ``outputs="y"`` the
    state unused and its gradient arriving as None, as in training."""
    arrs = _ssd_arrays(np.random.RandomState(0), 2, 12, 4, groups, 2, 2)
    args = _t(arrs, grad=True)

    def fn(*a):
        y, state = SSDScan.apply(*a, chunk)
        return (y, state) if outputs == "both" else y

    out = fn(*args)
    assert (out[0] if outputs == "both" else out).grad_fn.name() == \
        "SSDScanBackward"
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("needs_grad,keep", [
    ((), False), (("x",), True), (("dt",), True), (("a", "cm"), True)])
def test_ssd_scan_keeps_chunk_states_only_under_grad(monkeypatch,
                                                     needs_grad, keep):
    """SSDScan asks its forward to keep the chunk states (the (cum, dt)
    pairs and previous states the backward kernels read, ``_scan``'s
    ``keep``) exactly when one of its inputs needs a gradient; serving,
    with no input that needs one, keeps nothing. On CPU tensors the
    forward is the plain version and keeps nothing either way."""
    seen = []
    forward = ssd_ops._forward

    def record(*args, keep):
        seen.append(keep)
        return forward(*args, keep=keep)

    monkeypatch.setattr(ssd_ops, "_forward", record)
    names = ("x", "dt", "a", "bm", "cm")
    arrs = _ssd_arrays(np.random.RandomState(5), 1, 8, 2, 1, 4, 4)
    args = [t.requires_grad_(name in needs_grad)
            for t, name in zip(_t(arrs, torch.float32), names)]
    y, _ = SSDScan.apply(*args, 4)
    assert seen == [keep]
    assert (y.grad_fn is not None) == keep
    if keep:
        assert y.grad_fn.saved_tensors[-1] is None   # CPU: nothing kept


# ---------------------------------------------------------------------------
# against jax.vjp of the reference's chunked form (fp32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,g,n,p,chunk,with_state", [
    (2, 32, 4, 2, 8, 16, 8, True),
    (1, 48, 2, 1, 16, 8, 16, True),
    (2, 32, 4, 1, 8, 8, 32, False),
    (1, 64, 6, 3, 4, 8, 16, False),
])
def test_ssd_scan_bwd_matches_jax_vjp(b, s, h, g, n, p, chunk, with_state):
    """ssd_scan_bwd in fp32 against jax.vjp of the reference
    ``repro.models.ssm.ssd_chunked`` on the same inputs and cotangents (y
    and the final state, or y alone), at shapes where the reference's
    gradient is finite, within the repo's fp32 model tolerance (1e-4)."""
    rng = np.random.RandomState(s + h)
    arrs = [a.astype(np.float32) for a in _ssd_arrays(rng, b, s, h, g, n, p)]
    dy = rng.randn(b, s, h, p).astype(np.float32)
    dstate = (rng.randn(b, h, n, p).astype(np.float32) if with_state
              else np.zeros((b, h, n, p), np.float32))
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    got = ssd_scan_bwd(*_t(arrs, torch.float32), torch.from_numpy(dy),
                       torch.from_numpy(dstate) if with_state else None,
                       chunk)
    for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert gt.dtype == torch.float32 and gt.shape == w.shape, name
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(gt.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_ssd_scan_bwd_row_groups(monkeypatch):
    """Batch rows taken in groups (one row at a time when the byte bound
    is small) give the one-group gradients."""
    rng = np.random.RandomState(9)
    args = _t(_ssd_arrays(rng, 3, 32, 4, 2, 8, 8), torch.float32)
    dy, dstate = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  for shape in ((3, 32, 4, 8), (3, 4, 8, 8)))
    whole = ssd_scan_bwd(*args, dy, dstate, 8)
    monkeypatch.setattr(ssd_ops, "BWD_BYTES", 1)
    rows = ssd_scan_bwd(*args, dy, dstate, 8)
    for w, r in zip(whole, rows):
        torch.testing.assert_close(r, w, rtol=1e-6, atol=1e-6)


def _nan_shape_inputs():
    """The full configs' chunk (256) at the init's dt = softplus(0) and
    A = -1: a chunk's span of dt |A| is 177, past fp32's exp overflow."""
    rng = np.random.RandomState(3)
    b, s, h, g, n, p = 1, 256, 2, 1, 4, 4
    x, bm, cm = (rng.randn(*shape) for shape in
                 ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    dt = np.full((b, s, h), np.log(2.0))
    a = -np.ones(h)
    dy = rng.randn(b, s, h, p)
    return (x, dt, a, bm, cm), dy


def test_reference_grad_is_nan_at_full_chunk_port_is_finite():
    """F3, a reference quirk the port does not copy: at chunk 256 with
    the init's dt and A, jax.vjp of the reference's ssd_chunked gives NaN
    in dt and A (its ``where(causal, exp(seg), 0)`` meets inf above the
    diagonal), while x, B and C stay finite. The port's fp32 gradient is
    finite everywhere and agrees with its float64 gradient, which
    gradcheck holds to finite differences at that shape."""
    arrs, dy = _nan_shape_inputs()
    f32 = [a.astype(np.float32) for a in arrs]
    y, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=256)[0],
                     *(jnp.asarray(a) for a in f32))
    assert np.isfinite(np.asarray(y)).all()
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy, jnp.float32))]
    finite = [bool(np.isfinite(g).all()) for g in ref]
    assert finite == [True, False, False, True, True]   # x dt A B C

    got = ssd_scan_bwd(*_t(f32, torch.float32),
                       torch.from_numpy(dy.astype(np.float32)), None, 256)
    exact = ssd_scan_bwd(*_t(arrs), torch.from_numpy(dy), None, 256)
    for name, g, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, exact):
        assert bool(torch.isfinite(g).all()), name
        top = float(e.abs().max())
        np.testing.assert_allclose(g.double().numpy() / top,
                                   e.numpy() / top, rtol=0, atol=1e-5,
                                   err_msg=name)
    args = _t(arrs, grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: SSDScan.apply(*a, 256)[0], args, fast_mode=True)


# ---------------------------------------------------------------------------
# the backward kernel's operand rounding (csrc/ssd_scan_bwd.cu), emulated
# ---------------------------------------------------------------------------

SSD_GRAD_BF16 = 8e-3    # chip_smoke.py's limits, scaled by the largest
SSD_GRAD_FP32 = 1e-4    # magnitude of each gradient


def _split(t):
    """An fp32 operand as two bf16 wgmmas take it: (hi, lo), in fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _bf16(t):
    """An fp32 operand rounded once to bf16 (one wgmma)."""
    return (t.to(torch.bfloat16).float(),)


def _ssd_bwd_kernel_passes(x, dt, a, bm, cm, dy, chunk, weighted=_bf16,
                           state=_split, heads_summed=False, g_in_db=None):
    """The SSD backward as csrc/ssd_scan_bwd.cu computes it, in fp32 on
    the CPU (model layout, one group): the forward's chunk states and
    state passing (w o x and S_prev through ``state``), dS_prev =
    C^T (e o dy) (e o dy through ``state``), the state recurrence in
    reverse (g through ``state``, dd = <g, S_prev>), the key-side products
    (dx += M^T dy, dB += dS^T C with M^T and dS^T through ``weighted``;
    dx += w (B g), dB += w (x g^T), d w = <B g, x>), the query-side ones
    (dC += dS B + e (dy S_prev^T), d cum_i's terms), then ddt from the
    reverse cumsum of d cum and dA summed directly over
    dseg_ij (cdt_i - cdt_j) and the other terms weighted by cdt =
    cumsum(dt). With ``heads_summed`` (the kernels since the redesign),
    dS^T is summed over the group's heads in fp32 before ``weighted`` and
    the dB, dC products take that one sum; else (the first design) each
    head's dS^T goes through ``weighted`` and into its own products, and
    dB, dC are summed over heads after. ``g_in_db`` (default ``state``)
    is what g goes through in dB's state-side term x g^T alone. Returns
    (dx, ddt, dA, dB, dC) in the kernel's dtypes."""
    b, s, h, p = x.shape
    n, nc, ln = bm.shape[-1], s // chunk, chunk

    def heads(t):  # [b, s, h, k] -> [b, h, nc, L, k]
        return t.float().reshape(b, nc, ln, h, -1).permute(0, 3, 1, 2, 4)

    xf, dyf = heads(x), heads(dy)
    bf, cf = (heads(t.expand(b, s, h, n)) for t in (bm, cm))
    dtf = heads(dt[..., None])[..., 0]                      # [b, h, nc, L]
    af = a.float().reshape(1, h, 1, 1)
    cum = torch.cumsum(dtf * af, -1)
    cl = cum[..., -1:]
    cdt = cum / af                                          # cumsum(dt)
    w, e = torch.exp(cl - cum) * dtf, torch.exp(cum)

    def mm(eq, parts, other):
        return sum(torch.einsum(eq, part, other) for part in parts)

    sc = mm("bhcjp,bhcjn->bhcnp", state(w[..., None] * xf), bf)
    st, prev = torch.zeros(b, h, n, p), []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(cl[:, :, c])[..., None] + sc[:, :, c]
    sp = state(torch.stack(prev, 2))
    dsp = mm("bhcip,bhcin->bhcnp", state(e[..., None] * dyf), cf)
    g, gs, dd = torch.zeros(b, h, n, p), [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        dd[c] = (g * sum(part[:, :, c] for part in sp)).sum((-1, -2))
        g = g * torch.exp(cl[:, :, c])[..., None] + dsp[:, :, c]
    g_all = torch.stack(gs, 2)
    gp = state(g_all)
    dd = torch.stack(dd, 2)

    causal = torch.ones(ln, ln, dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]             # [.., i, j]
    dec = seg.masked_fill(~causal, float("-inf")).exp()
    sco = torch.einsum("bhcin,bhcjn->bhcij", cf, bf)
    dm = torch.einsum("bhcip,bhcjp->bhcij", dyf, xf)
    f = dec * dtf[..., None, :]
    tt = dm * sco * dec
    ka = tt.sum(-2)                                         # per key j
    qa = (tt * dtf[..., None, :]).sum(-1)                   # per query i
    daseg = (tt * dtf[..., None, :] * seg.masked_fill(~causal, 0.0)).sum(
        (-1, -2)) / af[..., 0]
    m_t = weighted((sco * f).transpose(-1, -2))             # [.., j, i]
    ds_f = (dm * f).transpose(-1, -2)
    if heads_summed:          # one group: every head shares B and C
        ds_t = weighted(ds_f.sum(1, keepdim=True))
        cg, bg_ = cf[:, :1], bf[:, :1]
    else:
        ds_t, cg, bg_ = weighted(ds_f), cf, bf
    dx = mm("bhcji,bhcip->bhcjp", m_t, dyf)
    db_in = mm("bhcji,bhcin->bhcjn", ds_t, cg)
    dc_in = mm("bhcij,bhcjn->bhcin", [t.transpose(-1, -2) for t in ds_t],
               bg_)
    bg = mm("bhcnp,bhcjn->bhcjp", gp, bf)
    xg = mm("bhcnp,bhcjp->bhcjn", (g_in_db or state)(g_all), xf)
    dx = dx + w[..., None] * bg
    db = w[..., None] * xg
    kb = (bg * xf).sum(-1)
    cs = mm("bhcnp,bhcin->bhcip", sp, cf)
    dys = mm("bhcnp,bhcip->bhcin", sp, dyf)
    dc = e[..., None] * dys
    qb = e * (dyf * cs).sum(-1)

    dww = kb * w
    tail = dww.sum(-1) + dd * torch.exp(cl[..., 0])
    dcum = qa + qb - dtf * ka - dww
    dcum[..., -1] += tail
    dda = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = ka + kb * torch.exp(cl - cum) + dda * af
    da = (daseg + ((qb - dww) * cdt).sum(-1)
          + cdt[..., -1] * tail).sum((0, 2))

    def back(t):  # [b, h, nc, L, k] -> [b, s, h, k]
        return t.permute(0, 2, 3, 1, 4).reshape(b, s, t.shape[1], -1)

    return (back(dx).to(x.dtype), back(ddt[..., None])[..., 0], da,
            (back(db_in).sum(2, keepdim=True)
             + back(db).sum(2, keepdim=True)).to(bm.dtype),
            (back(dc_in).sum(2, keepdim=True)
             + back(dc).sum(2, keepdim=True)).to(cm.dtype))


@pytest.mark.parametrize("variant,h,ok", [
    pytest.param("kernel", 2, True, id="kernel-True"),
    pytest.param("split", 2, True, id="split-True"),
    pytest.param("bf16", 2, False, id="bf16-False"),
    pytest.param("heads_summed", 2, True, id="heads_summed-True"),
    pytest.param("heads_summed", 8, True, id="heads_summed_8_heads-True"),
])
def test_ssd_bwd_kernel_rounding_at_mamba2_geometry(variant, h, ok):
    """CPU evidence for the backward kernel's operand precision at one
    mamba2_780m head geometry (S=512, 2 heads, N=128, P=64, chunk 256)
    with chip_smoke.py's input distribution, each gradient scaled by its
    largest magnitude. "kernel" (the first design of
    csrc/ssd_scan_bwd.cu: M^T and each head's dS^T plain bf16, the
    state-side operands g, S_prev, w o x and e o dy as bf16 hi/lo),
    "heads_summed" (the kernels since the redesign: as "kernel", but dS^T
    summed over the group's heads in fp32 and rounded to bf16 once before
    the dB and dC products, and g plain bf16 in dB's state-side term;
    also at 8 heads, where the sum is longer) and
    "split" (every fp32-weighted operand hi/lo) keep dx, dB, dC within
    SSD_GRAD_BF16 of jax.vjp of the reference's chunked form and ddt, dA
    within SSD_GRAD_FP32 of the exact gradient; "bf16" (every operand
    plain bf16) puts ddt outside. At this geometry the
    reference's own dt and A gradients are NaN (F3: its
    where(causal, exp(seg), 0) meets inf at chunk 256, asserted here), so
    ddt and dA are held to the port's float64 ``ssd_scan_bwd``, which
    test_reference_grad_is_nan_at_full_chunk_port_is_finite holds to
    finite differences at chunk 256 and test_ssd_scan_bwd_matches_jax_vjp
    to jax.vjp where the reference is finite."""
    rng = np.random.RandomState(11)
    b, s, n, p, chunk = 1, 512, 128, 64, 256

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16)

    x = bf16(b, s, h, p)
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(b, s, h))).astype(
        np.float32))
    a = torch.from_numpy(-np.exp(rng.randn(h) * 0.2).astype(np.float32))
    bm, cm, dy = bf16(b, s, 1, n), bf16(b, s, 1, n), bf16(b, s, h, p)
    _, vjp = jax.vjp(lambda *z: jax_ssd_chunked(*z, chunk=chunk)[0],
                     *(jnp.asarray(t.float().numpy())
                       for t in (x, dt, a, bm, cm)))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(dy.float().numpy()))]
    assert [bool(np.isfinite(t).all()) for t in ref] == [True, False,
                                                         False, True, True]
    exact = ssd_scan_bwd(*(t.double() for t in (x, dt, a, bm, cm)),
                         dy.double(), None, chunk)
    want = [ref[0], exact[1].numpy(), exact[2].numpy(), ref[3], ref[4]]
    weighted, state = {"kernel": (_bf16, _split), "split": (_split, _split),
                       "bf16": (_bf16, _bf16),
                       "heads_summed": (_bf16, _split)}[variant]
    summed = variant == "heads_summed"
    got = _ssd_bwd_kernel_passes(x, dt, a, bm, cm, dy, chunk, weighted,
                                 state, heads_summed=summed,
                                 g_in_db=_bf16 if summed else None)
    errs = {}
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert bool(torch.isfinite(g).all()), name
        top = float(np.abs(w).max())
        errs[name] = float(np.abs(g.double().numpy() - w).max()) / top
    within = all(errs[k] <= (SSD_GRAD_BF16 if k in ("dx", "dB", "dC")
                             else SSD_GRAD_FP32) for k in errs)
    assert within == ok, errs


# ---------------------------------------------------------------------------
# the repaired chunked form (models/ssm.py::ssd_chunked)
# ---------------------------------------------------------------------------

def _where_decay(seg, causal):
    """The reference's decay (repro/models/ssm.py:80), the port's
    formula before the repair."""
    return torch.where(causal, torch.exp(seg), 0.0)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_ssd_bwd_bound_counts_group_products_once(arch):
    """The SSD backward's least work (``bwd_work``, which chip_smoke.py and
    scripts/profile_ssd_scan_bwd.py divide by the card's rates for its
    bound) at the train shape B=4 S=2048: C B^T and the intra-chunk dB and
    dC products over the causal triangle once per group, dM and M^T dy once
    per head, four L x N x P state products per head, no chunk state
    recomputed; inputs and gradients once. Giving every head its own B and
    C adds the group terms alone, and a ragged last chunk counts its own
    rows."""
    cfg = get_config(arch)
    b, s, h, g = 4, 2048, cfg.ssm_heads, cfg.ssm_groups
    n, p, chunk = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    flops, nbytes = ssd_ops.bwd_work(b, s, h, g, n, p, chunk)
    tri = chunk * (chunk + 1) // 2
    per_chunk = 2 * (tri * 3 * g * n + tri * 2 * h * p
                     + 4 * h * chunk * n * p)
    assert flops == b * (s // chunk) * per_chunk
    assert nbytes == (3 * 2 * b * s * h * p + 2 * 4 * b * s * h + 2 * 4 * h
                      + 4 * 2 * b * s * g * n)
    per_head, _ = ssd_ops.bwd_work(b, s, h, h, n, p, chunk)
    assert per_head - flops == b * (s // chunk) * 2 * tri * 3 * (h - g) * n
    ragged, _ = ssd_ops.bwd_work(b, s + 44, h, g, n, p, chunk)
    tail, _ = ssd_ops.bwd_work(b, 44, h, g, n, p, chunk)
    assert ragged == flops + tail


@pytest.mark.parametrize("s,chunk,init_dt", [(64, 16, False),
                                             (256, 256, True),
                                             (512, 128, True)])
def test_ssd_chunked_forward_bitwise_unchanged(monkeypatch, s, chunk,
                                               init_dt):
    """Masking seg before the exp gives the forward bitwise the values of
    the old ``where`` formula (exp(-inf) is 0), y and final state, also
    where the old one overflowed above the diagonal."""
    rng = np.random.RandomState(5)
    arrs = list(_ssd_arrays(rng, 2, s, 3, 1, 8, 8))
    if init_dt:
        arrs[1], arrs[2] = np.full((2, s, 3), np.log(2.0)), -np.ones(3)
    args = _t(arrs, torch.float32)
    y, state = ssm.ssd_chunked(*args, chunk)
    monkeypatch.setattr(ssm, "_causal_decay", _where_decay)
    y_old, state_old = ssm.ssd_chunked(*args, chunk)
    assert torch.equal(y, y_old) and torch.equal(state, state_old)
    assert bool(torch.isfinite(y).all())


def _nan_leaves(cfg, params, batch):
    _, _, grads = value_and_grad(cfg, params, batch)
    out = []
    tree_map(lambda path, g: out.append(path) if not bool(
        torch.isfinite(g).all()) else None, grads)
    return sorted(out)


def test_mamba2_grads_finite_at_full_chunk(monkeypatch):
    """One mamba2_780m layer narrowed to d_model 128 (4 heads of 64,
    N = 128) and a 1000-token vocab, at its own chunk 256 and S = 256 in
    fp32 on the CPU: every gradient leaf is finite. With the old decay
    formula the same call puts NaN into five leaves."""
    cfg = get_config("mamba2_780m").with_(
        n_layers=1, d_model=128, vocab=1000, compute_dtype="float32")
    assert cfg.ssm_chunk == 256
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (1, 257))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    assert _nan_leaves(cfg, params, batch) == []
    monkeypatch.setattr(ssm, "_causal_decay", _where_decay)
    assert _nan_leaves(cfg, params, batch) == [
        "embed", "layers/ssm/A_log", "layers/ssm/dt_bias", "layers/ssm/wdt",
        "layers/ssm_norm"]


# ---------------------------------------------------------------------------
# kernel admission: the smoke shapes by padding, the full ones unpadded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FULL)
def test_padded_shapes_are_identity_at_full_configs(arch):
    """The kernels run every full registry config at its own shape: the
    ops' padding functions are the identity there, so the full-width
    paths never pay for padding."""
    cfg = get_config(arch)
    if cfg.n_heads:
        assert flash_pad(cfg.hd) == cfg.hd
    if cfg.d_ff and cfg.mlp == "swiglu":
        assert mlp_pad(cfg.d_model, cfg.d_ff) == (cfg.d_model, cfg.d_ff)
    if cfg.is_ssm_family:
        assert ssd_pad(cfg.ssm_head_dim) == cfg.ssm_head_dim


@pytest.mark.parametrize("kind,dims,want", [
    ("flash", 16, 64), ("flash", 8, 64), ("flash", 64, 64),
    ("flash", 72, 80), ("flash", 88, 96), ("flash", 104, 128),
    ("flash", 136, None), ("flash", 20, None), ("flash", 0, None),
    ("mlp", (64, 128), (128, 128)), ("mlp", (64, 64), (128, 128)),
    ("mlp", (2048, 8192), (2048, 8192)), ("mlp", (192, 320), (256, 384)),
    ("mlp", (96, 128), None), ("mlp", (128, 100), None),
    ("ssd", 16, 64), ("ssd", 32, 64), ("ssd", 64, 64),
    ("ssd", 72, None), ("ssd", 12, None),
])
def test_padded_shapes(kind, dims, want):
    """The shape each kernel runs for a smoke shape: flash pads hd (a
    multiple of 8 up to 128) to the next native head dim, fused_mlp K
    and F (multiples of 64) to multiples of 128, ssd_scan P (a multiple
    of 8 up to 64) to 64; anything else is refused with ValueError."""
    fn = {"flash": flash_pad, "mlp": lambda d: mlp_pad(*d),
          "ssd": ssd_pad}[kind]
    if want is None:
        with pytest.raises(ValueError):
            fn(dims)
    else:
        assert fn(dims) == want
