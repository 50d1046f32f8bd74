"""The Mamba-2 chain around the SSD scan (``repro_torch.kernels.ssm_chain``)
on the CPU: the plain versions are the torch chain ``models.ssm._block``
ran before the kernels, bitwise; ``_block`` keeps that chain under
autograd, on DTensors and on the CPU, with the kernels' counters still;
the wrappers refuse what the kernels do not take. The kernels themselves
run in ``tests/test_torch_cuda.py`` on the card.
"""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import counters, ssm_chain  # noqa: E402
from repro_torch.kernels.ssm_chain import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402

ARCHS = ["mamba2_780m", "zamba2_1_2b"]


def _old_block(cfg, params, x):
    """``models.ssm._block`` as it was before the chain's kernels, the
    oracle of the torch chain: (out, final state, pre-conv projections)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    chunk = min(cfg.ssm_chunk, s)

    def w(key):
        return params[key].to(x.dtype)

    def conv(x, w):
        k, s = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        return sum(xp[:, i:i + s, :] * w[i] for i in range(k))

    z = x @ w("wz")
    xin = x @ w("wx")
    Bv = x @ w("wB")
    Cv = x @ w("wC")
    dt = x @ w("wdt")
    xc = F.silu(conv(xin, w("conv_x")))
    Bc = F.silu(conv(Bv, w("conv_B")))
    Cc = F.silu(conv(Cv, w("conv_C")))
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final = ssm._ssd(xc.reshape(b, s, h, p), dt, A,
                        Bc.reshape(b, s, g, n), Cc.reshape(b, s, g, n), chunk)
    y = y + params["D"].to(x.dtype)[:, None] * xc.reshape(b, s, h, p)
    y = y.reshape(b, s, cfg.d_inner)
    y = rmsnorm(y * F.silu(z), params["gn_scale"])
    return y @ w("wo"), final, (xin, Bv, Cv)


def _inputs(arch, b, s, dtype, seed=0):
    """The smoke config, its Mamba-2 params (fp32 leaves kept fp32, the
    rest in ``dtype``, the fp32 ones drawn off their init values so the
    skip, the bias and the scale are not the identity) and x [b, s, D]."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(seed)
    params = ssm.init_mamba2(cfg, gen, dtype)
    for key in ("dt_bias", "A_log", "D", "gn_scale"):
        params[key] = params[key] + 0.5 * torch.randn(
            params[key].shape, generator=gen)
    x = torch.randn((b, s, cfg.d_model), generator=gen).to(dtype)
    return cfg, params, x


def _chain_launches():
    return ops.conv_silu.launches, ops.gated_rmsnorm.launches


@pytest.fixture
def no_kernels(monkeypatch):
    """The chain's kernel ops replaced by ones that fail if called."""
    def fail(*_):
        raise AssertionError("the chain's kernel op was called")
    monkeypatch.setattr(ssm_chain, "conv_silu", fail)
    monkeypatch.setattr(ssm_chain, "gated_rmsnorm", fail)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_chain_is_bitwise_the_old_torch_chain(arch, s, dtype,
                                                    no_kernels):
    """At the smoke widths (mamba2: W 128, G*N 16, H 8; zamba2 the same),
    two sequences, a prompt shorter than the conv (S 2 < K 4) and one
    longer: ``_block``'s torch chain, whose expressions ``ssm_chain.ref``
    now holds, gives the old chain's output, final state and projections
    bitwise, in bf16 and fp32; the kernel ops are never called."""
    cfg, params, x = _inputs(arch, 2, s, dtype)
    before = _chain_launches()
    with torch.no_grad():
        got = ssm._block(cfg, params, x)
        want = _old_block(cfg, params, x)
    assert _chain_launches() == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_versions_match_the_chain_expressions(arch):
    """``conv_silu_ref`` and ``gated_rmsnorm_ref`` on the CPU, called
    through the ops (CPU tensors take the plain version and count no
    launch), give the old chain's tensors bitwise; the causal conv of a
    sequence never reads its neighbour's rows."""
    cfg, params, x = _inputs(arch, 3, 3, torch.bfloat16, seed=1)
    b, s = x.shape[:2]
    h, p, gn = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state
    gen = torch.Generator().manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    xin, bm, cm, dt = rand(b, s, cfg.d_inner), rand(b, s, gn), rand(
        b, s, gn), rand(b, s, h)
    w = [params[k].to(torch.bfloat16) for k in ("conv_x", "conv_B",
                                                 "conv_C")]
    before = _chain_launches()
    xc, bc, cc, dto, a = ops.conv_silu(xin, bm, cm, *w, dt,
                                       params["dt_bias"], params["A_log"])
    conv = ssm_chain.causal_dw_conv
    assert torch.equal(xc, F.silu(conv(xin, w[0])))
    assert torch.equal(bc, F.silu(conv(bm, w[1])))
    assert torch.equal(cc, F.silu(conv(cm, w[2])))
    assert torch.equal(dto, F.softplus(dt.float() + params["dt_bias"]))
    assert torch.equal(a, -torch.exp(params["A_log"]))
    # row 0 of each sequence sees only its own first row
    assert torch.equal(conv(xin, w[0])[:, 0], xin[:, 0] * w[0][-1])
    y, z = rand(b, s, h, p), rand(b, s, cfg.d_inner)
    got = ops.gated_rmsnorm(y, xc, z, params["D"], params["gn_scale"])
    skip = y + params["D"].to(y.dtype)[:, None] * xc.reshape(b, s, h, p)
    want = rmsnorm(skip.reshape(b, s, -1) * F.silu(z), params["gn_scale"])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert _chain_launches() == before


@pytest.mark.parametrize("arch", ARCHS)
def test_block_keeps_the_torch_chain_under_autograd(arch, no_kernels):
    """A forward that records a gradient runs the torch chain: the
    gradient reaches every leaf, the kernel ops are not called and their
    counters do not move."""
    cfg, params, x = _inputs(arch, 2, 16, torch.float32)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    before = _chain_launches()
    out = ssm.mamba2_block(cfg, leaves, x)
    out.square().sum().backward()
    assert _chain_launches() == before
    for key, t in leaves.items():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), key


@pytest.mark.parametrize("case,want", [
    ("no grad", True), ("params require grad", False),
    ("params require grad, grad mode off", True),
    ("x requires grad", False), ("cpu", False)])
def test_chain_kernels_only_for_plain_cuda_tensors_without_a_gradient(
        case, want):
    """``_chain_kernels`` on a stand-in for a CUDA activation: the kernels
    run when no gradient is recorded (grad mode off, or no input requiring
    grad) and never on CPU tensors."""
    _, params, x = _inputs("mamba2_780m", 1, 2, torch.float32)
    cuda_x = SimpleNamespace(is_cuda=case != "cpu",
                             requires_grad=case == "x requires grad")
    if case.startswith("params require grad"):
        params = {k: v.requires_grad_() for k, v in params.items()}
    grad = case != "params require grad, grad mode off"
    with torch.set_grad_enabled(grad):
        assert ssm._chain_kernels(cuda_x, params) is want


def test_block_keeps_the_torch_chain_on_dtensors(tmp_path, no_kernels):
    """On a (1, 1) mesh of DTensors (gloo, one process) a no-grad prefill
    runs the torch chain (the gated norm would need the heads' shards):
    the kernel ops are not called, the counters do not move, and the
    logits equal the single process's."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh(data=1, model=1, device_type="cpu")
        cfg = get_config("mamba2_780m", smoke=True).with_(
            compute_dtype="float32")
        params = model_zoo.init_params(cfg, torch.Generator().manual_seed(0))
        dparams = sh.distribute(params, sh.param_specs(params, mesh), mesh)
        toks = torch.randint(0, cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        before = _chain_launches()
        with torch.no_grad():
            want, _ = model_zoo.prefill(cfg, params, toks, 24)
            got, _ = model_zoo.prefill(cfg, dparams, sh.distribute(
                {"tokens": toks}, sh.batch_specs(cfg, 2, mesh, "prefill"),
                mesh)["tokens"], 24)
        assert _chain_launches() == before
        assert torch.allclose(got.full_tensor(), want, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def _conv_args(dtype=torch.bfloat16, w=16, gn=8, h=8, k=4):
    gen = torch.Generator().manual_seed(3)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=gen).to(dt)

    return [rand(2, 4, w), rand(2, 4, gn), rand(2, 4, gn), rand(k, w),
            rand(k, gn), rand(k, gn), rand(2, 4, h),
            rand(h, dt=torch.float32), rand(h, dt=torch.float32)]


def _norm_args(dtype=torch.bfloat16, h=2, p=8):
    gen = torch.Generator().manual_seed(4)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=gen).to(dt)

    return [rand(2, 4, h, p), rand(2, 4, h * p), rand(2, 4, h * p),
            rand(h, dt=torch.float32), rand(h * p, dt=torch.float32)]


@pytest.mark.parametrize("op,args", [(ops.conv_silu, _conv_args),
                                     (ops.gated_rmsnorm, _norm_args)])
@pytest.mark.parametrize("which", [0, -1])
def test_wrappers_refuse_inputs_that_require_grad(op, args, which):
    """A forward-only kernel would drop the gradient: an input that
    requires grad is refused while grad mode is on, on any device."""
    ins = args(torch.float32)
    ins[which].requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        op(*ins)
    with torch.no_grad():
        op(*ins)


@pytest.mark.parametrize("admit,args", [
    (ops.admit_conv_silu, _conv_args), (ops.admit_gated_rmsnorm, _norm_args)])
@pytest.mark.parametrize("fault,match", [
    ("dtype", "bfloat16"), ("fp32 dtype", "float32"),
    ("strided", "contiguous"), ("cpu", "CUDA"), ("shape", "shape")])
def test_wrappers_refuse_what_the_kernels_do_not_take(admit, args, fault,
                                                      match):
    """Before a launch: a wrong dtype (bf16 inputs, fp32 parameters), a
    non-contiguous input, CPU tensors and mismatched shapes raise
    ValueError."""
    ins = args()
    if fault == "dtype":
        ins[0] = ins[0].float()
    elif fault == "fp32 dtype":
        ins[-1] = ins[-1].to(torch.bfloat16)
    elif fault == "strided":
        ins[1] = ins[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "shape":
        ins[-1] = ins[-1][:-1]
    with pytest.raises(ValueError, match=match):
        admit(*ins)


@pytest.mark.parametrize("admit,args,kw,match", [
    (ops.admit_conv_silu, _conv_args, dict(w=12), "multiples of 8"),
    (ops.admit_conv_silu, _conv_args, dict(k=3), "width 4"),
    (ops.admit_gated_rmsnorm, _norm_args, dict(p=12), "multiple of 8"),
    (ops.admit_gated_rmsnorm, _norm_args, dict(h=1025, p=8),
     "at most 8192"),
])
def test_wrappers_refuse_widths_the_kernels_do_not_take(admit, args, kw,
                                                        match):
    with pytest.raises(ValueError, match=match):
        admit(*args(**kw))


def test_chain_counters_are_registered():
    """Both ops count their launches in ``kernels.counters``, so a CUDA
    graph's bookkeeping and the benchmark's reset see them."""
    keys = set(counters.read())
    assert {("conv_silu", "launches"), ("gated_rmsnorm", "launches")} <= keys
    assert {ops.conv_silu, ops.gated_rmsnorm} <= set(counters.OPS)
