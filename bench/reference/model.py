"""Plain float32 reference of the benchmark's language models.

Written from the configuration files in ``bench/configs`` and the papers
they cite, in plain PyTorch: no kernel, no cache, no batching, nothing of
the program under test. It reads the weights the benchmark made (a flat
dict of '/'-joined paths, laid out by ``param_layout``) and works every
derived quantity out again.

Each family's layers are a file of their own, ``bench/families/<family>.py``
(found by the configuration's ``family``): the weights of a layer and its
residual sublayers, built from the blocks here. The blocks: causal
multi-head attention with rotary positions (split halves), the SwiGLU
MLP, the configured norm, and the Mamba-2 mixer.

Mamba-2 (arXiv:2405.21060): z, x, B, C, dt projections; a depthwise causal
conv of width ``ssm_conv`` with SiLU on x, B and C; dt = softplus(dt +
dt_bias); A = -exp(A_log); the scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t
x_t^T, y_t = C_t h_t + D x_t, computed in the chunked dual form of the
paper's minimal listing (``ssd``); then rmsnorm(y * silu(z)) and the out
projection.

``Dots`` carries the precision of every matrix product: float32 with TF32
off, or, for the control, operands rounded to float8 e4m3 with a
per-tensor scale and products summed in float32 (``lowp.fp8_matmul``).
"""
from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lowp

Params = Dict[str, torch.Tensor]


def padded_vocab(cfg: dict) -> int:
    pad = cfg["vocab_pad"]
    return (cfg["vocab"] + pad - 1) // pad * pad


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def family(cfg: dict):
    """The module ``bench/families/<family>.py`` of ``cfg``'s family, found
    by name: its layers' weights (``layout``) and residual sublayers
    (``sublayers``), and its work counts."""
    return importlib.import_module(f"bench.families.{cfg['family']}")


def dense(*shape) -> tuple:
    """The init of a matrix [.., in, out]: normal, std 1/sqrt(in)."""
    return ("normal", 1.0 / math.sqrt(shape[-2]))


def param_layout(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """[(path, shape, init)] of every weight, per-layer weights stacked on
    a leading layer axis. ``init`` is ("normal", std), ("ones",) or
    ("zeros",); matrices are [in, out] with std 1/sqrt(in), the embedding
    std 1. The family adds its layers' weights."""
    d, v = cfg["d_model"], padded_vocab(cfg)
    return [("embed", (v, d), ("normal", 1.0)),
            ("unembed", (d, v), dense(d, v)),
            ("final_norm", (d,), ("ones",))] + family(cfg).layout(cfg)


def attn_layout(cfg: dict, prefix: str, stack: tuple) -> list:
    """The weights of one attention block (wq, wk, wv, wo)."""
    d, hd = cfg["d_model"], head_dim(cfg)
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    return [(f"{prefix}/{name}", stack + shape, dense(*shape))
            for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                                ("wv", (d, kv * hd)), ("wo", (h * hd, d)))]


def mlp_layout(cfg: dict, prefix: str, stack: tuple) -> list:
    """The weights of one SwiGLU MLP (w1, w3, w2)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return [(f"{prefix}/{name}", stack + shape, dense(*shape))
            for name, shape in (("w1", (d, f)), ("w3", (d, f)),
                                ("w2", (f, d)))]


def mamba2_layout(cfg: dict, prefix: str, stack: tuple) -> list:
    """The weights of one Mamba-2 mixer; the conv taps std 1/width."""
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    h = di // cfg["ssm_head_dim"]
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    kw = cfg["ssm_conv"]
    out = []
    for name, shape, init in (
            ("wz", (d, di), None), ("wx", (d, di), None),
            ("wB", (d, gn), None), ("wC", (d, gn), None),
            ("wdt", (d, h), None), ("dt_bias", (h,), ("zeros",)),
            ("conv_x", (kw, di), ("normal", 1.0 / kw)),
            ("conv_B", (kw, gn), ("normal", 1.0 / kw)),
            ("conv_C", (kw, gn), ("normal", 1.0 / kw)),
            ("A_log", (h,), ("zeros",)), ("D", (h,), ("ones",)),
            ("gn_scale", (di,), ("ones",)), ("wo", (di, d), None)):
        out.append((f"{prefix}/{name}", stack + shape,
                    init or dense(*shape)))
    return out


def fp32_leaf(path: str) -> bool:
    """Leaves that a served model keeps in float32: norm scales and the
    Mamba-2 dt_bias, A_log, D and gn_scale; every matrix is served in
    the compute dtype."""
    last = path.rsplit("/", 1)[-1]
    return "norm" in last or last in ("dt_bias", "A_log", "D", "gn_scale")


class Dots:
    """Matrix products in float32 (``fp8=False``) or with float8 e4m3
    operands (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a, b):
        return lowp.fp8_matmul(a, b) if self.fp8 else torch.matmul(a, b)


def strict_fp32():
    """Float32 products stay float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _norm(cfg: dict, x, scale=None):
    if cfg["norm"] == "layernorm_np":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + cfg["norm_eps"])
    return _rms(x, scale, cfg["norm_eps"])


def _rms(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(cfg: dict, x, positions):
    """x [S, H, hd]: rotate the two halves of each head by position x
    theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (positions.double()[:, None] * inv).float()
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def block(w: Params, prefix: str, i=None) -> Params:
    """The leaves under ``prefix``, by last name; layer ``i`` of stacked
    leaves."""
    n = len(prefix) + 1
    return {k[n:]: (v if i is None else v[i]) for k, v in w.items()
            if k.startswith(prefix + "/")}


def attention(cfg: dict, dots: Dots, w: Params, x):
    """Causal self-attention of one sequence x [S, D]; ``w`` the block's
    wq, wk, wv, wo."""
    s = x.shape[0]
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = head_dim(cfg)
    q = dots.mm(x, w["wq"]).view(s, h, hd)
    k = dots.mm(x, w["wk"]).view(s, kv, hd)
    v = dots.mm(x, w["wv"]).view(s, kv, hd)
    pos = torch.arange(s, device=x.device)
    q, k = _rope(cfg, q, pos), _rope(cfg, k, pos)
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = dots.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = dots.mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(s, h * hd)
    return dots.mm(o, w["wo"])


def mlp(dots: Dots, w: Params, x):
    g = dots.mm(x, w["w1"])
    u = dots.mm(x, w["w3"])
    return dots.mm(F.silu(g) * u, w["w2"])


def _causal_conv(x, taps):
    """Depthwise causal conv: y_t = sum_i taps[i] x_{t - (K-1) + i}."""
    k, s = taps.shape[0], x.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[i:i + s] * taps[i] for i in range(k))


def _segsum(a):
    """a [..., L] -> [..., L, L]: sum of a over (j, i] below the diagonal,
    -inf above it (the minimal SSD listing's segsum)."""
    n = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    seg = c[..., :, None] - c[..., None, :]
    keep = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(dots: Dots, x, dt, a, bm, cm, chunk: int):
    """Chunked SSD of one sequence. x [S, H, P]; dt [S, H]; a [H];
    bm, cm [S, G, N] -> y [S, H, P]. Within a chunk the quadratic form;
    across chunks the state recurrence."""
    s, h, p = x.shape
    g = bm.shape[1]
    rep = h // g
    nc = s // chunk
    xw = (x * dt[..., None]).view(nc, chunk, h, p)
    la = (dt * a).view(nc, chunk, h).permute(0, 2, 1)      # [c, h, l]
    b = bm.repeat_interleave(rep, dim=1).view(nc, chunk, h, -1)
    c = cm.repeat_interleave(rep, dim=1).view(nc, chunk, h, -1)
    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(sum_(j,i] dt A) dt_j x_j
    cb = dots.mm(c.permute(0, 2, 1, 3), b.permute(0, 2, 3, 1))
    m = cb * torch.exp(_segsum(la))                        # [c, h, l, l]
    y = dots.mm(m, xw.permute(0, 2, 1, 3))                # [c, h, l, p]
    # each chunk's own state: sum_j exp(sum_(j,L] dt A) B_j (dt_j x_j)^T
    cum = torch.cumsum(la, dim=-1)
    to_end = torch.exp(cum[..., -1:] - cum)                # [c, h, l]
    st = dots.mm((b.permute(0, 2, 3, 1) * to_end[:, :, None, :]),
                  xw.permute(0, 2, 1, 3))                  # [c, h, n, p]
    decay = torch.exp(cum[..., -1])                        # [c, h]
    prev, state = [], torch.zeros_like(st[0])
    for i in range(nc):
        prev.append(state)
        state = state * decay[i][:, None, None] + st[i]
    prev = torch.stack(prev)                               # [c, h, n, p]
    y = y + dots.mm(c.permute(0, 2, 1, 3) * torch.exp(cum)[..., None],
                     prev)
    return y.permute(0, 2, 1, 3).reshape(s, h, p)


def mamba2(cfg: dict, dots: Dots, w: Params, x):
    """A Mamba-2 layer (weights ``w``) on one sequence x [S, D] (normed
    input)."""
    def p(name):
        return w[name]

    s = x.shape[0]
    h = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]
    pd, g, n = cfg["ssm_head_dim"], cfg["ssm_groups"], cfg["ssm_state"]
    z = dots.mm(x, p("wz"))
    xs = F.silu(_causal_conv(dots.mm(x, p("wx")), p("conv_x")))
    bm = F.silu(_causal_conv(dots.mm(x, p("wB")), p("conv_B")))
    cm = F.silu(_causal_conv(dots.mm(x, p("wC")), p("conv_C")))
    dt = F.softplus(dots.mm(x, p("wdt")) + p("dt_bias"))
    a = -torch.exp(p("A_log"))
    chunk = min(cfg["ssm_chunk"], s)
    y = ssd(dots, xs.view(s, h, pd), dt, a, bm.view(s, g, n),
            cm.view(s, g, n), chunk)
    y = (y + p("D")[:, None] * xs.view(s, h, pd)).reshape(s, -1)
    y = _rms(y * F.silu(z), p("gn_scale"), cfg["norm_eps"])
    return dots.mm(y, p("wo"))


def residual(cfg: dict, scale, f) -> Callable:
    """The residual sublayer x -> x + f(norm(x))."""
    return lambda x: x + f(_norm(cfg, x, scale))


def _layer(cfg, dots, w, i, x):
    for f in family(cfg).sublayers(cfg, dots, w, i):
        x = f(x)
    return x


def hidden(cfg: dict, w: Params, tokens, dots: Dots = Dots(),
           remat: bool = False):
    """Final normed hidden states [S, D] of one sequence ``tokens`` [S];
    with ``remat`` each layer is recomputed in the backward (memory
    only: the arithmetic is the same)."""
    x = w["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        if remat:
            x = checkpoint(_layer, cfg, dots, w, i, x, use_reentrant=False)
        else:
            x = _layer(cfg, dots, w, i, x)
    return _norm(cfg, x, w["final_norm"])


def logits(cfg: dict, w: Params, tokens, dots: Dots = Dots(),
           rows=None):
    """Logits [S', V] of one sequence over the real vocabulary (the
    padding columns are dropped), at positions ``rows`` (default all)."""
    h = hidden(cfg, w, tokens, dots)
    if rows is not None:
        h = h[rows]
    return dots.mm(h, w["unembed"])[:, :cfg["vocab"]]


def loss(cfg: dict, w: Params, tokens, labels, dots: Dots = Dots()):
    """Mean next-token cross entropy of one sequence (tokens, labels
    [S]), the logits in float32 over the real vocabulary."""
    h = hidden(cfg, w, tokens, dots, remat=True)
    z = dots.mm(h, w["unembed"])[:, :cfg["vocab"]]
    return (torch.logsumexp(z, -1)
            - z.gather(-1, labels.long()[:, None])[:, 0]).mean()
