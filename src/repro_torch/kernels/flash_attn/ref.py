"""Plain PyTorch oracle for the flash attention kernel: exact softmax
attention, causal with queries end-aligned to the keys, GQA via repeat
(the semantics of ``repro.kernels.flash_attn.ref.attention_ref``), in
fp32 (float64 for float64 inputs)."""
import torch


def attention_ref(q, k, v, causal=True, scale=None):
    """Pallas layout q [BH, Sq, hd], k/v [BKV, Skv, hd] -> [BH, Sq, hd],
    or model layout q [B, Sq, H, hd], k/v [B, Skv, KV, hd] ->
    [B, Sq, H, hd]; in q.dtype; the scores scaled by ``scale`` (None:
    divided by sqrt(hd))."""
    if q.dim() == 4:
        b, sq, h, hd = q.shape
        o = attention_ref(*(t.permute(0, 2, 1, 3).flatten(0, 1)
                            for t in (q, k, v)), causal, scale)
        return o.reshape(b, h, sq, hd).permute(0, 2, 1, 3)
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    acc = torch.promote_types(q.dtype, torch.float32)
    kk = k.repeat_interleave(g, dim=0)
    vv = v.repeat_interleave(g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), kk.to(acc))
    s = s / (hd ** 0.5) if scale is None else s * scale
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, vv.to(acc))
    return o.to(q.dtype)


def attention_lse(q, k, causal=True):
    """Each query row's log-sum-exp (natural log) of the scores that
    ``attention_ref`` normalises: q k^T / sqrt(hd), GQA, the end-aligned
    causal mask at -inf. Pallas layout q [BH, Sq, hd], k [BKV, Skv, hd]
    -> [BH, Sq]; model layout q [B, Sq, H, hd], k [B, Skv, KV, hd] ->
    [B, H, Sq]; fp32 (float64 for float64 inputs). The forward kernel
    writes the same quantity in log2 units (times log2(e)) for its
    backward."""
    if q.dim() == 4:
        b, sq, h, _ = q.shape
        lse = attention_lse(*(t.permute(0, 2, 1, 3).flatten(0, 1)
                              for t in (q, k)), causal)
        return lse.reshape(b, h, sq)
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    kk = k.repeat_interleave(bh // bkv, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), kk.to(acc)) / (hd ** 0.5)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s = s.masked_fill(~mask[None], float("-inf"))
    return torch.logsumexp(s, dim=-1)
