"""Plain PyTorch oracle for the flash attention kernel: exact softmax
attention, causal with queries end-aligned to the keys, GQA via repeat
(the semantics of ``repro.kernels.flash_attn.ref.attention_ref``)."""
import torch


def attention_ref(q, k, v, causal=True):
    """Pallas layout q [BH, Sq, hd], k/v [BKV, Skv, hd] -> [BH, Sq, hd],
    or model layout q [B, Sq, H, hd], k/v [B, Skv, KV, hd] ->
    [B, Sq, H, hd]; in q.dtype."""
    if q.dim() == 4:
        b, sq, h, hd = q.shape
        o = attention_ref(*(t.permute(0, 2, 1, 3).flatten(0, 1)
                            for t in (q, k, v)), causal)
        return o.reshape(b, h, sq, hd).permute(0, 2, 1, 3)
    bh, sq, hd = q.shape
    bkv, skv, _ = k.shape
    g = bh // bkv
    kk = k.repeat_interleave(g, dim=0)
    vv = v.repeat_interleave(g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk.float()) / (hd ** 0.5)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, vv.float())
    return o.to(q.dtype)
