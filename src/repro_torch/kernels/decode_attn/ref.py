"""Plain PyTorch version of the decode attention kernel: the port's torch
decode path as the models ran it before the kernel. RoPE on the new
token's query and key (``apply_rope`` with the table's row at ``pos``,
bitwise ``rope_freqs`` at ``pos``), the new key and value written into
the cache at ``pos``, then ``gqa_decode_attend`` over keys [0, pos].

The JAX reference has no kernel here: its decode attention is plain jnp
(``repro.models.attention.decode_attention``).
"""
import torch
import torch.distributed as dist

from ...models.common import apply_rope


def gqa_decode_attend(q, ck, cv, pos, groups=(), scale=None):
    """q [B,1,H,hd] against cache [B,S,KV,hd] without repeating KV; ``pos``
    an int or a 0-d integer tensor on the cache's device; softmax scale
    ``scale`` (None: 1/sqrt(hd)), a scalar of the query's dtype.

    Operands are rounded to the query dtype, products accumulate in
    fp32; keys past ``pos`` are masked. With process ``groups`` (split-KV
    decode) the cache is one shard of the sequence, ``pos`` is local (it
    may lie before or past the shard), and the softmax's max, its sum and
    the weighted values are reduced over the groups, so every shard
    returns the attention over all of it; with none the reductions are
    local."""
    b, _, h, hd = q.shape
    s_max, kv = ck.shape[1], ck.shape[2]
    g = h // kv
    scale = torch.tensor(1.0 / (hd ** 0.5) if scale is None else scale,
                         dtype=q.dtype)
    qg = (q * scale).reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(q.dtype).float())
    mask = torch.arange(s_max, device=q.device) <= pos
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=grp)
    p = torch.exp(s - m)        # the global max is finite: key 0 is seen
    den = p.sum(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(den, group=grp)
    out = torch.einsum("bkgs,bskd->bkgd", (p / den).to(q.dtype).float(),
                       cv.to(q.dtype).float())
    for grp in groups:
        dist.all_reduce(out, group=grp)
    return out.reshape(b, 1, h * hd)


def decode_attention_ref(q, k, v, ck, cv, pos, rope=None, scale=None):
    """q [B,1,H,hd], k/v [B,1,KV,hd] (the new token, before RoPE); cache
    ck/cv [B,S,KV,hd], written in place at ``pos``, a 0-d integer tensor
    on the cache's device, gathered and written through there without a
    host read; ``rope`` the (cos, sin) table [>= pos + 1, hd/2] of
    ``ops.rope_table``, or None for no RoPE; ``scale`` the softmax scale
    (None: 1/sqrt(hd)). Returns the attention over keys [0, pos],
    [B, 1, H*hd] in q's dtype."""
    at = pos.view(1).long()
    if rope is not None:
        c, s = (t[at] for t in rope)
        q, k = apply_rope(q, c, s), apply_rope(k, c, s)
    ck[:, at] = k
    cv[:, at] = v
    return gqa_decode_attend(q, ck, cv, pos, scale=scale).to(q.dtype)
