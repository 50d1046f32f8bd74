"""Plain PyTorch oracle for the SSD chunk-scan kernel: the sequential
recurrence of ``repro.kernels.ssd_scan.ref.ssd_ref``, plus the final
state, which the kernel also writes (prefill needs it for the decode
cache)."""
import torch


def ssd_ref(x, dt, a, bm, cm):
    """x [BH, S, P]; dt [BH, S, 1]; a [BH, 1, 1]; bm/cm [BH, S, N].

    h_t = exp(dt_t * a) h_{t-1} + dt_t * B_t (x) x_t ; y_t = C_t . h_t,
    in fp32 (float64 for float64 inputs). Returns (y [BH, S, P] in
    x.dtype, h_S [BH, N, P] in that accumulation type)."""
    bh, s, p = x.shape
    n = bm.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, bf, cf = (t.to(acc) for t in (x, dt[..., 0], bm, cm))
    af = a.to(acc)[:, 0, 0]
    h = torch.zeros((bh, n, p), dtype=acc, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * af)
        h = h * da[:, None, None] + torch.einsum(
            "bn,b,bp->bnp", bf[:, t], dtf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def to_pallas_layout(x, dt, A, B, C):
    """Model layout (x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,G,N]) as
    the kernel's Pallas layout (x [BH,S,P], dt [BH,S,1], a [BH,1,1],
    B/C [BH,S,N], groups expanded to heads)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]

    def heads(t):  # [B,S,H,*] -> [BH,S,*]
        return t.permute(0, 2, 1, 3).reshape(b * h, s, t.shape[-1])

    return (heads(x), heads(dt[..., None]),
            A.reshape(1, h).expand(b, h).reshape(b * h, 1, 1),
            heads(B.repeat_interleave(rep, dim=2)),
            heads(C.repeat_interleave(rep, dim=2)))


def from_pallas_layout(y, state, b: int):
    """(y [BH,S,P], state [BH,N,P]) back to (y [B,S,H,P], state
    [B,H,N,P])."""
    bh, s, p = y.shape
    h = bh // b
    return (y.reshape(b, h, s, p).permute(0, 2, 1, 3),
            state.reshape(b, h, *state.shape[1:]))
