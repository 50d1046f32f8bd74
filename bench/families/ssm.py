"""The Mamba-2 family (Mamba-2 780M): L x [x + mamba2(rmsnorm(x))], no
attention and no MLP. Its layers for the reference
(``bench.reference.model``) and its work counts (``bench.work``)."""
from __future__ import annotations

from bench import work
from bench.reference import model as ref


def _dims(cfg: dict):
    """(d_inner, heads, groups x state)."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, di // cfg["ssm_head_dim"], cfg["ssm_groups"] * cfg["ssm_state"]


def layout(cfg: dict) -> list:
    L, d = cfg["n_layers"], cfg["d_model"]
    return ([("layers/ssm_norm", (L, d), ("ones",))]
            + ref.mamba2_layout(cfg, "layers/ssm", (L,)))


def sublayers(cfg: dict, dots, w, i: int) -> list:
    return [ref.residual(cfg, w["layers/ssm_norm"][i],
                         lambda h: ref.mamba2(
                             cfg, dots, ref.block(w, "layers/ssm", i), h))]


def matmul_params(cfg: dict) -> int:
    """The in projections (z, x, B, C, dt) and the out projection."""
    d = cfg["d_model"]
    di, h, gn = _dims(cfg)
    return cfg["n_layers"] * (d * (2 * di + 2 * gn + h) + di * d)


def mix_flops(cfg: dict, b: int, queries: int, before: int) -> float:
    """The recurrence: a token's state update and read-out, 2 x 2 N P a
    head, whatever came before it."""
    _, h, _ = _dims(cfg)
    return (4.0 * h * cfg["ssm_state"] * cfg["ssm_head_dim"]
            * cfg["n_layers"] * b * queries)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    _, h, _ = _dims(cfg)
    L, b = cfg["n_layers"], traffic["batch"]
    s = traffic["seq"] if traffic["kind"] == "train" else traffic["prompt"]
    shape = (b, s, h, cfg["ssm_groups"], cfg["ssm_state"],
             cfg["ssm_head_dim"], min(cfg["ssm_chunk"], s))
    if traffic["kind"] == "train":
        return {"ssd_fwd": [(2 * L, work.ssd_fwd(*shape))],
                "ssd_bwd": [(L, work.ssd_bwd(*shape))]}
    return {"ssd_fwd": [(L, work.ssd_fwd(*shape))]}
