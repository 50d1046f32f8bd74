"""DNN workload descriptions as 7D loop nests (Timeloop convention).

The paper (Section IV-E) uses the conventional 7D representation of a conv
layer: R/S = filter height/width, P/Q = output height/width, C = input
channels, K = output channels, N = batch. Matrix multiplies (FC, attention
matmuls, BERT Section VI) are degenerate cases with R=S=Q=1 (output rows in
P, output cols in K, reduction in C).

Output data space: [K, P, Q]; input data space: [C, P+R-1, Q+S-1] (stride 1)
or generally [C, (P-1)*stride+R, (Q-1)*stride+S]; weights: [K, C, R, S].
"""
from __future__ import annotations

import dataclasses
from typing import List

DIMS = ("K", "C", "P", "Q", "R", "S", "N")
OUTPUT_DIMS = ("K", "P", "Q")  # N folded into P for matmuls / ignored (paper IV-E)
REDUCTION_DIMS = ("C", "R", "S")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One DNN layer as a 7D loop nest."""

    name: str
    K: int  # output channels
    C: int  # input channels
    P: int  # output height
    Q: int  # output width
    R: int = 1  # filter height
    S: int = 1  # filter width
    N: int = 1  # batch (folded; kept for completeness)
    stride: int = 1
    pad: int = 0

    def dim(self, d: str) -> int:
        return getattr(self, d)

    @property
    def macs(self) -> int:
        return self.N * self.K * self.C * self.P * self.Q * self.R * self.S

    @property
    def output_elems(self) -> int:
        return self.N * self.K * self.P * self.Q

    @property
    def input_shape(self) -> tuple:
        ih = (self.P - 1) * self.stride + self.R
        iw = (self.Q - 1) * self.stride + self.S
        return (self.C, ih, iw)

    @property
    def input_elems(self) -> int:
        c, h, w = self.input_shape
        return self.N * c * h * w

    @property
    def weight_elems(self) -> int:
        return self.K * self.C * self.R * self.S

    def output_size(self) -> int:
        """P*Q*K — paper's "largest output size" Middle heuristic."""
        return self.P * self.Q * self.K

    def overall_size(self) -> int:
        """P*Q*C*K — paper's "largest overall size" Middle heuristic."""
        return self.P * self.Q * self.C * self.K


def conv(name, C, K, hw, RS=3, stride=1, pad=None) -> LayerSpec:
    if pad is None:
        pad = RS // 2
    return LayerSpec(name=name, K=K, C=C, P=hw, Q=hw, R=RS, S=RS,
                     stride=stride, pad=pad)


def matmul(name, M, Kdim, Nout, batch=1) -> LayerSpec:
    """GEMM C[M,Nout] = A[M,Kdim] @ B[Kdim,Nout] as degenerate conv.

    Paper Section VI: "by setting R, S, P, and Q to 1, matrix-matrix
    multiplications can be expressed" — we keep output rows in P so the
    mapper can tile them, which is the same degeneracy (R=S=1, Q=1).
    Head-batched matmuls fold the head count into M.
    """
    return LayerSpec(name=name, K=Nout, C=Kdim, P=M * batch, Q=1, R=1, S=1,
                     stride=1, pad=0)


# ---------------------------------------------------------------------------
# Networks evaluated in the paper (Section V: ResNet-18, VGG-16, ResNet-50;
# Section VI: one BERT encoder block).
# ---------------------------------------------------------------------------

def vgg16() -> List[LayerSpec]:
    """13 conv layers of VGG-16 (paper reports 13 layers)."""
    cfg = [
        (3, 64, 224), (64, 64, 224),
        (64, 128, 112), (128, 128, 112),
        (128, 256, 56), (256, 256, 56), (256, 256, 56),
        (256, 512, 28), (512, 512, 28), (512, 512, 28),
        (512, 512, 14), (512, 512, 14), (512, 512, 14),
    ]
    return [conv(f"conv{i+1}", c, k, hw) for i, (c, k, hw) in enumerate(cfg)]


def resnet18() -> List[LayerSpec]:
    """20 layers (paper: "Layer 2 to Layer 20"): conv1 + 16 block convs +
    3 downsample 1x1 convs."""
    layers = [LayerSpec("conv1", K=64, C=3, P=112, Q=112, R=7, S=7,
                        stride=2, pad=3)]
    # stage 1: 56x56, 64ch — 2 basic blocks
    for b in range(2):
        layers.append(conv(f"s1b{b}c1", 64, 64, 56))
        layers.append(conv(f"s1b{b}c2", 64, 64, 56))
    # stages 2-4 with downsample conv in first block
    stage = [(64, 128, 28), (128, 256, 14), (256, 512, 7)]
    for si, (cin, cout, hw) in enumerate(stage, start=2):
        layers.append(conv(f"s{si}b0c1", cin, cout, hw, stride=2))
        layers.append(conv(f"s{si}b0c2", cout, cout, hw))
        layers.append(LayerSpec(f"s{si}b0ds", K=cout, C=cin, P=hw, Q=hw,
                                R=1, S=1, stride=2, pad=0))
        layers.append(conv(f"s{si}b1c1", cout, cout, hw))
        layers.append(conv(f"s{si}b1c2", cout, cout, hw))
    assert len(layers) == 20
    return layers


def resnet50() -> List[LayerSpec]:
    """49 conv layers: conv1 + 16 bottleneck blocks x 3 convs (downsample
    convs excluded; paper Section IV-J argues skip layers complete within
    the block's execution and do not affect total latency)."""
    layers = [LayerSpec("conv1", K=64, C=3, P=112, Q=112, R=7, S=7,
                        stride=2, pad=3)]
    stages = [  # (n_blocks, mid_ch, out_ch, hw)
        (3, 64, 256, 56), (4, 128, 512, 28), (6, 256, 1024, 14),
        (3, 512, 2048, 7),
    ]
    cin = 64
    for si, (nb, mid, cout, hw) in enumerate(stages, start=1):
        for b in range(nb):
            stride = 2 if (b == 0 and si > 1) else 1
            layers.append(LayerSpec(f"s{si}b{b}c1", K=mid, C=cin, P=hw,
                                    Q=hw, R=1, S=1, stride=stride, pad=0))
            layers.append(conv(f"s{si}b{b}c2", mid, mid, hw))
            layers.append(LayerSpec(f"s{si}b{b}c3", K=cout, C=mid, P=hw,
                                    Q=hw, R=1, S=1, stride=1, pad=0))
            cin = cout
    assert len(layers) == 49
    return layers


def bert_encoder(seq: int = 512, d_model: int = 768, heads: int = 12,
                 d_ff: int = 3072) -> List[LayerSpec]:
    """One BERT-base encoder block as a chain of matmul layers (Section VI).

    Softmax/LN are elementwise and excluded (paper: "FC and FFN layers ...
    account for a majority of the computation").
    """
    hd = d_model // heads
    return [
        matmul("q_proj", seq, d_model, d_model),
        matmul("k_proj", seq, d_model, d_model),
        matmul("v_proj", seq, d_model, d_model),
        matmul("qk", seq, hd, seq, batch=heads),
        matmul("av", seq, seq, hd, batch=heads),
        matmul("out_proj", seq, d_model, d_model),
        matmul("ffn1", seq, d_model, d_ff),
        matmul("ffn2", seq, d_ff, d_model),
    ]


NETWORKS = {
    "resnet18": resnet18,
    "vgg16": vgg16,
    "resnet50": resnet50,
    "bert_encoder": bert_encoder,
}


def get_network(name: str) -> List[LayerSpec]:
    """Layers of a core network, or of a zoo scenario string
    (``repro_torch.workloads`` grammar ``<arch>[:phase][@length][xblocks]``,
    e.g. ``deepseek_moe_16b:prefill@2048``). Raises ``KeyError`` listing
    both namespaces for unknown names."""
    if name in NETWORKS:
        return NETWORKS[name]()
    try:  # lazy: the lowering layer imports the config registry
        from ..workloads import scenario_layers
    except ImportError:
        raise KeyError(
            f"unknown network {name!r}; have {sorted(NETWORKS)} "
            "(zoo scenarios unavailable: repro_torch.workloads failed to "
            "import)") from None
    return scenario_layers(name)   # KeyError on unknown arch
