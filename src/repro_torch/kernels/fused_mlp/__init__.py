from .ops import FusedMLP, fused_mlp, fused_mlp_backward
from .ref import fused_mlp_ref
