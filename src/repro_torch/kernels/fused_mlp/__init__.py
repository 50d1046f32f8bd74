from .ops import FusedMLP, fused_mlp
from .ref import fused_mlp_ref
