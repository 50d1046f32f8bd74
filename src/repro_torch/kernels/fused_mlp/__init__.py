from .ops import fused_mlp
from .ref import fused_mlp_ref
