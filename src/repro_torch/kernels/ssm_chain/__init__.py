from .ops import conv_silu, gated_rmsnorm
from .ref import causal_dw_conv, conv_silu_ref, gated_rmsnorm_ref
