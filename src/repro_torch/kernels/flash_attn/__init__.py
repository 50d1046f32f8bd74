from .ops import FlashAttention, flash_attention, flash_attention_backward
from .ref import attention_lse, attention_ref
