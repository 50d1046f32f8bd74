from .ops import FlashAttention, flash_attention
from .ref import attention_ref
