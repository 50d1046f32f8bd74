from .ops import flash_attention
from .ref import attention_ref
