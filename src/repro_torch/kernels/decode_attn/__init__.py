from .ops import decode_attention, rope_table, split_plan
from .ref import decode_attention_ref, gqa_decode_attend
