from .ops import adamw_step, adamw_sumsq, sumsq_slots
from .ref import adamw_step_ref, clip_scale_ref, sumsq_ref
