from .kernel import (HEAD_DIMS, LAUNCH_SHAPES, LAUNCHES, LIBRARY,
                     flash_attention, flash_bwd, flash_decode_int8, launch,
                     launch_bwd, launch_int8, plan, plan_int8,
                     reset_launches)
from .ops import attention, attention_bwd, attention_int8
from .ref import (attention_bwd_ref, attention_int8_ref, attention_ref,
                  attention_split_ref)

__all__ = ["HEAD_DIMS", "LAUNCH_SHAPES", "LAUNCHES", "LIBRARY",
           "flash_attention", "flash_bwd", "flash_decode_int8", "launch",
           "launch_bwd", "launch_int8", "plan", "plan_int8",
           "reset_launches", "attention", "attention_bwd", "attention_int8",
           "attention_bwd_ref", "attention_int8_ref", "attention_ref",
           "attention_split_ref"]
