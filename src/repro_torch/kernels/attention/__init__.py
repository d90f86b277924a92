from .kernel import (HEAD_DIMS, LAUNCH_SHAPES, LAUNCHES, LIBRARY,
                     flash_attention, launch, reset_launches)
from .ops import attention
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCH_SHAPES", "LAUNCHES", "LIBRARY",
           "flash_attention", "launch", "reset_launches", "attention",
           "attention_ref"]
