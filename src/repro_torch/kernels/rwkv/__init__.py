from .kernel import (HEAD_DIMS, LAUNCH_SHAPES, LAUNCHES, LIBRARY, Plan,
                     launch, plan, reset_launches, wkv_cuda)
from .ops import wkv
from .ref import wkv_ref

__all__ = ["HEAD_DIMS", "LAUNCH_SHAPES", "LAUNCHES", "LIBRARY", "Plan",
           "launch", "plan", "reset_launches", "wkv_cuda",
           "wkv", "wkv_ref"]
