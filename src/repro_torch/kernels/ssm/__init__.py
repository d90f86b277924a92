from .kernel import (LAUNCH_SHAPES, LAUNCHES, LIBRARY, MAX_N, launch,
                     reset_launches, selective_scan_cuda)
from .ops import selective_scan
from .ref import selective_scan_ref

__all__ = ["LAUNCH_SHAPES", "LAUNCHES", "LIBRARY", "MAX_N", "launch",
           "reset_launches", "selective_scan_cuda", "selective_scan",
           "selective_scan_ref"]
