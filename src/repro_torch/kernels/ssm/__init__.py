from .kernel import (LAUNCH_SHAPES, LAUNCHES, LIBRARY, MAX_N, launch,
                     launch_fused, reset_launches, selective_scan_cuda,
                     selective_scan_fused_cuda)
from .ops import selective_scan, selective_scan_fused
from .ref import selective_scan_fused_ref, selective_scan_ref

__all__ = ["LAUNCH_SHAPES", "LAUNCHES", "LIBRARY", "MAX_N", "launch",
           "launch_fused", "reset_launches", "selective_scan_cuda",
           "selective_scan_fused_cuda", "selective_scan",
           "selective_scan_fused", "selective_scan_fused_ref",
           "selective_scan_ref"]
