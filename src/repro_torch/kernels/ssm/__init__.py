from .kernel import (BWD_CHUNK, LAUNCH_SHAPES, LAUNCHES, LIBRARY, MAX_N,
                     launch, launch_bwd, launch_fused, plan_fused_bwd,
                     reset_launches, selective_scan_cuda,
                     selective_scan_fused_bwd_cuda, selective_scan_fused_cuda,
                     states_shape)
from .ops import selective_scan, selective_scan_fused
from .ref import (selective_scan_fused_bwd_ref, selective_scan_fused_ref,
                  selective_scan_ref)

__all__ = ["BWD_CHUNK", "LAUNCH_SHAPES", "LAUNCHES", "LIBRARY",
           "MAX_N", "launch", "launch_bwd", "launch_fused", "plan_fused_bwd",
           "reset_launches", "selective_scan_cuda",
           "selective_scan_fused_bwd_cuda", "selective_scan_fused_cuda",
           "selective_scan", "selective_scan_fused",
           "selective_scan_fused_bwd_ref", "selective_scan_fused_ref",
           "selective_scan_ref", "states_shape"]
