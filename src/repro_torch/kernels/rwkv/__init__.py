from .kernel import (BWD_CHUNK, HEAD_DIMS, LAUNCH_SHAPES, LAUNCHES, LIBRARY,
                     BwdPlan, Plan, launch, launch_bwd, plan, plan_bwd,
                     reset_launches, wkv_bwd_cuda, wkv_cuda)
from .ops import wkv
from .ref import (wkv_bwd_chunks_ref, wkv_bwd_ref, wkv_chunk_matrices_ref,
                  wkv_ref)

__all__ = ["BWD_CHUNK", "HEAD_DIMS", "LAUNCH_SHAPES", "LAUNCHES", "LIBRARY",
           "BwdPlan", "Plan", "launch", "launch_bwd", "plan", "plan_bwd",
           "reset_launches", "wkv_bwd_cuda", "wkv_cuda", "wkv",
           "wkv_bwd_chunks_ref", "wkv_bwd_ref", "wkv_chunk_matrices_ref",
           "wkv_ref"]
