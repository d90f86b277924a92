"""Hand-written CUDA kernels for an NVIDIA Hopper card (`sm_90a`).

  intersect/  — IoU Sketch L-way bitmap AND + popcount and the
                AND/OR/ANDNOT program evaluator (the query combine)
  attention/  — flash attention with positions and GQA (the LM's
                prefill and decode attention), its backward (training),
                and decode attention against an int8 KV cache
  rwkv/       — the RWKV-6 wkv recurrence with an initial and a final
                state (rwkv6-3b's prefill and decode)
  ssm/        — the Mamba selective (diagonal) scan with an initial and
                a final state: from a and b, and fused from the layer's
                own dt, A, B_, C_ and x (jamba-v0.1-52b's Mamba layers)

Each package ships the CUDA source (`csrc/`), built with nvcc on first
use and loaded with ctypes by the shared helper (`_build.py`), wrappers
with launch counters, and the plain PyTorch version (`ref.py`) that CPU
tensors take and the card's results are held against. The packages
import on first use (`from repro_torch.kernels import rwkv`).
"""

__all__ = ["attention", "intersect", "rwkv", "ssm"]
