"""Hand-written CUDA kernels for an NVIDIA Hopper card (`sm_90a`).

  intersect/  — IoU Sketch L-way bitmap AND + popcount and the
                AND/OR/ANDNOT program evaluator (the query combine)

Each package ships the CUDA source (`csrc/`), a ctypes loader that
builds it with nvcc on first use (`_build.py`), wrappers with launch
counters (`ops.py`), and the plain PyTorch version (`ref.py`) that CPU
tensors take and the card's results are held against.
"""
