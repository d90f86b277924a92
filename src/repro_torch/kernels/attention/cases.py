"""Attention cases with positions, shared by the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py`'s `attn_edge` phase:
the positions the sliding-window, VLM and encoder-decoder models give
the kernel, at small shapes that take both bf16 kernels (`kernel.plan`)
and the float32 one."""

from __future__ import annotations

import torch


def position_cases(device) -> list:
    """(name, (B, S, T, H, KV, dh), keywords) of the attention the
    mixtral, vlm and encdec serving paths give the kernel, on `device`:
    positions per batch row in prefill and in decode (M-RoPE's temporal
    ids: a run of equal ids for the image patches, then text from an
    offset of its row's own), a ring of T = window slots after its wrap (key positions not
    sorted) in decode and in prefill, and non-causal S = 32 against
    4096 keys (the split-KV decode kernel, g = 1, dh = 64) and S = T =
    4096 (the prefill kernel)."""
    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device)

    offsets = torch.tensor([20, 25, 50], device=device)
    ids = torch.cat([torch.zeros(3, 100, device=device, dtype=torch.long),
                     offsets[:, None] + torch.arange(200, device=device)],
                    dim=1)                                  # (3, 300)
    row0 = torch.full((400,), -1, dtype=torch.long, device=device)
    row0[:300] = ids[0]
    ring = torch.empty(256, dtype=torch.long, device=device)
    held = torch.arange(455 - 255, 456, device=device)    # 200 .. 455
    ring[held % 256] = held
    kv_rows = torch.stack([torch.arange(400, device=device) - 7 * b
                           for b in range(2)])            # (2, 400)
    return [
        ("rows_prefill", (3, 300, 300, 16, 4, 128),
         {"causal": True, "q_positions": i32(ids), "kv_positions": i32(ids)}),
        ("rows_prefill_window", (3, 300, 300, 16, 4, 128),
         {"causal": True, "window": 64, "q_positions": i32(ids),
          "kv_positions": i32(ids)}),
        ("rows_decode", (3, 1, 400, 64, 8, 128),
         {"causal": True, "q_positions": i32(offsets[:, None] + 200),
          "kv_positions": i32(row0)}),
        ("rows_kv_decode", (2, 1, 400, 32, 8, 128),
         {"causal": True, "q_positions": i32([[399], [392]]),
          "kv_positions": i32(kv_rows)}),
        ("ring_decode", (2, 1, 256, 48, 8, 128),
         {"causal": True, "window": 256, "q_positions": i32([455]),
          "kv_positions": i32(ring)}),
        ("ring_prefill", (2, 64, 256, 48, 8, 128),
         {"causal": True, "window": 256,
          "q_positions": i32(torch.arange(392, 456)),
          "kv_positions": i32(ring)}),
        ("cross_decode", (1, 32, 4096, 16, 16, 64),
         {"causal": False, "q_positions": i32(torch.arange(32)),
          "kv_positions": i32(torch.arange(4096))}),
        ("encoder", (1, 4096, 4096, 16, 16, 64),
         {"causal": False, "q_positions": i32(torch.arange(4096)),
          "kv_positions": i32(torch.arange(4096))}),
    ]
