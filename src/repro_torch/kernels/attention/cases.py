"""Attention cases with positions, shared by the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py`'s `attn_edge`,
`int8_edge` and `attn_bwd_edge` phases: the positions the sliding-window,
VLM and encoder-decoder models give the kernel, at small shapes that take
both bf16 kernels (`kernel.plan`) and the float32 one; the int8 decode
kernel's cases (`int8_cases`, inputs by `int8_inputs`) and the backward
kernel's (`bwd_cases`, inputs by `bwd_inputs`). Inputs are drawn from a
seeded `torch.Generator` on the CPU and moved to the device, so a card
and the CPU see the same numbers."""

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


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def int8_cases(device) -> list:
    """(name, (B, S, T, H, KV, dh), keywords) of int8 decode attention:
    empty slots, a rolling ring after its wrap (key positions unsorted),
    a window, positions per batch row, GQA groups of 1, 8 and 48, dh 64
    and 128, T not a multiple of the split or the tile, a single valid
    key, every key masked (all these on both routes of
    `kernel.plan_int8`), and 48 rows against 20,000 keys, whose scores no
    cluster holds (the split route only)."""
    ring = torch.empty(300, dtype=torch.long)
    held = torch.arange(777 - 299, 778)
    ring[held % 300] = held
    empty = torch.arange(500)
    empty[350:] = -1
    single = torch.full((130,), -1)
    single[77] = 5
    rows = torch.stack([torch.arange(640) - 9 * b for b in range(3)])
    return [
        ("empty_slots", (2, 1, 500, 64, 8, 128),
         {"q_positions": _i32([349], device),
          "kv_positions": _i32(empty, device)}),
        ("ring", (2, 1, 300, 48, 8, 128),
         {"window": 300, "q_positions": _i32([777], device),
          "kv_positions": _i32(ring, device)}),
        ("window", (3, 1, 1000, 8, 1, 64),
         {"window": 100, "q_positions": _i32([999], device),
          "kv_positions": _i32(torch.arange(1000), device)}),
        ("rows", (3, 1, 640, 64, 8, 128),
         {"q_positions": _i32([[639], [630], [621]], device),
          "kv_positions": _i32(rows, device)}),
        ("mqa_g48", (2, 1, 333, 48, 1, 128),
         {"q_positions": _i32([332], device),
          "kv_positions": _i32(torch.arange(333), device)}),
        ("g1_ragged", (4, 1, 4097, 16, 16, 64),
         {"q_positions": _i32([4096], device),
          "kv_positions": _i32(torch.arange(4097), device)}),
        ("single_key", (2, 1, 130, 32, 4, 64),
         {"q_positions": _i32([5], device),
          "kv_positions": _i32(single, device)}),
        ("all_masked", (1, 1, 70, 8, 8, 64),
         {"q_positions": _i32([3], device),
          "kv_positions": _i32(torch.arange(70) + 10, device)}),
        ("mqa_long", (1, 1, 20000, 48, 1, 128),
         {"q_positions": _i32([19999], device),
          "kv_positions": _i32(torch.arange(20000), device)}),
    ]


def int8_inputs(shape, seed: int, device, dtype=torch.bfloat16):
    """q (B, S, H, dh) in `dtype`, and k, v (B, T, KV, dh) int8 with bf16
    scales (B, T, KV), quantized from normal draws as the model's
    `_quantize_kv` does."""
    B, S, T, H, KV, dh = shape
    g = torch.Generator().manual_seed(seed)

    def quant(x):
        scale = x.abs().amax(-1) / 127.0 + 1e-9
        x8 = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
        return x8.to(torch.int8).to(device), scale.bfloat16().to(device)

    q = torch.randn(B, S, H, dh, generator=g).to(dtype).to(device)
    k8, ks = quant(torch.randn(B, T, KV, dh, generator=g))
    v8, vs = quant(torch.randn(B, T, KV, dh, generator=g))
    return q, k8, v8, ks, vs


def bwd_cases(device) -> list:
    """(name, (B, S, H, KV, dh), keywords) of training attention (S = T):
    causal, a window, positions per batch row, GQA groups of 1, 8 and
    48, dh 64 and 128, S not a multiple of the 32-row tile, and S = 1;
    then the tensor-core route's edges (its items of 128 keys or query
    positions, its tiles of 64): causal over several items with S not a
    multiple of 64, a window narrower than a tile (whole tiles skipped,
    the tiles it crosses masked), and g = 8 at dh 64 with positions per
    row over several items; last dh 32, which the FMA route takes in
    bf16 too, from the bf16 prefill kernel's log-sum-exp under
    autograd."""
    rows = torch.stack([torch.arange(77) + 5 * b for b in range(2)])
    rows300 = torch.stack([torch.arange(300) + 7 * b for b in range(2)])
    return [
        ("causal", (2, 96, 8, 1, 64), {"causal": True}),
        ("causal_g8_ragged", (1, 77, 64, 8, 128), {"causal": True}),
        ("window", (2, 130, 16, 2, 64), {"causal": True, "window": 33}),
        ("rows", (2, 77, 8, 8, 128),
         {"causal": True, "q_positions": _i32(rows, device),
          "kv_positions": _i32(rows, device)}),
        ("mqa_g48", (1, 40, 48, 1, 128), {"causal": True}),
        ("noncausal", (1, 50, 4, 4, 64), {"causal": False}),
        ("one_token", (3, 1, 8, 8, 64), {"causal": True}),
        ("causal_items_ragged", (1, 1000, 16, 2, 128), {"causal": True}),
        ("window_narrow", (1, 700, 8, 1, 64), {"causal": True,
                                                "window": 100}),
        ("g8_dh64_rows", (2, 300, 16, 2, 64),
         {"causal": True, "q_positions": _i32(rows300, device),
          "kv_positions": _i32(rows300, device)}),
        ("dh32_window", (2, 200, 16, 2, 32), {"causal": True,
                                              "window": 90}),
    ]


def bwd_inputs(shape, seed: int, device, dtype=torch.bfloat16):
    """q, dout (B, S, H, dh) and k, v (B, S, KV, dh) in `dtype`."""
    B, S, H, KV, dh = shape
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(B, S, H, dh, generator=g) for _ in range(2))
    k, v = (torch.randn(B, S, KV, dh, generator=g) for _ in range(2))
    return tuple(x.to(dtype).to(device) for x in (q, k, v, dout))
