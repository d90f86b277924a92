"""Assigned input-shape cells (4 per architecture, 40 total).

`train_*` lowers train_step; `prefill_*` lowers a full-prompt forward that
materializes the KV cache; `decode_*` / `long_*` lower serve_step (one new
token against a seq_len-long cache). long_500k requires bounded decode
state: it runs for rwkv6 (constant state), jamba (mamba state + 4 KV
layers) and mixtral (SWA rolling buffer); the 7 pure full-attention archs
skip it (recorded in DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    step: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# Archs whose decode state stays bounded at 500k context.
LONG_CONTEXT_OK = {"mixtral-8x22b", "rwkv6-3b", "jamba-v0.1-52b"}


def cells_for(arch_name: str) -> list[str]:
    out = []
    for s in SHAPES:
        if s == "long_500k" and arch_name not in LONG_CONTEXT_OK:
            continue
        out.append(s)
    return out


def skipped_cells_for(arch_name: str) -> list[str]:
    return [s for s in SHAPES if s not in cells_for(arch_name)]
