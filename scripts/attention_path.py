#!/usr/bin/env python3
"""Time one checkout's attention kernel at the LM path's shapes.

    python3 scripts/attention_path.py [TREE]

TREE is a checkout's root (default: the one holding this script), for
instance an unpacked `git archive` of a parent commit under `build/`,
so that two commits' kernels can be timed in turns in one call on one
card: `attention_path.py build/parent; attention_path.py .; ...`. It
imports TREE's own `chip_smoke.py` and `src/`, builds TREE's attention
library, and runs TREE's `attn_timing_phase` at the `lm` phase's
shapes (qwen3-32b: B = 4, 64 heads over 8 KV heads of 128; a causal
prefill of 2000 positions and a decode step against 2032 slots), with
the launch counts of 8 layers. Prints the JSON lines; needs a CUDA card.
"""

import os
import sys

LM_SHAPES = {(4, 2000, 2000, 64, 8, 128, "bfloat16"): 8,
             (4, 1, 2032, 64, 8, 128, "bfloat16"): 256}


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), ".."))
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import attention as ta
    if not torch.cuda.is_available():
        raise SystemExit("attention_path: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"tree": tree, "card": cs.card_line()})
    cs.build_phase([ta.LIBRARY])
    entry = cs.attn_timing_phase(ta, torch.device("cuda", 0), 0, LM_SHAPES,
                                 {"float32": 0.0, "bfloat16": 0.0})
    cs.emit({"tree": tree, "attention": {
        kind: {key: shape[key] for key in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "max_abs_err")}
        for kind, shape in entry["shapes"].items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
