#!/usr/bin/env python3
"""Run one checkout's encoder-decoder serving path on the card, as
`chip_smoke.py` does, and time its encoder alone.

    python3 scripts/encdec_path.py [TREE] [--repeat 3] [--encodes 10]

TREE is a checkout's root (default: the one holding this script), for
instance an unpacked `git archive` of a parent commit under `build/`,
so that two commits' serving paths can be timed in turns in one call on
one card: `encdec_path.py build/parent; encdec_path.py build/change;
...`. It imports TREE's own `chip_smoke.py` and `src/`, builds TREE's
attention library, runs TREE's `encdec_phase` `--repeat` times (each
prints its JSON line, `prefill_s` and `decode_s` among its keys), then
times `--encodes` calls of `model.encode` on the phase's frames (4,
ENC_FRAMES, 1024) bf16 with gradients enabled and no weight needing one,
as a server calls it: host clock ending in a device synchronise, each
call and their median. Needs a CUDA card.
"""

import argparse
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--encodes", type=int, default=10)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.seamless_m4t_medium import ENC_FRAMES
    from repro_torch.kernels import attention as ta
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        raise SystemExit("encdec_path: no CUDA card")
    device = torch.device("cuda", 0)
    cs.emit({"tree": tree, "card": cs.card_line()})
    cs.build_phase([ta.LIBRARY])
    phase_args = argparse.Namespace(seed=0)
    for _ in range(args.repeat):
        cs.encdec_phase(phase_args, device)
    model = build_model(get_config(cs.ENCDEC_ARCH))
    params, _ = cs.new_params(model, 0, device)
    frames = torch.randn(cs.ENCDEC_BATCH, ENC_FRAMES, model.cfg.d_model,
                         generator=torch.Generator(device=device)
                         .manual_seed(11), device=device).to(torch.bfloat16)
    seconds = []
    for _ in range(args.encodes + 1):           # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(params, frames)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    cs.emit({"phase": "encode", "tree": tree, "grad_enabled":
             torch.is_grad_enabled(), "shape": list(frames.shape),
             "encode_s": seconds[1:],
             "encode_s_median": statistics.median(seconds[1:])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
