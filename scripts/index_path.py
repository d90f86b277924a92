#!/usr/bin/env python3
"""Run one checkout's index path on the card, as `chip_smoke.py` does.

    python3 scripts/index_path.py [TREE] [--docs 1000000] [--B 200000]

TREE is a checkout's root (default: the one holding this script), for
instance an unpacked `git archive` of a parent commit under `build/`,
so that two commits' index paths can be timed in turns in one call on
one card: `index_path.py build/parent; index_path.py build/change; ...`.
It imports TREE's own `chip_smoke.py` and `src/`, builds TREE's
intersect library, and runs TREE's `main_phase` with `--profile` (the
`query_batch` under `impl="bitmap"` and `impl="sorted"`,
`IoUSketch.query`, `combine_cluster_planned`, and the cProfile of both
batches). Prints `chip_smoke.py`'s JSON lines; needs a CUDA card.
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--B", type=int, default=200_000)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import intersect as tx
    if not torch.cuda.is_available():
        raise SystemExit("index_path: no CUDA card")
    cs.emit({"tree": tree, "card": cs.card_line()})
    cs.build_phase([tx.LIBRARY])
    cs.main_phase(argparse.Namespace(docs=args.docs, B=args.B, seed=0,
                                     profile=True), torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
