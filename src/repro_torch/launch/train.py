"""Train launcher (CLI): a model of the registry trained on a
keyword-filtered mixture that an Airphant index serves
(`repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
        --reduced --steps 50 --query "block" --workdir build/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --reduced --device cpu --steps 2

`--arch` takes any architecture whose batches are tokens and labels:
the transformers, RWKV-6 and Jamba (on a card their wkv and scan are
differentiated by the `wkv_bwd` and `selective_scan_fused_bwd` kernels,
their attention by `flash_bwd`). The loader feeds no encoder frames or
image patches, as the JAX launcher's does not, so the encoder-decoder and
the VLM are trained through `train()` with a loader that adds them.

A 4,000-line log corpus is written and indexed into a `LocalBlobStore`
at `--workdir` (once); an `IndexedCorpusLoader` behind a simulated cloud
store serves `--batch` × `--seq` token batches of the documents that
match `--query` (all of them without one); `training.run` trains on
`--device` (the card by default) with AdamW, checkpoints every
`--ckpt-every` steps into the same store, and resumes from the latest
checkpoint there when it is started again. Parameters are drawn from a
seeded `torch.Generator`. `--layers` cuts the config's depth. The JAX
launcher's XLA flags for a TPU (`TPU_XLA_FLAGS`, `--print-env`) have no
counterpart here.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

DEFAULT_WORKDIR = Path(__file__).resolve().parents[3] / "build" / \
    "airphant-train"


def logs_store(workdir, n_docs: int = 4000):
    """The workdir's blob store, with the log corpus and its index
    ("index/logs") written on first use."""
    from ..data import make_logs_like, write_corpus
    from ..index import Builder, BuilderConfig
    from ..storage import LocalBlobStore

    store = LocalBlobStore(str(workdir))
    if not store.list("index/logs"):
        docs = make_logs_like(n_docs, seed=7)
        corpus = write_corpus(store, "corpus/logs", docs, n_blobs=4)
        Builder(BuilderConfig(B=2000, F0=1.0)).build(corpus, store,
                                                     "index/logs")
    return store


def make_loader(store, cfg, seq: int, batch: int, query, device):
    """`IndexedCorpusLoader` over the logs index behind a simulated cloud
    store; the keyword filter's combine runs on `device`."""
    from ..data.pipeline import IndexedCorpusLoader, PipelineConfig
    from ..storage import SimCloudStore

    return IndexedCorpusLoader(
        SimCloudStore(store, seed=0), "index/logs",
        PipelineConfig(seq_len=seq, batch_size=batch, vocab_size=cfg.vocab),
        query=query, device=device)


def train(cfg, store, loader, *, steps: int, lr: float, ckpt_every: int,
          device, log_every: int = 10, ckpt_config=None, ckpt_store=None,
          seed: int = 0):
    """Seeded parameters on `device`, then `training.run` with
    checkpoints in `ckpt_store` (default: `store`), resuming from the
    latest there. Returns (model, state, log)."""
    from ..models import build_model, init_params
    from ..training import (CheckpointManager, OptimizerConfig,
                            TrainLoopConfig, run)

    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_desc(), gen, device)
    ckpt = CheckpointManager(store if ckpt_store is None else ckpt_store,
                             ckpt_config)
    state, log = run(
        model, params, loader, ckpt,
        TrainLoopConfig(total_steps=steps, checkpoint_every=ckpt_every,
                        log_every=log_every),
        OptimizerConfig(lr=lr, total_steps=steps,
                        warmup_steps=max(steps // 10, 1)))
    return model, state, log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--query", default=None,
                    help="keyword filter for the training mixture")
    ap.add_argument("--workdir", default=os.fspath(DEFAULT_WORKDIR))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..kernels.intersect.ops import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    store = logs_store(args.workdir)
    loader = make_loader(store, cfg, args.seq, args.batch, args.query,
                         device)
    _model, _state, log = train(cfg, store, loader, steps=args.steps,
                                lr=args.lr, ckpt_every=args.ckpt_every,
                                device=device)
    print("steps:", log.steps)
    print("losses:", [round(x, 4) for x in log.losses])
    if log.resumed_from is not None:
        print("resumed from step", log.resumed_from)


if __name__ == "__main__":
    main()
