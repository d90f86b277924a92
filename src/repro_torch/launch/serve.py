"""Serve launcher (CLI): search serving, or LM decode with a KV cache or
a recurrent state.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --queries 50
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --mode decode --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
        --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
        --arch jamba-v0.1-52b

`--mode search` (the default) mirrors `repro/launch/serve.py --mode
search`: a 4,000-line log corpus indexed into an in-memory store behind
a simulated `--region`, then one `SearchService.search_batch` of
`--queries` words drawn from it, top 10, combined on `--device`.
`--mode decode` mirrors its decode mode on the reduced config of
`--arch` (a dense or MoE transformer, RWKV-6 or the Jamba hybrid), with
weights drawn from a seeded `torch.Generator`: prefill of `--batch`
random 32-token prompts, then greedy decoding. `--mode rag` needs
`RAGPipeline`, which is not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import argparse
import inspect
import time
from dataclasses import dataclass

import torch

PROMPT_LEN = 32


@dataclass
class Decoded:
    tokens: torch.Tensor          # (B, n_tokens) greedy tokens fed back in
    logits: torch.Tensor          # (B, vocab) float32 after the last token
    prefill_s: float              # host wall time, the device synchronised
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(model, params, prompt: torch.Tensor, n_tokens: int):
    """`model.prefill` of `prompt` (B, S), with room for `n_tokens` more:
    a KV cache of S + n_tokens slots where the model's prefill takes
    `pad_to`; a recurrent state, whose size does not grow, where not."""
    kw = ({"pad_to": prompt.shape[1] + n_tokens}
          if "pad_to" in inspect.signature(model.prefill).parameters else {})
    return model.prefill(params, {"tokens": prompt}, **kw)


def decode_loop(model, params, prompt, n_tokens: int) -> Decoded:
    """Prefill `prompt` (B, S) with room for n_tokens more, then feed back
    the argmax token `n_tokens` times."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, params, prompt, n_tokens)
    _sync(device)
    t1 = time.perf_counter()
    tokens = []
    for _ in range(n_tokens):
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        tokens.append(tok)
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
    _sync(device)
    t2 = time.perf_counter()
    out = torch.cat(tokens, dim=1) if tokens else \
        prompt.new_zeros((prompt.shape[0], 0))
    return Decoded(out, logits, t1 - t0, t2 - t1)


def serve_search(args) -> None:
    """`--mode search`: build, open through a simulated region, serve one
    batch, print the service's latency summary."""
    import numpy as np

    from ..data import make_logs_like, write_corpus
    from ..data.tokenizer import distinct_words
    from ..index import Builder, BuilderConfig
    from ..kernels.intersect.ops import resolve_device
    from ..serving import SearchService
    from ..storage import (REGIONS, InMemoryBlobStore, SimCloudStore,
                           SimCloudTransport)

    device = resolve_device(args.device)
    store = InMemoryBlobStore()
    docs = make_logs_like(4000, seed=13)
    corpus = write_corpus(store, "corpus/serve", docs, n_blobs=4)
    Builder(BuilderConfig(B=2000, F0=1.0, hedge_layers=1)).build(
        corpus, store, "index/serve")
    cloud = SimCloudStore(store, model=REGIONS[args.region], seed=0)
    svc = SearchService(SimCloudTransport(cloud), "index/serve",
                        hedge=args.hedge, device=device)
    truth = set()
    for d in docs[:500]:
        truth.update(distinct_words(d))
    rng = np.random.default_rng(0)
    queries = [str(w) for w in
               rng.choice(sorted(truth), args.queries, replace=False)]
    results = svc.search_batch(queries, top_k=10)
    s = svc.stats.summary()
    print(f"served {s['n_queries']} queries in {s['n']} batch(es) @ "
          f"{args.region} on {device}: mean {s['mean_ms']:.0f} ms, p99 "
          f"{s['p99_ms']:.0f} ms, wait {s['wait_ms']:.0f} ms / download "
          f"{s['download_ms']:.1f} ms, avg FP "
          f"{s['avg_false_positives']:.2f}, "
          f"{sum(bool(r.refs) for r in results)} with results")
    svc.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="search",
                    choices=["search", "rag", "decode"])
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--queries", type=int, default=30)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hedge", action="store_true")
    ap.add_argument("--region", default="us-central1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mode == "rag":
        raise SystemExit("--mode rag needs RAGPipeline, which is not "
                         "ported yet (ROADMAP queue 1, item 8)")
    if args.mode == "search":
        serve_search(args)
        return

    import numpy as np

    from ..configs import get_config
    from ..kernels.intersect.ops import resolve_device
    from ..models import build_model, init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model.param_desc(), gen, device)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(4, cfg.vocab, (args.batch, PROMPT_LEN))).to(device)
    out = decode_loop(model, params, prompt, args.tokens)
    if not torch.isfinite(out.logits).all():
        raise SystemExit("decode produced non-finite logits")
    print(f"{cfg.name} (reduced) on {device}: prefill {args.batch}×"
          f"{PROMPT_LEN} in {out.prefill_s:.3f}s; decoded {args.tokens} "
          f"tokens × batch {args.batch} in {out.decode_s:.3f}s "
          f"({args.tokens * args.batch / max(out.decode_s, 1e-9):.1f} tok/s)")
    print("greedy tokens:", out.tokens.tolist())


if __name__ == "__main__":
    main()
