"""Airphant on PyTorch + CUDA: the IoU Sketch index's query path, with
the round-1 candidate combine on an NVIDIA Hopper card, and LM serving
(prefill + KV-cache decode of the dense transformer, prefill +
recurrent-state decode of RWKV-6) with its attention and its wkv
recurrence in hand-written kernels.

Mirrors `repro` (the JAX package) module for module, over the slices
ported so far: build → open → `query_batch(impl="bitmap")`; the index
lifecycle (`Index`, segments, memory segments, GC); the serving tier's
query path (`SearchService`, `Frontend`, `ShardedIndex` →
`ClusterSearcher` scatter-gather, the control plane); and `configs` /
`models` / `launch.serve.decode_loop`. Subpackages import
lazily — `import repro_torch` touches neither torch nor numpy:

    from repro_torch import Builder, BuilderConfig, Searcher, as_transport
    Builder(BuilderConfig(B=20_000)).build(corpus, store, "idx/logs")
    Searcher(as_transport(store), "idx/logs").query_batch([...])

Entry points run on the card (`device="cuda"`) unless the caller asks
for `device="cpu"`; without a card the default raises.
"""

import importlib

__version__ = "0.1.0"

# public façade -> defining module; resolved on first attribute access
_LAZY_EXPORTS = {
    "Index": "repro_torch.index",
    "IndexWriter": "repro_torch.index",
    "MultiSegmentSearcher": "repro_torch.index",
    "Builder": "repro_torch.index",
    "BuilderConfig": "repro_torch.index",
    "Searcher": "repro_torch.index",
    "And": "repro_torch.index",
    "Or": "repro_torch.index",
    "Not": "repro_torch.index",
    "Term": "repro_torch.index",
    "Phrase": "repro_torch.index",
    "Regex": "repro_torch.index",
    "parse": "repro_torch.index",
    "to_string": "repro_torch.index",
    "normalize": "repro_torch.index",
    "PureNegationError": "repro_torch.index",
    "GramlessIndexError": "repro_torch.index",
    "GCReport": "repro_torch.index",
    "collect_garbage": "repro_torch.index",
    "SearchService": "repro_torch.serving",
    "ShardedIndex": "repro_torch.serving",
    "ClusterSearcher": "repro_torch.serving",
    "ClusterConflict": "repro_torch.serving",
    "collect_cluster_garbage": "repro_torch.serving",
    "Frontend": "repro_torch.serving",
    "FrontendConfig": "repro_torch.serving",
    "Overloaded": "repro_torch.serving",
    "DeadlineExceeded": "repro_torch.serving",
    "StorageTransport": "repro_torch.storage",
    "TransportPolicy": "repro_torch.storage",
    "SimCloudTransport": "repro_torch.storage",
    "BlobStoreTransport": "repro_torch.storage",
    "as_transport": "repro_torch.storage",
}

__all__ = ["__version__", *_LAZY_EXPORTS]


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(__all__)
