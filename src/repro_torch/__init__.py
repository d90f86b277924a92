"""Airphant on PyTorch + CUDA: the IoU Sketch index's query path, with
the round-1 candidate combine on an NVIDIA Hopper card.

Mirrors `repro` (the JAX package) module for module, over the slice
ported so far: build → open → `query_batch(impl="bitmap")`. Subpackages
import lazily — `import repro_torch` touches neither torch nor numpy:

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
