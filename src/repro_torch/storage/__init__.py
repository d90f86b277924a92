"""Separation of compute and storage: blob stores, simulated cloud, and
the async `StorageTransport` protocol the read path speaks."""

from .blobstore import (BlobStore, InMemoryBlobStore, LocalBlobStore,
                        RangeRequest, from_items)
from .cache import LRUCache, SuperpostCache
from .simcloud import REGIONS, FetchStats, NetworkModel, SimCloudStore
from .transport import (DEFAULT_POLICY, BlobStoreTransport, FetchFuture,
                        SimCloudTransport, StorageTransport, TransportBatch,
                        TransportError, TransportPolicy, as_transport)

__all__ = ["BlobStore", "InMemoryBlobStore", "LocalBlobStore", "RangeRequest",
           "from_items",
           "LRUCache", "SuperpostCache",
           "REGIONS", "FetchStats", "NetworkModel", "SimCloudStore",
           "StorageTransport", "TransportPolicy", "TransportBatch",
           "TransportError", "FetchFuture", "SimCloudTransport",
           "BlobStoreTransport", "as_transport", "DEFAULT_POLICY"]
