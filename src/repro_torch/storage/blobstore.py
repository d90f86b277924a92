"""Blob-store abstraction: the `separation of compute and storage` substrate.

Everything Airphant persists — superpost blocks, index headers, tokenized
corpus shards, model checkpoints — goes through this interface. The two
implementations here are backed by local disk and by memory; `simcloud.py`
wraps either with a cloud-latency model so benchmarks see GCS/S3-like
behaviour (affine latency, random range reads) without a network.
"""

from __future__ import annotations

import os
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass

from ..analysis.locks import OrderedLock


@dataclass(frozen=True)
class RangeRequest:
    """A single random read: fetch `length` bytes of `blob` at `offset`.

    `length=-1` means read to the end of the blob. This mirrors the
    HTTP Range reads all major cloud vendors support (paper §III-A).
    """

    blob: str
    offset: int = 0
    length: int = -1


class BlobStore(ABC):
    """Object storage: named immutable blobs with random range reads."""

    @abstractmethod
    def put(self, name: str, data: bytes) -> None: ...

    @abstractmethod
    def get_range(self, req: RangeRequest) -> bytes: ...

    @abstractmethod
    def size(self, name: str) -> int: ...

    @abstractmethod
    def list(self, prefix: str = "") -> list[str]: ...

    @abstractmethod
    def delete(self, name: str) -> None: ...

    def get(self, name: str) -> bytes:
        return self.get_range(RangeRequest(name))

    def exists(self, name: str) -> bool:
        """Fallback for exotic subclasses; both built-in stores override
        this with an O(1) check — `list` walks every blob."""
        return name in self.list(name)

    def put_if_absent(self, name: str, data: bytes) -> bool:
        """Create `name` only if it does not exist; True on creation.

        This is the primitive that makes index-manifest publication a
        compare-and-swap (docs/index_lifecycle.md): of two writers racing
        to publish the same generation, exactly one wins. Both built-in
        stores override this with a genuinely atomic version (real object
        stores expose the same via if-none-match / precondition PUTs);
        this fallback is check-then-put and only suitable for stores
        without concurrent writers.
        """
        if self.exists(name):
            return False
        self.put(name, data)
        return True

    def mtime(self, name: str) -> float:
        """Last-modified time of `name` as a POSIX timestamp.

        Garbage collection (`index.lifecycle.collect_garbage`) uses this
        for its grace window: an unreachable blob younger than the window
        is kept for the next sweep, so a reader that resolved a manifest
        moments ago can still range-read the blobs it points at. Stores
        that cannot answer return 0.0 ("unknown age" = old enough to
        collect); both built-in stores answer truthfully.
        """
        return 0.0

    def total_bytes(self, prefix: str = "") -> int:
        return sum(self.size(n) for n in self.list(prefix))


class InMemoryBlobStore(BlobStore):
    """Dict-backed store. Thread-safe; used by unit tests and simcloud."""

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._mtimes: dict[str, float] = {}
        self._lock = OrderedLock("blobstore.memory")

    def put(self, name: str, data: bytes) -> None:
        with self._lock:
            self._blobs[name] = bytes(data)
            self._mtimes[name] = time.time()

    def put_if_absent(self, name: str, data: bytes) -> bool:
        with self._lock:
            if name in self._blobs:
                return False
            self._blobs[name] = bytes(data)
            self._mtimes[name] = time.time()
            return True

    def get_range(self, req: RangeRequest) -> bytes:
        with self._lock:
            data = self._blobs[req.blob]
        if req.length < 0:
            return data[req.offset:]
        end = req.offset + req.length
        if end > len(data):
            raise ValueError(
                f"range [{req.offset}, {end}) out of bounds for blob "
                f"{req.blob!r} of size {len(data)}")
        return data[req.offset:end]

    def size(self, name: str) -> int:
        with self._lock:
            return len(self._blobs[name])

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._blobs if n.startswith(prefix))

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._blobs

    def mtime(self, name: str) -> float:
        with self._lock:
            return self._mtimes[name]

    def delete(self, name: str) -> None:
        with self._lock:
            self._blobs.pop(name, None)
            self._mtimes.pop(name, None)


class LocalBlobStore(BlobStore):
    """Directory-backed store; blob names map to file paths.

    Writes are atomic (tmp + rename) so a crashed writer never leaves a
    half-written checkpoint or index block visible — the property the
    checkpoint manager's fault-tolerance relies on.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        path = os.path.abspath(os.path.join(self.root, name))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise ValueError(f"blob name {name!r} escapes store root")
        return path

    def put(self, name: str, data: bytes) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def put_if_absent(self, name: str, data: bytes) -> bool:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)      # atomic create-exclusive on POSIX
        except FileExistsError:
            return False
        finally:
            os.remove(tmp)
        return True

    def get_range(self, req: RangeRequest) -> bytes:
        with open(self._path(req.blob), "rb") as f:
            f.seek(req.offset)
            return f.read() if req.length < 0 else f.read(req.length)

    def size(self, name: str) -> int:
        return os.path.getsize(self._path(name))

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if fn.endswith(".tmp") or ".tmp." in fn:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def mtime(self, name: str) -> float:
        return os.path.getmtime(self._path(name))

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass


def from_items(items) -> InMemoryBlobStore:
    """An `InMemoryBlobStore` holding `(name, bytes)` pairs — e.g. every
    blob of another store, so an index built by one process (or by the
    JAX package) can be opened by this one."""
    store = InMemoryBlobStore()
    for name, data in items:
        store.put(name, data)
    return store
