"""Fault-tolerant checkpointing on the blob store
(`repro/training/checkpoint.py`), in the JAX package's layout.

Every leaf of the state tree is one blob of raw little-endian bytes at
`<prefix>/step-<step:010d>/<leaf path>.npy`, its dtype and shape in the
manifest; the manifest (`MANIFEST.json`) is written last, so a crash
mid-save never leaves a manifest that points at missing blobs. Leaf paths
are the JAX package's: the keys from the root, joined by "/", dicts in
sorted-key order, so a checkpoint written by either package restores in
the other. bfloat16 travels through a
uint16 view (as `models/convert.py` carries it) under the dtype name
"bfloat16". Restore reads every leaf in one batch of range reads (one
`fetch_batch` round through a `SimCloudStore`), checks each blob's
sha256 prefix, and puts each leaf on the device of the leaf it replaces.

Saves can run on a background thread. The snapshot to host memory
happens on the caller's thread before it starts (`Tensor.to("cpu",
copy=True)`, which waits for the card), so the next step's in-place
update cannot race the copy; one save is in flight at a time. A save
frees each leaf's snapshot once its blob is written, and a restore each
payload once its leaf is on its device, so host memory holds about one
copy of the state at a time. The blobs' sha256 digests are taken on a
few threads at once (hashlib leaves the interpreter lock for large
buffers): a 4-layer cut of qwen3-32b checkpoints 35 GB.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..models.common import tree_unflatten
from ..storage.blobstore import BlobStore, RangeRequest

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


@dataclass(frozen=True)
class CheckpointConfig:
    prefix: str = "ckpt"
    keep_last_k: int = 3
    validate_hashes: bool = True


def _paths(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(path, leaf) of a tree of nested dicts, in the JAX package's
    flattening order (`tree_leaves`')."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         prefix + (k,))]
    return [("/".join(str(k) for k in prefix), tree)]


def _host_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host snapshot as a contiguous array of its raw little-endian
    bytes' elements (bfloat16 as int16), and its dtype name."""
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).numpy()), "bfloat16"
    arr = np.ascontiguousarray(t.numpy())
    return arr, str(arr.dtype)


def _digests(buffers: list) -> list[str]:
    """The sha256 prefix of each buffer, several at a time."""
    def digest(b):
        return hashlib.sha256(b).hexdigest()[:16]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(digest, buffers))


def _from_bytes(data: bytes, dtype: str, shape: list[int],
                device) -> torch.Tensor:
    """A leaf on `device` from its blob. The blob is read in place and
    copied once, to the device (or into the tensor's own memory on the
    CPU)."""
    if dtype != "bfloat16" and dtype not in _DTYPES:
        raise ValueError(f"checkpoint leaf of unknown dtype {dtype!r}")
    arr = np.frombuffer(data, dtype=np.int16 if dtype == "bfloat16"
                        else dtype)
    with warnings.catch_warnings():     # read-only, and only read
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape(shape).to(device, copy=True)


class CheckpointManager:
    def __init__(self, store: BlobStore,
                 config: CheckpointConfig | None = None):
        self.store = store
        self.cfg = config or CheckpointConfig()
        self._save_thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def _step_prefix(self, step: int) -> str:
        return f"{self.cfg.prefix}/step-{step:010d}"

    def save(self, step: int, tree, blocking: bool = True,
             extra_metadata: dict | None = None) -> None:
        """Snapshot to host on this thread, then persist; with
        blocking=False the persist runs on a background thread."""
        leaves = [(name, torch.as_tensor(leaf).detach().to("cpu", copy=True))
                  for name, leaf in _paths(tree)]
        self.wait()          # one async save in flight at a time

        def _persist() -> None:
            prefix = self._step_prefix(step)
            manifest = {"step": step, "leaves": [],
                        "extra": extra_metadata or {}}
            digests = _digests([_host_array(t)[0] for _, t in leaves])
            for digest in digests:  # each snapshot is freed once its blob is
                name, t = leaves.pop(0)
                arr, dtype = _host_array(t)
                blob = f"{prefix}/{name}.npy"
                self.store.put(blob, arr.tobytes())
                manifest["leaves"].append({
                    "name": name, "blob": blob, "shape": list(t.shape),
                    "dtype": dtype, "sha": digest,
                })
                del t, arr
            # manifest last => crash-safe commit point
            self.store.put(f"{prefix}/MANIFEST.json",
                           json.dumps(manifest).encode())
            self._gc(step)

        if blocking:
            _persist()
        else:
            self._save_thread = threading.Thread(target=_persist, daemon=True)
            self._save_thread.start()

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def _gc(self, newest_step: int) -> None:
        steps = self.all_steps()
        keep = set(sorted(s for s in steps if s <= newest_step)
                   [-self.cfg.keep_last_k:])
        keep.update(s for s in steps if s > newest_step)
        for s in steps:
            if s not in keep:
                for name in self.store.list(self._step_prefix(s)):
                    self.store.delete(name)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = set()
        for name in self.store.list(self.cfg.prefix):
            if name.endswith("MANIFEST.json"):
                part = name.split("/")[-2]
                if part.startswith("step-"):
                    steps.add(int(part[5:]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, cloud=None):
        """Restore into the structure of `tree_like` (values ignored; each
        restored leaf goes to the device of the tensor it replaces, the
        CPU otherwise). `cloud`: an optional `SimCloudStore`, which makes
        the restore one parallel fetch batch. Returns (tree, manifest)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        prefix = self._step_prefix(step)
        manifest = json.loads(self.store.get(f"{prefix}/MANIFEST.json"))
        by_name = {e["name"]: e for e in manifest["leaves"]}
        paths = _paths(tree_like)
        missing = [n for n, _ in paths if n not in by_name]
        if missing:
            raise KeyError(f"checkpoint step {step} missing leaves "
                           f"{missing[:5]}")
        requests = [RangeRequest(by_name[n]["blob"]) for n, _ in paths]
        if cloud is not None:
            payloads, _stats = cloud.fetch_batch(requests)
        else:
            payloads = [self.store.get_range(r) for r in requests]
        if self.cfg.validate_hashes:
            for (n, _), digest in zip(paths, _digests(payloads)):
                entry = by_name[n]
                if digest != entry["sha"]:
                    raise IOError(f"checkpoint corruption in {entry['blob']}:"
                                  f" {digest} != {entry['sha']}")
        out = []
        for i, (n, like) in enumerate(paths):
            data, payloads[i] = payloads[i], None     # freed leaf by leaf
            entry = by_name[n]
            out.append(_from_bytes(data, entry["dtype"], entry["shape"],
                                   like.device if isinstance(
                                       like, torch.Tensor) else "cpu"))
        return tree_unflatten(tree_like, out), manifest
