"""Checkpointing: per-leaf npz + JSON manifest, atomic, async (twin of
``repro.checkpoint.ckpt``).

A checkpoint holds the reference's logical tree: its leaf keys, its
layer-stacked arrays (the port's per-layer tensors stacked along a
leading dim, :mod:`repro_torch.tree`), its dtype names and its content
hash.  So the port reads a checkpoint the reference wrote and the
reference reads one the port wrote.  bf16 and fp8 leaves are stored as
uint16/uint8 views (npz has no such dtypes), which are the bytes the
reference writes through ``ml_dtypes``.  Writes go to a temporary
directory that is renamed into place; :class:`AsyncCheckpointer` writes
in a background thread.  Re-sharding on restore (the reference's
``sharding_tree``) comes with data-parallel training across ranks
(``ROADMAP.md`` queue 1, item 6b).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core.formats import dtype_name

#: torch dtypes npz cannot hold -> the same-width unsigned view
_VIEW_AS = {torch.bfloat16: (torch.uint16, np.uint16),
            torch.float8_e4m3fn: (torch.uint8, np.uint8),
            torch.float8_e5m2: (torch.uint8, np.uint8)}
_BY_NAME = {dtype_name(dt): dt for dt in _VIEW_AS}


def _host_array(leaf: TR.Leaf) -> np.ndarray:
    """A leaf's logical array on the host (bf16/fp8 as unsigned views)."""
    parts = [p.detach().cpu() for p in leaf.parts]
    t = torch.stack(parts) if leaf.stacked else parts[0]
    view = _VIEW_AS.get(t.dtype)
    if view is not None:
        t = t.view(view[0])
    return t.numpy()


def save(path: str, tree, *, step: int, extra: dict | None = None) -> dict:
    """Blocking save.  Returns the manifest."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    h = hashlib.sha256()
    arrays = {}
    leaves = sorted(TR.walk(tree), key=lambda leaf: leaf.key)
    for i, leaf in enumerate(leaves):
        arr = _host_array(leaf)
        dt_name = dtype_name(leaf.parts[0].dtype)
        key = leaf.key
        name = f"a{i}"
        arrays[name] = arr
        h.update(arr.tobytes())
        manifest["leaves"][key] = {
            "file": name, "shape": list(arr.shape), "dtype": dt_name}
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    manifest["hash"] = h.hexdigest()
    manifest["time"] = time.time()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return manifest


def _tensor(arr: np.ndarray, dt_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    dt = _BY_NAME.get(dt_name)
    return t.view(dt) if dt is not None else t


def restore(path: str, like_tree, *, verify: bool = True):
    """Restore into the structure of ``like_tree`` (each tensor in the
    like tensor's dtype, on its device).  Returns (tree, manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "leaves.npz"))
    leaves = TR.walk(like_tree)
    by_key = {}
    new = {}
    for leaf in leaves:
        meta = manifest["leaves"][leaf.key]
        arr = data[meta["file"]]
        by_key[leaf.key] = arr
        want = ((len(leaf.parts),) if leaf.stacked else ()) + tuple(
            leaf.parts[0].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {leaf.key}: ckpt "
                             f"{arr.shape} vs model {want}")
        t = _tensor(arr, meta["dtype"])
        parts = list(t.unbind(0)) if leaf.stacked else [t]
        for like, got in zip(leaf.parts, parts):
            new[id(like)] = got.to(device=like.device,
                                   dtype=like.dtype).clone()
    if verify and manifest.get("hash") and len(manifest["leaves"]) == len(
            leaves):
        h = hashlib.sha256()
        for key in sorted(by_key):  # save()'s order
            h.update(by_key[key].tobytes())
        if h.hexdigest() != manifest["hash"]:
            raise IOError(f"checkpoint {path} hash mismatch (corrupt?)")
    return TR.replace_tensors(like_tree, new), manifest


class AsyncCheckpointer:
    """Non-blocking saver: one background writer, newest-wins queueing.
    ``submit`` copies the tree to the host before it returns, so the
    caller may go on updating it."""

    def __init__(self, base_dir: str, keep: int = 3):
        self.base_dir = base_dir
        self.keep = keep
        os.makedirs(base_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self.last_saved_step = -1

    def submit(self, tree, step: int, extra: dict | None = None):
        host_tree = TR.map_tensors(
            lambda t: t.detach().to("cpu", copy=True), tree)
        with self._lock:
            self._pending = (host_tree, step, extra)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                if self._pending is None:
                    return
                tree, step, extra = self._pending
                self._pending = None
            save(os.path.join(self.base_dir, f"step_{step:08d}"), tree,
                 step=step, extra=extra)
            self.last_saved_step = step
            self._gc()

    def _gc(self):
        ckpts = sorted(d for d in os.listdir(self.base_dir)
                       if d.startswith("step_"))
        for d in ckpts[:-self.keep]:
            shutil.rmtree(os.path.join(self.base_dir, d))

    def wait(self, timeout: float = 60.0):
        t = self._thread
        if t is not None:
            t.join(timeout)

    def latest(self) -> Optional[str]:
        ckpts = sorted(d for d in os.listdir(self.base_dir)
                       if d.startswith("step_"))
        return os.path.join(self.base_dir, ckpts[-1]) if ckpts else None
