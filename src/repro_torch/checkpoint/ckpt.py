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
in a background thread.

Arrays are saved in logical (whole, unsharded) coordinates, so a
checkpoint written on one mesh restores onto any other: elastic re-mesh
is "restore onto the surviving mesh".  :func:`save` takes DTensor leaves
(``launch.mesh.distribute``): the ranks of their mesh send their shards
to the mesh's first rank (``launch.mesh.gather_to_origin``), which alone
assembles, hashes and writes the arrays, then hands the manifest to the
others; the file is byte for byte an unsharded save of the same tree.
``restore(..., sharding_tree=s)`` with one ``launch.sharding.
NamedSharding`` returns every tensor as a DTensor on ``s``'s mesh whose
local tensor is this rank's slice; each rank reads only that slice (the
npz's members are memory-mapped), and the mesh's first rank alone reads
everything to check the hash.  The port's tree holds a stacked leaf's
layers as separate tensors, so ``s``'s spec applies to each of them.  A dict ``sharding_tree`` raises ``ValueError``, as the
reference's ``jax.device_put`` does: its docstring promises a per-leaf
tree, but its code passes the whole dict as every leaf's sharding.
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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _host(t: torch.Tensor, writer: bool) -> torch.Tensor | None:
    """``t``'s logical array on the writer's host (a DTensor's shards are
    sent to it: ``launch.mesh.gather_to_origin``); ``None`` elsewhere."""
    if _is_dtensor(t):
        from repro_torch.launch.mesh import gather_to_origin
        return gather_to_origin(t)
    return t.cpu() if writer else None


def _host_array(leaf: TR.Leaf, writer: bool) -> np.ndarray | None:
    """A leaf's logical array on the writer's host (bf16/fp8 as unsigned
    views); ``None`` on the other ranks, which send their shards."""
    parts = [_host(p.detach(), writer) for p in leaf.parts]
    if not writer:
        return None
    t = torch.stack(parts) if leaf.stacked else parts[0]
    view = _VIEW_AS.get(t.dtype)
    if view is not None:
        t = t.view(view[0])
    return t.numpy()


def _meshes(tree) -> list:
    """The device meshes of ``tree``'s DTensor tensors (one at most)."""
    found = []
    for t in TR.tensors(tree):
        if _is_dtensor(t) and all(t.device_mesh is not m for m in found):
            found.append(t.device_mesh)
    if len(found) > 1:
        raise ValueError("save: the DTensor leaves live on more than one "
                         "mesh")
    return found


def _share(obj, device_mesh, src_is_me: bool):
    """``obj`` from the rank at ``device_mesh``'s origin to every rank of
    the mesh (point-to-point sends of its JSON bytes); returns it."""
    import torch.distributed as dist
    ranks = device_mesh.mesh.reshape(-1).tolist()
    if src_is_me:
        raw = torch.frombuffer(bytearray(json.dumps(obj).encode()),
                               dtype=torch.uint8)
        for r in ranks[1:]:
            dist.send(torch.tensor([raw.numel()]), dst=r)
            dist.send(raw, dst=r)
        return obj
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src=ranks[0])
    raw = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(raw, src=ranks[0])
    return json.loads(raw.numpy().tobytes())


def save(path: str, tree, *, step: int, extra: dict | None = None) -> dict:
    """Blocking save.  Returns the manifest.  With DTensor leaves it is
    collective over their mesh: the rank at the mesh's origin alone
    gathers the shards, assembles and hashes the arrays and writes; then
    it sends the manifest to the others, which wait for it."""
    meshes = _meshes(tree)
    from repro_torch.launch.mesh import is_origin
    writer = not meshes or is_origin(meshes[0])
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    h = hashlib.sha256()
    arrays = {}
    leaves = sorted(TR.walk(tree), key=lambda leaf: leaf.key)
    for i, leaf in enumerate(leaves):
        arr = _host_array(leaf, writer)
        if not writer:
            continue
        name = f"a{i}"
        arrays[name] = arr
        h.update(arr.tobytes())
        manifest["leaves"][leaf.key] = {
            "file": name, "shape": list(arr.shape),
            "dtype": dtype_name(leaf.parts[0].dtype)}
    if writer:
        manifest["hash"] = h.hexdigest()
        manifest["time"] = time.time()
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    if meshes:
        manifest = _share(manifest, meshes[0], writer)
    return manifest


class _Npz:
    """The arrays of an ``np.savez`` file, each opened as a read-only
    memory map of its bytes inside the (uncompressed) zip, so a reader
    that slices one reads only that slice.  A compressed, Fortran-ordered,
    0-d or empty member is read whole."""

    def __init__(self, path: str):
        import zipfile
        self.path = path
        self._at: dict = {}
        with zipfile.ZipFile(path) as z, open(path, "rb") as raw:
            for info in z.infolist():
                name = info.filename[:-len(".npy")]
                if info.compress_type != zipfile.ZIP_STORED:
                    self._at[name] = None
                    continue
                raw.seek(info.header_offset + 26)
                skip = int.from_bytes(raw.read(2), "little") + int.from_bytes(
                    raw.read(2), "little")
                with z.open(info) as f:
                    version = np.lib.format.read_magic(f)
                    shape, fortran, dtype = (
                        np.lib.format.read_array_header_1_0(f)
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0(f))
                    head = f.tell()
                offset = info.header_offset + 30 + skip + head
                whole = (fortran or not shape or 0 in shape
                         or dtype.hasobject)
                self._at[name] = None if whole else (offset, shape, dtype)

    def __getitem__(self, name: str) -> np.ndarray:
        at = self._at[name]
        if at is None:
            with np.load(self.path) as data:
                return data[name]
        offset, shape, dtype = at
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape)


def _hash(data: _Npz, manifest: dict, keys) -> str:
    """``save``'s hash of the arrays of ``keys`` (in sorted order), read
    in pieces of at most 64 MiB."""
    h = hashlib.sha256()
    for key in sorted(keys):
        arr = data[manifest["leaves"][key]["file"]]
        if not isinstance(arr, np.memmap):
            h.update(arr.tobytes())
            continue
        flat = arr.reshape(-1)
        step = max(1, (64 << 20) // max(1, arr.itemsize))
        for i in range(0, flat.size, step):
            h.update(np.ascontiguousarray(flat[i:i + step]))
    return h.hexdigest()


def _tensor(arr: np.ndarray, dt_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    dt = _BY_NAME.get(dt_name)
    return t.view(dt) if dt is not None else t


def restore(path: str, like_tree, *, sharding_tree=None,
            verify: bool = True):
    """Restore into the structure of ``like_tree`` (each tensor in the
    like tensor's dtype, on its device).  ``sharding_tree``, one
    ``launch.sharding.NamedSharding``, re-shards on load — the elastic
    re-mesh entry point: every tensor becomes a DTensor on its mesh, and
    each rank reads only its slice of each array; the rank at the mesh's
    origin checks the hash and tells the others (see the module
    docstring).  Returns (tree, manifest)."""
    if isinstance(sharding_tree, dict):
        raise ValueError(
            "restore: sharding_tree must be one sharding applied to every "
            "leaf; a dict is not a tree prefix of the leaves (the "
            "reference's device_put raises ValueError on it too)")
    mesh = None if sharding_tree is None else sharding_tree.mesh
    if mesh is not None and mesh.coordinate is None:
        raise ValueError("restore: this rank is not on the sharding's mesh")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = _Npz(os.path.join(path, "leaves.npz"))
    leaves = TR.walk(like_tree)
    new = {}
    for leaf in leaves:
        meta = manifest["leaves"][leaf.key]
        arr = data[meta["file"]]
        want = ((len(leaf.parts),) if leaf.stacked else ()) + tuple(
            leaf.parts[0].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {leaf.key}: ckpt "
                             f"{arr.shape} vs model {want}")
        for i, like in enumerate(leaf.parts):
            whole = arr[i] if leaf.stacked else arr
            if mesh is not None:
                from repro_torch.launch import mesh as MS
                spec = sharding_tree.spec
                piece = _tensor(whole[MS.local_box(whole.shape, spec, mesh)],
                                meta["dtype"])
                new[id(like)] = MS.from_local(piece.to(like.dtype),
                                              whole.shape, spec, mesh)
                continue
            new[id(like)] = _tensor(whole, meta["dtype"]).to(
                device=like.device, dtype=like.dtype)
    if verify and manifest.get("hash") and len(manifest["leaves"]) == len(
            leaves):
        keys = [leaf.key for leaf in leaves]
        if mesh is None:
            ok = _hash(data, manifest, keys) == manifest["hash"]
        else:
            from repro_torch.launch.mesh import is_origin
            me = is_origin(mesh.device_mesh)
            ok = _share(me and _hash(data, manifest, keys)
                        == manifest["hash"], mesh.device_mesh, me)
        if not ok:
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
