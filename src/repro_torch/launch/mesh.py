"""Named meshes over the ranks of ``torch.distributed`` (twin of
``repro.launch.mesh``).

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model") — "pod" is
a second (hierarchical) data-parallel axis.

A :class:`Mesh` lays the first ``prod(shape)`` ranks of the default
process group out row-major on ``shape``, as ``jax.make_mesh`` lays out
its devices, and holds a ``torch.distributed.device_mesh.DeviceMesh``
with those axis names (``mesh.device_mesh``: DTensors live on it).  Like
the reference's mesh, ``mesh.shape`` is a dict of axis sizes and
``mesh.axis_names`` the names.  Creating a mesh is collective over the
whole default group (every rank creates every axis subgroup); a rank
outside the mesh gets ``coordinate = None``.

Collectives.  Sums (:func:`psum`, :func:`pmean`) are one
``dist.all_reduce`` of an fp32 copy along one axis subgroup, rounded
once to the input's dtype; gathers (:func:`all_gather`) are list
``dist.all_gather`` of raw bytes (gloo has no fp8 types).
:func:`gather_to_origin` moves a DTensor's shards to the mesh's first
rank alone (point-to-point sends of host bytes), which assembles the
logical array.  DTensor's own collectives (``full_tensor``,
``redistribute``) go through ``all_gather_into_tensor``, which crashed
(SIGSEGV) with gloo ranks sharing one H100 under torch 2.11, so the port
never calls them.  Every collective adds to the process's
:func:`comm_stats` (bytes, calls, host seconds by operation).

:func:`run_on_mesh` spawns the ranks (``launch.grid.spawn``: a
``file://`` rendezvous, one process per rank) and builds the mesh in
each.  :func:`make_production_mesh`, :func:`make_host_mesh` and
:func:`make_grid_mesh` raise :func:`_require_devices`'s descriptive error
when the process group has fewer ranks than the mesh needs.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Sequence

import torch
import torch.distributed as dist

#: the production meshes' shapes and axis names
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _require_devices(need: int, what: str, have: int | None = None
                     ) -> None:
    """Descriptive failure instead of an opaque reshape error when the
    process group (or the launcher's ``--devices``: ``have``) has fewer
    ranks than the requested mesh."""
    have = _world() if have is None else have
    if have < need:
        raise RuntimeError(
            f"{what} needs {need} ranks but only {have} are available; "
            f"spawn {need} ranks (repro_torch.launch.mesh.run_on_mesh, or "
            f"launch.grid.spawn) *before* building the mesh (or pass "
            f"--devices {need} to the launcher)")


def _default_device() -> torch.device:
    """This process's card when one was selected (a spawned rank on a
    card sets it before the process group starts), else the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A named mesh over the first ``prod(shape)`` ranks of the default
    group (see the module docstring).  ``device`` is this rank's device
    (default: its selected card, else the CPU)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 device=None):
        from torch.distributed.device_mesh import DeviceMesh
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must "
                             "pair one distinct name per dimension")
        if not dist.is_initialized():
            raise RuntimeError(f"a {shape} mesh needs an initialized "
                               "process group (run_on_mesh spawns one)")
        n = math.prod(shape)
        self.device = torch.device(device) if device is not None \
            else _default_device()
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.device_mesh = DeviceMesh(
            self.device.type, torch.arange(n).reshape(shape),
            mesh_dim_names=axes)
        coord = self.device_mesh.get_coordinate()
        self.coordinate = (dict(zip(axes, coord)) if coord is not None
                           else None)
        self.rank = dist.get_rank()
        self._reshaped: dict = {}

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self.coordinate[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def reshaped(self, shape, axes) -> "Mesh":
        """A mesh of ``shape``/``axes`` over the first ranks of the same
        group, kept for the next request (creating it is collective)."""
        key = (tuple(shape), tuple(axes))
        if key == (tuple(self.shape.values()), self.axis_names):
            return self
        if key not in self._reshaped:
            _require_devices(math.prod(key[0]), f"Mesh{key[0]}")
            self._reshaped[key] = Mesh(*key, device=self.device)
        return self._reshaped[key]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"coordinate={self.coordinate})")


def make_mesh(shape, axes, *, device=None, backend: str | None = None
              ) -> Mesh:
    """``Mesh(shape, axes)`` after :func:`_require_devices` (``backend``,
    when named, must be the process group's)."""
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the named backend {backend!r}")
    shape = tuple(int(s) for s in shape)
    _require_devices(math.prod(shape), f"make_mesh({shape})")
    return Mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape, axes = PRODUCTION[bool(multi_pod)]
    _require_devices(math.prod(shape), "make_production_mesh")
    return Mesh(shape, axes, device=device)


def production_shape(multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes, without any rank (the dry run's
    specs read only these)."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return dict(zip(axes, shape))


def make_host_mesh(data: int = 2, model: int = 2, *, device=None) -> Mesh:
    """Small ("data", "model") mesh (tests)."""
    _require_devices(data * model, f"make_host_mesh({data}x{model})")
    return Mesh((data, model), ("data", "model"), device=device)


def make_grid_mesh(rows: int = 2, cols: int = 2,
                   axes: tuple[str, str] = ("row", "col")):
    """P×Q grid for distributed SUMMA (``core.summa``): the port's
    ``launch.grid.Grid`` over the default group, whose axes are always
    ("row", "col")."""
    from repro_torch.launch.grid import Grid
    if tuple(axes) != ("row", "col"):
        raise ValueError(f"the SUMMA grid's axes are ('row', 'col'), not "
                         f"{tuple(axes)}")
    _require_devices(rows * cols, f"make_grid_mesh({rows}x{cols})")
    return Grid(rows, cols, device=_default_device(),
                backend=dist.get_backend())


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a :class:`Mesh`, a ``DeviceMesh``, a dict, or
    any object whose ``shape`` is such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                 # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes present in the mesh."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def mesh_report(mesh: Mesh) -> dict:
    """Where this rank sits: rank, coordinate, axis sizes, data axes,
    device and backend."""
    return {"rank": mesh.rank, "coordinate": mesh.coordinate,
            "shape": dict(mesh.shape), "data_axes": data_axes(mesh),
            "model": mesh.shape.get("model"), "device": str(mesh.device),
            "backend": dist.get_backend()}


def run_on_mesh(shape, axes, fn, *args, device: str = "cuda",
                backend: str, **kwargs):
    """Spawn ``prod(shape)`` ranks on ``device`` over ``backend``
    (``launch.grid.spawn``: ``"cuda:0"`` with ``gloo`` puts every rank on
    one card), build ``Mesh(shape, axes)`` in each and run ``fn(mesh,
    *args, **kwargs)``; rank 0's result is returned."""
    import functools

    from repro_torch.launch.grid import spawn
    shape = tuple(int(s) for s in shape)
    return spawn(math.prod(shape), functools.partial(
        make_mesh, shape, tuple(axes)), fn, *args, device=device,
        backend=backend, **kwargs)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class CommStats:
    """This process's mesh collectives by operation: calls, host seconds
    and bytes (a gather: the bytes this rank receives; an all-reduce: the
    bytes of the fp32 buffer it reduces)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.seconds: dict[str, float] = {}

    def add(self, op: str, nbytes: int, seconds: float) -> None:
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)
        self.calls[op] = self.calls.get(op, 0) + 1
        self.seconds[op] = self.seconds.get(op, 0.0) + seconds

    def snapshot(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "seconds": dict(self.seconds)}


_STATS = CommStats()


def comm_stats() -> CommStats:
    return _STATS


def _raw(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _gather_raw(raw: torch.Tensor, group, n: int, op: str
                ) -> list[torch.Tensor]:
    outs = [torch.empty_like(raw) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(outs, raw, group=group)
    _STATS.add(op, (n - 1) * raw.numel(), time.perf_counter() - t0)
    return outs


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str,
               op: str = "all_gather") -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis`` (same shape and dtype on all),
    in axis order; ``x`` itself where the axis has one rank."""
    n = mesh.shape[axis]
    if n == 1:
        return [x]
    outs = _gather_raw(_raw(x), mesh.group(axis), n, op)
    return [o.view(x.dtype).reshape(x.shape) for o in outs]


def psum(mesh: Mesh, x: torch.Tensor, axis: str,
         op: str = "psum") -> torch.Tensor:
    """The sum of ``x`` over ``axis``: one ``all_reduce`` of an fp32 copy,
    rounded once to ``x``'s dtype.  Every rank of the axis ends with the
    same bits (gloo reduces each chunk once and sends the result round);
    at two ranks the fp32 sum does not depend on the order."""
    if mesh.shape[axis] == 1:
        return x
    s = x.detach().to(torch.float32, copy=True)
    t0 = time.perf_counter()
    dist.all_reduce(s, group=mesh.group(axis))
    _STATS.add(op, s.numel() * s.element_size(), time.perf_counter() - t0)
    return s.to(x.dtype)


def pmean(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The fp32 mean of ``x`` over ``axis``."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    return psum(mesh, x.float(), axis, "pmean") / n


def barrier(mesh) -> None:
    """Every rank of the mesh (a :class:`Mesh` or a ``DeviceMesh``) has
    arrived: one barrier per axis, in order, so each rank then knows of
    every other."""
    dm = getattr(mesh, "device_mesh", mesh)
    for i in range(dm.ndim):
        if dm.shape[i] > 1:
            dist.barrier(group=dm.get_group(i))


# ---------------------------------------------------------------------------
# shards of a logical array
# ---------------------------------------------------------------------------

def placements(mesh, spec) -> list:
    """DTensor placements of a per-dimension spec on ``mesh``: ``Shard(i)``
    on each mesh axis named at tensor dim i, ``Replicate()`` elsewhere.
    A dim sharded over several axes names them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    where: dict[str, int] = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in group if a in names]
        if pos != sorted(pos):
            raise ValueError(f"spec {tuple(spec)}: dim {i} names its axes "
                             f"out of the mesh's order {tuple(names)}")
        for a in group:
            if a in names:
                where[a] = i
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def _box(shape, pls, sizes, coord) -> list[tuple[int, int]]:
    """[start, stop) per tensor dim of the shard at mesh ``coord``
    (``torch.chunk``'s split, as DTensor's ``Shard``; where the axes
    divide the dim, the box ``NamedSharding.devices_indices_map`` gives
    the device at ``coord``)."""
    box = [(0, int(s)) for s in shape]
    for m, pl in enumerate(pls):
        dim = getattr(pl, "dim", None)
        if dim is None:
            continue
        lo, hi = box[dim]
        n, k = hi - lo, sizes[m]
        c = -(-n // k)
        i = coord[m]
        box[dim] = (lo + min(i * c, n), lo + min((i + 1) * c, n))
    return box


def local_box(shape, spec, mesh: Mesh) -> tuple[slice, ...]:
    """This rank's piece of a logical array of ``shape`` under ``spec``,
    as index slices."""
    coord = [mesh.coordinate[a] for a in mesh.axis_names]
    box = _box(shape, placements(mesh, spec), list(mesh.shape.values()),
               coord)
    return tuple(slice(a, b) for a, b in box)


def local_slice(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of the logical array ``x`` under ``spec``
    (contiguous, on ``x``'s device)."""
    return x[local_box(x.shape, spec, mesh)].contiguous()


def from_local(local: torch.Tensor, shape, spec, mesh: Mesh):
    """This rank's piece ``local`` of a logical array of ``shape`` under
    ``spec`` as a DTensor on ``mesh`` (moved to the mesh's device); no
    communication."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local.to(mesh.device), mesh.device_mesh,
                              placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute(x: torch.Tensor, spec, mesh: Mesh):
    """``x`` (the logical array, held whole by every rank) as a DTensor
    on ``mesh`` whose local tensor is this rank's piece, on the mesh's
    device; no communication."""
    return from_local(local_slice(x, spec, mesh), x.shape, spec, mesh)


def is_origin(device_mesh) -> bool:
    """This rank sits at the mesh's first coordinate (the writer)."""
    coord = device_mesh.get_coordinate()
    return coord is not None and not any(coord)


def gather_to_origin(t) -> torch.Tensor | None:
    """The logical array of a DTensor ``t``, on the host of the rank at
    its mesh's origin, which alone assembles it; ``None`` on every other
    rank.  Each rank whose coordinate is 0 on every replicated axis sends
    its shard's bytes (``dist.send`` of a host copy); the origin receives
    them in mesh order and places each by its box."""
    dm = t.device_mesh
    pls = list(t.placements)
    sizes = list(dm.shape)
    coord = list(dm.get_coordinate())
    ranks = dm.mesh.reshape(-1).tolist()
    shape = tuple(t.shape)
    local = t.to_local()
    sharded = [getattr(pl, "dim", None) is not None for pl in pls]
    origin = ranks[0]
    if not is_origin(dm):
        if local.numel() and all(c == 0 for c, s in zip(coord, sharded)
                                 if not s):
            dist.send(_raw(local.cpu()), dst=origin)
        return None
    out = torch.empty(shape, dtype=local.dtype)
    t0, got = time.perf_counter(), 0
    for flat, c in enumerate(itertools.product(*(range(n) for n in sizes))):
        if any(v and not s for v, s in zip(c, sharded)):
            continue
        box = tuple(slice(a, b) for a, b in _box(shape, pls, sizes, c))
        if flat == 0:
            out[box] = local.cpu()
            continue
        piece = out[box]
        if not piece.numel():     # an empty shard sends nothing
            continue
        raw = torch.empty(piece.numel() * piece.element_size(),
                          dtype=torch.uint8)
        dist.recv(raw, src=ranks[flat])
        out[box] = raw.view(local.dtype).reshape(piece.shape)
        got += raw.numel()
    _STATS.add("gather", got, time.perf_counter() - t0)
    return out
