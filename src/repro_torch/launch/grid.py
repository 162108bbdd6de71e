"""P×Q process grid over ``torch.distributed`` (counterpart of
``repro.launch.mesh.make_grid_mesh``, the SUMMA grid).

:class:`Grid` lays the ranks of the default process group out row-major
on a P×Q grid, as ``jax.make_mesh((P, Q), ("row", "col"))`` lays out its
devices: rank ``r`` sits at ``(p, q) = divmod(r, Q)``.  Each rank holds
the subgroup of its grid row and of its grid column, so a broadcast runs
along one grid axis.  The device and the backend are named by the caller:

* ``nccl`` when every rank has a card of its own (NCCL refuses two ranks
  on one card);
* ``gloo`` on the CPU, and for several ranks sharing one card (gloo takes
  CUDA tensors and stages them through host memory).

Nothing picks a backend after a failure.

:func:`run_on_grid` spawns the P·Q ranks (``torch.multiprocessing``,
``spawn``), lets them meet at a ``file://`` rendezvous in a fresh
temporary directory (no TCP port, so concurrent runs cannot collide),
runs ``fn(grid, *args, **kwargs)`` on every rank and returns rank 0's
result (:func:`call_all` runs many calls in one spawn).  An
exception in a rank fails the call: the rank's own exception is raised,
chained to a :class:`GridRankError` that carries its traceback.  ``fn``
must be importable by name from ``repro_torch`` (a child imports only the
function's module, never a test module).  :func:`spawn` is the same
machinery for any handle a rank builds over the default group:
:func:`run_on_grid` builds a :class:`Grid`,
``repro_torch.launch.mesh.run_on_mesh`` a named mesh.

Tracing: a rank never opens the parent's trace file (the tracing
variables are kept from the children's environment while they spawn).
When the parent traces, rank 0 records into an in-memory tracer on the
parent's timeline and its events are written into the parent's trace
after the ranks join — rank 0's view, as the reference's single
controller traces one distributed GEMM once; the other ranks trace
nothing.
"""
from __future__ import annotations

import functools
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import obs

#: backends a grid can run over
BACKENDS = ("nccl", "gloo")


class GridRankError(RuntimeError):
    """A rank of :func:`run_on_grid` failed; the message holds its
    traceback."""


class Grid:
    """The P×Q grid over the default process group (which must hold P·Q
    ranks over ``backend``).  Creating it is collective: every rank
    creates every row and column subgroup, in the same order.

    ``bytes_sent`` counts the bytes of every slab this rank took part in
    broadcasting (sent or received), ``broadcasts`` the calls and
    ``broadcast_seconds`` their host seconds (over gloo a CUDA slab's
    call also waits for the stream's earlier work, which its copy to the
    host follows)."""

    def __init__(self, P: int, Q: int, *, device, backend: str):
        P, Q = int(P), int(Q)
        if P < 1 or Q < 1:
            raise ValueError(f"grid extents must be positive, got {P}x{Q}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; valid: "
                             f"{BACKENDS}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"Grid({P}x{Q}) needs an initialized process group of "
                f"{P * Q} ranks (run_on_grid spawns one)")
        world = dist.get_world_size()
        if world != P * Q:
            raise RuntimeError(
                f"Grid({P}x{Q}) needs {P * Q} ranks but the process group "
                f"has {world}")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}"
                             f", not the named backend {backend!r}")
        self.P, self.Q = P, Q
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        self.p, self.q = divmod(self.rank, Q)
        rows = [dist.new_group([r * Q + c for c in range(Q)])
                for r in range(P)]
        cols = [dist.new_group([r * Q + c for r in range(P)])
                for c in range(Q)]
        self.row_group, self.col_group = rows[self.p], cols[self.q]
        self._regrids: dict = {}
        self.bytes_sent = 0
        self.broadcasts = 0
        self.broadcast_seconds = 0.0

    @property
    def shape(self) -> tuple[int, int]:
        return self.P, self.Q

    def reset_counters(self) -> None:
        self.bytes_sent = 0
        self.broadcasts = 0
        self.broadcast_seconds = 0.0

    def broadcast(self, x: torch.Tensor, owner: int, axis: str
                  ) -> torch.Tensor:
        """``x`` from the rank at index ``owner`` along grid ``axis``
        (``"row"``: from grid column ``owner`` of this rank's grid row;
        ``"col"``: from grid row ``owner`` of this rank's grid column),
        in place.  The bytes travel as they are stored: a slab is sent as
        its raw bytes (gloo has no fp8 types), never upcast."""
        if axis == "row":
            group, src = self.row_group, self.p * self.Q + int(owner)
        elif axis == "col":
            group, src = self.col_group, int(owner) * self.Q + self.q
        else:
            raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")
        if not x.is_contiguous():
            raise ValueError("a broadcast slab must be contiguous")
        if x.numel() == 0:
            return x
        t0 = time.perf_counter()
        dist.broadcast(x.view(torch.uint8), src=src, group=group)
        self.broadcast_seconds += time.perf_counter() - t0
        self.bytes_sent += x.numel() * x.element_size()
        self.broadcasts += 1
        return x

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (same shape and dtype on all ranks), in rank
        order, as raw bytes."""
        if not x.is_contiguous():
            raise ValueError("an all-gathered tensor must be contiguous")
        raw = x.view(torch.uint8)
        outs = [torch.empty_like(raw) for _ in range(self.P * self.Q)]
        dist.all_gather(outs, raw)
        return [o.view(x.dtype).reshape(x.shape) for o in outs]


def regrid(grid: Grid, P: int, Q: int) -> Grid:
    """A P×Q grid over the same ranks as ``grid`` (creating it is
    collective; it is kept on ``grid`` for the next request)."""
    shape = (int(P), int(Q))
    if shape == grid.shape:
        return grid
    if shape not in grid._regrids:
        grid._regrids[shape] = Grid(*shape, device=grid.device,
                                    backend=grid.backend)
    return grid._regrids[shape]


def rank_report(grid: Grid) -> dict:
    """Where this rank sits: rank, grid position and shape, device,
    backend, torch threads, and the top-level packages it has imported."""
    return {"rank": grid.rank, "shape": grid.shape, "p": grid.p,
            "q": grid.q, "device": str(grid.device),
            "backend": grid.backend, "threads": torch.get_num_threads(),
            "packages": sorted({m.split(".")[0] for m in sys.modules})}


def call_all(grid, calls, capture: bool = False) -> list:
    """Run every call of ``calls`` on ``grid`` in order and return the
    results, so many grid calls share one spawn.  A call is ``(fn, args,
    kwargs)``, run as ``fn(*args, grid=grid, **kwargs)``, or ``(fn, args,
    kwargs, (P, Q))``, run on ``regrid(grid, P, Q)``.  ``grid`` may also
    be a named mesh (``repro_torch.launch.mesh.Mesh``): a call then runs
    as ``fn(*args, mesh=mesh, **kwargs)``, and ``(fn, args, kwargs,
    (shape, axes))`` on ``mesh.reshaped(shape, axes)`` (a rank outside
    that mesh gets ``None``).  With ``capture``,
    a call's exception is returned in its result's place; only for errors
    every rank raises alike before any collective (argument checks), or
    the ranks fall out of step."""
    out = []
    for fn, args, kwargs, *shape in calls:
        try:
            if isinstance(grid, Grid):
                g = regrid(grid, *shape[0]) if shape else grid
                out.append(fn(*args, grid=g, **kwargs))
                continue
            m = grid.reshaped(*shape[0]) if shape else grid
            out.append(fn(*args, mesh=m, **kwargs) if m.coordinate
                       is not None else None)
        except Exception as e:   # noqa: BLE001 — returned to the caller
            if not capture:
                raise
            out.append(e)
    return out


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` gives every rank its own card
    (rank r on ``cuda:r``); ``"cuda:i"`` puts every rank on card i;
    ``"cpu"`` the CPU."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", rank)
    return d


def _check_placement(world: int, device: str, backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: {BACKENDS}")
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} but no CUDA card is "
                               "visible")
        need = world if d.index is None else d.index + 1
        if torch.cuda.device_count() < need:
            raise RuntimeError(
                f"device {device!r} for {world} ranks needs {need} cards, "
                f"{torch.cuda.device_count()} are visible")
        if backend == "nccl" and d.index is not None and world > 1:
            raise ValueError(
                f"nccl refuses {world} ranks on one card ({device}): name "
                "backend='gloo', or device='cuda' for a card per rank")
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA devices; the CPU takes gloo")


def placement(P: int, Q: int, device: str = "cuda",
              backend: str | None = None) -> tuple[str, str]:
    """``(rank device, backend)`` for a P×Q grid of spawned ranks on
    ``device``, decided before any work from what is visible: for
    ``"cuda"``, a card per rank over ``nccl`` when P·Q cards are visible,
    else every rank on ``cuda:0`` over ``gloo``; for ``"cuda:i"``, every
    rank on card i over ``gloo``; on the CPU, ``gloo``.  A ``backend``
    the caller names is kept (and checked when the ranks start)."""
    world = int(P) * int(Q)
    d = torch.device(device)
    if d.type != "cuda":
        return "cpu", backend or "gloo"
    if d.index is not None:   # every rank on the named card
        return str(d), backend or "gloo"
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world else "gloo")
    return ("cuda" if backend == "nccl" else "cuda:0"), backend


def _threads_per_rank(world: int) -> int:
    return max(1, (os.cpu_count() or 1) // world)


#: thread-count variables of the BLAS libraries a rank may load
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

#: variables that switch tracing on at import (``repro_torch.obs``)
_TRACE_VARS = (obs.TRACE_ENV, obs.OBS_ENV)


def _rank_main(rank: int, world: int, setup, fn, args, kwargs,
               device: str, backend: str, workdir: str,
               trace_t0: float | None = None) -> None:
    if rank == 0 and trace_t0 is not None:
        obs.configure(enabled=True, t0=trace_t0)
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(_threads_per_rank(world))
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(workdir, 'rdv')}",
            world_size=world, rank=rank)
        try:
            result = fn(setup(device=dev, backend=backend), *args,
                        **kwargs)
            if rank == 0:
                with open(os.path.join(workdir, "result.pt"), "wb") as fh:
                    torch.save(result, fh)
                if obs.is_enabled():
                    with open(os.path.join(workdir, "trace.pkl"),
                              "wb") as fh:
                        pickle.dump(obs.tracer().buffer, fh)
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:   # noqa: BLE001 — an unpicklable exception
            blob = None
        with open(os.path.join(workdir, f"error-{rank}.pkl"), "wb") as fh:
            pickle.dump((blob, tb), fh)
        raise


def run_on_grid(P: int, Q: int, fn, *args, device: str = "cuda",
                backend: str, **kwargs):
    """Spawn P·Q ranks on ``device`` (see :func:`rank_device`) over
    ``backend``, run ``fn(grid, *args, **kwargs)`` on each, return rank
    0's result.  A failed rank fails the call (see the module
    docstring).  The ranks split the host's cores: each runs
    ``cpu_count // (P·Q)`` threads (torch, and the BLAS variables it
    starts with unless the caller set them)."""
    return spawn(int(P) * int(Q), functools.partial(Grid, int(P), int(Q)),
                 fn, *args, device=device, backend=backend, **kwargs)


def spawn(world: int, setup, fn, *args, device: str = "cuda",
          backend: str, **kwargs):
    """Spawn ``world`` ranks on ``device`` over ``backend``; each builds
    its handle ``setup(device=rank device, backend=backend)`` over the
    default group (collectively) and runs ``fn(handle, *args,
    **kwargs)``; rank 0's result is returned.  ``setup`` and ``fn`` are
    pickled by name."""
    import torch.multiprocessing as tmp
    world = int(world)
    _check_placement(world, device, backend)
    workdir = tempfile.mkdtemp(prefix="repro-grid-")
    saved = {k: os.environ.get(k) for k in _THREAD_VARS + _TRACE_VARS}
    trace_t0 = obs.tracer().t0 if obs.is_enabled() else None
    try:
        for k in _THREAD_VARS:
            os.environ.setdefault(k, str(_threads_per_rank(world)))
        for k in _TRACE_VARS:    # a rank must not reopen the parent's file
            os.environ.pop(k, None)
        try:
            tmp.start_processes(
                _rank_main, args=(world, setup, fn, args, kwargs, device,
                                  backend, workdir, trace_t0),
                nprocs=world, join=True, start_method="spawn")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException):
            _raise_rank_error(workdir, world)
            raise
        trace = os.path.join(workdir, "trace.pkl")
        if trace_t0 is not None and os.path.exists(trace):
            with open(trace, "rb") as fh:
                obs.tracer().absorb(pickle.load(fh))
        with open(os.path.join(workdir, "result.pt"), "rb") as fh:
            return torch.load(fh, weights_only=False)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workdir, ignore_errors=True)


def _raise_rank_error(workdir: str, world: int) -> None:
    """Re-raise the first failed rank's own exception (when it pickled),
    chained to its traceback; return if no rank left a record."""
    for rank in range(world):
        path = os.path.join(workdir, f"error-{rank}.pkl")
        if not os.path.exists(path):
            continue
        with open(path, "rb") as fh:
            blob, tb = pickle.load(fh)
        cause = GridRankError(f"rank {rank} of {world} failed:\n{tb}")
        exc = pickle.loads(blob) if blob is not None else None
        if isinstance(exc, Exception):
            raise exc from cause
        raise cause
