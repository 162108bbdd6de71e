"""Split-accumulation tile-centric GEMM: the CUDA kernel
``csrc/split_gemm.cu`` (replacing the Pallas kernel
``repro/kernels/split_gemm.py::split_gemm_tile_multi``) and its plain
PyTorch version::

    C ← α·A·B + β·C

over per-format buffers (``MPMatrix.bufs``) and int tile class maps, as
the tile kernel, plus split compound C classes: such a tile's update is,
per k tile, the ``slices²`` slice-pair dots of the split A and B tiles
summed in ``slice_pair_order``, and its store is the split round trip.

Spec rows are ``split_format_specs(fset)``: ``(compute_dtype,
dot_precision, buffer_dtype, slices, slice_dtype, qmax_or_None)``.

At t = 64 and 128 the wrapper first runs the kernel's slice pass (one
launch per split spec present, counted in ``prep_launches``): every A
and B element, read from the buffer its tile's class names, is split
into its slices, each stored in the class's compute dtype (exact there)
in workspaces allocated here; the GEMM then runs the slice-pair passes
on the tensor cores.  :func:`slice_operands` runs the pass alone and
:func:`slice_operand_plain` is its plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import cast_storage, split_slices
from repro_torch.core.layout import expand_map, fp32_matmul
from repro_torch.kernels import _build
from repro_torch.kernels import mp_gemm_tile as _tile
from repro_torch.split.recovery import (class_dense, slice_pair_order,
                                        split_store)

#: launches of the CUDA GEMM by :func:`split_gemm_tile_multi`
launches = 0

#: launches of the slice pass (t = 64 and 128, one per split spec present)
prep_launches = 0

#: tile edges the kernel is compiled for
TILE_SIZES = _tile.TILE_SIZES

#: slice dtypes and counts the kernel implements
SLICE_DTYPES = (torch.float16, torch.float8_e5m2)
MAX_SLICES = 3

_MAX_NF = 3
_MAX_PAIRS = MAX_SLICES * MAX_SLICES


def slice_store_dtype(spec: tuple) -> torch.dtype:
    """The dtype the slice pass stores a split class's slices in: the
    class's compute dtype, which must hold every slice exactly (fp16 for
    fp16 slices; fp16 or bf16 for e5m2 slices, subnormals and inf
    included)."""
    compute, sdt = spec[0], spec[4]
    if compute == torch.float16 or (compute == torch.bfloat16
                                    and sdt == torch.float8_e5m2):
        return compute
    raise TypeError(f"{sdt} slices are not exact in compute dtype {compute}")


def slice_operand_plain(bufs, cls_map, tile: int, slices: int,
                        slice_dtype: torch.dtype,
                        store_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the slice pass for one operand: every element
    upcast from the buffer its tile's class names, split into ``slices``
    ``slice_dtype`` slices (``split_slices``), each stored in
    ``store_dtype``; returns ``[slices, rows, cols]``."""
    x = class_dense(bufs, cls_map, tile)
    return torch.stack([s.to(store_dtype)
                        for s in split_slices(x, slices, slice_dtype)])


def split_dot_ktiled(a32: torch.Tensor, b32: torch.Tensor, slices: int,
                     slice_dtype: torch.dtype, tile: int) -> torch.Tensor:
    """``A·B`` of a split class in the kernel's order: per k tile, the
    slice-pair dots added in ``slice_pair_order``, then added to the
    running fp32 sum."""
    sa = split_slices(a32, slices, slice_dtype)
    sb = split_slices(b32, slices, slice_dtype)
    pairs = slice_pair_order(slices)
    acc = None
    for k0 in range(0, a32.shape[1], tile):
        upd = None
        for i, j in pairs:
            p = fp32_matmul(sa[i][:, k0:k0 + tile].float(),
                            sb[j][k0:k0 + tile].float())
            upd = p if upd is None else upd + p
        acc = upd if acc is None else acc + upd
    return acc


def split_gemm_plain(a_bufs, b_bufs, c_bufs, pa, pb, pc, *, tile: int,
                     specs: tuple, alpha: float = 1.0,
                     beta: float = 0.0) -> tuple:
    """Plain version: per C class present, the class's dot over the whole
    matrix (the tile kernel's for simple classes, the k-tiled slice-pair
    expansion for split classes), then per-tile select and store."""
    del pa, pb   # the valid tile is the only non-zero among the buffers
    a32, b32, c32 = (_tile._upcast_sum(b) for b in (a_bufs, b_bufs, c_bufs))
    pc = np.asarray(pc)
    sel = torch.from_numpy(expand_map(pc, tile).astype(np.int64)).to(
        a32.device)
    vals = {}
    for code in sorted({int(v) for v in np.unique(pc)}):
        spec = specs[code]
        if spec[3] == 1:
            acc = fp32_matmul(_tile._round(a32, spec[0]),
                              _tile._round(b32, spec[0]))
        else:
            acc = split_dot_ktiled(a32, b32, spec[3], spec[4], tile)
        vals[code] = split_store(alpha * acc + beta * c32, spec, tile)
    outs = []
    for code, spec in enumerate(specs):
        v = vals.get(code)
        out = (torch.zeros_like(c32) if v is None
               else torch.where(sel == code, v, torch.zeros_like(v)))
        outs.append(cast_storage(out, spec[2]))
    return tuple(outs)


def order_allowance(a_bufs, b_bufs, c_bufs, pc, out: torch.Tensor, *,
                    tile: int, specs: tuple, alpha: float = 1.0,
                    beta: float = 0.0) -> torch.Tensor:
    """Largest per-element difference two correct results may show
    (``out`` dense fp32).  Simple classes: the tile kernel's allowance.
    Split classes: two orders of the ``K·slices²`` slice products differ
    by at most ``2·K·s²·2^-24·(|α|·Σ|slices of A|·Σ|slices of B| +
    |β|·|C|)``, and each side's split round trip adds at most its
    recovered roundoff times ``|out|`` plus half the slice dtype's
    smallest subnormal."""
    allow = _tile.order_allowance(
        a_bufs, b_bufs, c_bufs, pc, out, tile=tile,
        specs=tuple((s[0], s[2], s[5]) for s in specs), alpha=alpha,
        beta=beta)
    pc = np.asarray(pc)
    sel = torch.from_numpy(expand_map(pc, tile).astype(np.int64)).to(
        out.device)
    a32, b32, c32 = (_tile._upcast_sum(b) for b in (a_bufs, b_bufs, c_bufs))
    for code in np.unique(pc):
        spec = specs[int(code)]
        s, sdt = spec[3], spec[4]
        if s == 1:
            continue
        abs_a = sum(x.float().abs() for x in split_slices(a32, s, sdt))
        abs_b = sum(x.float().abs() for x in split_slices(b32, s, sdt))
        mag = abs(alpha) * fp32_matmul(abs_a, abs_b) + abs(beta) * c32.abs()
        rec = float(torch.finfo(sdt).eps / 2) ** s
        floor = float(torch.finfo(sdt).smallest_normal
                      * torch.finfo(sdt).eps / 2)
        val = (2.0 * a32.shape[1] * s * s * 2.0 ** -24 * mag * (1 + rec)
               + 2.0 * (rec * out.abs() + floor))
        allow = torch.where(sel == int(code), val, allow)
    return allow


within = _tile.within


class _Args(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p * _MAX_NF),
                ("b", ctypes.c_void_p * _MAX_NF),
                ("c", ctypes.c_void_p * _MAX_NF),
                ("o", ctypes.c_void_p * _MAX_NF),
                ("sa", ctypes.c_void_p * _MAX_NF),
                ("sb", ctypes.c_void_p * _MAX_NF),
                ("pa", ctypes.c_void_p), ("pb", ctypes.c_void_p),
                ("pc", ctypes.c_void_p),
                ("adt", ctypes.c_int * _MAX_NF),
                ("bdt", ctypes.c_int * _MAX_NF),
                ("cdt", ctypes.c_int * _MAX_NF),
                ("odt", ctypes.c_int * _MAX_NF),
                ("comp", ctypes.c_int * _MAX_NF),
                ("qmax", ctypes.c_int * _MAX_NF),
                ("slices", ctypes.c_int * _MAX_NF),
                ("sdt", ctypes.c_int * _MAX_NF),
                ("pairs", (ctypes.c_int * _MAX_PAIRS) * _MAX_NF),
                ("nf", ctypes.c_int), ("M", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("alpha", ctypes.c_float), ("beta", ctypes.c_float)]


def _prepare(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs, alpha, beta):
    """Checks of a CUDA launch, then (argument block, output buffers,
    device class maps); the maps must live until the launches that read
    them are queued."""
    m, k, n = _tile._check(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs)
    dev0 = a_bufs[0].device
    if not a_bufs[0].is_cuda:
        raise ValueError(f"unsupported device {dev0}")
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not in the kernel's {TILE_SIZES}")
    for b in (*a_bufs, *b_bufs, *c_bufs):
        if b.device != dev0:
            raise ValueError("all buffers must share one device")
        if b.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"buffer dtype {b.dtype} unsupported")
        if not b.is_contiguous():
            raise ValueError("buffers must be contiguous")
    staged = tile in _tile.STAGED_TILES
    for spec in specs:
        compute, _, buf_dtype, slices, sdt, _ = spec
        if compute not in (torch.float32, torch.bfloat16, torch.float16) \
                or buf_dtype not in _build.DTYPE_CODES:
            raise TypeError(f"spec ({compute}, {buf_dtype}) unsupported")
        if not 1 <= slices <= MAX_SLICES or (
                slices > 1 and sdt not in SLICE_DTYPES):
            raise TypeError(f"split spec ({slices} x {sdt}) unsupported")
        if staged and slices > 1:
            slice_store_dtype(spec)
    _tile.check_aligned((*a_bufs, *b_bufs, *c_bufs), tile)
    maps = [_build.upload_int32(p, dev0) for p in (pa, pb, pc)]
    outs = tuple(torch.empty((m, n), dtype=s[2], device=dev0) for s in specs)
    a = _Args()
    codes = _build.DTYPE_CODES
    for f, (compute, _, buf_dtype, slices, sdt, qmax) in enumerate(specs):
        a.a[f], a.b[f], a.c[f] = (a_bufs[f].data_ptr(), b_bufs[f].data_ptr(),
                                  c_bufs[f].data_ptr())
        a.o[f] = outs[f].data_ptr()
        a.adt[f], a.bdt[f] = codes[a_bufs[f].dtype], codes[b_bufs[f].dtype]
        a.cdt[f], a.odt[f] = codes[c_bufs[f].dtype], codes[buf_dtype]
        a.comp[f], a.qmax[f] = codes[compute], int(qmax or 0)
        a.slices[f], a.sdt[f] = slices, codes[sdt]
        for p, (i, j) in enumerate(slice_pair_order(slices)):
            a.pairs[f][p] = 4 * i + j
    a.pa, a.pb, a.pc = (t.data_ptr() for t in maps)
    a.nf, a.M, a.K, a.N = len(specs), m, k, n
    a.alpha, a.beta = float(alpha), float(beta)
    return a, outs, maps


def _slice_pass(a: _Args, f: int, spec: tuple, tile: int, dev0,
                lib) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the slice pass of split class ``f`` into new workspaces
    (A's slices ``[s, M, K]``, B's ``[s, K, N]``) and point the argument
    block at them; they live until the GEMM (same stream) has read
    them."""
    global prep_launches
    st = slice_store_dtype(spec)
    sa = torch.empty((spec[3], a.M, a.K), dtype=st, device=dev0)
    sb = torch.empty((spec[3], a.K, a.N), dtype=st, device=dev0)
    a.sa[f], a.sb[f] = sa.data_ptr(), sb.data_ptr()
    dev, stream = _build.cuda_args(sa)
    err = lib.split_prep_launch(ctypes.byref(a), f, tile, dev, stream)
    _build.check_launch("split_gemm slice pass", err)
    with _build.COUNT_LOCK:
        prep_launches += 1
    return sa, sb


def slice_operands(a_bufs, b_bufs, c_bufs, pa, pb, pc, *, tile: int,
                   specs: tuple, code: int) -> tuple:
    """The slice pass alone for split class ``code`` (CUDA tensors, t =
    64 or 128): the slices of A ``[s, M, K]`` and of B ``[s, K, N]`` as
    the GEMM reads them.  Its plain version is
    :func:`slice_operand_plain`, per operand."""
    if tile not in _tile.STAGED_TILES or specs[code][3] < 2:
        raise ValueError(f"no slice pass for class {code} at t={tile}")
    a, _, maps = _prepare(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs,
                          1.0, 0.0)
    return _slice_pass(a, code, specs[code], tile, a_bufs[0].device, _lib())


def split_gemm_tile_multi(a_bufs, b_bufs, c_bufs, pa, pb, pc, *, tile: int,
                          specs: tuple, alpha: float = 1.0,
                          beta: float = 0.0) -> tuple:
    """C ← α·A·B + β·C with per-tile precision and split accumulation for
    split C classes; returns one output buffer per class code.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    global launches
    if a_bufs[0].device.type == "cpu":
        _tile._check(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs)
        return split_gemm_plain(a_bufs, b_bufs, c_bufs, pa, pb, pc,
                                tile=tile, specs=specs, alpha=alpha,
                                beta=beta)
    a, outs, maps = _prepare(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile,
                             specs, alpha, beta)
    lib = _lib()
    # the slice pass, once per split spec among the C classes present
    work = {}
    if tile in _tile.STAGED_TILES:
        for f in (int(c) for c in np.unique(pc) if specs[int(c)][3] > 1):
            key = specs[f][3:5] + (specs[f][0],)
            if key not in work:
                work[key] = _slice_pass(a, f, specs[f], tile,
                                        a_bufs[0].device, lib)
            a.sa[f], a.sb[f] = (t.data_ptr() for t in work[key])
    dev, stream = _build.cuda_args(a_bufs[0])
    err = lib.split_gemm_launch(ctypes.byref(a), tile, dev, stream)
    _build.check_launch("split_gemm", err)
    with _build.COUNT_LOCK:
        launches += 1
    return outs


def _lib() -> ctypes.CDLL:
    lib = _build.load("split_gemm", [ctypes.POINTER(_Args), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p])
    lib.split_prep_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.split_prep_launch.restype = ctypes.c_int
    return lib
