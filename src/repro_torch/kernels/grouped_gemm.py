"""Grouped GEMM over the compact class-sorted layout: the CUDA kernel
``csrc/grouped_gemm.cu`` (replacing the Pallas kernel
``repro/kernels/grouped_gemm.py::grouped_mp_gemm``) and its plain PyTorch
version::

    C = A·B

A and B are :class:`~repro_torch.core.layout.CompactMPMatrix` operands
(``tiles[code]`` of shape ``[n_code, t, t]``); ``c_cls`` names each C
tile's class, which sets its compute dtype and storage.  C comes back
compact, one tile array per class with slots from ``make_slots``.  One
kernel launch covers every output class, over a host-built work list of
(i, j, class, slot).

The accumulate-into form (``acc=``, SUMMA's local update: the reference
passes the fp32 output spec to ``_grouped_class_call`` there) adds A·B
to fp32 running sums, one array per class, in place: no storage rounding
and no per-tile quantization, so a k loop split one panel per call gives
the bits of one call over every panel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import cast_storage
from repro_torch.core.layout import (CompactMPMatrix, _check_codes,
                                     fp32_matmul)
from repro_torch.kernels import _build
from repro_torch.kernels import mp_gemm_tile as _tile

#: launches of the CUDA kernel by :func:`grouped_mp_gemm`
launches = 0

#: per path (``mp_gemm_tile.PATHS``), launches by :func:`grouped_mp_gemm`
#: in which at least one C tile took it
path_launches = dict.fromkeys(_tile.PATHS, 0)

#: tile edges the kernel is compiled for
TILE_SIZES = _tile.TILE_SIZES

_MAX_NF = 3


def _check(a: CompactMPMatrix, b: CompactMPMatrix, c_cls) -> np.ndarray:
    if a.fset != b.fset:
        raise ValueError(f"operand format sets differ: {a.fset.names} vs "
                         f"{b.fset.names}")
    if a.tile != b.tile:
        raise ValueError(f"tile mismatch {a.tile} vs {b.tile}")
    if a.cls.shape[1] != b.cls.shape[0]:
        raise ValueError(
            f"inner tile-grid mismatch {a.cls.shape} · {b.cls.shape}")
    c_cls = _check_codes(np.asarray(c_cls, np.int8), a.fset)
    if c_cls.shape != (a.cls.shape[0], b.cls.shape[1]):
        raise ValueError(f"C map {c_cls.shape} != tile grid "
                         f"{(a.cls.shape[0], b.cls.shape[1])}")
    return c_cls


def grouped_gemm_plain(a: CompactMPMatrix, b: CompactMPMatrix,
                       c_cls: np.ndarray, acc: tuple | None = None) -> tuple:
    """Plain version: per output class present, its tiles in slot order,
    each summed k tile by k tile in k order (one fp32 t×t×t product of
    the operands rounded to the class's compute dtype per k tile, added
    to the tile's running fp32 sum), so a C tile's value depends on
    neither the grid's shape nor how a k loop is split over calls; then
    quantized per tile for integer classes and stored.  With ``acc`` the
    sums start from ``acc`` and are written back into it, fp32, neither
    rounded nor quantized (the accumulate-into form)."""
    t = a.tile
    specs = _tile.format_specs(a.fset)
    mt, nt = c_cls.shape
    kt = a.cls.shape[1]
    ad = a.padded_dense().reshape(mt, t, kt, t).permute(0, 2, 1, 3)
    bd = b.padded_dense().reshape(kt, t, nt, t).permute(0, 2, 1, 3)
    dev = ad.device
    outs = []
    for code, (compute, buf_dtype, qmax) in enumerate(specs):
        idx = np.argwhere(c_cls == code)
        if not len(idx):
            outs.append(acc[code] if acc is not None else torch.zeros(
                (0, t, t), dtype=buf_dtype, device=dev))
            continue
        ii = torch.from_numpy(idx[:, 0]).to(dev)
        jj = torch.from_numpy(idx[:, 1]).to(dev)
        ar, br = _tile._round(ad, compute), _tile._round(bd, compute)
        tiles = (acc[code] if acc is not None else
                 torch.zeros((len(idx), t, t), dtype=torch.float32,
                             device=dev))
        for kk in range(kt):
            tiles = tiles + fp32_matmul(ar[ii, kk], br[kk, jj])
        if acc is not None:
            outs.append(acc[code].copy_(tiles))
            continue
        if qmax:
            tiles = _tile.quantize_tiles(tiles.reshape(-1, t), t,
                                         qmax).reshape(-1, t, t)
        outs.append(cast_storage(tiles, buf_dtype))
    return tuple(outs)


class _Args(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p * _MAX_NF),
                ("b", ctypes.c_void_p * _MAX_NF),
                ("o", ctypes.c_void_p * _MAX_NF),
                ("pa", ctypes.c_void_p), ("a_slot", ctypes.c_void_p),
                ("pb", ctypes.c_void_p), ("b_slot", ctypes.c_void_p),
                ("work", ctypes.c_void_p),
                ("adt", ctypes.c_int * _MAX_NF),
                ("bdt", ctypes.c_int * _MAX_NF),
                ("odt", ctypes.c_int * _MAX_NF),
                ("comp", ctypes.c_int * _MAX_NF),
                ("qmax", ctypes.c_int * _MAX_NF),
                ("nf", ctypes.c_int), ("kt", ctypes.c_int),
                ("nt", ctypes.c_int), ("n_work", ctypes.c_int),
                ("accumulate", ctypes.c_int)]


def work_list(c_cls: np.ndarray, ncodes: int) -> np.ndarray:
    """``[n_tiles, 4]`` int32 rows (i, j, class, output slot), class by
    class, row-major within a class (the slots of ``make_slots``)."""
    rows = []
    for code in range(ncodes):
        idx = np.argwhere(c_cls == code)
        rows.append(np.column_stack([idx, np.full(len(idx), code),
                                     np.arange(len(idx))]))
    return np.ascontiguousarray(np.concatenate(rows), np.int32)


def device_tables(a_cls, a_slot, b_cls, b_slot, c_cls: np.ndarray,
                  ncodes: int, device: torch.device) -> tuple:
    """The kernel's int32 tables on ``device``: A's and B's class and slot
    maps and the work list of ``c_cls``, for a caller that launches one
    layout many times (SUMMA's k-panels) to keep across launches."""
    return tuple(_build.upload_int32(x, device) for x in
                 (a_cls, a_slot, b_cls, b_slot, work_list(c_cls, ncodes)))


def _check_tables(tables, a: CompactMPMatrix, b: CompactMPMatrix,
                  c_cls: np.ndarray, device: torch.device) -> tuple:
    tables = tuple(tables)
    shapes = (a.cls.shape, a.slot.shape, b.cls.shape, b.slot.shape,
              (c_cls.size, 4))
    if len(tables) != len(shapes) or any(
            x.dtype != torch.int32 or x.device != device
            or tuple(x.shape) != tuple(s) for x, s in zip(tables, shapes)):
        raise ValueError(
            "tables must be device_tables of these operands' maps: int32 "
            f"arrays of shapes {[tuple(s) for s in shapes]} on {device}")
    return tables


def _check_acc(acc, c_cls: np.ndarray, fset, t: int,
               device: torch.device) -> tuple:
    counts = np.bincount(c_cls.reshape(-1), minlength=len(fset))
    acc = tuple(acc)
    if len(acc) != len(fset):
        raise ValueError(f"acc holds {len(acc)} arrays, the format set "
                         f"{len(fset)} classes")
    for code, x in enumerate(acc):
        if (x.dtype != torch.float32 or tuple(x.shape)
                != (int(counts[code]), t, t) or x.device != device
                or not x.is_contiguous()):
            raise ValueError(
                f"acc[{code}] must be a contiguous float32 "
                f"[{int(counts[code])}, {t}, {t}] array on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return acc


def grouped_mp_gemm(a: CompactMPMatrix, b: CompactMPMatrix,
                    c_cls: np.ndarray, *, acc=None,
                    tables=None) -> CompactMPMatrix:
    """C = A·B with compact class-sorted operands and a per-tile output
    class map ``c_cls`` int8[mt, nt]; returns a CompactMPMatrix.  With
    ``acc`` (per class an fp32 ``[n_code, t, t]`` array in slot order)
    it adds A·B into ``acc`` in place and returns it as C (the
    accumulate-into form).  ``tables`` (:func:`device_tables` of these
    maps) spares the kernel's per-call table build and upload.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    global launches
    c_cls = _check(a, b, c_cls)
    fset, t = a.fset, a.tile
    mt, nt = c_cls.shape
    kt = a.cls.shape[1]
    dev0 = a.tiles[0].device
    if acc is not None:
        acc = _check_acc(acc, c_cls, fset, t, dev0)
    if dev0.type == "cpu":
        outs = grouped_gemm_plain(a, b, c_cls, acc)
    else:
        if not a.tiles[0].is_cuda:
            raise ValueError(f"unsupported device {dev0}")
        if t not in TILE_SIZES:
            raise ValueError(f"tile {t} not in the kernel's {TILE_SIZES}")
        specs = _tile.format_specs(fset)
        for x in (*a.tiles, *b.tiles):
            if x.device != dev0:
                raise ValueError("all tile arrays must share one device")
            if x.dtype not in _build.DTYPE_CODES:
                raise TypeError(f"tile dtype {x.dtype} unsupported")
            if not x.is_contiguous():
                raise ValueError("tile arrays must be contiguous")
        for compute, buf_dtype, _ in specs:
            if compute not in (torch.float32, torch.bfloat16,
                               torch.float16) \
                    or buf_dtype not in _build.DTYPE_CODES:
                raise TypeError(f"spec ({compute}, {buf_dtype}) unsupported")
        _tile.check_aligned((*a.tiles, *b.tiles), t)
        plan = _tile.launch_plan(t, specs)
        if tables is None:
            tabs = device_tables(a.cls, a.slot, b.cls, b.slot, c_cls,
                                 len(fset), dev0)
        else:
            tabs = _check_tables(tables, a, b, c_cls, dev0)
        counts = np.bincount(c_cls.reshape(-1), minlength=len(fset))
        outs = acc if acc is not None else tuple(
            torch.empty((int(cnt), t, t), dtype=s[1], device=dev0)
            for cnt, s in zip(counts, specs))
        args = _Args()
        codes = _build.DTYPE_CODES
        for f, (compute, buf_dtype, qmax) in enumerate(specs):
            args.a[f], args.b[f] = a.tiles[f].data_ptr(), b.tiles[f].data_ptr()
            args.o[f] = outs[f].data_ptr()
            args.adt[f] = codes[a.tiles[f].dtype]
            args.bdt[f] = codes[b.tiles[f].dtype]
            args.odt[f] = codes[outs[f].dtype]
            args.comp[f] = codes[compute]
            args.qmax[f] = 0 if acc is not None else int(qmax or 0)
        (args.pa, args.a_slot, args.pb, args.b_slot,
         args.work) = (x.data_ptr() for x in tabs)
        args.nf, args.kt, args.nt = len(specs), kt, nt
        args.n_work = c_cls.size
        args.accumulate = int(acc is not None)
        dev, stream = _build.cuda_args(a.tiles[0])
        lib = _build.load("grouped_gemm", [ctypes.POINTER(_Args),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p])
        err = lib.grouped_gemm_launch(ctypes.byref(args), t, plan["smem"],
                                      dev, stream)
        _build.check_launch("grouped_gemm", err)
        with _build.COUNT_LOCK:
            launches += 1
            for p in _tile.paths_taken(plan, c_cls):
                path_launches[p] += 1
    return CompactMPMatrix(tuple(outs), c_cls,
                           CompactMPMatrix.make_slots(c_cls), t,
                           (mt * t, nt * t), fset)
