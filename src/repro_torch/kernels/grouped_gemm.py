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
                       c_cls: np.ndarray) -> tuple:
    """Plain version: per output class present, one fp32 dot of the
    operands rounded to its compute dtype; that class's tiles gathered
    in slot order, quantized per tile for integer classes, and stored."""
    t = a.tile
    fset = a.fset
    specs = _tile.format_specs(fset)
    ad, bd = a.padded_dense(), b.padded_dense()
    mt, nt = c_cls.shape
    outs = []
    for code, (compute, buf_dtype, qmax) in enumerate(specs):
        idx = np.argwhere(c_cls == code)
        if not len(idx):
            outs.append(torch.zeros((0, t, t), dtype=buf_dtype,
                                    device=ad.device))
            continue
        acc = fp32_matmul(_tile._round(ad, compute),
                          _tile._round(bd, compute))
        tiles = acc.reshape(mt, t, nt, t).permute(0, 2, 1, 3)[
            torch.from_numpy(idx[:, 0]).to(ad.device),
            torch.from_numpy(idx[:, 1]).to(ad.device)]
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
                ("nt", ctypes.c_int), ("n_work", ctypes.c_int)]


def work_list(c_cls: np.ndarray, ncodes: int) -> np.ndarray:
    """``[n_tiles, 4]`` int32 rows (i, j, class, output slot), class by
    class, row-major within a class (the slots of ``make_slots``)."""
    rows = []
    for code in range(ncodes):
        idx = np.argwhere(c_cls == code)
        rows.append(np.column_stack([idx, np.full(len(idx), code),
                                     np.arange(len(idx))]))
    return np.ascontiguousarray(np.concatenate(rows), np.int32)


def grouped_mp_gemm(a: CompactMPMatrix, b: CompactMPMatrix,
                    c_cls: np.ndarray) -> CompactMPMatrix:
    """C = A·B with compact class-sorted operands and a per-tile output
    class map ``c_cls`` int8[mt, nt]; returns a CompactMPMatrix.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    global launches
    c_cls = _check(a, b, c_cls)
    fset, t = a.fset, a.tile
    mt, nt = c_cls.shape
    kt = a.cls.shape[1]
    dev0 = a.tiles[0].device
    if dev0.type == "cpu":
        outs = grouped_gemm_plain(a, b, c_cls)
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
        work = work_list(c_cls, len(fset))
        counts = np.bincount(work[:, 2], minlength=len(fset))
        outs = tuple(torch.empty((int(cnt), t, t), dtype=s[1], device=dev0)
                     for cnt, s in zip(counts, specs))
        tabs = [_build.upload_int32(x, dev0)
                for x in (a.cls, a.slot, b.cls, b.slot, work)]
        args = _Args()
        codes = _build.DTYPE_CODES
        for f, (compute, buf_dtype, qmax) in enumerate(specs):
            args.a[f], args.b[f] = a.tiles[f].data_ptr(), b.tiles[f].data_ptr()
            args.o[f] = outs[f].data_ptr()
            args.adt[f] = codes[a.tiles[f].dtype]
            args.bdt[f] = codes[b.tiles[f].dtype]
            args.odt[f], args.comp[f] = codes[buf_dtype], codes[compute]
            args.qmax[f] = int(qmax or 0)
        (args.pa, args.a_slot, args.pb, args.b_slot,
         args.work) = (x.data_ptr() for x in tabs)
        args.nf, args.kt, args.nt = len(specs), kt, nt
        args.n_work = len(work)
        dev, stream = _build.cuda_args(a.tiles[0])
        lib = _build.load("grouped_gemm", [ctypes.POINTER(_Args),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p])
        err = lib.grouped_gemm_launch(ctypes.byref(args), t, plan["smem"],
                                      dev, stream)
        _build.check_launch("grouped_gemm", err)
        launches += 1
        for p in _tile.paths_taken(plan, c_cls):
            path_launches[p] += 1
    return CompactMPMatrix(tuple(outs), c_cls,
                           CompactMPMatrix.make_slots(c_cls), t,
                           (mt * t, nt * t), fset)
