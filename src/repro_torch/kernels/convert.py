"""Elementwise precision conversion: the CUDA kernel ``csrc/convert.cu``
(replacing the Pallas kernel ``repro/kernels/convert.py::convert``) and
its plain PyTorch versions, in two forms.

* :func:`convert` — ``x`` (fp32) → ``out_dtype`` with the reference's
  rounding: nearest-even into bf16, fp16, fp8 e4m3 or e5m2, fp16 and e5m2
  overflowing to ±inf and e4m3 giving NaN above 464
  (:func:`repro_torch.core.formats.cast_storage`).
* :func:`convert_by_class` — the layouts' storage cast (``MPMatrix``'s
  per-class buffers) in one launch: element (r, c) of the padded matrix
  goes to the buffer of class ``cls_map[r // tile, c // tile]`` through
  that class's ``to_buffer`` and every other buffer gets zero.  It takes
  format sets whose classes are plain float casts or split round trips
  (:func:`class_map_form`); a per-tile-scaled integer class needs its
  tile's absmax, so such sets keep the per-class path.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import (FormatSet, PrecisionFormat,
                                      SplitFormat, cast_storage)
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`convert`
launches = 0

#: launches of the class-map form by :func:`convert_by_class`
class_launches = 0

#: output dtypes the kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
              torch.float8_e4m3fn, torch.float8_e5m2)

#: slice dtypes of the split round trips the class-map form takes
SLICE_DTYPES = (torch.float16, torch.float8_e5m2)

_MAX_NF = 4


def convert_plain(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: the reference's cast."""
    return cast_storage(x, out_dtype)


def convert(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted to ``out_dtype``, same shape.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    global launches
    if x.device.type == "cpu":
        return convert_plain(x, out_dtype)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"convert kernel reads fp32, not {x.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"convert kernel writes {OUT_DTYPES}, not "
                        f"{out_dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("convert needs a contiguous, 16-byte aligned input")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if not x.numel():
        return out
    dev, stream = _build.cuda_args(x)
    err = _lib().convert_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                _build.DTYPE_CODES[out_dtype], dev, stream)
    _build.check_launch("convert", err)
    with _build.COUNT_LOCK:
        launches += 1
    return out


#: the class-map kernel's tiles are whole 8-element vectors
CLASS_TILE_MULTIPLE = 8


def class_map_form(fset: FormatSet) -> bool:
    """Whether ``fset``'s storage cast can take :func:`convert_by_class`:
    every class a plain float cast into a dtype the kernel writes, or the
    split round trip of 2-3 fp16 or e5m2 slices.  False for a set with a
    per-tile-scaled integer class (its cast needs the tile's absmax)."""
    for f in fset.formats():
        if isinstance(f, SplitFormat):
            if f.slices not in (2, 3) or f.slice_dtype not in SLICE_DTYPES:
                return False
        elif type(f) is not PrecisionFormat \
                or f.storage_dtype not in OUT_DTYPES:
            return False
    return len(fset) <= _MAX_NF


def _grid(x: torch.Tensor, cls_map: np.ndarray, tile: int,
          multiple: int = 1) -> tuple[int, int]:
    """The map's tile grid (mt, nt); it must cover ``x`` with tiles of a
    multiple of ``multiple`` elements."""
    mt, nt = cls_map.shape
    if tile < 1 or tile % multiple or mt * tile < x.shape[0] \
            or nt * tile < x.shape[1]:
        raise ValueError(f"tile {tile} (a multiple of {multiple}) x map "
                         f"{cls_map.shape} must cover x {tuple(x.shape)}")
    return mt, nt


def class_masked(x: torch.Tensor, cls_map, tile: int, fset: FormatSet):
    """Per class code of ``fset``, (its format, ``x`` zero-padded to the
    tile grid with every other class's tiles zeroed): the map is expanded
    on ``x``'s device (uploaded pinned to a card)."""
    cls_map = np.asarray(cls_map)
    mt, nt = _grid(x, cls_map, tile)
    xp = x.float()
    pm, pn = mt * tile - xp.shape[0], nt * tile - xp.shape[1]
    if pm or pn:
        xp = torch.nn.functional.pad(xp, (0, pn, 0, pm))
    sel = (_build.upload_int32(cls_map, x.device) if x.is_cuda
           else torch.from_numpy(cls_map.astype(np.int32)))
    sel = sel.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    for code in fset.codes:
        yield fset.fmt(code), torch.where(sel == code, xp,
                                          torch.zeros_like(xp))


def convert_by_class_plain(x: torch.Tensor, cls_map, tile: int,
                           fset: FormatSet) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`convert_by_class` (any format set): per
    class code that class's ``to_buffer`` of :func:`class_masked`."""
    return tuple(f.to_buffer(m, tile=tile)
                 for f, m in class_masked(x, cls_map, tile, fset))


class _ClassArgs(ctypes.Structure):
    _fields_ = [("o", ctypes.c_void_p * _MAX_NF),
                ("odt", ctypes.c_int * _MAX_NF),
                ("slices", ctypes.c_int * _MAX_NF),
                ("sdt", ctypes.c_int * _MAX_NF),
                ("map", ctypes.c_void_p), ("nf", ctypes.c_int),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("mt", ctypes.c_int), ("nt", ctypes.c_int),
                ("tile", ctypes.c_int)]


def convert_by_class(x: torch.Tensor, cls_map, tile: int,
                     fset: FormatSet) -> tuple[torch.Tensor, ...]:
    """One buffer per class code of ``fset``, each ``[mt·tile, nt·tile]``
    in the class's buffer dtype: ``x`` [M, N] (fp32, unpadded) under the
    tile class map ``cls_map`` [mt, nt].  CPU tensors take the plain
    version; CUDA tensors launch the kernel once (or raise, also for a
    set :func:`class_map_form` refuses)."""
    global class_launches
    if x.device.type == "cpu":
        return convert_by_class_plain(x, cls_map, tile, fset)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"convert_by_class reads a 2-D fp32 matrix, not "
                        f"{x.dtype} {tuple(x.shape)}")
    if not class_map_form(fset):
        raise ValueError(f"format set {fset.names} has a class the class-"
                         "map form does not take (per-tile-scaled integer "
                         "classes keep the per-class path)")
    cls_map = np.asarray(cls_map)
    mt, nt = _grid(x, cls_map, tile, CLASS_TILE_MULTIPLE)
    m, n = x.shape
    x = x.contiguous()
    outs = tuple(torch.empty((mt * tile, nt * tile),
                             dtype=fset.fmt(code).buffer_dtype,
                             device=x.device) for code in fset.codes)
    if not x.numel():
        return tuple(o.zero_() for o in outs)
    dmap = _build.upload_int32(cls_map, x.device)
    a = _ClassArgs()
    for code, o in zip(fset.codes, outs):
        f = fset.fmt(code)
        a.o[code], a.odt[code] = o.data_ptr(), _build.DTYPE_CODES[o.dtype]
        split = isinstance(f, SplitFormat)
        a.slices[code] = f.slices if split else 1
        a.sdt[code] = _build.DTYPE_CODES[f.slice_dtype] if split else 0
    a.map, a.nf = dmap.data_ptr(), len(fset)
    a.M, a.N, a.mt, a.nt, a.tile = m, n, mt, nt, tile
    dev, stream = _build.cuda_args(x)
    err = _lib().convert_by_class_launch(x.data_ptr(), ctypes.byref(a), dev,
                                         stream)
    _build.check_launch("convert_by_class", err)
    with _build.COUNT_LOCK:
        class_launches += 1
    return outs


def _lib() -> ctypes.CDLL:
    lib = _build.load("convert", [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p])
    lib.convert_by_class_launch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_ClassArgs), ctypes.c_int,
        ctypes.c_void_p]
    lib.convert_by_class_launch.restype = ctypes.c_int
    return lib
