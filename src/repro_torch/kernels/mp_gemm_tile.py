"""Tile-centric mixed-precision GEMM (Algorithm 1): the CUDA kernel
``csrc/mp_gemm_tile.cu`` (replacing the Pallas kernel
``repro/kernels/mp_gemm_tile.py::mp_gemm_tile_multi``) and its plain
PyTorch version::

    C ← α·A·B + β·C

over per-format buffers (``MPMatrix.bufs``) and int tile class maps.
The class of each C tile picks the compute dtype of its update; sums are
fp32; the result lands in the buffer of C's class (zeros in the others),
integer classes after a per-tile symmetric absmax quantize-dequantize.

``FormatSpec`` rows are ``(compute_dtype, buffer_dtype, qmax_or_None)``,
one per class code (:func:`format_specs`).  :func:`launch_plan` says which
path of the kernel each C class takes and how much shared memory a block
needs; the grouped kernel shares it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import FormatSet, cast_storage
from repro_torch.core.layout import expand_map, fp32_matmul
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`mp_gemm_tile_multi`
launches = 0

#: tile edges the kernel is compiled for
TILE_SIZES = (16, 32, 64, 128)

#: tile edges that run the staged dot of ``csrc/tile_dot.cuh`` (wgmma
#: needs 64 rows); smaller tiles keep the simple fp32 dot
STAGED_TILES = (64, 128)

#: the kernel's paths: wgmma on the tensor cores, the staged fp32 FMA
#: register tile, the simple fp32 dot of t < 64
PATHS = ("tensor_core", "fp32", "simple")

#: per path, launches by :func:`mp_gemm_tile_multi` in which at least one
#: C tile took it
path_launches = dict.fromkeys(PATHS, 0)

_MAX_NF = 3


def format_specs(fset: FormatSet) -> tuple:
    """Per-class (compute dtype, buffer dtype, qmax or None) rows."""
    return tuple(
        (f.compute_dtype, f.buffer_dtype,
         int(f.qmax) if f.per_tile_scaled else None)
        for f in fset.formats())


def staged_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of a staged-dot block (``Big<T>::SMEM`` of
    ``csrc/tile_dot.cuh``, which the launch refuses to differ from): 1 KB
    of alignment slack, six compute slots of a bf16/fp16 A slice and B
    slice (64 deep; the fp32 path uses the same bytes as two fp32 slots)
    and 64 bytes of reduction scratch."""
    return 1024 + 6 * 2 * tile * 64 * 2 + 64


def launch_plan(tile: int, specs: tuple) -> dict:
    """How the kernel runs at ``tile`` over the class rows ``specs``:
    threads per block, dynamic shared memory (0 for the simple dot), and
    per class code the path a C tile of that class takes."""
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not in the kernel's {TILE_SIZES}")
    if tile not in STAGED_TILES:
        return {"threads": min(tile, 32) ** 2, "smem": 0,
                "paths": ("simple",) * len(specs)}
    return {"threads": 256 if tile == 128 else 128,
            "smem": staged_smem_bytes(tile),
            "paths": tuple("tensor_core" if compute in (torch.bfloat16,
                                                        torch.float16)
                           else "fp32" for compute, _, _ in specs)}


def paths_taken(plan: dict, c_map) -> set:
    """The paths the C tiles of class map ``c_map`` take under ``plan``."""
    return {plan["paths"][int(c)] for c in np.unique(c_map)}


def check_aligned(tensors, tile: int) -> None:
    """The staged dot copies 16-byte chunks: every buffer must start on a
    16-byte boundary."""
    if tile in STAGED_TILES and any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("buffers must start on a 16-byte boundary")


def quantize_tiles(x: torch.Tensor, tile: int, qmax: int) -> torch.Tensor:
    """Per-(tile × tile) symmetric absmax quantize-dequantize of ``x``
    (the epilogue of an integer C class; NaN propagates like the
    reference's ``max``)."""
    m, n = x.shape
    xt = x.reshape(m // tile, tile, n // tile, tile)
    am = xt.abs().amax(dim=(1, 3), keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not the kernels' correctly rounded division
    scale = torch.where(am > 0, am / torch.full_like(am, qmax),
                        torch.ones_like(am))
    q = torch.clamp(torch.round(xt / scale), -qmax, qmax) * scale
    return q.reshape(m, n)


def _upcast_sum(bufs) -> torch.Tensor:
    out = bufs[0].float()
    for b in bufs[1:]:
        out = out + b.float()
    return out


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def mp_gemm_tile_plain(a_bufs, b_bufs, c_bufs, pa, pb, pc, *, tile: int,
                       specs: tuple, alpha: float = 1.0,
                       beta: float = 0.0) -> tuple:
    """Plain version: per C class present, one fp32 dot of the operands
    rounded to that class's compute dtype; per-tile select, epilogue and
    store exactly as the kernel."""
    del pa, pb   # the valid tile is the only non-zero among the buffers
    a32, b32, c32 = (_upcast_sum(b) for b in (a_bufs, b_bufs, c_bufs))
    pc = np.asarray(pc)
    sel = torch.from_numpy(expand_map(pc, tile).astype(np.int64)).to(
        a32.device)
    outs = []
    vals = {}
    for code in sorted({int(v) for v in np.unique(pc)}):
        compute, _, qmax = specs[code]
        acc = fp32_matmul(_round(a32, compute), _round(b32, compute))
        v = alpha * acc + beta * c32
        vals[code] = quantize_tiles(v, tile, qmax) if qmax else v
    for code, (_, buf_dtype, _) in enumerate(specs):
        v = vals.get(code)
        out = (torch.zeros_like(c32) if v is None
               else torch.where(sel == code, v, torch.zeros_like(v)))
        outs.append(cast_storage(out, buf_dtype))
    return tuple(outs)


def order_allowance(a_bufs, b_bufs, c_bufs, pc, out: torch.Tensor, *,
                    tile: int, specs: tuple, alpha: float = 1.0,
                    beta: float = 0.0) -> torch.Tensor:
    """Largest per-element difference two correct results of this GEMM
    may show (``out`` is either one, dense fp32): the fp32 summation-order
    term ``2·K·2^-24·(|α|·|A|·|B| + |β|·|C|)``, plus one rounding of a
    float C tile's storage format, or one quantization step of an integer
    C tile (a tiny fp32 difference may flip one rounding)."""
    a, b, c = (_upcast_sum(x).abs() for x in (a_bufs, b_bufs, c_bufs))
    s = abs(alpha) * fp32_matmul(a, b) + abs(beta) * c
    allow = 2.0 * a.shape[1] * 2.0 ** -24 * s
    pc = np.asarray(pc)
    sel = torch.from_numpy(expand_map(pc, tile).astype(np.int64)).to(
        out.device)
    m, n = out.shape
    for code in np.unique(pc):
        compute, buf_dtype, qmax = specs[int(code)]
        if qmax:
            am = out.abs().reshape(m // tile, tile, n // tile, tile).amax(
                dim=(1, 3))
            extra = (am / qmax).repeat_interleave(tile, 0).repeat_interleave(
                tile, 1)
            val = allow + extra
        else:
            u = float(torch.finfo(buf_dtype).eps) / 2.0
            val = allow * (1 + u) + 2 * u * out.abs()
        allow = torch.where(sel == int(code), val, allow)
    return allow


def within(got: torch.Tensor, want: torch.Tensor, allow: torch.Tensor
           ) -> tuple[float, float]:
    """(max |got - want|, worst ratio to ``allow``); NaN in both (fp8
    overflow, as in the reference) counts as equal, NaN in one only as an
    infinite error."""
    both = torch.isnan(got) & torch.isnan(want)
    zero = torch.zeros_like(got)
    err = torch.where(both, zero, (got - want).abs())
    ratio = torch.where(both, zero, err / (allow + 1e-30))
    return (float(err.nan_to_num(float("inf")).max()),
            float(ratio.nan_to_num(float("inf")).max()))


class _Args(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p * _MAX_NF),
                ("b", ctypes.c_void_p * _MAX_NF),
                ("c", ctypes.c_void_p * _MAX_NF),
                ("o", ctypes.c_void_p * _MAX_NF),
                ("pa", ctypes.c_void_p), ("pb", ctypes.c_void_p),
                ("pc", ctypes.c_void_p),
                ("adt", ctypes.c_int * _MAX_NF),
                ("bdt", ctypes.c_int * _MAX_NF),
                ("cdt", ctypes.c_int * _MAX_NF),
                ("odt", ctypes.c_int * _MAX_NF),
                ("comp", ctypes.c_int * _MAX_NF),
                ("qmax", ctypes.c_int * _MAX_NF),
                ("nf", ctypes.c_int), ("M", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("alpha", ctypes.c_float), ("beta", ctypes.c_float)]


def _check(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs) -> tuple:
    nf = len(specs)
    if not (len(a_bufs) == len(b_bufs) == len(c_bufs) == nf) \
            or not 1 <= nf <= _MAX_NF:
        raise ValueError(f"need one A/B/C buffer per class (1..{_MAX_NF})")
    m, k = a_bufs[0].shape
    n = b_bufs[0].shape[1]
    for bufs, shape in ((a_bufs, (m, k)), (b_bufs, (k, n)),
                        (c_bufs, (m, n))):
        for b in bufs:
            if tuple(b.shape) != shape:
                raise ValueError(f"buffer {tuple(b.shape)} != {shape}")
    if m % tile or k % tile or n % tile:
        raise ValueError(f"M, K, N = {m}, {k}, {n} must be tile multiples "
                         f"(tile {tile})")
    grids = ((pa, (m // tile, k // tile)), (pb, (k // tile, n // tile)),
             (pc, (m // tile, n // tile)))
    for p, shape in grids:
        if tuple(np.shape(p)) != shape:
            raise ValueError(f"class map {np.shape(p)} != tile grid {shape}")
        if np.size(p) and not 0 <= int(np.min(p)) <= int(np.max(p)) < nf:
            raise ValueError(f"class codes outside 0..{nf - 1}")
    return m, k, n


def mp_gemm_tile_multi(a_bufs, b_bufs, c_bufs, pa, pb, pc, *, tile: int,
                       specs: tuple, alpha: float = 1.0,
                       beta: float = 0.0) -> tuple:
    """C ← α·A·B + β·C with per-tile precision over per-format buffers;
    returns one output buffer per class code.  ``pa``/``pb``/``pc`` are
    host (numpy) tile class maps.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    global launches
    m, k, n = _check(a_bufs, b_bufs, c_bufs, pa, pb, pc, tile, specs)
    dev0 = a_bufs[0].device
    if dev0.type == "cpu":
        return mp_gemm_tile_plain(a_bufs, b_bufs, c_bufs, pa, pb, pc,
                                  tile=tile, specs=specs, alpha=alpha,
                                  beta=beta)
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
    for compute, buf_dtype, _ in specs:
        if compute not in (torch.float32, torch.bfloat16, torch.float16) \
                or buf_dtype not in _build.DTYPE_CODES:
            raise TypeError(f"spec ({compute}, {buf_dtype}) unsupported")
    check_aligned((*a_bufs, *b_bufs, *c_bufs), tile)
    plan = launch_plan(tile, specs)
    maps = [_build.upload_int32(p, dev0) for p in (pa, pb, pc)]
    outs = tuple(torch.empty((m, n), dtype=s[1], device=dev0) for s in specs)
    a = _Args()
    codes = _build.DTYPE_CODES
    for f, (compute, buf_dtype, qmax) in enumerate(specs):
        a.a[f], a.b[f], a.c[f] = (a_bufs[f].data_ptr(), b_bufs[f].data_ptr(),
                                  c_bufs[f].data_ptr())
        a.o[f] = outs[f].data_ptr()
        a.adt[f], a.bdt[f] = codes[a_bufs[f].dtype], codes[b_bufs[f].dtype]
        a.cdt[f], a.odt[f] = codes[c_bufs[f].dtype], codes[buf_dtype]
        a.comp[f], a.qmax[f] = codes[compute], int(qmax or 0)
    a.pa, a.pb, a.pc = (t.data_ptr() for t in maps)
    a.nf, a.M, a.K, a.N = len(specs), m, k, n
    a.alpha, a.beta = float(alpha), float(beta)
    dev, stream = _build.cuda_args(a_bufs[0])
    lib = _build.load("mp_gemm_tile", [ctypes.POINTER(_Args), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
    err = lib.mp_gemm_tile_launch(ctypes.byref(a), tile, plan["smem"], dev,
                                  stream)
    _build.check_launch("mp_gemm_tile", err)
    with _build.COUNT_LOCK:
        launches += 1
        for p in paths_taken(plan, pc):
            path_launches[p] += 1
    return outs
