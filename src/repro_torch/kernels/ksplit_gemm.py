"""Class-split GEMM behind MPLinear: the CUDA kernel
``csrc/ksplit_gemm.cu`` (replacing the Pallas kernel
``repro/kernels/ksplit_gemm.py::ksplit_gemm_multi``) and its plain
PyTorch version::

    y = Σ_f x[:, off_f : off_f + K_f] · w_f       (fp32 out)

``bufs`` are the weight buffers in storage order (the order their K rows
are concatenated in x: ``FormatSet.class_order``, most expensive first);
``fmts[f]`` is the matching format, of which only the compute dtype is
used (the fp32 output carries no storage rounding).

The kernel sums every output element in one fixed order that depends
only on K and the segment layout (see the source note): chunk partials of
:data:`CHUNK` k, each one fp32 FMA chain in k order, added in chunk order.
So a row gets the same bits at any M and under any launch geometry
(:func:`choose_geometry` picks one per shape; :func:`ksplit_gemm_at`
takes one forced); the plain version sums per segment with the library
matmul and agrees to fp32 summation-order tolerance.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.layout import fp32_matmul, round_to_compute
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`ksplit_gemm_multi` (this count
#: and nothing else; the plain version does not count)
launches = 0

_MAX_SEG = 3

#: k per chunk partial (the kernel's KS_CHUNK): fixed, whatever the shape
CHUNK = 64
#: output columns per block (32 lanes x 8 columns)
STRIP = 256
#: strips x row blocks from which a launch keeps one block per strip and
#: row block; narrower grids split K over several blocks per strip
BLOCKS_WANTED = 128
#: warps per block (the kernel's KS_MAX_WARPS): chunks per block
WARPS = 8
#: largest chunk-partial workspace a geometry may ask for
MAX_WORKSPACE_BYTES = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch shape of the kernel: rows per block (1, 2, 4 or 8) and
    blocks per column strip along K (``zsplit``; 1 = the block adds its
    own chunks, > 1 = the last block of the strip adds everyone's from
    the workspace).  No field changes the chunk width or the order of any
    sum."""

    ms: int
    zsplit: int


def rows_per_block(m: int) -> int:
    return 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8


@functools.lru_cache(maxsize=4096)
def choose_geometry(m: int, n: int, k: int) -> Geometry:
    """The geometry :func:`ksplit_gemm_multi` launches for ``[m, k] ·
    [k, n]``: one block per strip and row block when those already fill
    the card, else K spread over blocks of one chunk per warp.  At decode
    widths a launch is bound by one warp's latency chain, and 8 warps
    per block beat 2 or 4 there (the final sum gets 256 threads)."""
    ms = rows_per_block(m)
    base = -(-n // STRIP) * -(-m // ms)
    nch = -(-k // CHUNK)
    if base >= BLOCKS_WANTED or nch * m * n * 4 > MAX_WORKSPACE_BYTES:
        return Geometry(ms, 1)
    return Geometry(ms, -(-nch // WARPS))


class _Seg(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("wdt", ctypes.c_int),
                ("cdt", ctypes.c_int), ("k0", ctypes.c_int),
                ("klen", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("seg", _Seg * _MAX_SEG), ("x", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("ws", ctypes.c_void_p),
                ("count", ctypes.c_void_p), ("nseg", ctypes.c_int),
                ("xdt", ctypes.c_int), ("M", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("ms", ctypes.c_int), ("zsplit", ctypes.c_int),
                ("vec", ctypes.c_int)]


#: per (device, stream): (chunk-partial workspace, arrival counters),
#: grown on demand and reused by every launch on that stream (the kernel
#: leaves the counters 0); launches on one stream run in order, so they
#: never share partials or counters with a launch in flight
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(dev: torch.device, key: tuple[int, int], ws_elems: int,
                 counters: int):
    with _build.COUNT_LOCK:      # threads sharing a stream share these
        ws, cnt = _scratch.get(key, (None, None))
        if ws is None or ws.numel() < ws_elems:
            ws = torch.empty(max(ws_elems, 1), dtype=torch.float32,
                             device=dev)
        if cnt is None or cnt.numel() < counters:
            cnt = torch.zeros(max(counters, 1), dtype=torch.int32,
                              device=dev)
        _scratch[key] = (ws, cnt)
        return ws, cnt


def ksplit_gemm_plain(x: torch.Tensor, bufs, fmts) -> torch.Tensor:
    """Plain version: one fp32 dot per segment (operands rounded to the
    segment's compute dtype), added in storage order."""
    y = torch.zeros((x.shape[0], bufs[0].shape[1]), dtype=torch.float32,
                    device=x.device)
    off = 0
    for buf, fmt in zip(bufs, fmts):
        kc = buf.shape[0]
        if not kc:
            continue
        y = y + fp32_matmul(round_to_compute(x[:, off:off + kc], fmt),
                            round_to_compute(buf, fmt))
        off += kc
    return y


def order_bound(x: torch.Tensor, bufs, fmts) -> torch.Tensor:
    """Largest per-element difference two correct results may show:
    both sum the same exact fp32 products, and two orders of a K-term sum
    differ by at most ``2·K·2^-24·Σ_k |x_k·w_k|`` (the kernel is held to
    its plain version, and the plain version to the reference, by this)."""
    s = torch.zeros((x.shape[0], bufs[0].shape[1]), dtype=torch.float32,
                    device=x.device)
    off = 0
    for buf, fmt in zip(bufs, fmts):
        kc = buf.shape[0]
        if kc:
            s = s + fp32_matmul(
                round_to_compute(x[:, off:off + kc], fmt).abs(),
                round_to_compute(buf, fmt).abs())
            off += kc
    return 2.0 * x.shape[1] * 2.0 ** -24 * s


def _check(x: torch.Tensor, bufs, fmts) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if len(bufs) != len(fmts) or not 1 <= len(bufs) <= _MAX_SEG:
        raise ValueError(f"need 1..{_MAX_SEG} buffers with one format each")
    n = bufs[0].shape[1]
    for b in bufs:
        if b.ndim != 2 or b.shape[1] != n:
            raise ValueError("weight buffers must be [K_f, N] with one N")
    if sum(b.shape[0] for b in bufs) != x.shape[1]:
        raise ValueError(f"segments cover {sum(b.shape[0] for b in bufs)} "
                         f"rows, x has K={x.shape[1]}")


def ksplit_gemm_multi(x: torch.Tensor, bufs, fmts) -> torch.Tensor:
    """y = Σ_f x[:, off_f:off_f+K_f] · bufs[f] at ``fmts[f]``'s compute
    dtype, fp32 ``[M, N]``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise) at :func:`choose_geometry`'s
    geometry."""
    _check(x, bufs, fmts)
    if x.device.type == "cpu":
        return ksplit_gemm_plain(x, bufs, fmts)
    return _launch(x, bufs, fmts, choose_geometry(
        x.shape[0], bufs[0].shape[1], x.shape[1]))


#: weight set -> an argument block with its segments filled in, keyed
#: by everything the block holds (so a hit is the block a miss would
#: build); the checks of the weights run once per set.  A decode step
#: launches the kernel 121 times and is bound by the host
#: (``kernel_ab.py`` measures the host time per call with the cache and
#: with it emptied)
_templates: dict[tuple, tuple[_Args, bool]] = {}
_launch_fn = None


def _template(bufs, fmts) -> tuple[_Args, bool]:
    """The argument block of a weight set (segments, N) and whether every
    buffer allows 16-byte vector loads."""
    key = tuple((b.data_ptr(), b.shape, b.stride(), b.dtype, b.device,
                 f.compute_dtype) for b, f in zip(bufs, fmts))
    hit = _templates.get(key)
    if hit is not None:
        return hit
    segs = [(b, f) for b, f in zip(bufs, fmts) if b.shape[0]]
    for b, f in segs:
        if b.device != bufs[0].device:
            raise ValueError("weight buffers must share a device")
        if b.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"weight dtype {b.dtype} unsupported")
        if f.compute_dtype not in (torch.float32, torch.bfloat16,
                                   torch.float16):
            raise TypeError(f"compute dtype {f.compute_dtype} unsupported")
        if not b.is_contiguous():
            raise ValueError("weight buffers must be contiguous")
    a = _Args()
    off = 0
    for i, (b, f) in enumerate(segs):
        a.seg[i] = _Seg(b.data_ptr(), _build.DTYPE_CODES[b.dtype],
                        _build.DTYPE_CODES[f.compute_dtype], off,
                        b.shape[0])
        off += b.shape[0]
    a.nseg, a.N = len(segs), bufs[0].shape[1]
    aligned = all(b.data_ptr() % 16 == 0 for b, _ in segs)
    if len(_templates) > 4096:
        _templates.clear()
    _templates[key] = (a, aligned)
    return a, aligned


def ksplit_gemm_at(x: torch.Tensor, bufs, fmts,
                   geom: Geometry) -> torch.Tensor:
    """The kernel launched at a given geometry (CUDA tensors only): the
    bits of every row are the same at every valid geometry."""
    _check(x, bufs, fmts)
    return _launch(x, bufs, fmts, geom)


def _launch(x: torch.Tensor, bufs, fmts, geom: Geometry) -> torch.Tensor:
    global launches, _launch_fn
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: kernel takes fp32 or bf16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if geom.ms not in (1, 2, 4, 8):
        raise ValueError(f"rows per block {geom.ms} not in 1, 2, 4, 8")
    tmpl, aligned = _template(bufs, fmts)
    if bufs[0].device != x.device:
        raise ValueError("x and weight buffers must share a device")
    m, k = x.shape
    n = tmpl.N
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    a = _Args.from_buffer_copy(tmpl)
    a.x, a.y = x.data_ptr(), y.data_ptr()
    a.xdt, a.M, a.K = _build.DTYPE_CODES[x.dtype], m, k
    a.ms, a.zsplit = geom.ms, geom.zsplit
    a.vec = int(aligned and n % 8 == 0)
    dev, stream = _build.cuda_args(x)
    if geom.zsplit > 1:
        ws, cnt = _scratch_for(x.device, (dev, stream),
                               -(-k // CHUNK) * m * n,
                               -(-n // STRIP) * -(-m // geom.ms))
        a.ws, a.count = ws.data_ptr(), cnt.data_ptr()
    if _launch_fn is None:
        _launch_fn = _build.load("ksplit_gemm", [
            ctypes.POINTER(_Args), ctypes.c_int,
            ctypes.c_void_p]).ksplit_gemm_launch
    err = _launch_fn(ctypes.byref(a), dev, stream)
    _build.check_launch("ksplit_gemm", err)
    with _build.COUNT_LOCK:
        launches += 1
    return y
