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
only on K and the segment layout (see the source note), so a row gets
the same bits at any M; the plain version sums per segment with the
library matmul and agrees to fp32 summation-order tolerance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layout import fp32_matmul, round_to_compute
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`ksplit_gemm_multi` (this count
#: and nothing else; the plain version does not count)
launches = 0

_MAX_SEG = 3


class _Seg(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("wdt", ctypes.c_int),
                ("cdt", ctypes.c_int), ("k0", ctypes.c_int),
                ("klen", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("seg", _Seg * _MAX_SEG), ("x", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("nseg", ctypes.c_int),
                ("xdt", ctypes.c_int), ("M", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int)]


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
    tensors launch the kernel (or raise)."""
    global launches
    _check(x, bufs, fmts)
    if x.device.type == "cpu":
        return ksplit_gemm_plain(x, bufs, fmts)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: kernel takes fp32 or bf16")
    segs = [(b, f) for b, f in zip(bufs, fmts) if b.shape[0]]
    for b, f in segs:
        if b.device != x.device:
            raise ValueError("x and weight buffers must share a device")
        if b.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"weight dtype {b.dtype} unsupported")
        if f.compute_dtype not in (torch.float32, torch.bfloat16,
                                   torch.float16):
            raise TypeError(f"compute dtype {f.compute_dtype} unsupported")
        if not b.is_contiguous():
            raise ValueError("weight buffers must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    m, k = x.shape
    n = bufs[0].shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    a = _Args()
    off = 0
    for i, (b, f) in enumerate(segs):
        a.seg[i] = _Seg(b.data_ptr(), _build.DTYPE_CODES[b.dtype],
                        _build.DTYPE_CODES[f.compute_dtype], off,
                        b.shape[0])
        off += b.shape[0]
    a.x, a.y = x.data_ptr(), y.data_ptr()
    a.nseg, a.xdt = len(segs), _build.DTYPE_CODES[x.dtype]
    a.M, a.K, a.N = m, k, n
    dev, stream = _build.cuda_args(x)
    lib = _build.load("ksplit_gemm", [ctypes.POINTER(_Args), ctypes.c_int,
                                      ctypes.c_void_p])
    err = lib.ksplit_gemm_launch(ctypes.byref(a), dev, stream)
    _build.check_launch("ksplit_gemm", err)
    launches += 1
    return y
