"""Elementwise precision conversion: the CUDA kernel ``csrc/convert.cu``
(replacing the Pallas kernel ``repro/kernels/convert.py::convert``) and
its plain PyTorch version.

``x`` (fp32) → ``out_dtype`` with the reference's rounding: nearest-even
into bf16, fp16, fp8 e4m3 or e5m2, fp16 and e5m2 overflowing to ±inf and
e4m3 giving NaN above 464 (:func:`repro_torch.core.formats.cast_storage`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import cast_storage
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`convert`
launches = 0

#: output dtypes the kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
              torch.float8_e4m3fn, torch.float8_e5m2)


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
    lib = _build.load("convert", [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p])
    err = lib.convert_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                             _build.DTYPE_CODES[out_dtype], dev, stream)
    _build.check_launch("convert", err)
    launches += 1
    return out
