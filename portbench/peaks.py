"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).

A FLOP is charged at the peak of the lowest precision its operands are
stored in: fp8 (and int8) K-blocks at 1,979 TFLOP/s, every other FLOP
(bf16- and fp32-class blocks, attention, the backward pass) at 989.  So
no implementation that keeps the stated precision can read above 100%.
"""
from __future__ import annotations

BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12

#: per storage format, the FLOP/s a product of its operands is charged at
FLOPS = {"fp8_e4m3": FP8_FLOPS, "fp8_e5m2": FP8_FLOPS, "int8": FP8_FLOPS,
         "bf16": BF16_FLOPS, "fp16": BF16_FLOPS, "fp32": BF16_FLOPS}

#: bytes of one stored element per format
BYTES = {"fp8_e4m3": 1, "fp8_e5m2": 1, "int8": 1, "bf16": 2, "fp16": 2,
         "fp32": 4}


def least_seconds(flops_by_fmt: dict, nbytes: float) -> float:
    """The least time the chip could take: the larger of the FLOPs at
    their peaks and the bytes at the memory's peak."""
    compute = sum(f / FLOPS[fmt] for fmt, f in flops_by_fmt.items())
    return max(compute, nbytes / BYTES_PER_S)
