"""Split accumulation: fp32-grade GEMM from low-precision passes (twin of
``repro.split.recovery``).

A :class:`~repro_torch.core.formats.SplitFormat` value is a sum of
``slices`` slice-dtype terms extracted hi→lo (``split_slices``).  The
product of two split operands expands to ``slices²`` slice-pair products,
each exact in fp32 for fp16 or e5m2 slices, summed smallest magnitude
first (``slice_pair_order``).  The oracle dot (``split_dot_general``),
the kernel's plain version, the CUDA kernel and its operation-for-
operation lowering (``split_gemm_ref``) all use that order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import (FormatSet, SplitFormat, cast_storage,
                                      format_set, get_format, split_slices)
from repro_torch.core.layout import MPMatrix, expand_map, fp32_matmul


def slice_pair_order(slices: int) -> tuple[tuple[int, int], ...]:
    """Accumulation order of the ``slices²`` pair products: descending
    ``i+j``, then descending ``i``, so the dominant (0, 0) term lands last
    on the largest partial sum."""
    pairs = [(i, j) for i in range(slices) for j in range(slices)]
    return tuple(sorted(pairs, key=lambda p: (-(p[0] + p[1]), -p[0])))


def recombine(parts) -> torch.Tensor:
    """fp32 sum of slices, in slice order (the storage round trip)."""
    out = parts[0].float()
    for s in parts[1:]:
        out = out + s.float()
    return out


def _pair_dot(sa, sb, pairs) -> torch.Tensor:
    acc = None
    for i, j in pairs:
        p = fp32_matmul(sa[i].float(), sb[j].float())
        acc = p if acc is None else acc + p
    return acc


def split_dot_general(a32: torch.Tensor, b32: torch.Tensor,
                      fmt: SplitFormat) -> torch.Tensor:
    """``A·B`` via the full ``slices²`` pair expansion (each pair product
    exact, multiplied in fp32), accumulated in ``slice_pair_order``."""
    sa = split_slices(a32, fmt.slices, fmt.slice_dtype)
    sb = split_slices(b32, fmt.slices, fmt.slice_dtype)
    return _pair_dot(sa, sb, slice_pair_order(fmt.slices))


def split_format_specs(fset: FormatSet) -> tuple:
    """Per-class spec rows of the split-aware kernels: ``(compute_dtype,
    dot_precision, buffer_dtype, slices, slice_dtype, qmax_or_None)``.
    Simple formats carry ``slices=1`` and their compute dtype as slice
    dtype; per-tile-scaled integer formats carry their ``qmax``."""
    rows = []
    for f in fset.formats():
        if isinstance(f, SplitFormat):
            rows.append((f.compute_dtype, f.dot_precision, f.buffer_dtype,
                         int(f.slices), f.slice_dtype, None))
        else:
            qmax = int(f.qmax) if f.per_tile_scaled else None
            rows.append((f.compute_dtype, f.dot_precision, f.buffer_dtype,
                         1, f.compute_dtype, qmax))
    return tuple(rows)


def has_split(fset: FormatSet) -> bool:
    return any(isinstance(f, SplitFormat) for f in fset.formats())


def split_variant(fset: FormatSet, split_name: str = "split2_fp16"
                  ) -> FormatSet:
    """The compute-higher sibling of ``fset``: same lower roles, HIGH
    replaced by a registered split compound format."""
    fmt = get_format(split_name)
    if not isinstance(fmt, SplitFormat):
        raise ValueError(f"{split_name!r} is not a split compound format")
    return format_set(*fset.names[:-1], split_name)


def split_store(x: torch.Tensor, spec: tuple, tile: int) -> torch.Tensor:
    """The store epilogue of one class on fp32 values ``x``: the split
    round trip for a split class, a per-tile absmax quantize-dequantize
    for an integer class, ``x`` itself otherwise."""
    from repro_torch.kernels.mp_gemm_tile import quantize_tiles
    slices, slice_dt, qmax = spec[3], spec[4], spec[5]
    if slices > 1:
        return recombine(split_slices(x, slices, slice_dt))
    if qmax is not None:
        return quantize_tiles(x, tile, qmax)
    return x


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """``a·b + c`` on fp32 values rounded once to fp32, as the kernels'
    ``__fmaf_rn``: the product is exact in fp64, the sum is rounded to
    odd in fp64 (TwoSum's error term says whether it was exact), and
    rounding that to fp32 is the single correct rounding (fp64 carries
    more than 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (e != 0) & even & torch.isfinite(e)
    away = torch.where(e > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, -float("inf")))
    return torch.where(fix, torch.nextafter(s, away), s).float()


def chain_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (fp32 values) as one sequential fp32 FMA chain over k per
    element, starting from 0: the order of the kernels' simple dot and of
    one slice pair's dot at t = 16/32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = fma32(a[:, k:k + 1], b[k:k + 1, :], acc)
    return acc


def class_dense(bufs, cls_map, tile: int) -> torch.Tensor:
    """The padded fp32 matrix with each element upcast from the buffer its
    tile's class names (what the kernels read)."""
    sel = torch.from_numpy(expand_map(np.asarray(cls_map), tile).astype(
        np.int64)).to(bufs[0].device)
    x = bufs[0].float()
    for code in range(1, len(bufs)):
        x = torch.where(sel == code, bufs[code].float(), x)
    return x


def split_gemm_ref(a: MPMatrix, b: MPMatrix, c: MPMatrix,
                   alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    """The split kernel at t = 16/32, operation for operation (slow, for
    tests and the card's bitwise check): operands upcast from the buffer
    each tile's class names; a simple C class as one FMA chain over all
    of K on operands rounded to its compute dtype; a split C class per k
    tile as one FMA chain per slice pair, the pairs added in
    ``slice_pair_order`` and the k tile's sum added to the accumulator;
    then ``alpha·acc + beta·C`` and the class's store epilogue."""
    fset = c.fset
    specs = split_format_specs(fset)
    t = c.tile
    a32, b32, c32 = (class_dense(m.bufs, m.cls, t) for m in (a, b, c))
    sel = torch.from_numpy(expand_map(c.cls, t).astype(np.int64)).to(
        c32.device)
    o_bufs = [torch.zeros(c32.shape, dtype=s[2], device=c32.device)
              for s in specs]
    for code in np.unique(c.cls):
        spec = specs[int(code)]
        if spec[3] == 1:
            op = spec[0]
            acc = chain_dot(a32 if op == torch.float32 else
                            a32.to(op).float(),
                            b32 if op == torch.float32 else
                            b32.to(op).float())
        else:
            sa = split_slices(a32, spec[3], spec[4])
            sb = split_slices(b32, spec[3], spec[4])
            acc = torch.zeros_like(c32)
            for k0 in range(0, a32.shape[1], t):
                upd = None
                for i, j in slice_pair_order(spec[3]):
                    pd = chain_dot(sa[i][:, k0:k0 + t].float(),
                                   sb[j][k0:k0 + t].float())
                    upd = pd if upd is None else upd + pd
                acc = acc + upd
        out = split_store(acc * alpha + c32 * beta, spec, t)
        o_bufs[int(code)] = torch.where(
            sel == int(code), cast_storage(out, spec[2]),
            o_bufs[int(code)])
    return MPMatrix(tuple(o_bufs), np.asarray(c.cls), t, c.shape, fset)


__all__ = [
    "FormatSet", "SplitFormat", "split_slices", "slice_pair_order",
    "recombine", "split_dot_general", "split_format_specs", "has_split",
    "split_variant", "split_gemm_ref",
]
