"""Split accumulation: fp32-grade GEMM from low-precision passes (twin of
``repro.split.recovery``).

A :class:`~repro_torch.core.formats.SplitFormat` value is a sum of
``slices`` slice-dtype terms extracted hi→lo (``split_slices``).  The
product of two split operands expands to ``slices²`` slice-pair products,
each exact in fp32 for fp16 or e5m2 slices, summed smallest magnitude
first (``slice_pair_order``).  The oracle dot (``split_dot_general``),
the per-tile lowering (``split_gemm_ref``), the kernel's plain version and
the CUDA kernel all use that order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import (FormatSet, SplitFormat, format_set,
                                      get_format, split_slices)
from repro_torch.core.layout import MPMatrix, fp32_matmul


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


def split_gemm_ref(a: MPMatrix, b: MPMatrix, c: MPMatrix,
                   alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    """Per-tile lowering of the split kernel (slow, for tests): for every
    C tile, per k tile, the class's (possibly split-expanded) tile dot,
    fp32 accumulation over k tiles, the class's store epilogue."""
    fset = c.fset
    specs = split_format_specs(fset)
    t = c.tile
    mt, kt = a.cls.shape
    nt = b.cls.shape[1]
    ad, bd, cd = a.padded_dense(), b.padded_dense(), c.padded_dense()
    o_bufs = [torch.zeros((mt * t, nt * t), dtype=s[2], device=cd.device)
              for s in specs]

    def tl(x, i, j):
        return x[i * t:(i + 1) * t, j * t:(j + 1) * t]

    for i in range(mt):
        for j in range(nt):
            cls_c = int(c.cls[i, j])
            spec = specs[cls_c]
            acc = torch.zeros((t, t), dtype=torch.float32, device=cd.device)
            for k in range(kt):
                a32, b32 = tl(ad, i, k), tl(bd, k, j)
                if spec[3] == 1:
                    op = spec[0]
                    upd = fp32_matmul(a32.to(op).float(), b32.to(op).float())
                else:
                    sa = split_slices(a32, spec[3], spec[4])
                    sb = split_slices(b32, spec[3], spec[4])
                    upd = _pair_dot(sa, sb, slice_pair_order(spec[3]))
                acc = acc + upd
            out = alpha * acc + beta * tl(cd, i, j)
            o_bufs[cls_c][i * t:(i + 1) * t, j * t:(j + 1) * t] = \
                split_store(out, spec, t).to(spec[2])
    return MPMatrix(tuple(o_bufs), np.asarray(c.cls), t, c.shape, fset)


__all__ = [
    "FormatSet", "SplitFormat", "split_slices", "slice_pair_order",
    "recombine", "split_dot_general", "split_format_specs", "has_split",
    "split_variant", "split_gemm_ref",
]
