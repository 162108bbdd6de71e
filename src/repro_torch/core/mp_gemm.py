"""Reference tile-centric mixed-precision GEMM (Algorithm 1), the
semantic contract every fast path is held to (twin of
``repro.core.mp_gemm``)::

    C ← α·A·B + β·C

A, B and C carry independent per-tile precision maps.  The operational
precision of the task for output tile C(i, j) is C(i, j)'s class; A/B
tiles arrive in their storage precision and are converted at the
consumer.  Accumulation is fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import SplitFormat
from repro_torch.core.layout import MPMatrix, dot_at, expand_map


def _class_dot(ad: torch.Tensor, bd: torch.Tensor, fmt) -> torch.Tensor:
    """One C-class dense dot at the class's operational precision:
    operands rounded to the compute dtype, upcast, multiplied in fp32;
    split compound formats expand to their slices² pair products."""
    if isinstance(fmt, SplitFormat):
        from repro_torch.split.recovery import split_dot_general
        return split_dot_general(ad, bd, fmt)
    return dot_at(ad, bd, fmt)


def mp_gemm_ref(a: MPMatrix, b: MPMatrix, c: MPMatrix,
                alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    """Oracle: one dense dot per C class present, then a per-tile select
    and the store back into C's per-tile precision."""
    ad, bd, cd = a.padded_dense(), b.padded_dense(), c.padded_dense()
    fset = c.fset
    classes = sorted({int(v) for v in np.unique(c.cls)})
    sel = torch.from_numpy(expand_map(c.cls, c.tile)).to(cd.device)
    out = torch.zeros_like(cd)
    for cc in classes:
        val = alpha * _class_dot(ad, bd, fset.fmt(cc)) + beta * cd
        out = torch.where(sel == cc, val, out)
    return MPMatrix.from_dense(out[: c.shape[0], : c.shape[1]], c.cls,
                               c.tile, fset)


def mp_gemm_tilewise_ref(a: MPMatrix, b: MPMatrix, c: MPMatrix,
                         alpha: float = 1.0, beta: float = 0.0
                         ) -> torch.Tensor:
    """Slow literal per-tile loop (Algorithm 1 verbatim), used to validate
    :func:`mp_gemm_ref` itself.  Returns dense fp32."""
    t = c.tile
    fset = c.fset
    ad, bd, cd = a.padded_dense(), b.padded_dense(), c.padded_dense()
    mt, kt = a.cls.shape
    kt2, nt = b.cls.shape
    if kt != kt2:
        raise ValueError(f"inner tile grids differ: {kt} vs {kt2}")
    out = torch.zeros_like(cd)
    for i in range(mt):
        for j in range(nt):
            fmt = fset.fmt(int(c.cls[i, j]))
            acc = torch.zeros((t, t), dtype=torch.float32, device=cd.device)
            for l in range(kt):
                acc += _class_dot(ad[i * t:(i + 1) * t, l * t:(l + 1) * t],
                                  bd[l * t:(l + 1) * t, j * t:(j + 1) * t],
                                  fmt)
            upd = alpha * acc + beta * cd[i * t:(i + 1) * t,
                                          j * t:(j + 1) * t]
            out[i * t:(i + 1) * t, j * t:(j + 1) * t] = fmt.roundtrip(upd)
    return out[: c.shape[0], : c.shape[1]]
