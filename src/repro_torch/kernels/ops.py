"""Public wrappers of the port's kernels over the layout types.

Each wrapper derives dtypes from the operands' FormatSet, so any
registered format flows through without kernel edits.  On CPU tensors the
kernels' plain versions run; on CUDA tensors the hand-written kernels
launch (built from ``csrc/`` at first use).
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import CompactMPMatrix, KSplitWeight, MPMatrix
from repro_torch.kernels import _build
from repro_torch.kernels import convert as _convert
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import grouped_gemm as _grouped
from repro_torch.kernels import ksplit_gemm as _ksplit
from repro_torch.kernels import mp_gemm_tile as _mp_tile
from repro_torch.kernels import split_gemm as _split

#: the kernel modules whose ``launches`` counters :func:`launch_counts`
#: reports
KERNELS = {"ksplit_gemm": _ksplit, "mp_gemm_tile": _mp_tile,
           "split_gemm": _split, "grouped_gemm": _grouped,
           "convert": _convert, "decode_attention": _decode_attention}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last :func:`reset_launch_counts`
    (the convert kernel's class-map form counts apart, in
    ``convert.class_launches``)."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def path_launch_counts() -> dict[str, dict[str, int]]:
    """Per kernel with several paths (tile, grouped), launches in which
    at least one C tile took each path, since the last reset."""
    return {name: dict(mod.path_launches) for name, mod in KERNELS.items()
            if hasattr(mod, "path_launches")}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
        if hasattr(mod, "prep_launches"):   # the split kernel's slice pass
            mod.prep_launches = 0
        if hasattr(mod, "class_launches"):  # convert's class-map form
            mod.class_launches = 0
        if hasattr(mod, "path_launches"):
            mod.path_launches = dict.fromkeys(mod.path_launches, 0)
        if hasattr(mod, "reset_tiles"):      # decode attention's tile counts
            mod.reset_tiles()


def ensure_built() -> dict[str, str]:
    """Build every kernel library now (in parallel) instead of at its
    first launch; returns name -> library path."""
    return _build.build_all()


def mp_gemm(a: MPMatrix, b: MPMatrix, c: MPMatrix,
            alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    """Tile-centric mixed-precision GEMM (Algorithm 1) via the tile
    kernel.  Per-format multi-buffer layout in and out."""
    if not (a.fset == b.fset == c.fset):
        raise ValueError("mp_gemm operands must share a format set")
    o_bufs = _mp_tile.mp_gemm_tile_multi(
        a.bufs, b.bufs, c.bufs, a.cls, b.cls, c.cls, tile=a.tile,
        specs=_mp_tile.format_specs(a.fset), alpha=alpha, beta=beta)
    return MPMatrix(tuple(o_bufs), c.cls, c.tile, c.shape, c.fset)


def split_mp_gemm(a: MPMatrix, b: MPMatrix, c: MPMatrix,
                  alpha: float = 1.0, beta: float = 0.0) -> MPMatrix:
    """Split-accumulation GEMM via the split kernel: split C classes
    expand to slices² low-precision passes, fp32-accumulated in
    ``slice_pair_order`` (see ``repro_torch.split``)."""
    from repro_torch.split.recovery import split_format_specs
    if not (a.fset == b.fset == c.fset):
        raise ValueError("split_mp_gemm operands must share a format set")
    o_bufs = _split.split_gemm_tile_multi(
        a.bufs, b.bufs, c.bufs, a.cls, b.cls, c.cls, tile=a.tile,
        specs=split_format_specs(a.fset), alpha=alpha, beta=beta)
    return MPMatrix(tuple(o_bufs), c.cls, c.tile, c.shape, c.fset)


def grouped_mp_gemm(a: CompactMPMatrix, b: CompactMPMatrix,
                    c_cls) -> CompactMPMatrix:
    """Compact class-sorted grouped GEMM (one launch for all C
    classes)."""
    return _grouped.grouped_mp_gemm(a, b, c_cls)


def convert_tiles(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Elementwise dtype conversion via the convert kernel."""
    return _convert.convert(x, out_dtype)


def ksplit_matmul_kernel(x: torch.Tensor, w: KSplitWeight) -> torch.Tensor:
    """MPLinear's matmul through the class-split kernel.  ``x``: [M, K]
    with K-classes stored contiguously in ``w.fset.class_order`` (sorted
    class vectors)."""
    fset = w.fset
    return _ksplit.ksplit_gemm_multi(
        x, tuple(w.bufs[code] for code in fset.class_order),
        tuple(fset.fmt(code) for code in fset.class_order))
