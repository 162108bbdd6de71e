"""The storage rules of the mixed-precision formats, frozen here so the
reference re-derives every weight the program stores.

A KSplit weight ``W[K, N]`` keeps each 128-row K-block in one format; an
NSplit weight keeps each column block in one.  A ratio policy gives
``round(ratio_high * blocks)`` blocks the most expensive format (HIGH),
``round(ratio_low8 * blocks)`` the cheapest of three (LOW8) and the rest
the middle one (LOW), HIGH blocks first.  Storage rounds to nearest,
ties to even; an fp8 e4m3 value above 464 in magnitude is NaN (448 is
the largest finite e4m3 value), as the formats' specification states.

:data:`ONE_STEP_DOWN` is the control's demotion: every class stored one
precision lower than the configuration states.
"""
from __future__ import annotations

import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16, "fp8_e4m3": torch.float8_e4m3fn,
          "fp8_e5m2": torch.float8_e5m2}

E4M3_NAN_ABOVE = 464.0

#: the nearest precision below each stated one (the control)
ONE_STEP_DOWN = {"fp32": "bf16", "bf16": "fp8_e4m3", "fp16": "fp8_e4m3",
                 "fp8_e4m3": "fp8_e4m3", "fp8_e5m2": "fp8_e5m2"}


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to ``fmt``'s storage, returned in fp32."""
    dt = DTYPES[fmt]
    if dt == torch.float32:
        return x.float()
    r = x.float().to(dt).float()
    if dt == torch.float8_e4m3fn:
        r = torch.where(x.float().abs() > E4M3_NAN_ABOVE,
                        torch.full_like(r, float("nan")), r)
    return r


def block_formats(blocks: int, formats: list[str], policy: dict
                  ) -> list[str]:
    """The format of each block under a ratio policy, HIGH first.
    ``formats`` lists 2 or 3 names in ascending cost: (LOW8,) LOW, HIGH."""
    if policy["kind"] != "ratio":
        raise ValueError(f"policy kind {policy['kind']!r} is not frozen here")
    n_hi = int(round(policy["ratio_high"] * blocks))
    n_lo8 = int(round(policy.get("ratio_low8", 0.0) * blocks))
    if n_lo8 and len(formats) < 3:
        raise ValueError(f"{formats} has no LOW8 format")
    n_lo = blocks - n_hi - n_lo8
    if n_lo < 0:
        raise ValueError(f"policy {policy} over-assigns {blocks} blocks")
    high, low = formats[-1], formats[-2]
    return [high] * n_hi + [low] * n_lo + [formats[0]] * n_lo8


def round_blocks(w: torch.Tensor, fmts: list[str], tile: int, dim: int,
                 demote: bool = False) -> torch.Tensor:
    """``w`` with each ``tile``-wide block along ``dim`` (0: K-blocks of a
    KSplit weight, 1: column blocks of an NSplit one) rounded to its
    format; ``demote`` stores each one step lower (the control)."""
    if w.shape[dim] != len(fmts) * tile:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} is not "
                         f"{len(fmts)} blocks of {tile}")
    out = torch.empty_like(w, dtype=torch.float32)
    start = 0
    while start < len(fmts):
        stop = start
        while stop < len(fmts) and fmts[stop] == fmts[start]:
            stop += 1
        fmt = ONE_STEP_DOWN[fmts[start]] if demote else fmts[start]
        sl = slice(start * tile, stop * tile)
        if dim == 0:
            out[sl] = round_to(w[sl], fmt)
        else:
            out[:, sl] = round_to(w[:, sl], fmt)
        start = stop
    return out
