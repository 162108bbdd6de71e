"""Tile-heterogeneous matrix layouts (twin of ``repro.core.layout``).

A tensor has a single dtype, so "each tile has its own precision" needs
an explicit representation:

* ``MPMatrix``     — one dense buffer per format of the FormatSet, each
                     tile valid in exactly one of them (zeros elsewhere).
* ``KSplitWeight`` — production layout for LM matmuls: the class map is
                     constant along N, K-blocks are stored class by class
                     (most expensive format first), one buffer per format.
* ``NSplitWeight`` — class map constant along K, split along N.

* ``CompactMPMatrix`` — class-sorted compact tiles: ``tiles[code]`` holds
                     that format's tiles only (the grouped kernel's
                     operands).

Class maps are host-side numpy int8 arrays; buffers are torch tensors on
whatever device the dense source lived on.

Every dot here follows one numeric rule (the port's fix for torch's
low-precision ``@`` returning low precision): operands are rounded to the
format's compute dtype, upcast to fp32, and multiplied in fp32 with TF32
off, so products of bf16/fp16/fp8 values are exact and sums are fp32.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import precision as P
from repro_torch.core.formats import (DEFAULT_FORMATS, FormatSet,
                                      PrecisionFormat)
# the module, not its names: importing kernels.convert first imports
# this module while that one is still initializing
from repro_torch.kernels import convert as _cv


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on fp32 operands in full fp32 (raises if TF32 is on —
    TF32 keeps ~3 digits and would break the fp32 class's error bound)."""
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "fp32 matmul needs TF32 off: set torch.backends.cuda.matmul."
            "allow_tf32 = False and float32_matmul_precision 'highest'")
    return torch.matmul(a.float(), b.float())


def storage_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded into ``dtype`` as the reference's ``astype`` rounds
    (e4m3 NaN above 464, not torch's saturation at 448): the convert
    kernel on the card, its plain version on the CPU; into fp32, the
    exact upcast."""
    if x.dtype == dtype:
        return x
    if dtype == torch.float32:
        return x.float()
    return _cv.convert(x.float().contiguous(), dtype)


class _RoundToCompute(torch.autograd.Function):
    """:func:`round_to_compute` under autograd.  The cotangent goes back
    the way the reference's ``astype`` chain transposes: rounded to the
    compute dtype, then into ``x``'s dtype by :func:`storage_cast`, so an
    fp8 operand's gradient gets the reference's overflow NaN."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.dtype, ctx.op = x.dtype, op
        return x.to(op).float()

    @staticmethod
    def backward(ctx, g):
        return storage_cast(g.to(ctx.op), ctx.dtype), None


def round_to_compute(x: torch.Tensor, fmt: PrecisionFormat) -> torch.Tensor:
    """Receiver-side conversion: ``x`` rounded to the format's compute
    dtype, returned as fp32 (exact upcast)."""
    op = fmt.compute_dtype
    if x.requires_grad and torch.is_grad_enabled():
        return _RoundToCompute.apply(x, op)
    if op == torch.float32:
        return x.float()
    return x.to(op).float()


def dot_at(x: torch.Tensor, w: torch.Tensor, fmt: PrecisionFormat
           ) -> torch.Tensor:
    """``x @ w`` at the format's operational precision, fp32 result."""
    return fp32_matmul(round_to_compute(x, fmt), round_to_compute(w, fmt))


def _pad_to(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pm, pn = m - x.shape[0], n - x.shape[1]
    if pm or pn:
        x = torch.nn.functional.pad(x, (0, pn, 0, pm))
    return x


def _to_buffer(fmt: PrecisionFormat, x: torch.Tensor, tile: int
               ) -> torch.Tensor:
    """``fmt.to_buffer(x)``.  On the card a plain float format's storage
    cast is :func:`storage_cast` (the convert kernel, bit for bit the
    reference's rounding); split and integer formats keep their own."""
    if x.is_cuda and type(fmt) is PrecisionFormat:
        return storage_cast(x, fmt.storage_dtype)
    return fmt.to_buffer(x, tile=tile)


def _check_codes(cls_map: np.ndarray, fset: FormatSet) -> np.ndarray:
    cls_map = np.asarray(cls_map)
    bad = [int(c) for c in np.unique(cls_map) if not 0 <= c < len(fset)]
    if bad:
        raise ValueError(f"class codes {bad} outside format set {fset.names}")
    return cls_map


def expand_map(cls_map: np.ndarray, tile: int) -> np.ndarray:
    """Per-element class codes of a tile map."""
    return np.repeat(np.repeat(np.asarray(cls_map), tile, 0), tile, 1)


def per_class_cast(w: torch.Tensor, cls_map: np.ndarray, tile: int,
                   fset: FormatSet) -> tuple[torch.Tensor, ...]:
    """``MPMatrix``'s buffers the per-class way (the path of a set with a
    per-tile-scaled integer class): per class a masked copy
    (``convert.class_masked``, the map expanded on ``w``'s device) and its
    cast (:func:`_to_buffer`: the convert kernel for a float class on the
    card)."""
    return tuple(_to_buffer(f, m, tile)
                 for f, m in _cv.class_masked(w, cls_map, tile, fset))


# ---------------------------------------------------------------------------
# MPMatrix — dense per-format buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MPMatrix:
    """``bufs[code]`` is a full (padded) buffer in that format's buffer
    dtype; tile (i, j) is valid in the buffer ``cls[i, j]`` selects and
    zero in the others."""

    bufs: tuple[torch.Tensor, ...]
    cls: np.ndarray                    # int8[mt, nt]
    tile: int
    shape: tuple[int, int]             # logical (unpadded) shape
    fset: FormatSet = DEFAULT_FORMATS

    @classmethod
    def from_dense(cls, w: torch.Tensor, cls_map: np.ndarray, tile: int,
                   fset: FormatSet = DEFAULT_FORMATS) -> "MPMatrix":
        """The storage cast of ``w`` under ``cls_map``: one
        ``convert_by_class`` (one launch on the card) unless the set has
        a class that form does not take (a per-tile-scaled integer) or the
        tile is not a whole number of the kernel's 8-element vectors;
        those keep the per-class path (:func:`per_class_cast`)."""
        cls_map = _check_codes(np.asarray(cls_map, np.int8), fset)
        if _cv.class_map_form(fset) and tile % _cv.CLASS_TILE_MULTIPLE == 0:
            bufs = _cv.convert_by_class(w.float(), cls_map, tile, fset)
        else:
            bufs = per_class_cast(w, cls_map, tile, fset)
        return cls(bufs, cls_map, tile, (int(w.shape[0]), int(w.shape[1])),
                   fset)

    def requantize(self, new_map: np.ndarray,
                   dense: torch.Tensor | None = None) -> "MPMatrix":
        """Re-quantize under a new class map (same tile grid and format
        set) — the refinement solver's escalation primitive.  ``dense`` is
        the exact source, so a promoted tile recovers the bits its old
        format dropped; without it the stored values are re-tiled."""
        new_map = _check_codes(np.asarray(new_map), self.fset)
        if new_map.shape != self.cls.shape:
            raise ValueError(
                f"new map {new_map.shape} != tile grid {self.cls.shape}")
        src = self.to_dense() if dense is None else dense
        return MPMatrix.from_dense(src, new_map, self.tile, self.fset)

    def padded_dense(self) -> torch.Tensor:
        """Padded fp32 view with per-tile storage rounding applied (the
        sum of the buffers' upcasts — only one is non-zero per tile)."""
        d = self.bufs[0].float()
        for b in self.bufs[1:]:
            d = d + b.float()
        return d

    def to_dense(self) -> torch.Tensor:
        return self.padded_dense()[: self.shape[0], : self.shape[1]]

    @property
    def padded_shape(self) -> tuple[int, int]:
        return tuple(self.bufs[0].shape)

    @property
    def device(self) -> torch.device:
        return self.bufs[0].device

    def storage_bytes(self) -> int:
        return P.map_storage_bytes(self.cls, self.tile, self.fset)


# ---------------------------------------------------------------------------
# CompactMPMatrix — class-sorted compact tiles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompactMPMatrix:
    """``tiles[code]`` holds that format's tiles as ``buffer_dtype[n_code,
    t, t]``; ``slot[i, j]`` is the index of tile (i, j) inside its class
    array (row-major order within each class).  Allocated bytes equal the
    map's storage bytes."""

    tiles: tuple[torch.Tensor, ...]
    cls: np.ndarray                    # int8[mt, nt]
    slot: np.ndarray                   # int32[mt, nt]
    tile: int
    shape: tuple[int, int]
    fset: FormatSet = DEFAULT_FORMATS

    @staticmethod
    def make_slots(cls_map: np.ndarray) -> np.ndarray:
        slot = np.zeros_like(cls_map, dtype=np.int32)
        for c in np.unique(cls_map):
            mask = cls_map == c
            slot[mask] = np.arange(mask.sum(), dtype=np.int32)
        return slot

    @classmethod
    def from_dense(cls, w: torch.Tensor, cls_map: np.ndarray, tile: int,
                   fset: FormatSet = DEFAULT_FORMATS) -> "CompactMPMatrix":
        cls_map = _check_codes(np.asarray(cls_map), fset)
        mt, nt = cls_map.shape
        wp = _pad_to(w.float(), mt * tile, nt * tile)
        tiles = wp.reshape(mt, tile, nt, tile).permute(0, 2, 1, 3).reshape(
            mt * nt, tile, tile)
        flat_cls = cls_map.reshape(-1)
        bufs = []
        for code in fset.codes:
            fmt = fset.fmt(code)
            idx = np.nonzero(flat_cls == code)[0]
            if not len(idx):
                bufs.append(torch.zeros((0, tile, tile),
                                        dtype=fmt.buffer_dtype,
                                        device=w.device))
                continue
            sel = tiles.index_select(0, torch.from_numpy(idx).to(w.device))
            bufs.append(_to_buffer(fmt, sel, tile))
        return cls(tuple(bufs), cls_map, cls.make_slots(cls_map), tile,
                   (int(w.shape[0]), int(w.shape[1])), fset)

    def padded_dense(self) -> torch.Tensor:
        """Padded fp32 matrix assembled tile by tile from the class
        arrays."""
        mt, nt = self.cls.shape
        t = self.tile
        dev = self.tiles[0].device
        out = torch.zeros((mt * nt, t, t), dtype=torch.float32, device=dev)
        flat_cls = self.cls.reshape(-1)
        flat_slot = self.slot.reshape(-1)
        for code, buf in enumerate(self.tiles):
            idx = np.nonzero(flat_cls == code)[0]
            if not len(idx):
                continue
            out[torch.from_numpy(idx).to(dev)] = buf.index_select(
                0, torch.from_numpy(flat_slot[idx].astype(np.int64)).to(
                    dev)).float()
        return out.reshape(mt, nt, t, t).permute(0, 2, 1, 3).reshape(
            mt * t, nt * t)

    def to_dense(self) -> torch.Tensor:
        return self.padded_dense()[: self.shape[0], : self.shape[1]]

    def to_mpmatrix(self) -> MPMatrix:
        return MPMatrix.from_dense(self.to_dense(), self.cls, self.tile,
                                   self.fset)

    def storage_bytes(self) -> int:
        return int(sum(buf.numel() * self.fset.bytes_of(code)
                       + buf.shape[0] * self.fset.meta_bytes_of(code)
                       for code, buf in enumerate(self.tiles)))


# ---------------------------------------------------------------------------
# KSplitWeight — structured-K production layout for LM matmuls
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KSplitWeight:
    """W[K, N] whose class is constant along N within each K-block; the
    K-blocks of each class are stored contiguously::

        y = Σ_fmt  x[:, rows_fmt] @ w_fmt     (at that format's precision)

    ``k_cls`` int8[kt] is the per-K-block class code; ``bufs[code]`` is
    the ``[K_code, N]`` buffer of that format."""

    bufs: tuple[torch.Tensor, ...]
    k_cls: np.ndarray
    tile: int
    shape: tuple[int, int]             # logical (K, N)
    fset: FormatSet = DEFAULT_FORMATS

    @staticmethod
    def k_partition(k_cls: np.ndarray, tile: int,
                    fset: FormatSet = DEFAULT_FORMATS
                    ) -> tuple[np.ndarray, ...]:
        """K-row indices per class in storage order (descending code)."""
        out = []
        for code in fset.class_order:
            blocks = np.nonzero(np.asarray(k_cls) == code)[0]
            rows = (blocks[:, None] * tile
                    + np.arange(tile)[None, :]).reshape(-1)
            out.append(rows.astype(np.int64))
        return tuple(out)

    @functools.cached_property
    def sorted(self) -> bool:
        """True when the K-classes are stored in their logical order
        (class vector sorted by descending code), so x's K columns are
        already class-contiguous — the condition of the kernel path."""
        return bool(np.all(np.diff(self.k_cls.astype(np.int64)) <= 0))

    @functools.cached_property
    def role_fractions(self) -> tuple[float, float]:
        """(HIGH fraction, LOW8 fraction) of the K-blocks (the map is
        fixed for the weight's life, so this is computed once)."""
        fset = self.fset
        b8 = (float((self.k_cls == fset.low8).mean())
              if fset.low8 is not None else 0.0)
        return float((self.k_cls == fset.high).mean()), b8

    @classmethod
    def from_dense(cls, w: torch.Tensor, k_cls: np.ndarray, tile: int,
                   fset: FormatSet = DEFAULT_FORMATS) -> "KSplitWeight":
        k_cls = _check_codes(np.asarray(k_cls, np.int8), fset)
        kt = k_cls.shape[0]
        k, n = int(w.shape[0]), int(w.shape[1])
        if k != kt * tile:
            raise ValueError(
                f"K={k} must equal kt*tile={kt}*{tile} (choose a tile that "
                "divides K)")
        wp = w.float()
        parts = dict(zip(fset.class_order, cls.k_partition(k_cls, tile,
                                                           fset)))
        bufs = []
        for code in fset.codes:
            idx = torch.from_numpy(parts[code]).to(w.device)
            rows = wp.index_select(0, idx)
            bufs.append(_to_buffer(fset.fmt(code), rows, tile))
        return cls(tuple(bufs), k_cls, tile, (k, n), fset)

    def to_dense(self) -> torch.Tensor:
        k, n = self.shape
        dev = self.bufs[0].device
        wp = torch.zeros((self.k_cls.shape[0] * self.tile, n),
                         dtype=torch.float32, device=dev)
        parts = self.k_partition(self.k_cls, self.tile, self.fset)
        for code, idx in zip(self.fset.class_order, parts):
            if len(idx):
                wp[torch.from_numpy(idx).to(dev)] = self.bufs[code].float()
        return wp[:k, :n]

    def storage_bytes(self) -> int:
        t = self.tile
        return int(sum(
            buf.numel() * self.fset.bytes_of(code)
            + (buf.shape[0] // t) * (-(-buf.shape[1] // t))
            * self.fset.meta_bytes_of(code)
            for code, buf in enumerate(self.bufs)))


# ---------------------------------------------------------------------------
# NSplitWeight — class map constant along K, split along N
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NSplitWeight:
    """``bufs[code]`` is the ``[K, N_code]`` buffer of that format; column
    blocks are stored class-sorted (most expensive format first)."""

    bufs: tuple[torch.Tensor, ...]
    n_cls: np.ndarray                  # int8[nt], stored order
    tile: int
    shape: tuple[int, int]
    fset: FormatSet = DEFAULT_FORMATS

    @classmethod
    def from_dense(cls, w: torch.Tensor, n_cls: np.ndarray, tile: int,
                   fset: FormatSet = DEFAULT_FORMATS) -> "NSplitWeight":
        """``n_cls`` must be class-sorted (descending code)."""
        n_cls = _check_codes(np.asarray(n_cls, np.int8), fset)
        k, n = int(w.shape[0]), int(w.shape[1])
        if n != n_cls.shape[0] * tile:
            raise ValueError(f"N={n} != nt*tile={n_cls.shape[0]}*{tile}")
        order = np.argsort(-n_cls.astype(np.int64), kind="stable")
        if not np.array_equal(order, np.arange(len(n_cls))):
            raise ValueError("n_cls must be class-sorted (fold permutations "
                             "into adjacent layers instead)")
        wp = w.float()
        cols = {code: int((n_cls == code).sum()) * tile
                for code in fset.codes}
        bufs: list = [None] * len(fset)
        start = 0
        for code in fset.class_order:
            stop = start + cols[code]
            bufs[code] = _to_buffer(fset.fmt(code),
                                    wp[:, start:stop].contiguous(), tile)
            start = stop
        return cls(tuple(bufs), n_cls, tile, (k, n), fset)

    def to_dense(self) -> torch.Tensor:
        return torch.cat([self.bufs[code].float()
                          for code in self.fset.class_order], dim=1)

    def storage_bytes(self) -> int:
        t = self.tile
        return int(sum(
            buf.numel() * self.fset.bytes_of(code)
            + (-(-buf.shape[0] // t)) * (buf.shape[1] // t)
            * self.fset.meta_bytes_of(code)
            for code, buf in enumerate(self.bufs)))


#: non-HIGH classes round their fp32 dot output to the class's compute
#: dtype, as the reference's row-parallel matmul reduces them in it
REDUCE_LOW_IN_COMPUTE = True

def nsplit_matmul(x: torch.Tensor, w: NSplitWeight) -> torch.Tensor:
    """y = x @ W with per-N-block operational precision, fp32 result.

    A plain library matmul, as the reference leaves it to XLA."""
    fset = w.fset
    parts = []
    for code in fset.class_order:
        buf = w.bufs[code]
        if not buf.shape[1]:
            continue
        fmt = fset.fmt(code)
        y = dot_at(x, buf, fmt)
        if code != fset.high and REDUCE_LOW_IN_COMPUTE:
            y = y.to(fmt.compute_dtype).float()
        parts.append(y)
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _take_k(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """x[..., idx] — a slice when idx is contiguous."""
    if len(idx) and np.all(np.diff(idx) == 1):
        return x[..., int(idx[0]):int(idx[-1]) + 1]
    return x.index_select(-1, torch.from_numpy(idx).to(x.device))


def ksplit_matmul(x: torch.Tensor, w: KSplitWeight) -> torch.Tensor:
    """y = x @ W with receiver-side conversion per class (the plain
    gathering path — any K-class order): one fp32 dot per class, summed
    in storage order."""
    fset = w.fset
    parts_idx = w.k_partition(w.k_cls, w.tile, fset)
    out = None
    for code, idx in zip(fset.class_order, parts_idx):
        if not len(idx):
            continue
        p = dot_at(_take_k(x, idx), w.bufs[code], fset.fmt(code))
        out = p if out is None else out + p
    if out is None:
        return torch.zeros(x.shape[:-1] + (w.shape[1],),
                           dtype=torch.float32, device=x.device)
    return out


def ksplit_matmul_vjp(x: torch.Tensor, w: KSplitWeight, g: torch.Tensor
                      ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``(dx, dbufs)``: the VJP of :func:`ksplit_matmul` at ``(x, w)`` for
    the output cotangent ``g``, rounded as JAX's VJP of the reference's
    ``ksplit_matmul`` rounds it.  Per class the two products are fp32 dots
    of the compute-rounded operands (as the forward's), each rounded to
    the class's compute dtype (the dtype of the dot's operands); then
    ``dx`` goes to ``x``'s dtype and each buffer's gradient into that
    buffer's dtype by :func:`storage_cast`.  A class with no K rows gets a
    zero gradient."""
    fset = w.fset
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1]).float()
    dx = torch.zeros_like(x2)
    dbufs: list = [None] * len(fset)
    parts = w.k_partition(w.k_cls, w.tile, fset)
    for code, idx in zip(fset.class_order, parts):
        buf = w.bufs[code]
        if not len(idx):
            dbufs[code] = torch.zeros_like(buf)
            continue
        fmt = fset.fmt(code)
        op = fmt.compute_dtype
        xc = round_to_compute(_take_k(x2, idx), fmt)
        dbufs[code] = storage_cast(fp32_matmul(xc.T, g2).to(op), buf.dtype)
        dxc = fp32_matmul(g2, round_to_compute(buf, fmt).T).to(op)
        if np.all(np.diff(idx) == 1):
            dx[:, int(idx[0]):int(idx[-1]) + 1] = dxc.to(x.dtype)
        else:
            dx.index_copy_(1, torch.from_numpy(idx).to(x.device),
                           dxc.to(x.dtype))
    return dx.reshape(x.shape), dbufs
