"""Extensible precision-format registry (PyTorch twin of
``repro.core.formats``).

Every precision a tile can be stored/computed in is one frozen
:class:`PrecisionFormat` record in a module-level registry; the *active*
combination of formats a matrix uses is an ordered :class:`FormatSet`
(2 or 3 names in ascending storage cost — class codes are indices into
that order, so the default ``fp8_e4m3+bf16+fp32`` gives LOW8=0, LOW=1,
HIGH=2).

Dtypes are torch dtypes; signatures spell them with the reference's
names (``float32``, ``bfloat16``, ``float8_e4m3fn`` …) so a plan stamped
by one package reads the same in the other.

Storage rounding follows the reference bit for bit.  The one place the
two frameworks' casts differ is fp8 e4m3 overflow: ``.to(float8_e4m3fn)``
saturates to ±448, while the reference yields NaN for ``|x| > 464`` (and
for ±inf).  :func:`cast_storage` writes that NaN explicitly — the
accuracy oracle and the refinement solver treat it as infinite error.

The compound split formats (``split2_fp16``, ``split3_e5m2``) store one
value as a sum of slices of a narrow dtype (:func:`split_slices`); their
layout buffers mirror the recombined value in fp32.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import torch

#: the e4m3 rounding boundary above which the reference cast gives NaN
#: (448 is the largest finite e4m3 value; 464 rounds half-to-even down to
#: it, anything larger rounds to the non-existent next binade)
E4M3_NAN_ABOVE = 464.0


def dtype_name(dt: torch.dtype) -> str:
    """Reference-style dtype name (``torch.bfloat16`` → ``bfloat16``)."""
    return str(dt).replace("torch.", "")


def cast_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` into ``dtype`` with the reference's semantics: plain
    round-to-nearest-even for every float type, plus NaN (not ±448) on fp8
    e4m3 overflow."""
    if dtype == torch.float8_e4m3fn:
        xf = x.float()
        r = xf.to(dtype).float()
        r = torch.where(xf.abs() > E4M3_NAN_ABOVE,
                        torch.full_like(r, float("nan")), r)
        return r.to(dtype)
    return x.to(dtype)


def unit_roundoff(dtype: torch.dtype) -> float:
    """u = 2^-(mantissa_bits + 1) of a float dtype."""
    return float(torch.finfo(dtype).eps) / 2.0


@dataclasses.dataclass(frozen=True)
class QuantizedTile:
    """Result of :meth:`PrecisionFormat.encode`: payload in the storage
    dtype plus metadata (``None`` for plain float formats, a per-tile fp32
    scale ``[..., rb, cb]`` for per-tile-scaled integer formats)."""

    payload: torch.Tensor
    meta: torch.Tensor | None = None
    tile: int | None = None


def tile_absmax(x: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """Per-(tile × tile)-block absolute max over the trailing two dims
    (ragged blocks zero-padded; ``tile=None`` → one block)."""
    xf = x.float().abs()
    if xf.ndim < 2:
        return xf.max() if xf.numel() else torch.zeros((), device=x.device)
    r, c = int(xf.shape[-2]), int(xf.shape[-1])
    t = int(tile) if tile else max(r, c, 1)
    rb, cb = -(-r // t), -(-c // t)
    xp = torch.nn.functional.pad(xf, (0, cb * t - c, 0, rb * t - r))
    xp = xp.reshape(*xf.shape[:-2], rb, t, cb, t)
    return xp.amax(dim=(-3, -1))


def expand_tile_scale(scale: torch.Tensor, tile: int | None,
                      shape: tuple[int, ...]) -> torch.Tensor:
    """Broadcast a per-tile scale ``[..., rb, cb]`` back to ``shape``."""
    s = scale
    if s.ndim < 2 or len(shape) < 2:
        return s.expand(shape) if s.ndim else s
    t = int(tile) if tile else max(int(shape[-2]), int(shape[-1]), 1)
    e = s.repeat_interleave(t, dim=-2).repeat_interleave(t, dim=-1)
    return e[..., :shape[-2], :shape[-1]]


@dataclasses.dataclass(frozen=True)
class PrecisionFormat:
    """Everything the stack needs to know about one precision format.

    ``dot_precision`` is ``"HIGHEST"`` (full fp32 products and sums) or
    ``"DEFAULT"`` (operands rounded to ``compute_dtype``); every dot in
    the port accumulates in fp32 either way.  ``pass_cost`` maps a device
    kind (exact key, family prefix such as ``"gpu"``, or ``"default"``) to
    the relative matmul pass count of a tile task in this format.
    """

    name: str
    storage_dtype: torch.dtype
    compute_dtype: torch.dtype
    bytes_per_elem: float
    dot_precision: str = "DEFAULT"
    pass_cost: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"default": 1.0})
    short: str = ""

    def cost_on(self, device_kind: str) -> float:
        """Relative matmul passes on ``device_kind`` (exact key, then its
        family prefix, then ``"default"``)."""
        if device_kind in self.pass_cost:
            return float(self.pass_cost[device_kind])
        family = device_kind.split("-")[0]
        if family in self.pass_cost:
            return float(self.pass_cost[family])
        return float(self.pass_cost.get("default", 1.0))

    @property
    def buffer_dtype(self) -> torch.dtype:
        """dtype of the layout buffer a tile of this format lives in."""
        return self.storage_dtype

    @property
    def per_tile_scaled(self) -> bool:
        return False

    @property
    def meta_bytes_per_tile(self) -> float:
        return 0.0

    # -- the quantization protocol ------------------------------------------
    def encode(self, x: torch.Tensor, *, tile: int | None = None
               ) -> QuantizedTile:
        return QuantizedTile(cast_storage(x, self.storage_dtype))

    def decode(self, qt: QuantizedTile) -> torch.Tensor:
        return qt.payload.float()

    def to_buffer(self, x: torch.Tensor, *, tile: int | None = None
                  ) -> torch.Tensor:
        """Value a layout buffer holds for ``x`` (payload when
        metadata-free, the decoded mirror otherwise)."""
        qt = self.encode(x, tile=tile)
        if qt.meta is None:
            return qt.payload.to(self.buffer_dtype)
        return self.decode(qt).to(self.buffer_dtype)

    def roundtrip(self, x: torch.Tensor, *, tile: int | None = None
                  ) -> torch.Tensor:
        """fp32 decode∘encode round-trip (what a consumer sees)."""
        return self.decode(self.encode(x, tile=tile))

    def storage_roundoff(self) -> float:
        return unit_roundoff(self.storage_dtype)

    def operational_roundoff(self) -> float:
        return unit_roundoff(self.compute_dtype)

    def signature(self) -> str:
        costs = ",".join(f"{k}={v:g}"
                         for k, v in sorted(self.pass_cost.items()))
        return (f"{self.name}:{dtype_name(self.storage_dtype)}"
                f">{dtype_name(self.compute_dtype)}"
                f":{self.bytes_per_elem}B:{self.dot_precision}"
                f":[{costs}]")


_REGISTRY: dict[str, PrecisionFormat] = {}


def register_format(fmt: PrecisionFormat | None = None, /, **kwargs
                    ) -> PrecisionFormat:
    """Register a format (idempotent for an identical definition; a
    different definition under a known name raises)."""
    if fmt is None:
        fmt = PrecisionFormat(**kwargs)
    prev = _REGISTRY.get(fmt.name)
    if prev is not None and prev.signature() != fmt.signature():
        raise ValueError(
            f"format {fmt.name!r} already registered with a different "
            f"definition ({prev.signature()} vs {fmt.signature()})")
    _REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> PrecisionFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown precision format {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_formats() -> dict[str, PrecisionFormat]:
    return dict(_REGISTRY)


def registry_signatures() -> dict[str, str]:
    return {n: f.signature() for n, f in sorted(_REGISTRY.items())}


# ---------------------------------------------------------------------------
# Built-in formats
# ---------------------------------------------------------------------------

#: fp32 storage and compute — the paper's "D".
FP32 = register_format(
    name="fp32", storage_dtype=torch.float32, compute_dtype=torch.float32,
    bytes_per_elem=4, dot_precision="HIGHEST",
    pass_cost={"default": 3.0, "tpu": 3.0, "gpu": 2.0, "cpu": 1.5},
    short="D")

#: bf16 storage and compute — the paper's "S".
BF16 = register_format(
    name="bf16", storage_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    bytes_per_elem=2, pass_cost={"default": 1.0}, short="S")

#: fp8 e4m3 storage, bf16 compute — "Q".
FP8_E4M3 = register_format(
    name="fp8_e4m3", storage_dtype=torch.float8_e4m3fn,
    compute_dtype=torch.bfloat16, bytes_per_elem=1,
    pass_cost={"default": 1.0, "gpu-a100": 0.5}, short="Q")

#: fp8 e5m2 storage, bf16 compute.
FP8_E5M2 = register_format(
    name="fp8_e5m2", storage_dtype=torch.float8_e5m2,
    compute_dtype=torch.bfloat16, bytes_per_elem=1,
    pass_cost={"default": 1.0, "gpu-a100": 0.5}, short="Q")

#: fp16 storage and compute.
FP16 = register_format(
    name="fp16", storage_dtype=torch.float16, compute_dtype=torch.float16,
    bytes_per_elem=2, pass_cost={"default": 1.0}, short="S")


# ---------------------------------------------------------------------------
# Compound split formats (Ozaki/Ootomo-style split accumulation)
# ---------------------------------------------------------------------------

def split_slices(x: torch.Tensor, slices: int, slice_dtype: torch.dtype
                 ) -> tuple[torch.Tensor, ...]:
    """Deterministic hi→lo operand split: slice *i* is the ``slice_dtype``
    rounding of the residual left by slices ``0..i-1``.  For fp16 slices
    the pairwise slice products are exact in fp32 (11-bit × 11-bit
    significands fit in 24 bits)."""
    rest = x.float()
    out = []
    for _ in range(slices):
        s = rest.to(slice_dtype)
        out.append(s)
        rest = rest - s.float()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SplitFormat(PrecisionFormat):
    """A compound format: one logical value stored as ``slices``
    precision-recovery slices of ``slice_dtype``.  Layout buffers mirror
    the recombined value in fp32; compute is ``slices²`` low-precision
    passes accumulated in fp32, and the recovered unit roundoff is
    ``2^-(slices·(nmant+1))``."""

    slices: int = 2
    slice_dtype: torch.dtype = torch.float16

    @property
    def buffer_dtype(self) -> torch.dtype:
        return torch.float32

    def encode(self, x: torch.Tensor, *, tile: int | None = None
               ) -> QuantizedTile:
        """Payload is the fp32 recombination of the slice expansion."""
        parts = split_slices(x, self.slices, self.slice_dtype)
        out = parts[0].float()
        for s in parts[1:]:
            out = out + s.float()
        return QuantizedTile(out)

    def recovered_roundoff(self) -> float:
        return unit_roundoff(self.slice_dtype) ** self.slices

    def storage_roundoff(self) -> float:
        return self.recovered_roundoff()

    def operational_roundoff(self) -> float:
        return self.recovered_roundoff()

    def signature(self) -> str:
        return (f"{super().signature()}:split{self.slices}x"
                f"{dtype_name(self.slice_dtype)}")


#: 2×fp16 split: 4 fp16 passes recover fp32-grade accuracy (2^-22).
SPLIT2_FP16 = register_format(SplitFormat(
    name="split2_fp16", storage_dtype=torch.float32,
    compute_dtype=torch.float16, bytes_per_elem=4,
    pass_cost={"default": 4.0, "gpu": 1.0, "cpu": 1.25},
    short="D", slices=2, slice_dtype=torch.float16))

#: 3×fp8 e5m2 split: 9 passes at bf16 recover ~bf16-grade accuracy (2^-9).
SPLIT3_E5M2 = register_format(SplitFormat(
    name="split3_e5m2", storage_dtype=torch.float32,
    compute_dtype=torch.bfloat16, bytes_per_elem=3,
    pass_cost={"default": 9.0, "gpu": 2.25, "cpu": 4.5},
    short="D", slices=3, slice_dtype=torch.float8_e5m2))


# ---------------------------------------------------------------------------
# Scaled integer formats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntFormat(PrecisionFormat):
    """Symmetric per-tile-absmax scaled integer storage: ``qbits``-bit
    codes in an int8 payload plus one fp32 scale per (tile × tile) tile.
    Layout buffers mirror the dequantized value in fp32, and the dot runs
    on those mirrors in full fp32."""

    qbits: int = 8

    @property
    def qmax(self) -> int:
        return 2 ** (self.qbits - 1) - 1

    @property
    def buffer_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def per_tile_scaled(self) -> bool:
        return True

    @property
    def meta_bytes_per_tile(self) -> float:
        return 4.0

    def encode(self, x: torch.Tensor, *, tile: int | None = None
               ) -> QuantizedTile:
        xf = x.float()
        am = tile_absmax(xf, tile)
        scale = torch.where(am > 0, am / self.qmax,
                            torch.ones_like(am)).float()
        se = expand_tile_scale(scale, tile, tuple(xf.shape))
        q = torch.clamp(torch.round(xf / se), -self.qmax, self.qmax)
        return QuantizedTile(q.to(torch.int8), scale,
                             int(tile) if tile else None)

    def decode(self, qt: QuantizedTile) -> torch.Tensor:
        q = qt.payload.float()
        if qt.meta is None:
            return q
        return q * expand_tile_scale(qt.meta, qt.tile, tuple(q.shape))

    def storage_roundoff(self) -> float:
        return 0.5 / self.qmax

    def operational_roundoff(self) -> float:
        return float(2.0 ** -24)

    def signature(self) -> str:
        return (f"{super().signature()}:int{self.qbits}pt"
                f":meta{self.meta_bytes_per_tile:g}B")


#: int8 + per-tile scale.
INT8_PT = register_format(IntFormat(
    name="int8_pt", storage_dtype=torch.int8, compute_dtype=torch.float32,
    bytes_per_elem=1, dot_precision="HIGHEST",
    pass_cost={"default": 1.0, "gpu": 0.5, "cpu": 0.75},
    short="Q", qbits=8))

#: int4 + per-tile scale (codes in an int8 container).
INT4_PT = register_format(IntFormat(
    name="int4_pt", storage_dtype=torch.int8, compute_dtype=torch.float32,
    bytes_per_elem=0.5, dot_precision="HIGHEST",
    pass_cost={"default": 1.0, "gpu": 0.25, "cpu": 0.75},
    short="Q", qbits=4))


# ---------------------------------------------------------------------------
# FormatSet — the ordered, role-tagged active combination
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FormatSet:
    """2 or 3 format names in ascending storage cost; class codes index
    ``names``.  ``high`` is the last (D role), ``low`` the one before it
    (S), ``low8`` the first of three (Q)."""

    names: tuple[str, ...]

    def __post_init__(self):
        if not (2 <= len(self.names) <= 3):
            raise ValueError(
                f"FormatSet holds 2 or 3 formats (D/S[/Q] roles), got "
                f"{self.names}")
        for n in self.names:
            get_format(n)
        costs = [get_format(n).bytes_per_elem for n in self.names]
        if costs != sorted(costs):
            raise ValueError(
                f"FormatSet must be ordered by ascending storage cost, got "
                f"{self.names} with bytes {costs}")

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    @property
    def high(self) -> int:
        return len(self.names) - 1

    @property
    def low(self) -> int:
        return len(self.names) - 2

    @property
    def low8(self) -> int | None:
        return 0 if len(self.names) == 3 else None

    @property
    def codes(self) -> tuple[int, ...]:
        return tuple(range(len(self.names)))

    @property
    def class_order(self) -> tuple[int, ...]:
        """Codes in descending storage cost — the storage order of split
        layouts (most expensive format first)."""
        return tuple(reversed(range(len(self.names))))

    def fmt(self, code: int) -> PrecisionFormat:
        try:
            return get_format(self.names[code])
        except IndexError:
            raise KeyError(
                f"class code {code} outside format set {self.names}") from None

    def formats(self) -> tuple[PrecisionFormat, ...]:
        return tuple(get_format(n) for n in self.names)

    def storage_dtype(self, code: int) -> torch.dtype:
        return self.fmt(code).storage_dtype

    def bytes_of(self, code: int) -> float:
        return self.fmt(code).bytes_per_elem

    def meta_bytes_of(self, code: int) -> float:
        return self.fmt(code).meta_bytes_per_tile

    def tile_bytes(self, code: int, tile: int) -> float:
        return self.bytes_of(code) * tile * tile + self.meta_bytes_of(code)

    def role_bytes(self) -> tuple[float, float, float]:
        b8 = float(self.fmt(self.low8).bytes_per_elem) \
            if self.low8 is not None else 0.0
        return (float(self.fmt(self.high).bytes_per_elem),
                float(self.fmt(self.low).bytes_per_elem), b8)

    def key(self) -> str:
        return "+".join(self.names)

    @classmethod
    def from_key(cls, key: str) -> "FormatSet":
        return cls(tuple(key.split("+")))

    @classmethod
    def parse(cls, spec: str) -> "FormatSet":
        """Registry names or role aliases separated by ``:``, ``+`` or
        ``,``, stably sorted into ascending storage cost."""
        toks = [t.strip() for t in re.split("[:+,]", spec) if t.strip()]
        names = [SPEC_ALIASES.get(t.lower(), t) for t in toks]
        for n in names:
            get_format(n)
        names.sort(key=lambda n: float(get_format(n).bytes_per_elem))
        return cls(tuple(names))


#: role / shorthand aliases accepted by :meth:`FormatSet.parse`
SPEC_ALIASES: dict[str, str] = {
    "d": "fp32", "s": "bf16", "q": "fp8_e4m3",
    "fp8": "fp8_e4m3", "int8": "int8_pt", "int4": "int4_pt",
}


def format_set(*names: str) -> FormatSet:
    return FormatSet(tuple(names))


#: LOW8=0 (fp8 e4m3), LOW=1 (bf16), HIGH=2 (fp32).
DEFAULT_FORMATS = format_set("fp8_e4m3", "bf16", "fp32")
