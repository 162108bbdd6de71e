"""Analytical roofline cost model over (path × precision map) (twin of
``repro.tune.costmodel``).

``GemmProblem`` captures the static facts of one mixed-precision GEMM;
``GemmPlan`` is one way to execute it.  ``predict_time`` scores a plan as
``max(compute, memory) + launches × launch overhead`` on the port's own
paths:

* ``ref``         — the oracle: one full fp32 dot per C class present,
                    plus dense fp32 copies of every operand;
* ``tile``        — the tile CUDA kernel: one launch, reads each valid
                    tile's storage bytes, writes every output buffer;
* ``ksplit_torch``— the plain gathering KSplit path: one fp32 dot per
                    class on rounded fp32 copies of x and w;
* ``ksplit_cuda`` — the ksplit CUDA kernel: one launch, weight storage
                    bytes read once;
* ``split``       — the split CUDA kernel: the tile kernel's traffic, its
                    slice pass's, and ``slices²`` passes for every split
                    C tile;
* ``grouped``     — the grouped CUDA kernel on compact operands: storage
                    bytes read once, plus the executor's conversions of
                    the MPMatrix operands to and from compact tiles.

Compute is priced by where each path multiplies.  The tile, grouped and
split kernels run a C tile of a bf16 or fp16 compute class on the tensor
cores at t = 64 and 128 (``low_tflops``) and every other C tile on the
fp32 FMA pipes (``fp32_tflops``), as ``kernels.mp_gemm_tile.launch_plan``
says; a split C tile's compute class is its slices' (fp16 for
split2_fp16, bf16 for split3_e5m2) and it does ``slices²`` passes.
``tile_flops_s`` sums that per C class.  At t = 16 and 32 every C tile,
split ones included, runs on the fp32 pipes.  The ksplit and plain paths
multiply on the fp32 pipes (rounded operands, fp32 FMA; TF32 is off), so
they are priced at the fp32 rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet, SplitFormat
from repro_torch.kernels import mp_gemm_tile as _tile
from repro_torch.tune.device import DeviceSpec

#: every execution path the dispatcher can route to
PATHS = ("ref", "tile", "ksplit_torch", "ksplit_cuda", "grouped", "split")

#: paths that launch the port's CUDA kernels
KERNEL_PATHS = ("tile", "ksplit_cuda", "grouped", "split")

#: tile edges the tile kernel is compiled for
TILE_SIZES = (16, 32, 64, 128)


def _fracs(cls_map: np.ndarray, fset: FormatSet) -> tuple[float, float]:
    total = cls_map.size
    f8 = (float((cls_map == fset.low8).sum()) / total
          if fset.low8 is not None else 0.0)
    return (float((cls_map == fset.high).sum()) / total, f8)


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """Static description of one C ← α·A·B + β·C instance."""

    m: int
    n: int
    k: int
    tile: int
    #: operation tag.  ``mp_gemm``/``linear``/``solve`` are single-device;
    #: distributed SUMMA problems use ``summa{P}x{Q}`` (the grid's shape
    #: is part of the plan-cache identity; ``m``/``n`` are then per-shard
    #: extents, and a ``!ub`` suffix marks a C map that is not
    #: shard-balanced)
    op: str = "mp_gemm"
    a_high: float = 0.0
    a_low8: float = 0.0
    b_high: float = 0.0
    b_low8: float = 0.0
    c_high: float = 0.0
    c_low8: float = 0.0
    b_k_constant: bool = False   # B map constant along N (ksplit layouts)
    c_classes: tuple = (DEFAULT_FORMATS.low,)
    alpha_one: bool = True
    beta_zero: bool = True
    pad_free: bool = True
    formats: str = DEFAULT_FORMATS.key()

    @property
    def fset(self) -> FormatSet:
        return FormatSet.from_key(self.formats)

    @classmethod
    def from_maps(cls, pa: np.ndarray, pb: np.ndarray, pc: np.ndarray,
                  tile: int, *, alpha: float = 1.0, beta: float = 0.0,
                  op: str = "mp_gemm", pad_free: bool = True,
                  fset: FormatSet = DEFAULT_FORMATS) -> "GemmProblem":
        pa, pb, pc = (np.asarray(p) for p in (pa, pb, pc))
        ah, a8 = _fracs(pa, fset)
        bh, b8 = _fracs(pb, fset)
        ch, c8 = _fracs(pc, fset)
        return cls(
            m=pa.shape[0] * tile, n=pb.shape[1] * tile,
            k=pa.shape[1] * tile, tile=tile, op=op,
            a_high=ah, a_low8=a8, b_high=bh, b_low8=b8,
            c_high=ch, c_low8=c8,
            b_k_constant=bool(np.all(pb == pb[:, :1])),
            c_classes=tuple(sorted(int(v) for v in np.unique(pc))),
            alpha_one=(alpha == 1.0), beta_zero=(beta == 0.0),
            pad_free=pad_free, formats=fset.key())

    def ratio_key(self) -> str:
        def one(h, l8):
            a, c = round(100 * h), round(100 * l8)
            return f"{a}D{100 - a - c}S" + (f"{c}Q" if c else "")
        return "|".join((one(self.a_high, self.a_low8),
                         one(self.b_high, self.b_low8),
                         one(self.c_high, self.c_low8)))

    def struct_key(self) -> str:
        return ("a{}b{}k{}p{}c{}".format(
            int(self.alpha_one), int(self.beta_zero),
            int(self.b_k_constant), int(self.pad_free),
            "".join(str(c) for c in self.c_classes)))

    def _elem_bytes(self, code: int) -> float:
        fset = self.fset
        return (fset.bytes_of(code)
                + fset.meta_bytes_of(code) / float(self.tile * self.tile))

    def bytes_per_elem(self, frac_high: float, frac_low8: float) -> float:
        fset = self.fset
        hb, lb = self._elem_bytes(fset.high), self._elem_bytes(fset.low)
        l8b = (self._elem_bytes(fset.low8)
               if fset.low8 is not None else 0.0)
        return (hb * frac_high + l8b * frac_low8
                + lb * (1.0 - frac_high - frac_low8))

    def stream_bytes_per_elem(self) -> float:
        """Bytes/elem of all per-format buffers of an MPMatrix together."""
        return float(sum(self._elem_bytes(c) for c in self.fset.codes))

    def c_fraction(self, code: int) -> float:
        """Share of C tiles in class ``code``."""
        fset = self.fset
        if code == fset.high:
            return self.c_high
        if code == fset.low8:
            return self.c_low8
        return 1.0 - self.c_high - self.c_low8


def split_c_classes(prob: GemmProblem) -> tuple[int, ...]:
    """C classes of ``prob`` in a split compound format — classes only the
    ``ref`` oracle and the ``split`` path compute correctly."""
    fset = prob.fset
    return tuple(c for c in prob.c_classes
                 if isinstance(fset.fmt(c), SplitFormat))


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One executable choice: a path plus a block shape.  The CUDA
    kernels use fixed internal blocking, so every port plan carries
    bm = bn = bk = tile."""

    path: str
    bm: int = 128
    bn: int = 128
    bk: int = 128

    def key(self) -> str:
        return f"{self.path}:{self.bm}x{self.bn}x{self.bk}"


def validate_plan(plan: GemmPlan, prob: GemmProblem,
                  dev: DeviceSpec) -> list[str]:
    """Reasons this plan cannot run here (empty list = valid)."""
    if plan.path not in PATHS:
        return [f"unknown path {plan.path!r}"]
    is_summa = prob.op.startswith("summa")
    if is_summa and plan.path not in ("ref", "grouped"):
        return [f"SUMMA local update supports ref/grouped, not "
                f"{plan.path!r}"]
    if plan.path == "ref":
        return []
    bad: list[str] = []
    t = prob.tile
    if (plan.bm, plan.bn, plan.bk) != (t, t, t):
        bad.append(f"port plans carry bm=bn=bk=tile={t}")
    # on the CPU SUMMA's grouped local update runs the kernel's plain
    # version (any tile), as the reference runs its Pallas kernel in
    # interpret mode off the TPU; a card without the kernels cannot run
    # it.  Single-device dispatch on the CPU keeps to ref: the cost model
    # would otherwise route every C = A·B there through the plain version
    plain = is_summa and plan.path == "grouped" and dev.kind == "cpu"
    if plan.path in KERNEL_PATHS and not dev.kernels and not plain:
        bad.append(f"{plan.path} needs the CUDA kernels (sm_90a), not "
                   f"{dev.kind}")
    if (plan.path in ("tile", "split", "grouped") and t not in TILE_SIZES
            and not plain):
        bad.append(f"{plan.path} kernel is built for tiles {TILE_SIZES}, "
                   f"not {t}")
    if plan.path in ("tile", "grouped") and split_c_classes(prob):
        bad.append(f"split-compound C classes need the split path (the "
                   f"{plan.path} dot would drop the recovery slices)")
    if plan.path == "split" and not split_c_classes(prob):
        bad.append("split path needs at least one split-compound C class "
                   "(use the tile path otherwise)")
    if plan.path == "grouped" and is_summa:
        # SUMMA applies alpha/beta after its panel loop; the kernel's work
        # items must be the same in number on every shard
        if prob.op.endswith("!ub"):
            bad.append("grouped SUMMA local update needs a "
                       "shard-balanced C map")
    elif plan.path == "grouped" and not (prob.alpha_one
                                         and prob.beta_zero):
        bad.append("grouped path computes C=A·B (alpha=1, beta=0)")
    if plan.path in ("ksplit_torch", "ksplit_cuda"):
        if any(isinstance(f, SplitFormat) for f in prob.fset.formats()):
            bad.append("ksplit paths compute at the B-class dtype and do "
                       "not support split compound formats")
        if not prob.b_k_constant:
            bad.append("ksplit paths need B map constant along N")
        if len(prob.c_classes) != 1:
            bad.append("ksplit paths need a uniform C map")
        if not prob.pad_free:
            bad.append("ksplit paths need unpadded operands")
        if prob.k % t:
            bad.append(f"K={prob.k} not a multiple of tile={t}")
    if plan.path == "ksplit_cuda" and not prob.beta_zero:
        bad.append("ksplit kernel computes y=x·W (beta=0)")
    return bad


def _slices(prob: GemmProblem, code: int) -> int:
    """Slices of class ``code``'s format (1 for a simple format)."""
    fmt = prob.fset.fmt(code)
    return fmt.slices if isinstance(fmt, SplitFormat) else 1


def tile_flops_s(prob: GemmProblem, dev: DeviceSpec) -> float:
    """Seconds of multiply-adds of the tile, grouped and split kernels:
    each C class's share of ``2·m·n·k``, times ``slices²`` for a split
    class, at the rate of the unit the kernel's launch plan runs its
    tiles on (tensor cores or fp32 pipes)."""
    flops = 2.0 * prob.m * prob.n * prob.k
    paths = (_tile.launch_plan(prob.tile, _tile.format_specs(prob.fset))[
        "paths"] if prob.tile in _tile.TILE_SIZES else ())
    total = 0.0
    for c in prob.c_classes:
        tc = c < len(paths) and paths[c] == "tensor_core"
        rate = dev.low_tflops if tc else dev.fp32_tflops
        total += (flops * prob.c_fraction(c) * _slices(prob, c) ** 2
                  / (rate * 1e12))
    return total


def predict_time(plan: GemmPlan, prob: GemmProblem, dev: DeviceSpec) -> dict:
    """Roofline score; ``total_s`` is the rank key."""
    m, n, k = prob.m, prob.n, prob.k
    flops = 2.0 * m * n * k
    a_bytes = m * k * prob.bytes_per_elem(prob.a_high, prob.a_low8)
    b_bytes = k * n * prob.bytes_per_elem(prob.b_high, prob.b_low8)
    c_bytes = m * n * prob.bytes_per_elem(prob.c_high, prob.c_low8)
    s = prob.stream_bytes_per_elem()
    n_cls = len(prob.c_classes)
    if plan.path == "ref":
        dots, launches = sum(_slices(prob, c) ** 2
                             for c in prob.c_classes), 8 + 6 * n_cls
        # every buffer read, dense fp32 copies, rounded copies per class,
        # the output re-encoded into nf buffers
        hbm = ((m * k + k * n + m * n) * (s + 4.0)
               + n_cls * (m * k + k * n + 3 * m * n) * 8.0 + m * n * s)
    elif plan.path == "tile":
        dots, launches = 1, 1
        hbm = a_bytes + b_bytes + c_bytes + m * n * s
    elif plan.path == "split":
        # at t = 64 and 128 a slice pass writes the slices of A and B
        # (2 bytes each) and the GEMM reads them back
        staged = prob.tile in _tile.STAGED_TILES
        sl = max((_slices(prob, c) for c in split_c_classes(prob)),
                 default=0) if staged else 0
        dots, launches = 1, 1 + int(sl > 0)
        hbm = (a_bytes + b_bytes + c_bytes + m * n * s
               + (m * k + k * n) * 4.0 * sl)
    elif plan.path == "grouped":
        # kernel: compact storage bytes once; executor: A and B from their
        # buffers to dense fp32 to compact tiles, C from compact tiles to
        # dense fp32 to its per-format buffers (~a dozen torch ops)
        dots, launches = 1, 12
        hbm = (a_bytes + b_bytes + c_bytes
               + (m * k + k * n) * (s + 12.0) + m * n * (8.0 + s))
    elif plan.path == "ksplit_torch":
        b_classes = 1 + int(prob.b_high > 0) + int(prob.b_low8 > 0)
        dots, launches = 1, 6 * b_classes
        hbm = a_bytes + b_bytes + (m * k + k * n) * 8.0 \
            + b_classes * m * n * 8.0
    else:   # ksplit_cuda
        dots, launches = 1, 1
        hbm = a_bytes + b_bytes + m * n * 4.0
    compute_s = (tile_flops_s(prob, dev)
                 if plan.path in ("tile", "grouped", "split")
                 else flops * dots / (dev.fp32_tflops * 1e12))
    hbm_s = hbm / (dev.hbm_gbps * 1e9)
    overhead_s = dev.launch_overhead_s * launches
    return {"compute_s": compute_s, "hbm_s": hbm_s,
            "overhead_s": overhead_s,
            "total_s": max(compute_s, hbm_s) + overhead_s}
