"""The tolerance argument of the tile and grouped kernels' tensor-core
path, tested on a model of that path's arithmetic.

At t = 64 and 128 the CUDA tile and grouped kernels run bf16/fp16 compute
classes on wgmma, whose fp32 accumulation is not a sequential
round-to-nearest sum: each k16 step adds sixteen exact products and the
accumulator in one multi-term adder that aligns every addend to the
largest one's exponent, dropping the bits below (truncation), and
normalizes the sum toward zero.  Each addend then loses less than one
unit in the 24th bit of the largest addend, which is at most
``2^-23·Σ|a·b|``, so over K products the path stays within
``K·2^-23·Σ|a·b| = 2·K·2^-24·Σ|a·b|`` of the exact sum — the fp32 term of
``kernels.mp_gemm_tile.order_allowance``, which the card checks hold the
kernels to.

The model below does exactly that (exact products, 16-term chunks plus
the accumulator, alignment to the largest exponent with ``guard`` extra
bits, truncation), with no guard bits as the worst case and three as a
likelier one, and these tests hold it to ``order_allowance`` against the
plain version (a blocked fp32 matmul), a sequential fp32 FMA chain and
the exact sum, over random and adversarial inputs.  Operands are bf16
values, so every product is exact in fp32.

The split kernel feeds the same tensor cores slice tiles: its stages walk
(k tile, slice pair in ``slice_pair_order``, 64-wide k sub-stage) into
one fp32 accumulator.  The second half of this file runs that stage order
through the model for split2_fp16 and split3_e5m2 and holds it to the
split kernel's ``order_allowance``; that those cases pass is why the
kernel keeps one accumulator rather than one per pair.  It also checks
the two facts the design rests on: every e5m2 value survives fp16 and
bf16 storage bit for bit, and every product of two slices is exact in
fp32.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import formats as PF
from repro_torch.kernels import mp_gemm_tile as PMT
from repro_torch.kernels import split_gemm as PSG
from repro_torch.split import recovery as PR

#: one bf16 compute class stored in fp32: the allowance's fp32 term and
#: one fp32 output rounding, nothing coarser on top
SPEC = ((torch.bfloat16, torch.float32, None),)
TILE = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.float().numpy().astype(np.float64)


def _round_toward_zero_f32(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def tensor_core_dot(a: np.ndarray, b: np.ndarray, chunk: int = 16,
                    guard: int = 0, acc: np.ndarray | None = None
                    ) -> np.ndarray:
    """acc + A·B the way the model tensor core sums it (acc = 0 unless
    given): per chunk of ``chunk`` k, the accumulator and the exact
    products aligned to the largest one's exponent keeping 24 + ``guard``
    bits (truncated), summed exactly, the sum truncated to fp32."""
    if acc is None:
        acc = np.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], chunk):
        terms = a[:, None, k0:k0 + chunk] * b.T[None, :, k0:k0 + chunk]
        terms = np.concatenate([acc[..., None], terms], axis=-1)
        _, e = np.frexp(np.abs(terms).max(axis=-1, keepdims=True))
        q = np.ldexp(1.0, e - 24 - guard)
        acc = _round_toward_zero_f32((np.trunc(terms / q) * q).sum(axis=-1))
    return acc


def sequential_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One fp32 round-to-nearest FMA chain per element, k in order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a[:, k:k + 1] * b[k:k + 1, :]).astype(np.float32)
    return acc.astype(np.float64)


def _sub_ulp(frac: float, k: int):
    """A first product of 1 and k - 1 products of ``frac`` units in the
    last place of 1: each one truncated away entirely by the model and
    rounded up by a sequential sum when frac > 1/2."""
    a = np.full((TILE, k), _bf16(frac * 2.0 ** -23))
    a[:, 0] = 1.0
    return a, np.ones((k, TILE))


def _case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "normal":
        return (_bf16(rng.standard_normal((TILE, 512))),
                _bf16(rng.standard_normal((512, TILE))))
    if name == "positive":   # every truncation has the same sign
        return (_bf16(rng.random((TILE, 2048))),
                _bf16(rng.random((2048, TILE))))
    if name == "wide":       # products over ~60 decades
        a = rng.standard_normal((TILE, 512)) * 10.0 ** rng.uniform(
            -15, 15, (TILE, 512))
        return _bf16(a), _bf16(rng.standard_normal((512, TILE)))
    if name == "descending":  # the largest products first
        a = np.sort(rng.random((TILE, 1024)) * 10.0 ** rng.uniform(
            -6, 0, (TILE, 1024)), axis=1)[:, ::-1]
        return _bf16(a), _bf16(rng.random((1024, TILE)) + 0.5)
    if name == "cancel":     # large terms of both signs, small remainder
        a = rng.standard_normal((TILE, 512))
        a[:, ::2] *= 1e4
        b = rng.standard_normal((512, TILE))
        b[1::2] = -b[::2]
        return _bf16(a), _bf16(b)
    if name == "sub-ulp-0.51":
        return _sub_ulp(0.51, 2048)
    if name == "sub-ulp-0.99":
        return _sub_ulp(0.99, 2048)
    if name == "subnormal":  # bf16 subnormal operands, subnormal products
        return (_bf16(rng.standard_normal((TILE, 256)) * 1e-39),
                _bf16(rng.standard_normal((256, TILE))))
    raise ValueError(name)


CASES = ("normal", "positive", "wide", "descending", "cancel",
         "sub-ulp-0.51", "sub-ulp-0.99", "subnormal")


def _allowance(a, b, out):
    """``order_allowance`` of C = A·B for one bf16-compute class stored in
    fp32, at ``out`` (dense fp32); also returns the plain version."""
    at, bt = torch.from_numpy(a).float(), torch.from_numpy(b).float()
    ct = torch.zeros((a.shape[0], b.shape[1]))
    grid = lambda x: np.zeros((x.shape[0] // TILE, x.shape[1] // TILE),  # noqa: E731
                              np.int8)
    maps = (grid(at), grid(bt), grid(ct))
    plain = PMT.mp_gemm_tile_plain((at,), (bt,), (ct,), *maps, tile=TILE,
                                   specs=SPEC)[0]
    allow = PMT.order_allowance((at,), (bt,), (ct,), maps[2],
                                plain if out is None else out, tile=TILE,
                                specs=SPEC)
    return allow, plain


@pytest.mark.parametrize("guard", (0, 3))
@pytest.mark.parametrize("name", CASES)
def test_tensor_core_model_within_order_allowance(name, guard):
    a, b = _case(name)
    model = torch.from_numpy(tensor_core_dot(a, b, guard=guard)).float()
    allow, plain = _allowance(a, b, None)
    seq = torch.from_numpy(sequential_dot(a, b)).float()
    exact = torch.from_numpy(a @ b)
    assert PMT.within(model, plain, allow)[1] <= 1.0
    assert PMT.within(model, seq, allow)[1] <= 1.0
    assert PMT.within(model.double(), exact, allow.double())[1] <= 1.0


def test_model_truncates_sub_ulp_terms_as_argued():
    """The adversarial case is the argument's edge: the model drops every
    sub-ulp product while a sequential sum rounds each one up, one unit
    in the last place apart per product — inside the allowance, but by
    less than a percent."""
    a, b = _sub_ulp(0.99, 2048)
    model = tensor_core_dot(a, b)
    seq = sequential_dot(a, b)
    assert np.all(model == 1.0)
    assert np.all(seq == 1.0 + 2047 * 2.0 ** -23)
    allow, _ = _allowance(a, b, torch.from_numpy(seq).float())
    ratio = PMT.within(torch.from_numpy(model).float(),
                       torch.from_numpy(seq).float(), allow)[1]
    assert 0.99 < ratio <= 1.0


def test_model_is_exact_where_no_bits_are_dropped():
    """Small integers: every sum is exact in 24 bits, so the model, the
    sequential chain and the exact sum agree bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.integers(-8, 9, (TILE, 256)).astype(np.float64)
    b = rng.integers(-8, 9, (256, TILE)).astype(np.float64)
    np.testing.assert_array_equal(tensor_core_dot(a, b), a @ b)
    np.testing.assert_array_equal(sequential_dot(a, b), a @ b)


# ---------------------------------------------------------------------------
# the split kernel's stage order
# ---------------------------------------------------------------------------

#: split format -> a format set whose HIGH class is it
SPLIT_SETS = {"split2_fp16": "fp8_e4m3+bf16+split2_fp16",
              "split3_e5m2": "fp8_e4m3+bf16+split3_e5m2"}
#: the kernel's tile edges with the staged dot: one or two 64-wide
#: sub-stages per k tile
SPLIT_TILES = (64, 128)


def _slices(x: np.ndarray, fmt) -> list[np.ndarray]:
    return [s.double().numpy() for s in PF.split_slices(
        torch.from_numpy(np.asarray(x, np.float32)), fmt.slices,
        fmt.slice_dtype)]


def split_tensor_core_dot(a: np.ndarray, b: np.ndarray, fmt, tile: int,
                          guard: int = 0) -> np.ndarray:
    """A·B of a split C tile in the kernel's stage order: per k tile, per
    slice pair in ``slice_pair_order``, per 64-wide sub-stage, the model
    tensor core's 16-term chunks, all into one accumulator."""
    sa, sb = _slices(a, fmt), _slices(b, fmt)
    acc = np.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], tile):
        for i, j in PR.slice_pair_order(fmt.slices):
            for u in range(k0, k0 + tile, 64):
                acc = tensor_core_dot(sa[i][:, u:u + 64], sb[j][u:u + 64],
                                      guard=guard, acc=acc)
    return acc


def _split_case(name: str, t: int, seed: int = 0):
    """A [t, k] and B [k, t] in fp32, in the slice dtypes' normal range,
    so the second and third slices are non-zero."""
    rng = np.random.default_rng(seed)
    k = 512
    if name == "normal":
        return (rng.standard_normal((t, k)).astype(np.float32),
                rng.standard_normal((k, t)).astype(np.float32))
    if name == "positive":
        return (rng.random((t, k)).astype(np.float32),
                rng.random((k, t)).astype(np.float32))
    if name == "decades":   # 1e-3..1e3, second slices near fp16 subnormal
        a = rng.standard_normal((t, k)) * 10.0 ** rng.uniform(-3, 3, (t, k))
        return (a.astype(np.float32),
                rng.standard_normal((k, t)).astype(np.float32))
    if name == "cancel":
        a = rng.standard_normal((t, k))
        a[:, ::2] *= 1e2
        b = rng.standard_normal((k, t))
        b[1::2] = -b[::2]
        return a.astype(np.float32), b.astype(np.float32)
    if name.startswith("sub-ulp-"):
        # a first product of 2^10, then k - 1 products of ``frac`` units
        # in the last place of 2^10 (fp32 ulp 2^-13): every one truncated
        # away by the model, rounded up by a sequential sum above 1/2
        frac = float(name[len("sub-ulp-"):])
        a = np.full((t, 1024), frac * 2.0 ** -13, np.float32)
        a[:, 0] = 2.0 ** 10
        return a, np.ones((1024, t), np.float32)
    raise ValueError(name)


SPLIT_CASES = ("normal", "positive", "decades", "cancel", "sub-ulp-0.51",
               "sub-ulp-0.75", "sub-ulp-0.99")


def _split_allowance(a, b, fs, tile, out):
    """The split kernel's plain version of C = A·B (C = 0, every tile of
    the split class) and its ``order_allowance`` at ``out`` (dense fp32;
    the plain result when None)."""
    grid = lambda x: np.full((x.shape[0] // tile, x.shape[1] // tile),  # noqa: E731
                             fs.high, np.int8)
    specs = PR.split_format_specs(fs)
    mats = [PF.cast_storage(torch.from_numpy(x), specs[fs.high][2])
            for x in (a, b, np.zeros((a.shape[0], b.shape[1]), np.float32))]
    bufs = [tuple(x if c == fs.high else torch.zeros_like(x)
                  for c in range(len(specs))) for x in mats]
    maps = [grid(a), grid(b), grid(mats[2])]
    plain = sum(o.float() for o in PSG.split_gemm_plain(
        *bufs, *maps, tile=tile, specs=specs))
    allow = PSG.order_allowance(*bufs, maps[2],
                                plain if out is None else out, tile=tile,
                                specs=specs)
    return allow, plain


@functools.lru_cache(maxsize=None)
def _split_references(fmt_name: str, name: str, tile: int):
    """(A, B, allowance, plain, sequential, exact) of one split case: the
    plain version (per-k-tile pair dots), a sequential fp32 chain over the
    kernel's stages and the exact sum, computed once for both guards."""
    fs = PF.FormatSet.from_key(SPLIT_SETS[fmt_name])
    fmt = fs.fmt(fs.high)
    a, b = _split_case(name, tile)
    allow, plain = _split_allowance(a, b, fs, tile, None)
    sa, sb = _slices(a, fmt), _slices(b, fmt)
    pairs = PR.slice_pair_order(fmt.slices)
    exact = torch.from_numpy(sum(sa[i] @ sb[j] for i, j in pairs))
    seq = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], tile):
        for i, j in pairs:
            for k in range(k0, k0 + tile):
                seq = (seq.astype(np.float64) + sa[i][:, k:k + 1]
                       * sb[j][k:k + 1, :]).astype(np.float32)
    return a, b, allow, plain, torch.from_numpy(seq), exact


@pytest.mark.parametrize("tile", SPLIT_TILES)
@pytest.mark.parametrize("guard", (0, 3))
@pytest.mark.parametrize("name", SPLIT_CASES)
@pytest.mark.parametrize("fmt_name", sorted(SPLIT_SETS))
def test_split_stage_order_within_split_order_allowance(fmt_name, name,
                                                        guard, tile):
    """One accumulator over every (k tile, pair, sub-stage) stage — then
    the kernel's split round trip — stays within the split allowance of
    the plain version (per-k-tile pair dots), of a sequential fp32 chain
    over the same stages and of the exact sum."""
    fs = PF.FormatSet.from_key(SPLIT_SETS[fmt_name])
    fmt = fs.fmt(fs.high)
    a, b, allow, plain, seq, exact = _split_references(fmt_name, name, tile)
    model = torch.from_numpy(split_tensor_core_dot(a, b, fmt, tile,
                                                   guard)).float()
    out = PR.recombine(PF.split_slices(model, fmt.slices, fmt.slice_dtype))
    assert PSG.within(out, plain, allow)[1] <= 1.0
    assert PSG.within(out, seq, allow)[1] <= 1.0
    assert PSG.within(out.double(), exact, allow.double())[1] <= 1.0


def test_split_model_truncates_sub_ulp_products():
    """The sub-ulp case is the argument's edge here too: the model drops
    every small product while a sequential chain rounds each up."""
    fs = PF.FormatSet.from_key(SPLIT_SETS["split2_fp16"])
    fmt = fs.fmt(fs.high)
    a, b = _split_case("sub-ulp-0.99", 64)
    model = split_tensor_core_dot(a, b, fmt, 64)
    assert np.all(model == 2.0 ** 10)
    _, plain = _split_allowance(a, b, fs, 64, None)
    assert torch.all(plain > 2.0 ** 10)


def _all_e5m2() -> torch.Tensor:
    return torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e5m2)


@pytest.mark.parametrize("store", (torch.float16, torch.bfloat16))
def test_every_e5m2_value_survives_fp16_and_bf16_storage(store):
    """split3_e5m2's slices are stored in bf16 (its compute dtype) by the
    slice pass, and could be in fp16: every e5m2 bit pattern, subnormals,
    ±inf and NaN included, goes there and back bit for bit, with its
    value unchanged."""
    e = _all_e5m2()
    held = e.to(store)
    back = held.to(torch.float8_e5m2)
    nan = torch.isnan(e.float())
    assert torch.equal(torch.isnan(held.float()), nan)
    assert torch.equal(back.view(torch.uint8)[~nan],
                       e.view(torch.uint8)[~nan])
    assert torch.equal(held.float()[~nan], e.float()[~nan])


def test_every_e5m2_slice_product_is_exact_in_fp32():
    """All 256 x 256 products of e5m2 values (2 + 1 significand bits each,
    exponents 2^-16..2^15) are fp32 numbers: the tensor cores multiply
    them exactly.  NaN and inf products are left out."""
    v = _all_e5m2().double()
    p = v[:, None] * v[None, :]
    ok = torch.isfinite(p)
    assert int(ok.sum()) > 60000
    assert torch.equal(p[ok].float().double(), p[ok])


def test_fp16_slice_products_are_exact_in_fp32():
    """Products of two fp16 values (11 significand bits each, exponents
    2^-24..2^15) are exact in fp32: every finite fp16 value against a
    spread of 64 others, subnormals and the extremes included."""
    rng = np.random.default_rng(0)
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.float16).double()
    v = v[torch.isfinite(v)]
    pick = torch.from_numpy(rng.choice(v.numel(), 60, replace=False))
    w = torch.cat([v[pick], torch.tensor([2.0 ** -24, 65504.0, -2.0 ** -14,
                                          1.0 + 2.0 ** -10])])
    p = v[:, None] * w[None, :]
    assert torch.equal(p.float().double(), p)
