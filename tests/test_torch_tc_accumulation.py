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
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mp_gemm_tile as PMT

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
                    guard: int = 0) -> np.ndarray:
    """A·B the way the model tensor core sums it: per chunk of ``chunk``
    k, the accumulator and the exact products aligned to the largest
    one's exponent keeping 24 + ``guard`` bits (truncated), summed
    exactly, the sum truncated to fp32."""
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
