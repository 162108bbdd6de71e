"""Port parity: the layouts' storage cast (``kernels.convert``'s class-map
form and ``MPMatrix.from_dense``) against the JAX package on the same
numpy-seeded inputs.

Tolerance: none.  The storage cast is elementwise, so every buffer is
held bit for bit; where the reference holds NaN the port must hold NaN
(the two frameworks encode an fp8 NaN differently).  The inputs carry
e4m3-overflow, ±inf, NaN and subnormal values into every class.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import layout as JL
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.kernels import convert as CV
from repro_torch.kernels import ops

#: class-map sets: fp8 e4m3 / bf16 / fp32, fp16 / e5m2, and two with a
#: split class
SETS = ("fp8_e4m3+bf16+fp32", "fp8_e5m2+fp16+fp32",
        "fp8_e4m3+bf16+split2_fp16", "fp16+split3_e5m2")
#: sets with a per-tile-scaled integer class (the per-class path)
INT_SETS = ("int8_pt+bf16+fp32", "int4_pt+bf16+split2_fp16")

#: values on every rounding edge of the storage dtypes
EDGES = [0.0, -0.0, 448.0, 464.0, 464.01, -480.0, 57344.0, 61439.99,
         61440.0, 65504.0, 65520.0, 1e5, np.inf, -np.inf, np.nan,
         2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -17, 2.0 ** -24, 2.0 ** -25,
         3 * 2.0 ** -25, 2.0 ** -133, 3e38]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, seed):
    """Values over 1e-12..1e6 with the edge values spread through every
    tile row (so each class's tiles see some)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-12, 6, shape)
    x = x.astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=4 * len(EDGES), replace=False)
    flat[idx] = np.tile(np.asarray(EDGES, np.float32), 4)
    return x


def _map(shape, tile, nclass, seed):
    """A class map over ``shape``'s tile grid holding every class."""
    mt, nt = -(-shape[0] // tile), -(-shape[1] // tile)
    m = np.random.default_rng(seed).integers(0, nclass, (mt, nt))
    m.reshape(-1)[:nclass] = np.arange(nclass)
    return m.astype(np.int8)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def assert_same_bits(j, p: torch.Tensor) -> None:
    """Bit-equal where the reference holds a number, NaN where it holds
    NaN (same dtype and shape)."""
    assert PF.dtype_name(p.dtype) == jnp.dtype(j.dtype).name
    jf = np.asarray(j).astype(np.float32)
    assert jf.shape == tuple(p.shape)
    nan = np.isnan(jf)
    np.testing.assert_array_equal(np.isnan(p.float().numpy()), nan)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    pb = _bits(p.view(ints[p.element_size()]).numpy())
    np.testing.assert_array_equal(_bits(j)[~nan], pb[~nan])


@pytest.mark.parametrize("shape", [(64, 96), (45, 71)])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("key", SETS)
def test_convert_by_class_plain_is_the_reference_storage_cast(key, tile,
                                                               shape):
    """``convert_by_class_plain`` equals the JAX ``MPMatrix.from_dense``
    buffers bit for bit (NaN as NaN), on padded and ragged shapes, with
    every class present in the map."""
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    x = _input(shape, seed=tile + shape[0])
    cls = _map(shape, tile, len(pfs), seed=tile)
    want = JL.MPMatrix.from_dense(jnp.asarray(x), cls, tile, jfs).bufs
    got = CV.convert_by_class_plain(torch.from_numpy(x), cls, tile, pfs)
    assert len(got) == len(want) == len(pfs)
    for j, p in zip(want, got):
        assert_same_bits(j, p)


@pytest.mark.parametrize("key", SETS + INT_SETS)
def test_from_dense_on_cpu_is_unchanged(key):
    """The port's ``MPMatrix.from_dense`` on the CPU gives the buffers of
    the plain per-class cast (``convert_by_class_plain``: a masked copy
    and ``to_buffer`` per class) bit for bit, whichever path its set
    takes."""
    fs = PF.FormatSet.from_key(key)
    x = torch.from_numpy(_input((50, 40), seed=3))
    cls = _map((50, 40), 16, len(fs), seed=4)
    got = PL.MPMatrix.from_dense(x, cls, 16, fs)
    want = CV.convert_by_class_plain(x, cls, 16, fs)
    assert got.shape == (50, 40) and got.padded_shape == (64, 48)
    for w, g in zip(want, got.bufs):
        assert w.dtype == g.dtype
        assert torch.equal(torch.isnan(w.float()), torch.isnan(g.float()))
        assert torch.equal(w.float().nan_to_num(0.0),
                           g.float().nan_to_num(0.0))


@pytest.mark.parametrize("key,form", [(k, True) for k in SETS]
                         + [(k, False) for k in INT_SETS]
                         + [("int8_pt+fp32", False), ("bf16+fp32", True)])
def test_integer_sets_are_routed_to_the_per_class_path(key, form,
                                                       monkeypatch):
    """``class_map_form`` (pure host) sends a set with an integer class
    to the per-class path and every other set to the class-map form;
    ``from_dense`` takes exactly that path, and neither launches a kernel
    on CPU tensors."""
    fs = PF.FormatSet.from_key(key)
    assert CV.class_map_form(fs) is form
    taken = []
    for mod, name in ((CV, "convert_by_class"), (PL, "per_class_cast")):
        def spy(*args, _real=getattr(mod, name), _name=name):
            taken.append(_name)
            return _real(*args)
        monkeypatch.setattr(mod, name, spy)
    ops.reset_launch_counts()
    PL.MPMatrix.from_dense(torch.ones((32, 32)), _map((32, 32), 16,
                                                      len(fs), 1), 16, fs)
    assert taken == ["convert_by_class" if form else "per_class_cast"]
    assert ops.launch_counts()["convert"] == CV.class_launches == 0


def test_convert_by_class_refuses_what_it_cannot_launch():
    """Off the CPU the wrapper launches or raises (another device is
    refused); a map that does not cover the matrix is refused by both
    forms, where the padded one is fine."""
    fs = PF.FormatSet.from_key(SETS[0])
    cls = np.zeros((2, 2), np.int8)
    with pytest.raises(ValueError, match="device"):
        CV.convert_by_class(torch.empty((32, 32), device="meta"), cls, 16,
                            fs)
    x = torch.ones((40, 32))
    assert len(CV.convert_by_class(x, np.zeros((3, 2), np.int8), 16,
                                   fs)) == 3
    for fn in (CV.convert_by_class, CV.convert_by_class_plain):
        with pytest.raises(ValueError, match="cover"):
            fn(x, cls, 16, fs)
