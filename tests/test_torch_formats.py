"""Port parity: format registry, tile maps and layouts of ``repro_torch``
against the JAX package, bit for bit.

Storage rounding, maps and layout buffers are elementwise or host-side
work, so the two packages must agree exactly — including fp8 e4m3
overflow, where torch's own cast saturates to ±448 and the port writes
the reference's NaN.  The import guard runs in a subprocess, so this
process's module table is never touched.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import layout as JL
from repro.core import precision as JP
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core import precision as PP

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

#: the non-split built-ins this slice ports
PORTED = ("fp32", "bf16", "fp8_e4m3", "fp8_e5m2", "fp16", "int8_pt",
          "int4_pt")

SETS = ("fp8_e4m3+bf16+fp32", "fp8_e5m2+fp16+fp32", "int8_pt+bf16+fp32",
        "int4_pt+bf16+fp32", "bf16+fp32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed=0, shape=(32, 48)):
    """Normal values plus the edges: fp8 e4m3 overflow boundaries, ±inf,
    NaN, subnormal magnitudes and exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, :12] = [448, 463.9, 464, 464.1, 480, 1e3, -1e5, np.inf, -np.inf,
                 np.nan, 57344, 61440]
    x[1, :6] = [2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 1e-8, -1e-30, 0.0]
    x[2:6] *= 300.0
    return x


def _same(a, b):
    """Equal values, NaN where the other has NaN (``a`` from JAX, ``b``
    a torch tensor)."""
    np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                  b.float().numpy())


def test_registry_signatures_match_reference():
    jsig = JF.registry_signatures()
    psig = PF.registry_signatures()
    assert set(PORTED) <= set(psig)
    for name in PORTED:
        assert psig[name] == jsig[name], name


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("tile", [None, 16])
def test_to_buffer_and_roundtrip_bit_exact(name, tile):
    x = _values()
    jf, pf = JF.get_format(name), PF.get_format(name)
    xt = torch.from_numpy(x)
    jb = jf.to_buffer(jnp.asarray(x), tile=tile)
    pb = pf.to_buffer(xt, tile=tile)
    assert PF.dtype_name(pb.dtype) == jnp.dtype(jb.dtype).name
    _same(jb, pb)
    _same(jf.roundtrip(jnp.asarray(x), tile=tile),
          pf.roundtrip(xt, tile=tile))


def test_e4m3_overflow_is_nan_not_saturation():
    x = torch.tensor([448.0, 464.0, 464.5, 480.0, 1e3, -1e5, float("inf")])
    got = PF.cast_storage(x, torch.float8_e4m3fn).float()
    assert got[:2].tolist() == [448.0, 448.0]
    assert torch.isnan(got[2:]).all()
    # torch's own cast saturates: the port must not inherit that
    assert x.to(torch.float8_e4m3fn).float()[4].item() == 448.0


@pytest.mark.parametrize("key", SETS)
def test_formatset_parse_and_roles(key):
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    assert pfs.names == jfs.names
    assert (pfs.high, pfs.low, pfs.low8) == (jfs.high, jfs.low, jfs.low8)
    assert pfs.class_order == jfs.class_order
    assert pfs.role_bytes() == jfs.role_bytes()
    spec = ":".join(reversed(key.split("+")))
    assert PF.FormatSet.parse(spec).names == JF.FormatSet.parse(spec).names


@pytest.mark.parametrize("policy", [
    JP.Policy("ratio", 0.5, seed=3), JP.Policy("ratio", 0.3, 0.2, seed=7),
    JP.Policy("uniform_high"), JP.Policy("uniform_low"),
    JP.Policy("norm_topk", 0.25), JP.Policy("outlier_aware"),
])
def test_make_map_identical(policy):
    w = _values(1, (64, 96))
    w[np.isnan(w) | np.isinf(w)] = 0.0
    pp = PP.Policy(policy.kind, policy.ratio_high, policy.ratio_low8,
                   policy.outlier_sigma, policy.seed)
    for fkey in ("fp8_e4m3+bf16+fp32", "bf16+fp32"):
        jfs, pfs = JF.FormatSet.from_key(fkey), PF.FormatSet.from_key(fkey)
        if policy.ratio_low8 and jfs.low8 is None:
            continue
        jm = JP.make_map(w.shape, 16, policy, w, jfs)
        pm = PP.make_map(w.shape, 16, pp, w, pfs)
        np.testing.assert_array_equal(jm, pm)
        assert PP.map_storage_bytes(pm, 16, pfs) == \
            JP.map_storage_bytes(jm, 16, jfs)
        assert PP.map_ratio_string(pm, pfs) == JP.map_ratio_string(jm, jfs)


def test_over_unity_policy_raises():
    with pytest.raises(ValueError):
        PP.make_map((32, 32), 16, PP.Policy("ratio", 1.0, 0.25))


@pytest.mark.parametrize("key", SETS)
@pytest.mark.parametrize("shape", [(48, 64), (40, 56)])
def test_mpmatrix_buffers_bit_exact(key, shape):
    x = _values(2, shape)
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    cls = JP.make_map(shape, 16, JP.Policy("ratio", 0.4, 0.3 if jfs.low8
                                           is not None else 0.0, seed=5),
                      fset=jfs)
    jm = JL.MPMatrix.from_dense(jnp.asarray(x), cls, 16, jfs)
    pm = PL.MPMatrix.from_dense(torch.from_numpy(x), cls, 16, pfs)
    assert len(pm.bufs) == len(jm.bufs)
    for jb, pb in zip(jm.bufs, pm.bufs):
        _same(jb, pb)
    _same(jm.to_dense(), pm.to_dense())
    assert pm.storage_bytes() == jm.storage_bytes()
    assert pm.padded_shape == tuple(jm.padded_shape)


@pytest.mark.parametrize("key", SETS)
@pytest.mark.parametrize("k_cls", [[2, 2, 1, 1], [1, 2, 0, 2], [0, 0, 0, 0]])
def test_ksplit_weight_bit_exact(key, k_cls):
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    k_cls = np.minimum(np.asarray(k_cls, np.int8), len(jfs) - 1)
    x = _values(3, (64, 40))
    jw = JL.KSplitWeight.from_dense(jnp.asarray(x), k_cls, 16, jfs)
    pw = PL.KSplitWeight.from_dense(torch.from_numpy(x), k_cls, 16, pfs)
    for jb, pb in zip(jw.bufs, pw.bufs):
        assert tuple(pb.shape) == tuple(jb.shape)
        _same(jb, pb)
    _same(jw.to_dense(), pw.to_dense())
    assert pw.storage_bytes() == jw.storage_bytes()
    for a, b in zip(JL.KSplitWeight.k_partition(k_cls, 16, jfs),
                    PL.KSplitWeight.k_partition(k_cls, 16, pfs)):
        np.testing.assert_array_equal(a, b)
    assert pw.sorted == bool(np.all(np.diff(k_cls.astype(int)) <= 0))


@pytest.mark.parametrize("key", SETS)
def test_nsplit_weight_bit_exact_and_matmul(key):
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    n_cls = np.asarray(sorted([jfs.high, jfs.low, jfs.low] + (
        [jfs.low8] if jfs.low8 is not None else []), reverse=True),
        np.int8)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((48, 16 * len(n_cls))).astype(np.float32)
    jw = JL.NSplitWeight.from_dense(jnp.asarray(w), n_cls, 16, jfs)
    pw = PL.NSplitWeight.from_dense(torch.from_numpy(w), n_cls, 16, pfs)
    for jb, pb in zip(jw.bufs, pw.bufs):
        _same(jb, pb)
    assert pw.storage_bytes() == jw.storage_bytes()
    x = rng.standard_normal((5, 48)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xp = torch.from_numpy(x).to(torch.bfloat16)
    jy = np.asarray(JL.nsplit_matmul(xj, jw), np.float32)
    py = PL.nsplit_matmul(xp, pw).numpy()
    # exact products, fp32 sums in another order (K = 48): 48·2^-24
    # relative to Σ|x·w| bounds the difference; low classes then round to
    # their compute dtype, which may flip one ulp of that dtype
    scale = np.abs(x) @ np.abs(w)
    assert np.all(np.abs(jy - py) <= 2 * 48 * 2.0 ** -24 * scale
                  + 2.0 ** -7 * np.abs(jy))


def test_bridge_tensor_bits():
    x = _values(5, (8, 16))
    for dt in (jnp.bfloat16, jnp.float8_e4m3fn, jnp.float8_e5m2,
               jnp.float16, jnp.float32):
        a = np.asarray(jnp.asarray(x).astype(dt))
        t = tensor_from_numpy(a, "cpu")
        assert PF.dtype_name(t.dtype) == jnp.dtype(dt).name
        np.testing.assert_array_equal(a.astype(np.float32), t.float().numpy())


def test_import_leaves_jax_and_reference_out():
    """``import repro_torch`` (every module: ``repro_torch.split``,
    ``repro_torch.solve``, ``repro_torch.serve.kv_pages``, the quant,
    optim, data, checkpoint, runtime and train modules, SUMMA, its
    schedule and grid, the settings facade, the tracer, both hygiene
    validators, the serve cluster and the three launchers among them)
    imports neither jax nor the JAX package — checked in a fresh
    interpreter, and in a rank it spawns (``run_on_grid``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('repro_torch.split', 'repro_torch.solve', "
        "'repro_torch.serve.kv_pages', 'repro_torch.launch.solve', "
        "'repro_torch.launch.serve', 'repro_torch.launch.train', "
        "'repro_torch.quant', 'repro_torch.quant.calibrate', "
        "'repro_torch.formats', 'repro_torch.tree', "
        "'repro_torch.optim.adamw', 'repro_torch.optim.grad_compress', "
        "'repro_torch.data.pipeline', 'repro_torch.checkpoint.ckpt', "
        "'repro_torch.runtime.fault', 'repro_torch.train.train_step', "
        "'repro_torch.train.trainer', 'repro_torch.core.summa', "
        "'repro_torch.core.schedule', 'repro_torch.launch.grid', "
        "'repro_torch.config', 'repro_torch.obs.trace', "
        "'repro_torch.obs.hygiene', 'repro_torch.tune.hygiene', "
        "'repro_torch.serve.cluster'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.launch.grid import rank_report, run_on_grid\n"
        "rep = run_on_grid(1, 1, rank_report, device='cpu', "
        "backend='gloo')\n"
        "assert 'repro_torch' in rep['packages'], rep\n"
        "assert not {'jax', 'repro'} & set(rep['packages']), rep\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
