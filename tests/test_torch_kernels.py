"""Port parity: the ksplit, tile and convert kernels of ``repro_torch`` —
their plain PyTorch versions against the JAX package's Pallas kernels run
as its own tests run them (``interpret=True`` on CPU), at tiles 16 and 32
— plus the wrappers' routing and checks.  (The split and grouped kernels
have their own files.)  The CUDA kernels themselves run only on a card:
those tests are marked ``gpu`` and skip here.

Tolerances.  Both packages multiply the same operands rounded to the same
compute dtype, so every product is exact in fp32 and only the order of the
fp32 sums differs; two orders of a K-term sum differ by at most
``2·K·2^-24·Σ|x·w|`` per element.  Outputs then stored in a narrower
format may differ by one rounding of that format, integer C tiles by one
quantization step.  Convert is held bit for bit, NaN as NaN.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import layout as JL
from repro.core import precision as JP
from repro.kernels import ksplit_gemm as JK
from repro.kernels import mp_gemm_tile as JMT
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import formats as PF
from repro_torch.core import layout as PL
from repro_torch.core import precision as PP
from repro_torch.kernels import ksplit_gemm as PK
from repro_torch.kernels import mp_gemm_tile as PMT
from repro_torch.kernels import ops

SETS = ("fp8_e4m3+bf16+fp32", "fp8_e5m2+fp16+fp32", "int8_pt+bf16+fp32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel)")
    return torch.device("cuda")


def _ksplit_case(key, k_cls, m, tile, n, xdtype, seed=0):
    rng = np.random.default_rng(seed)
    k = len(k_cls) * tile
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    k_cls = np.asarray(k_cls, np.int8)
    jw = JL.KSplitWeight.from_dense(jnp.asarray(w), k_cls, tile, jfs)
    pw = PL.KSplitWeight(tuple(tensor_from_numpy(np.asarray(b), "cpu")
                               for b in jw.bufs), k_cls, tile, (k, n), pfs)
    xj = jnp.asarray(x).astype(xdtype)
    xp = tensor_from_numpy(np.asarray(xj), "cpu")
    return xj, xp, jw, pw


def _bound(xp, pw):
    fs = pw.fset
    return PK.order_bound(xp, [pw.bufs[c] for c in fs.class_order],
                          [fs.fmt(c) for c in fs.class_order]).numpy()


@pytest.mark.parametrize("key,k_cls,tile,xdtype", [
    (key, k_cls, 16, jnp.bfloat16) for key in SETS
    for k_cls in ([2, 2, 1, 0], [1, 1, 1, 1])] + [
    (SETS[0], [2, 1, 1, 1], 32, jnp.bfloat16),
    (SETS[1], [2, 2, 1, 0], 16, jnp.float32)])
def test_ksplit_plain_matches_pallas(key, k_cls, tile, xdtype):
    m, n = 16, 32
    xj, xp, jw, pw = _ksplit_case(key, k_cls, m, tile, n, xdtype)
    fs = jw.fset
    specs = JMT.format_specs(fs)
    yj = np.asarray(JK.ksplit_gemm_multi(
        xj, tuple(jw.bufs[c] for c in fs.class_order),
        specs=tuple(specs[c] for c in fs.class_order),
        bm=16, bn=16, bk=tile, interpret=True))
    yp = PK.ksplit_gemm_plain(
        xp, [pw.bufs[c] for c in pw.fset.class_order],
        [pw.fset.fmt(c) for c in pw.fset.class_order]).numpy()
    bound = _bound(xp, pw)
    assert np.all(np.abs(yj - yp) <= bound)


def test_ksplit_wrapper_on_cpu_is_the_plain_version():
    _, xp, _, pw = _ksplit_case(SETS[0], [2, 2, 1, 0], 5, 16, 24,
                                jnp.bfloat16)
    before = PK.launches
    y = ops.ksplit_matmul_kernel(xp, pw)
    plain = PK.ksplit_gemm_plain(
        xp, [pw.bufs[c] for c in pw.fset.class_order],
        [pw.fset.fmt(c) for c in pw.fset.class_order])
    assert torch.equal(y, plain) and PK.launches == before
    # ... and the gathering path agrees with it to summation order
    ref = PL.ksplit_matmul(xp, pw)
    bound = _bound(xp, pw)
    assert np.all(np.abs((ref - y).numpy()) <= bound)


def test_ksplit_wrapper_rejects_bad_operands():
    _, xp, _, pw = _ksplit_case(SETS[0], [2, 2, 1, 0], 4, 16, 24,
                                jnp.bfloat16)
    bufs = [pw.bufs[c] for c in pw.fset.class_order]
    fmts = [pw.fset.fmt(c) for c in pw.fset.class_order]
    with pytest.raises(ValueError):
        PK.ksplit_gemm_multi(xp[:, :-16], bufs, fmts)      # K mismatch
    with pytest.raises(ValueError):
        PK.ksplit_gemm_multi(xp[None], bufs, fmts)         # not 2-D
    with pytest.raises(ValueError):
        PK.ksplit_gemm_multi(xp, bufs, fmts[:2])           # formats short


#: (K, N): the served InternLM2-1.8B linears, then narrow, ragged and
#: deep ones
GEOMETRY_KN = ((2048, 2048), (2048, 1024), (2048, 8192), (2048, 92544),
               (8192, 2048), (64, 24), (96, 200), (200, 1000))


def chunk_schedule(geom, k: int) -> list[tuple[int, int, int]]:
    """Where the ksplit kernel computes each chunk partial under ``geom``:
    per chunk c (in order), (block along K, warp, round), by the kernel's
    own index arithmetic (``csrc/ksplit_gemm.cu``: ``c0 + warp`` per round
    of 8 warps at zsplit 1; ``z * cpb + warp + round * 8`` above)."""
    nch = -(-k // PK.CHUNK)
    w = PK.WARPS
    if geom.zsplit == 1:
        return [(0, c % w, c // w) for c in range(nch)]
    cpb = -(-nch // geom.zsplit)
    return [(c // cpb, (c % cpb) % w, (c % cpb) // w) for c in range(nch)]


@pytest.mark.parametrize("k,n", GEOMETRY_KN)
def test_ksplit_geometry_never_changes_chunks_or_order(k, n):
    """At every M the chooser's geometry, and the forced one-block-per-
    strip one, compute each 64-k chunk partial exactly once, on one warp
    of one block (the kernel's own index arithmetic); the chunk width is
    the kernel's constant and no geometry field, and both reductions add
    the partials in chunk order — so a row's bits depend on K and the
    segments alone (the card run compares the two geometries' bits)."""
    nch = -(-k // PK.CHUNK)
    assert PK.CHUNK == 64
    assert [f.name for f in dataclasses.fields(PK.Geometry)] == [
        "ms", "zsplit"]
    for m in [*range(1, 65), 96, 128, 255, 256, 512, 4096]:
        g = PK.choose_geometry(m, n, k)
        assert g.ms == PK.rows_per_block(m)
        assert 1 <= g.zsplit <= nch
        if g.zsplit > 1:
            assert nch * m * n * 4 <= PK.MAX_WORKSPACE_BYTES
        for geom in (g, PK.Geometry(g.ms, 1)):
            sched = chunk_schedule(geom, k)
            assert len(sched) == nch == len(set(sched))
            assert all(0 <= z < geom.zsplit and 0 <= w < PK.WARPS
                       for z, w, _ in sched)


def test_ksplit_forced_geometry_needs_a_card():
    _, xp, _, pw = _ksplit_case(SETS[0], [2, 2, 1, 0], 4, 16, 24,
                                jnp.bfloat16)
    bufs = [pw.bufs[c] for c in pw.fset.class_order]
    fmts = [pw.fset.fmt(c) for c in pw.fset.class_order]
    before = PK.launches
    with pytest.raises(ValueError):
        PK.ksplit_gemm_at(xp, bufs, fmts, PK.choose_geometry(4, 24, 64))
    assert PK.launches == before


def _tile_case(key, t, shape, ratios, seed=0):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    jfs, pfs = JF.FormatSet.from_key(key), PF.FormatSet.from_key(key)
    dense = [rng.standard_normal(s).astype(np.float32)
             for s in ((m, k), (k, n), (m, n))]
    maps = [JP.make_map(d.shape, t, JP.Policy("ratio", ratios[0], ratios[1],
                                               seed=seed + i), fset=jfs)
            for i, d in enumerate(dense)]
    jm = [JL.MPMatrix.from_dense(jnp.asarray(d), p, t, jfs)
          for d, p in zip(dense, maps)]
    pm = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, t, pfs)
          for d, p in zip(dense, maps)]
    return jm, pm, maps, dense


def _within(pm, maps, t, got, want, alpha, beta):
    """Worst ratio of |got - want| to the tile GEMM's order allowance
    (``mp_gemm_tile.order_allowance``); ``got``/``want`` dense fp32."""
    allow = PMT.order_allowance(
        pm[0].bufs, pm[1].bufs, pm[2].bufs, maps[2], want, tile=t,
        specs=PMT.format_specs(pm[0].fset), alpha=alpha, beta=beta)
    return PMT.within(got, want, allow)[1]


@pytest.mark.parametrize("key,t,shape,ratios,alpha,beta", [
    (key, 16, (32, 48, 32), ratios, alpha, beta) for key in SETS
    for ratios, alpha, beta in (((0.4, 0.3), 1.5, 0.5),
                                ((1.0, 0.0), 1.0, 0.0))] + [
    (SETS[0], 32, (64, 64, 32), (0.5, 0.0), 2.0, -1.0),
    (SETS[2], 32, (64, 64, 32), (0.0, 0.0), 1.0, 0.0)])
def test_tile_plain_matches_pallas(key, t, shape, ratios, alpha, beta):
    jm, pm, maps, _ = _tile_case(key, t, shape, ratios)
    jouts = JMT.mp_gemm_tile_multi(
        jm[0].bufs, jm[1].bufs, jm[2].bufs, *(jnp.asarray(p) for p in maps),
        tile=t, specs=JMT.format_specs(jm[0].fset), alpha=alpha, beta=beta,
        interpret=True)
    pouts = PMT.mp_gemm_tile_plain(
        pm[0].bufs, pm[1].bufs, pm[2].bufs, *maps, tile=t,
        specs=PMT.format_specs(pm[0].fset), alpha=alpha, beta=beta)
    for jo, po in zip(jouts, pouts):
        assert PF.dtype_name(po.dtype) == jnp.dtype(jo.dtype).name
    jd = torch.from_numpy(sum(np.asarray(o).astype(np.float32)
                              for o in jouts))
    pd = sum(o.float() for o in pouts)
    # each output buffer is zero outside its class's tiles, as in the
    # reference
    sel = PL.expand_map(maps[2], t)
    for code, po in enumerate(pouts):
        assert not po.float()[torch.from_numpy(sel != code)].any()
    assert _within(pm, maps, t, pd, jd, alpha, beta) <= 1.0


def test_quantize_tiles_matches_reference_epilogue():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((32, 48)) * 5).astype(np.float32)
    x[0, 0] = np.nan      # a NaN makes its tile's scale 1, as in JAX
    got = PMT.quantize_tiles(torch.from_numpy(x), 16, 127).numpy()
    for i in range(2):
        for j in range(3):
            blk = x[16 * i:16 * (i + 1), 16 * j:16 * (j + 1)]
            want = np.asarray(JMT.quantize_block(jnp.asarray(blk), 127))
            np.testing.assert_array_equal(
                got[16 * i:16 * (i + 1), 16 * j:16 * (j + 1)], want)


def test_tile_wrapper_on_cpu_is_the_plain_version_and_checks():
    _, pm, maps, _ = _tile_case(SETS[0], 16, (32, 32, 32), (0.4, 0.3))
    specs = PMT.format_specs(pm[0].fset)
    before = PMT.launches
    out = ops.mp_gemm(*pm, alpha=1.0, beta=0.5)
    plain = PMT.mp_gemm_tile_plain(pm[0].bufs, pm[1].bufs, pm[2].bufs,
                                   *maps, tile=16, specs=specs, beta=0.5)
    assert all(torch.equal(a, b) for a, b in zip(out.bufs, plain))
    assert PMT.launches == before
    with pytest.raises(ValueError):
        PMT.mp_gemm_tile_multi(pm[0].bufs, pm[1].bufs, pm[2].bufs,
                               maps[0], maps[1], maps[2][:1], tile=16,
                               specs=specs)


@pytest.mark.gpu
def test_ksplit_kernel_matches_plain_on_card(cuda):
    for m in (1, 4, 37):
        _, xp, _, pw = _ksplit_case(SETS[0], [2, 2, 1, 0], m, 32, 200,
                                    jnp.bfloat16)
        x = xp.to(cuda)
        w = PL.KSplitWeight(tuple(b.to(cuda) for b in pw.bufs), pw.k_cls,
                            pw.tile, pw.shape, pw.fset)
        before = PK.launches
        y = ops.ksplit_matmul_kernel(x, w).cpu()
        assert PK.launches == before + 1
        y1 = ops.ksplit_matmul_kernel(x[:1].contiguous(), w).cpu()
        assert torch.equal(y1, y[:1])          # batch invariance
        plain = PK.ksplit_gemm_plain(
            xp, [pw.bufs[c] for c in pw.fset.class_order],
            [pw.fset.fmt(c) for c in pw.fset.class_order])
        bound = _bound(xp, pw)
        assert np.all(np.abs((y - plain).numpy()) <= bound)


#: the card checks' format sets: operand storage fp32, bf16, fp16, e4m3
#: and e5m2 into bf16, fp16, fp32 and int8_pt C classes
CARD_SETS = ("fp8_e4m3+bf16+fp32", "fp8_e4m3+fp16+fp32",
             "fp8_e5m2+fp16+fp32", "int8_pt+bf16+fp32")
#: (ratio_high, ratio_low8, edge case): the five mixes, then the edge
#: cases on a mix with every class
CARD_CASES = ((0.0, 0.0, None), (0.5, 0.0, None), (1.0, 0.0, None),
              (0.4, 0.2, None), (0.4, 0.3, None),
              (0.3, 0.3, "e4m3-overflow"), (0.3, 0.3, "inf*0"),
              (0.3, 0.3, "subnormal"))


def card_operands(shape, edge, seed=0):
    """Dense A, B, C (numpy fp32) for a card check: standard normal, then
    the edge case — |a| = 1000 (NaN in an e4m3 tile), rows of A at ±inf
    against rows of B at 0 (inf·0), or A scaled to bf16/fp32 subnormals
    with C = 0."""
    rng = np.random.default_rng(seed)
    m, k, n = shape
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((m, k), (k, n), (m, n)))
    if edge == "e4m3-overflow":
        a[::7, ::5] = 1e3
    elif edge == "inf*0":
        a[1, :] = np.inf
        a[5, 3] = -np.inf
        b[3, :] = 0.0
        b[:, 2] = 0.0
    elif edge == "subnormal":
        a *= np.float32(1e-39)
        c[:] = 0.0
    return a, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("key", CARD_SETS)
@pytest.mark.parametrize("t", PMT.TILE_SIZES)
def test_tile_kernel_matches_plain_on_card(cuda, t, key, case):
    hi, q, edge = case
    fs = PF.FormatSet.from_key(key)
    dense = card_operands((2 * t, 3 * t, 2 * t), edge)
    maps = [PP.make_map(d.shape, t, PP.Policy("ratio", hi, q, seed=i),
                        fset=fs) for i, d in enumerate(dense)]
    pm = [PL.MPMatrix.from_dense(torch.from_numpy(d), p, t, fs)
          for d, p in zip(dense, maps)]
    specs = PMT.format_specs(fs)
    beta = 0.0 if edge == "subnormal" else 0.5
    before = PMT.launches
    outs = PMT.mp_gemm_tile_multi(
        *[tuple(b.to(cuda) for b in x.bufs) for x in pm], *maps, tile=t,
        specs=specs, alpha=1.5, beta=beta)
    assert PMT.launches == before + 1
    plain = PMT.mp_gemm_tile_plain(
        pm[0].bufs, pm[1].bufs, pm[2].bufs, *maps, tile=t, specs=specs,
        alpha=1.5, beta=beta)
    kd = sum(o.float().cpu() for o in outs)
    pd = sum(o.float() for o in plain)
    # NaN counts as equal where both have it, as an infinite error where
    # only one does
    assert _within(pm, maps, t, kd, pd, 1.5, beta) <= 1.0


@pytest.mark.parametrize("key", CARD_SETS + ("int4_pt+bf16+fp32",
                                             "fp8_e5m2+bf16+fp32",
                                             "fp16+split2_fp16"))
@pytest.mark.parametrize("t", PMT.TILE_SIZES)
def test_launch_plan_takes_tensor_cores_for_bf16_fp16_classes(t, key):
    """The kernel's path per C class: wgmma exactly for a bf16 or fp16
    compute class at t >= 64, the staged fp32 FMA path for the others
    there, the simple dot below 64; shared memory within an H100 block's
    227 KB."""
    fs = PF.FormatSet.from_key(key)
    specs = PMT.format_specs(fs)
    plan = PMT.launch_plan(t, specs)
    for (compute, _, _), path in zip(specs, plan["paths"]):
        if t < 64:
            assert path == "simple"
        elif compute in (torch.bfloat16, torch.float16):
            assert path == "tensor_core"
        else:
            assert path == "fp32"
    assert 0 <= plan["smem"] <= 227 * 1024   # what an H100 block may use
    assert plan["smem"] == (PMT.staged_smem_bytes(t) if t >= 64 else 0)
    assert plan["threads"] == {16: 256, 32: 1024, 64: 128, 128: 256}[t]
    codes = np.arange(len(specs)).reshape(1, -1)
    assert PMT.paths_taken(plan, codes) == set(plan["paths"])


def test_path_counters_stay_zero_on_cpu():
    """On CPU tensors the wrappers run their plain versions: no launch,
    no path counted."""
    _, pm, maps, _ = _tile_case(SETS[0], 64, (128, 128, 64), (0.4, 0.3))
    ops.reset_launch_counts()
    ops.mp_gemm(*pm, alpha=1.0, beta=0.5)
    counts = ops.path_launch_counts()
    assert set(counts) == {"mp_gemm_tile", "grouped_gemm"}
    assert all(v == 0 for c in counts.values() for v in c.values())
    assert set(counts["mp_gemm_tile"]) == set(PMT.PATHS)


def test_staged_tiles_need_16_byte_aligned_buffers():
    x = torch.zeros(65, dtype=torch.float32)
    PMT.check_aligned((x[:64],), 64)
    PMT.check_aligned((x[1:],), 32)        # the simple dot takes any
    with pytest.raises(ValueError):
        PMT.check_aligned((x[1:],), 64)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

_CONVERT = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
            (jnp.float16, torch.float16),
            (jnp.float8_e4m3fn, torch.float8_e4m3fn),
            (jnp.float8_e5m2, torch.float8_e5m2)]


def _convert_input(seed=0):
    """fp32 over 1e-12..1e6 plus the rounding edges of every target: e4m3
    overflow (NaN above 464), fp16 and e5m2 overflow to inf, subnormals,
    ±inf, NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 96))
         * 10.0 ** rng.uniform(-12, 6, (64, 96))).astype(np.float32)
    edges = [0.0, -0.0, 448.0, 464.0, 464.01, -480.0, 1e3, 57344.0,
             61439.99, 61440.0, 65504.0, 65520.0, 1e5, np.inf, -np.inf,
             np.nan, 2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -17, 2.0 ** -24,
             2.0 ** -25, 3 * 2.0 ** -25, 2.0 ** -133, 3e38]
    x.reshape(-1)[:len(edges)] = edges
    return x


def _same_bits(j, p: torch.Tensor) -> bool:
    """Bit-equal where the reference holds a number, NaN where it holds
    NaN (NaN payloads differ between the frameworks)."""
    j = np.asarray(j)
    ints = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16),
            4: (np.uint32, torch.int32)}[j.itemsize]
    nan = np.isnan(j.astype(np.float32))
    pb = p.view(ints[1]).numpy().view(ints[0])
    return bool(np.array_equal(np.isnan(p.float().numpy()), nan)
                and np.array_equal(j.view(ints[0])[~nan], pb[~nan]))


@pytest.mark.parametrize("jdt,pdt", _CONVERT)
def test_convert_plain_matches_reference_bit_for_bit(jdt, pdt):
    from repro.kernels import ops as JO
    from repro.kernels import ref as KR
    from repro_torch.kernels import convert as PC
    x = _convert_input()
    plain = PC.convert_plain(torch.from_numpy(x), pdt)
    assert plain.dtype == pdt and tuple(plain.shape) == x.shape
    assert _same_bits(KR.convert_ref(jnp.asarray(x), jdt), plain)
    # ... and the Pallas kernel as the reference's own tests run it
    y = JO.convert_tiles(jnp.asarray(x), jdt, bm=32, bn=32)
    assert _same_bits(y, plain)
    before = PC.launches
    assert torch.equal(ops.convert_tiles(torch.from_numpy(x), pdt).view(
        torch.uint8), plain.view(torch.uint8))
    assert PC.launches == before


@pytest.mark.gpu
def test_convert_kernel_matches_plain_on_card(cuda):
    from repro_torch.kernels import convert as PC
    x = torch.from_numpy(_convert_input(1))
    for _, pdt in _CONVERT:
        before = PC.launches
        got = PC.convert(x.to(cuda), pdt).cpu()
        assert PC.launches == before + 1
        want = PC.convert_plain(x, pdt)
        nan = torch.isnan(want.float())
        ints = {1: torch.uint8, 2: torch.int16,
                4: torch.int32}[want.element_size()]
        assert torch.equal(torch.isnan(got.float()), nan)
        assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


def test_layout_storage_cast_on_cpu_is_the_plain_cast():
    """On CPU tensors the layouts' storage cast is the format's own
    (``to_buffer``) and launches nothing."""
    from repro_torch.kernels import convert as PC
    fs = PF.DEFAULT_FORMATS
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 300).astype(
        np.float32))
    cls = rng.integers(0, len(fs), (4, 4)).astype(np.int8)
    before = PC.launches
    m = PL.MPMatrix.from_dense(w, cls, 16, fs)
    assert PC.launches == before
    sel = torch.from_numpy(PL.expand_map(cls, 16))
    for code in fs.codes:
        masked = torch.where(sel == code, w, torch.zeros_like(w))
        want = fs.fmt(code).to_buffer(masked, tile=16)
        assert torch.equal(torch.isnan(m.bufs[code].float()),
                           torch.isnan(want.float()))
        assert torch.equal(m.bufs[code].float().nan_to_num(),
                           want.float().nan_to_num())


@pytest.mark.gpu
def test_layout_storage_cast_on_card_runs_convert(cuda):
    """On the card MPMatrix/CompactMPMatrix storage casts launch the
    convert kernel and store the CPU layout's bits."""
    from repro_torch.kernels import convert as PC
    fs = PF.DEFAULT_FORMATS
    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.standard_normal((256, 256)) * 300).astype(
        np.float32))
    cls = rng.integers(0, len(fs), (2, 2)).astype(np.int8)
    before = PC.launches
    for layout in (PL.MPMatrix, PL.CompactMPMatrix):
        got = layout.from_dense(w.to(cuda), cls, 128, fs).to_dense().cpu()
        want = layout.from_dense(w, cls, 128, fs).to_dense()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert PC.launches > before
