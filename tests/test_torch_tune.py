"""Dispatch of ``repro_torch``: which path each device spec picks, the
plan registry/cache and its counters, and ``mp_matmul`` end to end on CPU
tensors.

The port keeps its own plan cache (``REPRO_TORCH_TUNE_CACHE``); every test
here points it at ``tmp_path`` and gets a fresh registry and metrics, so
nothing leaks to other tests or to the JAX package's cache.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import layout as PL
from repro_torch.core.accuracy import check_against_fp64
from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.core.precision import Policy, make_map
from repro_torch.kernels import ops
from repro_torch.obs import metrics as M
from repro_torch.tune import costmodel as CM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as D
from repro_torch.tune import search as S

#: InternLM2-1.8B's KSplit shapes on one card (wq, wk/wv, up/gate, lm_head)
INTERNLM2_KN = ((2048, 2048), (2048, 1024), (2048, 8192), (2048, 92544))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv(S.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(D, "_REGISTRY", {})
    monkeypatch.setattr(S, "_default_cache", None)
    monkeypatch.setattr(M, "_DEFAULT", M.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear_prob(k, n, m, fset=DEFAULT_FORMATS):
    return CM.GemmProblem(
        m=m, n=n, k=k, tile=128, op="linear", b_high=0.5,
        b_k_constant=True, c_classes=(fset.low,), formats=fset.key())


@pytest.mark.parametrize("k,n", INTERNLM2_KN)
@pytest.mark.parametrize("m", [1, 4, 7])
def test_h100_routes_every_linear_to_the_ksplit_kernel(k, n, m):
    plan, src = D.resolve_plan(_linear_prob(k, n, m),
                               DV.DEVICE_TABLE["gpu-h100"], D.LINEAR_PATHS)
    assert plan.path == "ksplit_cuda" and src == "model"


@pytest.mark.parametrize("k,n", INTERNLM2_KN[:2])
def test_cpu_routes_linears_to_the_plain_path(k, n):
    plan, _ = D.resolve_plan(_linear_prob(k, n, 4), DV.DEVICE_TABLE["cpu"],
                             D.LINEAR_PATHS)
    assert plan.path == "ksplit_torch"


def _mp_prob(size, t, mix=(0.5, 0.0)):
    maps = [make_map((size, size), t, Policy("ratio", *mix, seed=s))
            for s in range(3)]
    return CM.GemmProblem.from_maps(*maps, t)


@pytest.mark.parametrize("size,mix", [(1024, (0.5, 0.0)), (1024, (0.4, 0.2)),
                                      (4096, (1.0, 0.0)),
                                      (4096, (0.0, 0.0))])
def test_h100_routes_mp_matmul_to_the_tile_kernel(size, mix):
    plan, _ = D.resolve_plan(_mp_prob(size, 128, mix),
                             DV.DEVICE_TABLE["gpu-h100"])
    assert plan.path == "tile"


@pytest.mark.parametrize("t", [16, 32, 64, 128])
@pytest.mark.parametrize("mix", [(0.0, 0.0), (0.5, 0.0), (1.0, 0.0),
                                 (0.4, 0.2)])
def test_tile_and_grouped_compute_priced_by_the_unit_each_class_runs_on(
        t, mix):
    """The tile and grouped kernels run a bf16/fp16-compute C tile on the
    tensor cores at t = 64 and 128, every other one on the fp32 pipes:
    the cost model prices each C tile's 2·t²·K at that unit's peak.  The
    split kernel runs its simple C tiles on the same staged dot, so the
    split path prices them the same way."""
    dev = DV.DEVICE_TABLE["gpu-h100"]
    size = 512
    maps = [make_map((size, size), t, Policy("ratio", *mix, seed=s))
            for s in range(3)]
    prob = CM.GemmProblem.from_maps(*maps, t)
    fp32_tiles = int((maps[2] == DEFAULT_FORMATS.high).sum())
    tc_tiles = maps[2].size - fp32_tiles   # bf16 and fp8 (bf16 compute)
    if t < 64:
        tc_tiles, fp32_tiles = 0, maps[2].size
    per_tile = 2.0 * t * t * size
    want = per_tile * (tc_tiles / (dev.low_tflops * 1e12)
                       + fp32_tiles / (dev.fp32_tflops * 1e12))
    for path in ("tile", "grouped"):
        got = CM.predict_time(CM.GemmPlan(path, t, t, t), prob,
                              dev)["compute_s"]
        assert got == pytest.approx(want, rel=1e-9)
    split = CM.predict_time(CM.GemmPlan("split", t, t, t), prob, dev)
    assert split["compute_s"] == pytest.approx(want, rel=1e-9)


SPLIT_KEYS = ("fp8_e4m3+bf16+split2_fp16", "fp8_e4m3+bf16+split3_e5m2",
              "int8_pt+bf16+split2_fp16")


@pytest.mark.parametrize("t", [16, 32, 64, 128])
@pytest.mark.parametrize("key", SPLIT_KEYS)
@pytest.mark.parametrize("mix", [(0.0, 0.0), (0.5, 0.0), (1.0, 0.0),
                                 (0.4, 0.2)])
def test_split_classes_priced_as_slice_passes_by_unit(t, key, mix):
    """A split C tile does slices² passes of 2·t²·K at its compute dtype
    (fp16 for split2_fp16, bf16 for split3_e5m2): on the tensor cores at
    t = 64 and 128, on the fp32 pipes below; its simple classes are
    priced as the tile kernel prices them (fp32 and integer classes on
    the fp32 pipes)."""
    dev = DV.DEVICE_TABLE["gpu-h100"]
    fs = FormatSet.from_key(key)
    size = 512
    maps = [make_map((size, size), t, Policy("ratio", *mix, seed=s),
                     fset=fs) for s in range(3)]
    prob = CM.GemmProblem.from_maps(*maps, t, fset=fs)
    want = 0.0
    for c in np.unique(maps[2]):
        f = fs.fmt(int(c))
        passes = getattr(f, "slices", 1) ** 2
        tc = t >= 64 and f.compute_dtype in (torch.bfloat16, torch.float16)
        rate = dev.low_tflops if tc else dev.fp32_tflops
        want += (2.0 * t * t * size * int((maps[2] == c).sum()) * passes
                 / (rate * 1e12))
    got = CM.predict_time(CM.GemmPlan("split", t, t, t), prob, dev)
    assert got["compute_s"] == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("shape", [(8064, 128, 8064), (8192, 8192, 128),
                                   (4096, 4096, 4096), (1024, 1024, 1024)])
@pytest.mark.parametrize("key", SPLIT_KEYS[:2])
@pytest.mark.parametrize("hi", [0.0, 0.5, 1.0])
def test_split_pricing_moves_no_routing(t, shape, key, hi):
    """With split passes priced on the tensor cores, GEMMs with split C
    classes still resolve to the split kernel, among the solve's paths
    and among mp_matmul's: cheaper passes move no routing decision in
    these shapes (the ref oracle was dearer before and is now more so)."""
    m, k, n = shape
    fs = FormatSet.from_key(key)
    maps = [make_map(sh, t, Policy("ratio", hi, 0.0, seed=s), fset=fs)
            for s, sh in enumerate(((m, k), (k, n), (m, n)))]
    maps[2][0, 0] = fs.high   # at least one split C tile
    prob = CM.GemmProblem.from_maps(*maps, t, beta=1.0, fset=fs)
    dev = DV.DEVICE_TABLE["gpu-h100"]
    assert D.resolve_plan(prob, dev, D.SOLVE_PATHS)[0].path == "split"
    assert D.resolve_plan(prob, dev)[0].path == "split"


@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("shape", [(8064, 128, 8064), (8192, 8192, 128),
                                   (4096, 4096, 4096)])
@pytest.mark.parametrize("hi", [0.0, 0.05, 0.5, 1.0])
def test_h100_keeps_the_solve_shapes_on_the_tile_kernel(t, shape, hi):
    """Cheaper tensor-core classes change no routing: the solve's GEMM
    shapes still resolve to the tile kernel among the solve's paths."""
    m, k, n = shape
    maps = [make_map(sh, t, Policy("ratio", hi, 0.0, seed=s))
            for s, sh in enumerate(((m, k), (k, n), (m, n)))]
    for beta in (0.0, 1.0):
        prob = CM.GemmProblem.from_maps(*maps, t, alpha=-1.0, beta=beta)
        plan, _ = D.resolve_plan(prob, DV.DEVICE_TABLE["gpu-h100"],
                                 D.SOLVE_PATHS)
        assert plan.path == "tile"


def test_tile_kernel_only_for_its_tile_sizes():
    prob = _mp_prob(64, 8)
    bad = CM.validate_plan(CM.GemmPlan("tile", 8, 8, 8), prob,
                           DV.DEVICE_TABLE["gpu-h100"])
    assert bad and "tile kernel" in bad[0]
    plan, _ = D.resolve_plan(prob, DV.DEVICE_TABLE["gpu-h100"])
    assert plan.path == "ref"
    assert D.resolve_plan(_mp_prob(256, 128), DV.DEVICE_TABLE["cpu"])[
        0].path == "ref"


def test_kernel_paths_invalid_without_the_kernels():
    for kind in ("cpu", "gpu-a100"):
        dev = DV.DEVICE_TABLE[kind]
        assert CM.validate_plan(CM.GemmPlan("ksplit_cuda", 128, 128, 128),
                                _linear_prob(2048, 2048, 4), dev)
        assert CM.validate_plan(CM.GemmPlan("tile", 128, 128, 128),
                                _mp_prob(256, 128), dev)


def test_detect_device_and_forcing(monkeypatch):
    assert DV.detect_device("cpu").kind == "cpu"
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    assert DV.detect_device("cpu").kind == "gpu-h100"
    monkeypatch.setenv(DV.DEVICE_ENV, "tpu-v5e")
    with pytest.raises(KeyError):
        DV.detect_device()


@pytest.mark.parametrize("name,cap,kind", [
    ("NVIDIA GH200 480GB", (9, 0), "gpu-h100"),
    ("NVIDIA H200", (9, 0), "gpu-h100"),
    ("NVIDIA H100 80GB HBM3", (9, 0), "gpu-h100"),
    ("NVIDIA H100 lookalike", (8, 9), "gpu-a100"),
    ("NVIDIA A100-SXM4-80GB", (8, 0), "gpu-a100")])
def test_cuda_spec_follows_compute_capability_not_name(monkeypatch, name,
                                                       cap, kind):
    """A card gets the kernels' spec by compute capability 9.0 (what
    sm_90a runs on), whatever its name says."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: name)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=None: cap)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    DV._cuda_kind.cache_clear()
    try:
        assert DV.detect_device(torch.device("cuda", 0)).kind == kind
        assert DV.DEVICE_TABLE[kind].kernels == (kind == "gpu-h100")
    finally:
        DV._cuda_kind.cache_clear()


def test_resolution_sources_and_counters(tmp_path):
    dev = DV.DEVICE_TABLE["gpu-h100"]
    prob = _linear_prob(2048, 8192, 4)
    assert D.resolve_plan(prob, dev, D.LINEAR_PATHS)[1] == "model"
    assert D.resolve_plan(prob, dev, D.LINEAR_PATHS)[1] == "registry"
    assert D.resolution_counters() == {"model": 1, "registry": 1}
    assert D.fresh_resolutions() == 1
    # persisted plans come back as cache hits in a fresh registry
    key = S.plan_key(dev, prob)
    S.default_cache().put(key, D._REGISTRY[key])
    D.clear_registry()
    fresh = S.PlanCache(str(tmp_path / "plans.json"))
    assert fresh.get(key).path == "ksplit_cuda"
    assert D.resolve_plan(prob, dev, D.LINEAR_PATHS)[1] == "cache"


def test_cache_retires_plans_of_redefined_formats(tmp_path):
    dev = DV.DEVICE_TABLE["gpu-h100"]
    key = S.plan_key(dev, _linear_prob(2048, 1024, 1))
    path = tmp_path / "plans.json"
    S.PlanCache(str(path)).put(key, CM.GemmPlan("ksplit_cuda"))
    raw = json.loads(path.read_text())
    raw["formats"]["bf16"] = "bf16:some-other-definition"
    path.write_text(json.dumps(raw))
    assert S.PlanCache(str(path)).get(key) is None


def test_own_cache_never_the_reference_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    assert S.cache_path() == str(tmp_path / "plans.json")
    monkeypatch.delenv(S.CACHE_ENV)
    assert S.cache_path().endswith("repro-torch-tune/plans.json")


def test_linear_matmul_on_forced_h100_spec_runs_the_kernel_route(
        monkeypatch):
    """The card's dispatch decisions on CPU tensors: ``ksplit_cuda`` is
    chosen and its wrapper runs the plain version."""
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 48), generator=g)
    ks = PL.KSplitWeight.from_dense(w, np.array([2, 2, 1, 0], np.int8), 16)
    x = torch.randn((2, 3, 64), generator=g).to(torch.bfloat16)
    y = D.linear_matmul(x, ks)
    assert y.shape == (2, 3, 48)
    assert D.dispatch_counts("linear") == {"ksplit_cuda": 1}
    ref = PL.ksplit_matmul(x, ks)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    # an unsorted class vector keeps the gathering path
    ku = PL.KSplitWeight.from_dense(w, np.array([1, 2, 0, 2], np.int8), 16)
    D.linear_matmul(x, ku)
    assert D.dispatch_counts("linear") == {"ksplit_cuda": 1,
                                           "ksplit_torch": 1}


@pytest.mark.parametrize("forced,path", [(None, "ref"), ("gpu-h100", "tile")])
def test_mp_matmul_end_to_end_on_cpu(monkeypatch, forced, path):
    if forced:
        monkeypatch.setenv(DV.DEVICE_ENV, forced)
    t = 16
    rng = np.random.default_rng(1)
    dense = [rng.standard_normal((64, 64)).astype(np.float32)
             for _ in range(3)]
    fs = FormatSet.from_key("fp8_e4m3+bf16+fp32")
    maps = [make_map((64, 64), t, Policy("ratio", 0.4, 0.3, seed=s), fset=fs)
            for s in range(3)]
    A, B, C = (PL.MPMatrix.from_dense(torch.from_numpy(d), p, t, fs)
               for d, p in zip(dense, maps))
    ops.reset_launch_counts()
    out = D.mp_matmul(A, B, C, beta=0.5)
    assert D.dispatch_counts("mp_gemm") == {path: 1}
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    rep = check_against_fp64(out.to_dense().numpy(), *dense, *maps, t, fs,
                             beta=0.5)
    assert rep["ok"], rep["worst_ratio"]


def test_ksplit_paths_of_mp_matmul_agree(monkeypatch):
    """A K-constant B map makes both ksplit paths valid; forced through
    each plan, the results agree with the reference to fp32 order."""
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    t = 16
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    pa = make_map((32, 64), t, Policy("ratio", 0.5, seed=1))
    pb = np.repeat(np.array([[2], [1], [2], [0]], np.int8), 3, axis=1)
    A = PL.MPMatrix.from_dense(a, pa, t)
    B = PL.MPMatrix.from_dense(b, pb, t)
    outs = [D.mp_matmul(A, B, plan=CM.GemmPlan(p, t, t, t)).to_dense()
            for p in ("ksplit_torch", "ksplit_cuda")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        D.mp_matmul(A, B, plan=CM.GemmPlan("ksplit_cuda", 8, 8, 8))


def test_tune_linear_params_and_bucket_prefetch():
    g = torch.Generator().manual_seed(0)
    from repro_torch.core.linear import init_mp_linear
    pol = Policy("ratio", 0.5)
    params = {"a": init_mp_linear(g, 64, 32, pol, tile=16, device="cpu"),
              "b": [init_mp_linear(g, 64, 32, pol, tile=16, device="cpu"),
                    init_mp_linear(g, 32, 64, pol, split="nsplit", tile=16,
                                   device="cpu")]}
    plans = D.tune_linear_params(params, m_hint=4)
    assert len(plans) == 1            # two linears share one signature
    table = D.resolve_plans_for_buckets({"default": params},
                                        [("default", 4, 8), ("default", 4,
                                                             16)])
    assert set(table) == {("default", 1), ("default", 4)}
    with pytest.raises(KeyError):
        D.resolve_plans_for_buckets({"default": params}, [("x", 4, 8)])
    assert obs.metrics_registry() is M._DEFAULT
