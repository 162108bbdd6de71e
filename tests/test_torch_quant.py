"""Port parity of quantized inference (twin of ``tests/test_quant.py``).

Block scores, class maps, ``quantize_params``' rebuilt buffers and
``map_report`` are bit for bit the reference's, also on a whole model
(the reference's stacked layers share one map per weight name; the
port's layer list does too).  A quantized variant serves through
``Engine(..., variants=...)`` beside the default weights: batched tokens
equal unbatched and a replay, both buckets appear, and every linear takes
the path its map's sortedness calls for (a calibrated map is not sorted
by class, so it takes the gathering path, as in the reference).

No twins: ``test_store_and_quantize_warn_once_per_process`` (the
deprecated ``store()``/``quantize()`` shims are not ported) and
``test_reregistration_error_names_differing_fields`` and
``test_hygiene_accepts_int_format_plan_keys`` (the registry's field-diff
message and ``tune/hygiene.py`` come with ``ROADMAP.md`` queue 1,
item 9).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.formats as JRF
import repro.quant as JRQ
from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.core.formats import format_set as jformat_set
from repro.core.layout import KSplitWeight as JKSplit
from repro.models import transformer as JT
from repro_torch import formats as RF
from repro_torch import quant as RQ
from repro_torch import tree as TR
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.core.formats import DEFAULT_FORMATS, format_set
from repro_torch.core.layout import KSplitWeight, ksplit_matmul
from repro_torch.core.linear import init_mp_linear
from repro_torch.core.precision import Policy
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.quant import (ActStats, block_scores, calibrate_ksplit,
                               calibrated_cls, map_report, quantize_params)
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import numpy_tree

INT8_SET = format_set("int8_pt", "fp32")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    from repro.tune import dispatch as JD
    from repro.tune import search as JS
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(JD, "_REGISTRY", {})
    monkeypatch.setattr(JS, "_default_cache", None)
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loud_operator(n=64, tile=16, loud_frac=0.25, gain=30.0, seed=7):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal((8, n)).astype(np.float32)
    x[:, : int(n * loud_frac)] *= gain
    return w, x


def test_calibration_assigns_high_to_loudest_blocks():
    n, t = 64, 16
    w, x = _loud_operator(n, t, loud_frac=0.25)
    scores = block_scores(torch.from_numpy(w),
                          ActStats().observe(torch.from_numpy(x)).get(n), t)
    want = JRQ.block_scores(w, JRQ.ActStats().observe(x).get(n), t)
    assert scores.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(scores, want)
    assert scores[0] > scores[1:].max()
    cls = calibrated_cls(scores, 0.25, INT8_SET)
    assert cls[0] == INT8_SET.high
    assert (cls[1:] == INT8_SET.low).all()
    w2, x2 = _loud_operator(n, t, loud_frac=0.5)
    cls2 = calibrated_cls(
        block_scores(w2, ActStats().observe(x2).get(n), t), 0.5, INT8_SET)
    assert (cls2[:2] == INT8_SET.high).all()
    assert (cls2[2:] == INT8_SET.low).all()


def test_calibration_is_deterministic_and_ties_break_by_index():
    w, x = _loud_operator()
    am = ActStats().observe(x).get(64)
    a = calibrated_cls(block_scores(w, am, 16), 0.25, INT8_SET)
    b = calibrated_cls(block_scores(w, am, 16), 0.25, INT8_SET)
    np.testing.assert_array_equal(a, b)
    tied = calibrated_cls(np.ones(8, np.float64), 0.25, INT8_SET)
    assert (tied[:2] == INT8_SET.high).all()
    assert (tied[2:] == INT8_SET.low).all()
    scores = np.random.default_rng(1).integers(0, 3, 16).astype(np.float32)
    for ratio in (0.0, 0.25, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            calibrated_cls(scores, ratio, INT8_SET),
            JRQ.calibrated_cls(scores, ratio, jformat_set("int8_pt", "fp32")))


def test_act_stats_online_fold_and_unobserved_dims():
    s = ActStats()
    s.observe(np.array([[1.0, -2.0], [0.5, 1.0]]))
    s.observe(torch.tensor([[-3.0, 0.1]]))
    np.testing.assert_allclose(s.get(2), [3.0, 2.0])
    np.testing.assert_array_equal(s.get(5), np.ones(5, np.float32))
    x = np.random.default_rng(2).standard_normal((3, 4, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(RQ.activation_absmax(torch.from_numpy(x)),
                                  JRQ.activation_absmax(x))


def _ksplit_pair(w, cls, t, names=("int8_pt", "fp32")):
    jw = JKSplit.from_dense(jnp.asarray(w), cls, t, jformat_set(*names))
    pw = KSplitWeight.from_dense(torch.from_numpy(w), cls, t,
                                 format_set(*names))
    return jw, pw


def test_calibrated_map_beats_uniform_int8_forward_error():
    n, t = 64, 16
    w, x = _loud_operator(n, t)
    exact = np.asarray(x, np.float64) @ np.asarray(w, np.float64)

    def rel_err(cls):
        jw, W = _ksplit_pair(w, cls, t)
        y = ksplit_matmul(torch.from_numpy(x), W).double().numpy()
        return float(np.abs(y - exact).max() / np.abs(exact).max()), W, jw

    uni, _, _ = rel_err(np.full(n // t, INT8_SET.low, np.int8))
    mixed, W, jw = rel_err(calibrated_cls(
        block_scores(w, ActStats().observe(x).get(n), t), 0.25, INT8_SET))
    assert mixed < uni / 2.0
    rep = map_report(W)
    assert rep["classes"] == {"int8_pt": 3, "fp32": 1}
    assert rep["bytes_vs_fp32"] < 0.5
    assert rep == JRQ.map_report(jw)


def test_quantize_params_rebuilds_ksplit_passes_through_nsplit():
    pol = Policy(kind="ratio", ratio_high=0.5)
    gen = torch.Generator().manual_seed(0)
    tree = {
        "k": init_mp_linear(gen, 64, 32, pol, tile=16, device="cpu"),
        "n": init_mp_linear(gen, 64, 32, pol, tile=16, split="nsplit",
                            device="cpu"),
        "dense": torch.ones((4, 4)),
    }
    stats = ActStats().observe(torch.randn((8, 64), generator=gen))
    q = quantize_params(tree, stats, fset=INT8_SET, ratio_high=0.25)
    assert q["k"].w.fset == INT8_SET
    assert q["k"].w.storage_bytes() < tree["k"].w.storage_bytes()
    assert q["n"] is tree["n"]
    assert q["dense"] is tree["dense"]
    x = torch.randn((4, 64), generator=gen)
    y = ksplit_matmul(x, q["k"].w)
    ref = ksplit_matmul(x, tree["k"].w)
    assert float((y - ref).abs().max()) <= 0.1 * float(ref.abs().max())
    # the default set keeps the repo default's HIGH format
    assert quantize_params(tree)["k"].w.fset == format_set(
        "int8_pt", DEFAULT_FORMATS.names[-1])


def test_calibrate_ksplit_layers_share_one_map():
    """The layers of one weight name (the reference's stacked weight) get
    ONE map, scored by the loudest layer per block; each layer decodes
    like a per-layer rebuild, and the buffers equal the reference's
    stacked calibration bit for bit."""
    n, t = 64, 16
    kt = n // t
    rng = np.random.default_rng(3)
    d0 = rng.standard_normal((n, n)).astype(np.float32)
    d1 = rng.standard_normal((n, n)).astype(np.float32)
    d0[:t] *= 40.0
    d1[2 * t:3 * t] *= 40.0
    hi = np.full(kt, INT8_SET.high, np.int8)
    layers = [KSplitWeight.from_dense(torch.from_numpy(d), hi, t, INT8_SET)
              for d in (d0, d1)]
    out = calibrate_ksplit(layers, np.ones(n, np.float32), INT8_SET, 0.5)
    assert isinstance(out, list) and len(out) == 2
    cls = out[0].k_cls
    assert set(np.flatnonzero(cls == INT8_SET.high)) == {0, 2}
    assert all(np.array_equal(o.k_cls, cls) for o in out)
    for lw, dense in zip(out, (d0, d1)):
        per_layer = KSplitWeight.from_dense(torch.from_numpy(dense), cls, t,
                                            INT8_SET)
        assert torch.equal(lw.to_dense(), per_layer.to_dense())
    jset = jformat_set("int8_pt", "fp32")
    jl = [JKSplit.from_dense(jnp.asarray(d), hi, t, jset) for d in (d0, d1)]
    stacked = JKSplit(tuple(jnp.stack([a, b]) for a, b in zip(jl[0].bufs,
                                                              jl[1].bufs)),
                      jl[0].k_cls, t, jl[0].shape, jset)
    jout = JRQ.calibrate_ksplit(stacked, np.ones(n, np.float32), jset, 0.5)
    np.testing.assert_array_equal(np.asarray(jout.k_cls.arr), cls)
    for code, jb in enumerate(jout.bufs):
        got = torch.stack([o.bufs[code] for o in out])
        np.testing.assert_array_equal(np.asarray(jb), got.numpy())
    assert map_report(out) == JRQ.map_report(jout)


@pytest.mark.parametrize("names,ratio", [(("int8_pt", "fp32"), 0.25),
                                         (("int4_pt", "int8_pt", "fp32"),
                                          0.5)])
def test_quantize_params_matches_reference_on_model(names, ratio):
    """The reference's ``quantize_params`` on its stacked reduced model and
    the port's on the bridged layer list, with the same activation
    statistics: equal maps, bit-equal buffers, equal reports."""
    jcfg = jreduced(load_all()["internlm2-1.8b"], tp=2)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(numpy_tree(jp), reduced(get("internlm2-1.8b")),
                           "cpu")
    acts = np.random.default_rng(4).standard_normal((6, 64)).astype(
        np.float32)
    acts[:, :8] *= 20.0
    jq = JRQ.quantize_params(jp, JRQ.ActStats().observe(acts),
                             fset=jformat_set(*names), ratio_high=ratio)
    pq = quantize_params(pp, ActStats().observe(acts),
                         fset=format_set(*names), ratio_high=ratio)
    assert pq["layers"][0]["attn"]["wo"] is pp["layers"][0]["attn"]["wo"]
    assert pq["embed"] is pp["embed"]
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    leaves = TR.walk(pq)
    assert len(flat) == len(leaves)
    for (path, a), leaf in zip(flat, leaves):
        b = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
        want = tensor_from_numpy(np.asarray(a), "cpu")
        assert b.dtype == want.dtype and b.shape == want.shape, leaf.key
        assert not b.numel() or torch.equal(b.contiguous().view(torch.uint8),
                           want.view(torch.uint8)), leaf.key
    jk = {"/".join(str(k) for k in p): w for p, w in
          jax.tree_util.tree_flatten_with_path(
              jq, is_leaf=lambda v: isinstance(v, JKSplit))[0]
          if isinstance(w, JKSplit)}
    pk = {"lm_head": pq["lm_head"].w}
    for name in ("wq", "wk", "wv"):
        pk[f"blocks/{name}"] = [lp["attn"][name].w for lp in pq["layers"]]
    for name in ("up", "gate"):
        pk[f"blocks/{name}"] = [lp["mlp"][name].w for lp in pq["layers"]]
    assert len(jk) == len(pk)
    for jpath, jw in jk.items():
        key = "lm_head" if jpath.startswith("['lm_head']") else \
            "blocks/" + jpath.split("'")[-2]
        rep = map_report(pk[key])
        assert rep == JRQ.map_report(jw), key
        assert set(rep["classes"]) <= set(names)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "gemma3-4b"])
def test_quantize_params_matches_reference_per_segment_position(arch):
    """A model whose layers differ by place in the pattern (xLSTM's sLSTM
    and mLSTM cells; gemma3's five local layers, its global one and a
    tail) gets one map per place of the reference's segments, as the
    reference's stacked leaves do: every leaf bit for bit."""
    jcfg = jreduced(load_all()[arch], tp=2)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(numpy_tree(jp), reduced(get(arch)), "cpu")
    acts = np.random.default_rng(5).standard_normal((6, 64)).astype(
        np.float32)
    acts[:, 8:16] *= 20.0
    jq = JRQ.quantize_params(jp, JRQ.ActStats().observe(acts))
    pq = quantize_params(pp, ActStats().observe(acts))
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    leaves = TR.walk(pq)
    assert [leaf.name for leaf in leaves] == [
        "/".join(str(k) for k in p) for p, _ in flat]
    for (_, a), leaf in zip(flat, leaves):
        b = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
        want = tensor_from_numpy(np.asarray(a), "cpu")
        assert b.dtype == want.dtype and b.shape == want.shape, leaf.key
        assert not b.numel() or torch.equal(b.contiguous().view(torch.uint8),
                           want.view(torch.uint8)), leaf.key


def test_quant_and_formats_facades_export_surface():
    assert RF.__all__ == JRF.__all__
    assert RQ.__all__ == JRQ.__all__
    assert RF.get_format("int8_pt").qmax == 127
    assert RF.FormatSet.parse("int8:d") == INT8_SET
    assert set(RF.registered_formats()) == set(RF.registry_signatures())
    with pytest.raises(AttributeError):
        RQ.not_an_api
    with pytest.raises(AttributeError):
        RF.not_an_api


def _formats_counts(fkey: str) -> dict:
    out: dict = {}
    for labels, c in PM.default_registry().series(PD.DISPATCH_METRIC):
        if labels["op"] == "linear" and labels["formats"] == fkey:
            out[labels["path"]] = out.get(labels["path"], 0) + int(c.value)
    return out


@pytest.mark.parametrize("device_spec", [None, "gpu-h100"])
def test_engine_serves_quantized_variant_bit_stable(monkeypatch,
                                                    device_spec):
    """``"default"`` and int8 requests in one stream: batched tokens equal
    unbatched and a replay, both buckets serve, no fresh resolution after
    warmup.  Under the card's dispatch decisions (``gpu-h100``; CPU
    tensors run the kernel's plain version) every sorted-map linear takes
    ``ksplit_cuda`` and every unsorted one ``ksplit_torch``."""
    if device_spec:
        monkeypatch.setenv(DV.DEVICE_ENV, device_spec)
    cfg = reduced(get("internlm2-1.8b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    tag = INT8_SET.key()
    stats = ActStats().observe(params["embed"][:32])
    qparams = quantize_params(params, stats, fset=INT8_SET, ratio_high=0.25)
    qk = [lin.w for lin in [qparams["lm_head"]] + [
        lp[blk][n] for lp in qparams["layers"]
        for blk, names in (("attn", ("wq", "wk", "wv")),
                           ("mlp", ("up", "gate"))) for n in names]]
    assert any("int8_pt" in map_report(w)["classes"] for w in qk)
    n_sorted = sum(w.sorted for w in qk)
    assert 0 < n_sorted < len(qk)      # calibrated maps: some unsorted
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=32,
                                          buckets=(4,)),
                 variants={tag: qparams})
    assert set(eng.variants) == {"default", tag}
    eng.warmup()
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2, 2]]
    fsets = ["default", tag, tag, "default"]

    def reqs():
        return [Request(np.asarray(p), max_new_tokens=3, fset=f)
                for p, f in zip(prompts, fsets)]

    r1 = reqs()
    eng.generate(r1)
    counts = _formats_counts(tag)
    r2 = reqs()
    eng.generate(r2)
    for a, b in zip(r1, r2):
        assert a.out_tokens == b.out_tokens
    refs = eng.generate_reference(reqs())
    for a, ref in zip(r1, refs):
        assert a.out_tokens == ref.out_tokens
    st = eng.stats()
    assert st["plans"]["post_warmup_fresh_resolutions"] == 0
    assert st["microbatches"]["multi_request"] >= 1
    assert {r.bucket for r in r1} == {"S4/default", f"S4/{tag}"}
    total = sum(counts.values())
    assert total and total % len(qk) == 0
    steps = total // len(qk)
    if device_spec:
        assert counts == {"ksplit_cuda": steps * n_sorted,
                          "ksplit_torch": steps * (len(qk) - n_sorted)}
        assert _formats_counts(DEFAULT_FORMATS.key()).get(
            "ksplit_torch", 0) == 0
    else:
        assert counts == {"ksplit_torch": total}


def _serve_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_serve_launcher_quantize_on_cpu():
    out = _serve_cli("--smoke", "--device", "cpu", "--quantize", "int8:d",
                     "--quantize-ratio", "0.5", "--prompts", "1 2 3", "4 5")
    assert out.returncode == 0, out.stderr
    assert "quantized variant int8_pt+fp32 (ratio_high=0.5)" in out.stdout
    served = [ln for ln in out.stdout.splitlines()
              if ln.startswith("request ")]
    assert len(served) == 2
    assert all("bucket=S4/int8_pt+fp32" in ln for ln in served)


def test_serve_launcher_ckpt_on_cpu(tmp_path):
    """``--ckpt`` serves a training checkpoint's params: greedy tokens
    equal serving those params directly."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import transformer as T
    cfg = reduced(get("internlm2-1.8b"), tp=2)
    params = T.init_model(torch.Generator().manual_seed(5), cfg)
    path = str(tmp_path / "step_00000007")
    ckpt.save(path, {"params": params}, step=7)
    out = _serve_cli("--smoke", "--device", "cpu", "--ckpt", path,
                     "--prompts", "1 2 3")
    assert out.returncode == 0, out.stderr
    assert "loaded checkpoint step 7" in out.stdout
    eng = Engine(cfg, params, ServeConfig(max_seq=128, max_batch=4))
    (r,) = eng.generate([Request(np.array([1, 2, 3]), max_new_tokens=8)])
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("request 0"))
    assert f"out={r.out_tokens}" in line
