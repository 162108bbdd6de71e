"""Port parity of training (twin of ``tests/test_train.py``): the
training forward, its gradients, the train step, the restart-safe loop
and the launcher of ``repro_torch``, on the JAX package's own weights
(``reduced`` InternLM2-1.8B, bridged) and the same numpy-seeded batches.

Tolerances, from what the two frameworks round differently:

* loss: ``LOSS_RTOL_EAGER`` (1e-5) against the reference run op by op,
  ``LOSS_RTOL_COMPILED`` (2e-4) against its compiled value (F4: XLA folds
  bf16 round trips inside the fused layer scan);
* gradients, every leaf in its own dtype (the leaf's dtype must equal
  the reference's): ``GRAD_FROB`` (1.5e-2) on ‖Δ‖/‖g‖ and ``GRAD_MAX``
  (3e-2) on max|Δ| / max|g|.  The forward's bf16 activations already
  differ from the reference's in ~2% of elements by one bf16 ulp (fp32
  summation order in attention and the matmuls decides the rounding), and
  the backward carries those flips into every leaf: measured 0.5% (norm)
  and 0.9% (max) at this size;
* the KSplit VJP alone is bit for bit the reference's
  (``test_ksplit_vjp_matches_reference_bitwise``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.core.formats import format_set as jformat_set
from repro.core.layout import KSplitWeight as JKSplit
from repro.core.layout import ksplit_matmul as jksplit_matmul
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.obs import metrics as JM
from repro.optim import adamw as JA
from repro.runtime import fault as JF
from repro.tune import dispatch as JD
from repro.tune import search as JS
from repro_torch import tree as TR
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.core.formats import format_set
from repro_torch.core.layout import (KSplitWeight, ksplit_matmul,
                                     ksplit_matmul_vjp)
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.optim import adamw
from repro_torch.runtime import fault as PF
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import TrainerConfig, train
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS
from test_torch_models import numpy_tree

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
LOSS_RTOL_EAGER = 1e-5
LOSS_RTOL_COMPILED = 2e-4
GRAD_FROB = 1.5e-2
GRAD_MAX = 3e-2
SEQ, BATCH = 16, 4


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setattr(JD, "_REGISTRY", {})
    monkeypatch.setattr(JS, "_default_cache", None)
    monkeypatch.setattr(JM, "_DEFAULT", JM.MetricsRegistry())
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcfg():
    return reduced(get("internlm2-1.8b"))


def _jcfg():
    return jreduced(load_all()["internlm2-1.8b"], tp=2)


@pytest.fixture(scope="module")
def ref():
    """The reference's params, batch, op-by-op loss and gradients, and
    its compiled loss."""
    jcfg = _jcfg()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jb = jmake_batch(jcfg, SEQ, BATCH, kind="train", seed=0, step=0)
    fn = lambda p: JT.forward_train(p, jcfg, jb)[0]  # noqa: E731
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(fn)(jp)
    return {"cfg": jcfg, "params": jp, "batch": jb, "loss": float(loss),
            "grads": grads, "loss_compiled": float(jax.jit(fn)(jp))}


def _port_params(ref):
    return params_from_numpy(numpy_tree(ref["params"]), _pcfg(), "cpu")


def _logical(leaf) -> np.ndarray:
    t = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
    return t.float().numpy()


def test_batches_equal_reference(ref):
    pb = make_batch(_pcfg(), SEQ, BATCH, seed=0, step=0, device="cpu")
    assert set(pb) == set(ref["batch"])
    for k, v in ref["batch"].items():
        assert pb[k].dtype == torch.int32
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(v))


def test_forward_train_loss_matches_reference(ref):
    pb = make_batch(_pcfg(), SEQ, BATCH, seed=0, step=0, device="cpu")
    with torch.no_grad():
        loss, metrics = PT.forward_train(_port_params(ref), _pcfg(), pb)
    assert float(metrics["ce"]) == float(loss)
    np.testing.assert_allclose(float(loss), ref["loss"],
                               rtol=LOSS_RTOL_EAGER)
    np.testing.assert_allclose(float(loss), ref["loss_compiled"],
                               rtol=LOSS_RTOL_COMPILED)


def test_gradients_match_reference_per_leaf(ref):
    pb = make_batch(_pcfg(), SEQ, BATCH, seed=0, step=0, device="cpu")
    pp = _port_params(ref)
    loss, _, grads = loss_and_grads(pp, _pcfg(), pb)
    np.testing.assert_allclose(float(loss), ref["loss"],
                               rtol=LOSS_RTOL_EAGER)
    assert not any(t.requires_grad for t in TR.tensors(pp))
    flat = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    leaves = TR.walk(grads)
    assert len(flat) == len(leaves)
    for (path, jg), leaf in zip(flat, leaves):
        assert "/".join(str(k) for k in path) == leaf.name
        assert str(jg.dtype) == str(leaf.parts[0].dtype).replace("torch.",
                                                                "")
        a, b = np.asarray(jg, np.float32), _logical(leaf)
        assert a.shape == b.shape, leaf.key
        if not a.size:
            continue
        frob = np.linalg.norm(a - b) / np.linalg.norm(a)
        worst = np.abs(a - b).max() / np.abs(a).max()
        assert frob <= GRAD_FROB and worst <= GRAD_MAX, (leaf.key, frob,
                                                         worst)


def test_kernel_route_under_autograd_equals_gathering_route(ref,
                                                            monkeypatch):
    """On the card's dispatch decisions every sorted-map linear takes
    ``ksplit_cuda`` (on CPU tensors the kernel's plain version) through
    ``_KSplitLinear``; its loss and gradients equal the gathering route's
    bit for bit here (the plain version sums the segments in storage
    order, as ``ksplit_matmul`` does)."""
    pb = make_batch(_pcfg(), SEQ, BATCH, seed=0, step=0, device="cpu")
    pp = _port_params(ref)
    l0, _, g0 = loss_and_grads(pp, _pcfg(), pb)
    assert PD.dispatch_counts("linear").get("ksplit_cuda", 0) == 0
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    monkeypatch.setattr(PD, "_REGISTRY", {})
    PM.default_registry().reset()
    l1, _, g1 = loss_and_grads(pp, _pcfg(), pb)
    counts = PD.dispatch_counts("linear")
    assert counts.get("ksplit_cuda", 0) == 5 * _pcfg().n_layers + 1
    assert counts.get("ksplit_torch", 0) == 0
    assert float(l0) == float(l1)
    for a, b in zip(TR.tensors(g0), TR.tensors(g1)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _mixed_weight(rng, fset_names=("fp8_e4m3", "bf16", "fp32"),
                  cls=(2, 2, 1, 0), k=64, n=48):
    w = rng.standard_normal((k, n)).astype(np.float32)
    cls = np.asarray(cls, np.int8)
    jw = JKSplit.from_dense(jnp.asarray(w), cls, 16, jformat_set(*fset_names))
    pw = KSplitWeight(tuple(tensor_from_numpy(np.asarray(b), "cpu")
                            for b in jw.bufs), cls, 16, (k, n),
                      format_set(*fset_names))
    return jw, pw


@pytest.mark.parametrize("cls", [(2, 2, 1, 0), (1, 2, 0, 2)])
def test_ksplit_vjp_matches_reference_bitwise(cls):
    """The VJP of the gathering path (the kernel path's backward) equals
    JAX's VJP of the reference's ``ksplit_matmul`` bit for bit, for a
    sorted and an unsorted map with fp8, bf16 and fp32 classes; and
    ``torch.autograd`` through ``ksplit_matmul`` gives the same."""
    rng = np.random.default_rng(3)
    jw, pw = _mixed_weight(rng, cls=cls)
    x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    g = rng.standard_normal((8, 48)).astype(np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(jksplit_matmul, x, jw)
        jdx, jdw = vjp(jnp.asarray(g))
    px = tensor_from_numpy(np.asarray(x), "cpu")
    dx, dbufs = ksplit_matmul_vjp(px, pw, torch.from_numpy(g))
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jdx, np.float32),
                                  dx.float().numpy())
    for jb, pb, buf in zip(jdw.bufs, dbufs, pw.bufs):
        assert pb.dtype == buf.dtype and pb.shape == buf.shape
        np.testing.assert_array_equal(np.asarray(jb, np.float32),
                                      pb.float().numpy())
    xa = px.clone().requires_grad_()
    bufs = [b.clone().requires_grad_() for b in pw.bufs]
    y = ksplit_matmul(xa, KSplitWeight(tuple(bufs), pw.k_cls, 16, pw.shape,
                                       pw.fset))
    auto = torch.autograd.grad(y, [xa, *bufs], torch.from_numpy(g),
                               allow_unused=True)
    assert torch.equal(auto[0], dx)
    for a, b in zip(auto[1:], dbufs):
        assert a is None and not b.numel() or torch.equal(
            a.float(), b.float())


def test_fp8_gradient_overflow_is_nan_not_saturated():
    """An fp8 buffer's gradient above 464 is NaN, as the reference's
    convert gives, where torch's own cast would saturate at 448."""
    rng = np.random.default_rng(5)
    jw, pw = _mixed_weight(rng, cls=(0, 0, 1, 2))
    x = np.zeros((4, 64), np.float32)
    x[:, :32] = 1.0
    g = np.zeros((4, 48), np.float32)
    g[:, :8] = 120.0           # column sums 480 > 464: NaN
    g[:, 8:16] = 114.0         # 456: the e4m3 value 448, not NaN
    with jax.disable_jit():
        _, vjp = jax.vjp(jksplit_matmul, jnp.asarray(x), jw)
        _, jdw = vjp(jnp.asarray(g))
    bufs = [b.clone().requires_grad_() for b in pw.bufs]
    w = KSplitWeight(tuple(bufs), pw.k_cls, 16, pw.shape, pw.fset)
    y = PD.linear_matmul(torch.from_numpy(x), w)
    (d8,) = torch.autograd.grad(y, [bufs[0]], torch.from_numpy(g))
    assert d8.dtype == torch.float8_e4m3fn
    got = d8.float().numpy()
    want = np.asarray(jdw.bufs[0], np.float32)
    assert np.isnan(got[:, :8]).all() and np.isnan(want[:, :8]).all()
    assert (got[:, 8:16] == 448.0).all()
    np.testing.assert_array_equal(got, want)
    assert (torch.tensor([480.0]).to(torch.float8_e4m3fn).float()
            == 448.0).all()     # the saturating cast the port must avoid


def test_train_step_matches_reference_update(ref):
    """One step from the reference's state (its op-by-op gradients and
    AdamW update) against the port's step: loss as above, every storage
    leaf within 2·lr (an early Adam step moves a weight by ≈ ±lr, and a
    near-zero gradient's sign may differ) plus one storage ulp."""
    jcfg = ref["cfg"]
    jocfg = JA.AdamWConfig(warmup_steps=0, total_steps=10)
    jp2, _, jm = JA.update(ref["params"], ref["grads"],
                           JA.init(ref["params"], jocfg), jocfg)
    pcfg = _pcfg()
    ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    pp = _port_params(ref)
    step = make_train_step(pcfg, ocfg, 1, tune_params=pp,
                           tune_tokens=SEQ * BATCH)
    pb = make_batch(pcfg, SEQ, BATCH, seed=0, step=0, device="cpu")
    pp2, st, m = step(pp, adamw.init(pp, ocfg), pb)
    assert int(st.count) == 1
    np.testing.assert_allclose(float(m["loss"]), ref["loss"],
                               rtol=LOSS_RTOL_EAGER)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    lr = m["lr"]
    flat = jax.tree_util.tree_flatten_with_path(jp2)[0]
    for (_, a), leaf in zip(flat, TR.walk(pp2)):
        a = np.asarray(a)
        if not a.size:
            continue
        b = _logical(leaf)
        ulp = np.spacing(np.abs(a.astype(np.float32))) * (
            2.0 ** 16 if a.dtype.name == "bfloat16" else 1.0)
        assert (np.abs(a.astype(np.float32) - b) <= 2 * lr + ulp).all(), \
            leaf.key


def test_loss_decreases(tmp_path):
    cfg = _pcfg()
    ocfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40,
                             weight_decay=0.0)
    tcfg = TrainerConfig(steps=25, seq_len=16, global_batch=4,
                         ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                         log_every=100, device="cpu")
    _, _, hist = train(cfg, ocfg, tcfg, log=lambda s: None)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


@pytest.mark.parametrize("compress", [False, True])
def test_microbatch_equivalence(compress):
    """4 microbatches match the single-batch step within accumulation
    noise (fp32 accumulation, as the reference test; and the bf16
    accumulator with error feedback)."""
    cfg = _pcfg()
    ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    batch = make_batch(cfg, 16, 4, seed=0, device="cpu")
    p1 = TR.map_tensors(torch.clone, params)
    p4 = TR.map_tensors(torch.clone, params)
    s1 = make_train_step(cfg, ocfg, 1)
    s4 = make_train_step(cfg, ocfg, 4, compress_accum=compress)
    p1, _, m1 = s1(p1, adamw.init(p1, ocfg), batch)
    p4, _, m4 = s4(p4, adamw.init(p4, ocfg), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-2)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(TR.tensors(p1), TR.tensors(p4))
                if a.numel())
    assert worst < 5e-2, worst


def test_fault_restart_resumes_deterministically(tmp_path):
    """A RestartSignal at step 7 restores the step-5 checkpoint and
    finishes; every step's loss equals the uninterrupted run's bit for bit
    (the pipeline replays the same batches; the CPU run is
    deterministic)."""
    cfg = _pcfg()
    ocfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=20)
    fired = {"n": 0}

    def injector(step):
        if step == 7 and fired["n"] == 0:
            fired["n"] += 1
            raise PF.RestartSignal("injected straggler", shrink=False)

    logs = []
    tcfg = TrainerConfig(steps=12, seq_len=16, global_batch=4,
                         ckpt_dir=str(tmp_path / "ck"), ckpt_every=5,
                         log_every=100, fault_injector=injector,
                         device="cpu")
    _, _, hist = train(cfg, ocfg, tcfg, log=logs.append)
    assert fired["n"] == 1
    assert any("restored step 5" in line for line in logs), logs
    assert [h["step"] for h in hist] == list(range(12))
    tcfg2 = TrainerConfig(steps=12, seq_len=16, global_batch=4,
                          ckpt_dir=str(tmp_path / "ck2"), ckpt_every=5,
                          log_every=100, device="cpu")
    _, _, hist2 = train(cfg, ocfg, tcfg2, log=lambda s: None)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist2]


def test_watchdog_detects_straggler_like_reference():
    for mod in (JF, PF):
        wd = mod.Watchdog(straggler_factor=2.0, min_samples=3)
        for _ in range(5):
            wd.record(1.0)
        assert wd.check() is None
        wd.record(5.0)
        assert "straggler" in (wd.check() or "")
        assert wd.check(now=wd._last_beat + 301.0).startswith("dead")


def test_shrink_mesh_shape_like_reference():
    for shape in ((16, 16), (2,), (8, 4, 2)):
        assert PF.shrink_mesh_shape(shape) == JF.shrink_mesh_shape(shape)
    assert PF.shrink_mesh_shape((4, 6), axis=1) == (4, 3)
    with pytest.raises(ValueError):
        PF.shrink_mesh_shape((3, 4))


def _cli(*args, timeout=180):
    """The launcher in a fresh interpreter on one CPU thread (a threaded
    CPU matmul may sum in another order for other buffer addresses, and a
    restore allocates new buffers)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=timeout)


def test_train_launcher_trains_and_restarts_on_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    out = _cli("--smoke", "--device", "cpu", "--steps", "30", "--ckpt-dir",
               ck)
    assert out.returncode == 0, out.stderr
    done = [line for line in out.stdout.splitlines()
            if line.startswith("done:")]
    first, last = (float(v) for v in done[0].split("loss ")[1].split(" → "))
    assert last < first
    # a fault at step 12 restores the step-10 checkpoint and replays; the
    # last loss equals the uninterrupted run's
    out2 = _cli("--smoke", "--device", "cpu", "--steps", "30", "--ckpt-dir",
                str(tmp_path / "ck2"), "--inject-fault", "12")
    assert out2.returncode == 0, out2.stderr
    assert "[fault] restored step 10" in out2.stdout
    assert out2.stdout.splitlines()[-1] == done[0]
    # --resume starts at the newest checkpoint (step 30: nothing to run)
    out3 = _cli("--smoke", "--device", "cpu", "--steps", "30", "--ckpt-dir",
                ck, "--resume")
    assert out3.returncode == 0, out3.stderr
    assert "at step 30" in out3.stdout


@pytest.mark.parametrize("flag", [["--devices", "4"], ["--mesh", "2x2"],
                                  ["--summa", "2x2", "--mesh", "2x2"]])
def test_train_launcher_refuses_multi_device_options(flag, tmp_path):
    """``--devices`` and ``--mesh`` are ported: ``--mesh`` is parsed and
    not read (as in the reference) and ``--devices`` bounds the ranks the
    SUMMA self-check may spawn.  What the launcher refuses, before any
    work, is a grid larger than that bound (the mesh's descriptive
    error)."""
    if "--summa" in flag:
        with pytest.raises(RuntimeError, match="needs 4 ranks but only 1"):
            train_cli.main(["--smoke", "--device", "cpu", *flag,
                            "--devices", "1"])
        return
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                           "--ckpt-dir", str(tmp_path), *flag]) == 0


def test_train_launcher_runs_the_summa_selfcheck(tmp_path):
    """``--summa PxQ`` runs the SUMMA self-check on spawned ranks at the
    config's tile/policy/format set, prints its report, then trains."""
    out = _cli("--smoke", "--device", "cpu", "--steps", "2", "--summa",
               "2x2", "--ckpt-dir", str(tmp_path / "ck"), timeout=300)
    assert out.returncode == 0, out.stderr
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("SUMMA self-check"))
    assert line.startswith("SUMMA self-check 2x2 [fp8_e4m3+bf16+fp32]")
    assert float(line.split("rel err ")[1].split(",")[0]) < 1e-2


def test_train_launcher_defaults_to_the_card():
    assert train_cli._parse([]).device == "cuda"
