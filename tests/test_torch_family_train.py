"""Port parity of training the MoE, xLSTM and Mamba-hybrid families, and
of quantized MoE serving: reduced Qwen1.5-MoE-A2.7B, Phi-3.5-MoE,
xLSTM-1.3B and Jamba-v0.1 on the JAX package's own weights (through
``repro_torch.bridge``) and batches.  (Module-level gradients and the
train-state checkpoints: ``tests/test_torch_family_train_parts.py``.)

* ``forward_train``'s loss within ``LOSS_RTOL_EAGER`` (1e-5) of the
  reference run op by op, and every gradient leaf (in the reference's
  dtype, under its name) within ``GRAD_FROB`` / ``GRAD_MAX`` of
  ``jax.grad`` (``tests/test_torch_train.py`` says why).  The MoE loss is
  ``ce + 0.01·aux`` in both, and ``metrics["ce"]`` is that sum, as the
  reference reports it.  xLSTM alone: the fp32 gate product ``xc @
  w_if`` sums in another order in torch than in XLA, which flips one
  bf16 activation at layer 6 of 8 (measured: 2 elements), and the
  exponential gating of the last two layers carries the flip into a
  loss gap of 1.8e-5 and gradient gaps up to 2.3e-2 / 3.2e-2.  There the
  allowance per leaf (and for the loss) is the larger of the dense one
  and the reference's own compiled-vs-op-by-op gap at that leaf, which
  is far wider (3.0e-4 in the loss, 0.61 in the worst leaf's norm);
* two microbatches against one for reduced qwen2 (the aux metric zero
  at two, as the reference's), and a restart that replays the losses
  bit for bit (qwen2, Jamba);
* ``quantize_params`` on reduced qwen2 equals the reference's variant
  leaf for leaf, the expert weights passed through as the default's own
  tensors; an ``Engine`` variant of it serves in equal mode as
  ``generate_reference`` does on the variant;
* the train launcher trains each of the four archs (exit 0).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.quant import calibrate as JQ
from repro_torch import tree as TR
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.optim import adamw
from repro_torch.quant import calibrate as PQ
from repro_torch.train.train_step import loss_and_grads, make_train_step
from test_torch_frontends import _isolated  # noqa: F401
from test_torch_models import numpy_tree
from test_torch_train import GRAD_FROB, GRAD_MAX, LOSS_RTOL_EAGER

ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
         "jamba-v0.1-52b"]
SEQ, BATCH = 16, 2
#: the arch whose flip is allowed up to the reference's own
#: compiled-vs-op-by-op gap (module docstring)
ORDER_FLIP_ARCH = "xlstm-1.3b"
U32 = 2.0 ** -24


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax cfg, jax params, port cfg, port params) of the reduced arch
    with the same weights."""
    jcfg = jreduced(load_all()[name], tp=2)
    pcfg = reduced(get(name))
    jp = jax.jit(JT.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    return jcfg, jp, pcfg, params_from_numpy(numpy_tree(jp), pcfg, "cpu")


def _batches(name, seed=2, step=3):
    jcfg, _, pcfg, _ = _pair(name)
    jb = jmake_batch(jcfg, SEQ, BATCH, kind="train", seed=seed, step=step)
    pb = make_batch(pcfg, SEQ, BATCH, kind="train", seed=seed, step=step,
                    device="cpu")
    for k, v in jb.items():
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(v))
    return jb, pb


def _leaf_gaps(want, got) -> tuple[float, float]:
    """(‖Δ‖/‖g‖, max|Δ|/max|g|) of two arrays; zeros where ``want`` is
    zero everywhere (then ``got`` must be too)."""
    a, b = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert a.shape == b.shape
    if not a.size or not np.abs(a).max():
        assert not b.size or not np.abs(b).max()
        return 0.0, 0.0
    return (float(np.linalg.norm(a - b) / np.linalg.norm(a)),
            float(np.abs(a - b).max() / np.abs(a).max()))


def _port_leaves(tree) -> list:
    """(name, dtype, fp32 numpy) per reference leaf of a port tree."""
    out = []
    for leaf in TR.walk(tree):
        t = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
        out.append((leaf.name, str(t.dtype).replace("torch.", ""),
                    t.float().numpy()))
    return out


def _jax_leaves(tree) -> list:
    return [("/".join(str(k) for k in p), str(a.dtype),
             np.asarray(a, np.float32))
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# the whole model: loss and every gradient leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_gradients_match_reference(name):
    jcfg, jp, pcfg, pp = _pair(name)
    jb, pb = _batches(name)

    def jloss(p):
        return JT.forward_train(p, jcfg, jb)

    with jax.disable_jit():
        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(pp, pcfg, pb)
    if pcfg.n_experts:
        assert float(jm["aux"]) > 0 and float(metrics["aux"]) > 0
        assert float(metrics["ce"]) == float(loss)     # ce includes aux
        np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                                   rtol=1e-6)
    else:
        assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    loss_tol = LOSS_RTOL_EAGER * abs(float(jl))
    leaf_tol = None
    if name == ORDER_FLIP_ARCH:
        cl, cg = jax.jit(jax.value_and_grad(lambda p: jloss(p)[0]))(jp)
        loss_tol = max(loss_tol, abs(float(cl) - float(jl)))
        leaf_tol = [_leaf_gaps(a, c) for (_, _, a), (_, _, c)
                    in zip(_jax_leaves(jg), _jax_leaves(cg))]
    assert abs(float(loss) - float(jl)) <= loss_tol, (float(loss), float(jl))
    want, got = _jax_leaves(jg), _port_leaves(grads)
    assert [w[0] for w in want] == [g[0] for g in got]
    for i, ((key, jdt, a), (_, pdt, b)) in enumerate(zip(want, got)):
        assert jdt == pdt, key
        frob, worst = _leaf_gaps(a, b)
        fmax, wmax = GRAD_FROB, GRAD_MAX
        if leaf_tol is not None:
            fmax, wmax = max(fmax, leaf_tol[i][0]), max(wmax, leaf_tol[i][1])
        assert frob <= fmax and worst <= wmax, (key, frob, worst)


# ---------------------------------------------------------------------------
# microbatches, checkpoints, restart
# ---------------------------------------------------------------------------

def test_microbatches_two_equal_one_for_moe():
    """Reduced qwen2: one step at two microbatches against one, within
    accumulation noise (the tolerances of ``test_microbatch_equivalence``);
    the aux metric is zero at more than one microbatch, as the
    reference's; the step keeps every buffer's address."""
    _, _, pcfg, pp = _pair("qwen2-moe-a2.7b")
    ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    batch = make_batch(pcfg, 16, 4, seed=0, device="cpu")
    p1 = TR.map_tensors(torch.clone, pp)
    p2 = TR.map_tensors(torch.clone, pp)
    ptrs = [t.data_ptr() for t in TR.tensors(p1)]
    p1, _, m1 = make_train_step(pcfg, ocfg, 1)(p1, adamw.init(p1, ocfg),
                                               batch)
    # AdamW re-quantizes in place: every buffer, the experts' included,
    # keeps its address
    assert [t.data_ptr() for t in TR.tensors(p1)] == ptrs
    p2, _, m2 = make_train_step(pcfg, ocfg, 2)(p2, adamw.init(p2, ocfg),
                                               batch)
    assert float(m1["aux"]) > 0 and float(m2["aux"]) == 0.0
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(TR.tensors(p1), TR.tensors(p2))
                if a.numel())
    assert worst < 5e-2, worst


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_restart_replays_losses_bit_for_bit(name, tmp_path):
    """A RestartSignal at step 4 restores the step-3 checkpoint; every
    step's loss equals the uninterrupted run's bit for bit."""
    from repro_torch.runtime import fault as PF
    from repro_torch.train.trainer import TrainerConfig, train
    pcfg = reduced(get(name))
    ocfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=6)
    fired = []

    def injector(step):
        if step == 4 and not fired:
            fired.append(step)
            raise PF.RestartSignal("injected", shrink=False)

    def run(sub, inj):
        logs = []
        tcfg = TrainerConfig(steps=6, seq_len=16, global_batch=2,
                             ckpt_dir=str(tmp_path / sub), ckpt_every=3,
                             log_every=100, fault_injector=inj,
                             device="cpu")
        return train(pcfg, ocfg, tcfg, log=logs.append)[2], logs

    hist, logs = run("a", injector)
    again, _ = run("b", None)
    assert fired and any("restored step 3" in ln for ln in logs), logs
    assert [h["step"] for h in hist] == list(range(6))
    assert [h["loss"] for h in hist] == [h["loss"] for h in again]


# ---------------------------------------------------------------------------
# quantized MoE
# ---------------------------------------------------------------------------

def _stats(jcfg, jp, pp):
    """The same activation statistics in both packages: the embedding
    rows of a few prompts."""
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (3, 12))
    js, ps = JQ.ActStats(), PQ.ActStats()
    for t in toks:
        js.observe(np.asarray(jp["embed"][t], np.float32))
        ps.observe(pp["embed"][torch.from_numpy(t)])
    return js, ps


def test_quantize_params_on_moe_matches_reference():
    """Every KSplit leaf calibrated as the reference calibrates it (the
    same maps, bit for bit the same buffers); the expert weights, router
    and the rest pass through as the default tree's own tensors."""
    jcfg, jp, pcfg, pp = _pair("qwen2-moe-a2.7b")
    js, ps = _stats(jcfg, jp, pp)
    jq = JQ.quantize_params(jp, js)
    pq = PQ.quantize_params(pp, ps)
    want, got = _jax_leaves(jq), _port_leaves(pq)
    assert [w[0] for w in want] == [g[0] for g in got]
    for (key, jdt, a), (_, pdt, b) in zip(want, got):
        assert jdt == pdt, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    jl, pl = jq["blocks"][0]["pos0"]["attn"]["wq"].w, pq["layers"][0][
        "attn"]["wq"].w
    assert pl.fset.names == ("int8_pt", "fp32") == tuple(jl.fset.names)
    np.testing.assert_array_equal(pl.k_cls, jl.k_cls.arr)
    assert len(set(pl.k_cls.tolist())) == 2
    for lq, lp in zip(pq["layers"], pp["layers"]):
        for name in ("gate", "up", "down"):
            assert lq["moe"][name] is lp["moe"][name]
            for t in ("w_hi", "w_lo"):
                assert getattr(lq["moe"][name], t).data_ptr() == getattr(
                    lp["moe"][name], t).data_ptr()
        assert lq["moe"]["router"] is lp["moe"]["router"]
        assert lq["moe"]["shared"]["up"] is not lp["moe"]["shared"]["up"]


def test_engine_serves_moe_variant_in_equal_mode():
    """Two requests on the int8 variant and two on the default weights
    through one equal-mode engine: each equals ``generate_reference``
    (the request alone, on its own variant's params)."""
    from repro_torch.core.formats import DEFAULT_FORMATS, format_set
    from repro_torch.serve import Engine, Request, ServeConfig
    jcfg, jp, pcfg, pp = _pair("qwen2-moe-a2.7b")
    _, ps = _stats(jcfg, jp, pp)
    qset = format_set("int8_pt", DEFAULT_FORMATS.names[-1])
    tag = qset.key()
    eng = Engine(pcfg, pp, ServeConfig(max_batch=4, max_seq=32),
                 variants={tag: PQ.quantize_params(pp, ps, fset=qset)})
    assert eng.mode == "equal"
    eng.warmup()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pcfg.vocab, n) for n in (8, 8, 16, 16)]

    def reqs():
        return [Request(p, max_new_tokens=4, fset=("default", tag)[i % 2])
                for i, p in enumerate(prompts)]

    got = eng.generate(reqs())
    refs = eng.generate_reference(reqs())
    assert [r.out_tokens for r in got] == [r.out_tokens for r in refs]
    assert {r.bucket.split("/", 1)[1] for r in got} == {"default", tag}
    assert all(r.done and len(r.out_tokens) == 4 for r in got)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains(arch, tmp_path, capsys):
    from repro_torch.launch import train as TL
    assert TL.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path)]) == 0
    assert "done: 3 steps" in capsys.readouterr().out

