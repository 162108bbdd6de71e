"""The plain reference against the port's CPU path on the same tensors,
at a tiny size; the frozen rounding rules against the port's storage;
the control's separation; and that a run loads neither JAX nor the JAX
package."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests import tiny
from portbench import harness
from portbench.families import dense_gqa as fam
from portbench.reference import checks
from portbench.reference import dense_gqa as ref

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    c = tiny.config()
    return c, fam.arch(c), fam.build(c, tiny.SEED, "cpu")


def test_rounding_rules_match_the_ports_storage(setup):
    c, _, params = setup
    for lf in ref.leaves(c):
        w = ref.stored(c, lf, ref.dense(tiny.SEED, lf, "cpu"))
        assert torch.equal(w, fam.read(params, lf.name)), lf.name


def test_demoted_storage_is_one_step_lower(setup):
    c, _, _ = setup
    lf = next(x for x in ref.leaves(c) if x.kind == "ksplit")
    w = ref.dense(tiny.SEED, lf, "cpu")
    lo = ref.stored(c, lf, w, demote=True)
    half = lf.shape[0] // 2
    assert torch.equal(lo[:half], w[:half].to(torch.bfloat16).float())
    assert torch.equal(lo[half:],
                       w[half:].to(torch.float8_e4m3fn).float())


def test_loss_and_gradients_agree(setup):
    from repro_torch.train.train_step import loss_and_grads
    c, arch, params = setup
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, c["vocab_size"], (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _, grads = loss_and_grads(params, arch, batch)
    masters = {lf.name: ref.stored(c, lf, ref.dense(tiny.SEED, lf, "cpu"))
               .requires_grad_(True) for lf in ref.leaves(c)}
    rl = ref.loss(ref.logits(masters.__getitem__, c, batch["tokens"]),
                  batch["labels"])
    rg = dict(zip(masters, torch.autograd.grad(rl, list(masters.values()))))
    # the port's activations are bf16, the reference's fp32
    rl = float(rl.detach())
    assert abs(float(loss) - rl) <= 2e-3 * rl
    for name, g in rg.items():
        got = fam.read(grads, name)
        assert float(torch.linalg.vector_norm(got - g)) \
            <= 3e-2 * float(torch.linalg.vector_norm(g)), name


def test_decode_through_the_cache_agrees(setup):
    from repro_torch.models import transformer as T
    c, arch, params = setup
    toks = torch.arange(11)[None] * 7 % c["vocab_size"]
    caches = T.init_cache(arch, 1, 16, "cpu")
    got = torch.stack([T.forward_decode(params, arch, toks[:, i:i + 1],
                                        caches, i)[0][0, 0]
                       for i in range(toks.shape[1])])
    w = ref.weights(c, tiny.SEED, "cpu")
    want = ref.logits(w.__getitem__, c, toks)[0]
    assert float((got - want).abs().max()) <= 2e-2 * float(
        want.abs().max())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_separates_from_the_program(seed):
    """The control (every class stored one step lower) reads several
    times the program's gap on the served tokens of a tiny run."""
    c = tiny.config()
    ctx = harness.make_context(tiny.CHAT, seed, "cpu",
                               tiny.workload(tiny.CHAT), c)
    cell = harness.load_module("traffic", "serve_bursts").Cell(ctx)
    cell.setup()
    cell.window(0.2, False)
    reqs = cell.sample()
    cell.free()
    prog = max(checks.served_gaps(ref, c, seed, reqs, "cpu"))
    ctl = max(checks.control_gaps(ref, c, seed, reqs, "cpu"))
    assert ctl >= 3 * prog and ctl > 0.02


def test_banned_names_are_compared_whole(monkeypatch):
    before = set(harness.banned_modules())
    for name in ("repro_torch_fake", "reprox", "jaxlike", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(harness.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert set(harness.banned_modules()) == before | {"repro"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import json; from portbench.tests import tiny; "
            "from portbench import harness; "
            "got, errors = tiny.run(tiny.CHAT); "
            "got2, errors2 = tiny.run(tiny.PRETRAIN); "
            "print(json.dumps([got['correct'], got2['correct'], "
            "errors + errors2, harness.banned_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=tiny.ROOT,
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    ok, ok2, errors, banned = json.loads(out.stdout.splitlines()[-1])
    assert ok and ok2 and errors == [] and banned == []
