"""Port parity of training the MoE, xLSTM and Mamba-hybrid families, by
part (the whole models: ``tests/test_torch_family_train.py``; the two
are separate files so each stays short under ``--dist loadfile``).

* Module-level gradients at three or more chunks, on the reference's
  weights or the same numpy draws: the mLSTM scan and the selective scan
  (their fp32 gradients within the fp32 summation-order bound
  2·n·2^-24·max|g|; the bf16 gradients of q/k/v, whose per-use shares
  the reference rounds to bf16 one use at a time and torch sums in fp32
  first, within ``GRAD_FROB`` / ``GRAD_MAX``), the sLSTM block and
  ``moe_block`` with its aux loss (within ``GRAD_FROB`` / ``GRAD_MAX``;
  an expert without a kept token gets an exact zero in both).  A routing
  pick that differs between the frameworks must sit at a top-k margin
  under the summation-order allowance, and is then replayed through
  ``route(..., picks=)``.
* A checkpoint of params and AdamW state after one update, reduced qwen2
  and xLSTM: the port's restores in the reference leaf for leaf, the
  reference's in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.core.precision import Policy as JPolicy
from repro.models import mamba as JMB
from repro.models import moe as JM
from repro.models import xlstm as JX
from repro.optim import adamw as JA
from repro_torch import tree as TR
from repro_torch.bridge import opt_state_from_numpy
from repro_torch.checkpoint import ckpt as PCK
from repro_torch.models import mamba as PMB
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm as PX
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from test_torch_frontends import _isolated  # noqa: F401
from test_torch_models import numpy_tree
from test_torch_moe import POLICY, _jax_tables, _port_moe, _topk_margin
from test_torch_train import GRAD_FROB, GRAD_MAX
from test_torch_family_train import (U32, _batches, _jax_leaves,
                                     _leaf_gaps, _pair, _port_leaves)


# ---------------------------------------------------------------------------
# module-level gradients at three or more chunks
# ---------------------------------------------------------------------------

def _within_order(got, want, n_terms: int):
    """fp32 results of a different summation order: within 2·n·2^-24 of
    the largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 2 * n_terms * U32 * max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch_grads(fn, inputs: list) -> list:
    leaves = [torch.from_numpy(np.array(_f32(a))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    ).requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    out.backward()
    return [t.grad for t in leaves]


def test_mlstm_chunk_gradients_match_reference():
    """``_mlstm_chunk`` at chunk 4 over 16 positions (four chunks, the
    carry between them under autograd) from a nonzero state: the
    gradients of a fixed functional of h and the final state to q, k, v,
    both gates and the initial state."""
    rng = np.random.default_rng(7)
    B, S, nh, dh, chunk = 2, 16, 2, 8, 4
    bf = [jnp.asarray(rng.standard_normal((B, S, nh, dh)), jnp.bfloat16)
          for _ in range(3)]
    li = jnp.asarray(rng.standard_normal((B, S, nh)), jnp.float32)
    lf = jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((B, S, nh)) + 3, jnp.float32))
    st = [jnp.asarray(rng.standard_normal(s) * 0.1, jnp.float32)
          for s in ((B, nh, dh, dh), (B, nh, dh), (B, nh))]
    wts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, S, nh, dh), (B, nh, dh, dh), (B, nh, dh), (B, nh))]

    def jf(q, k, v, li, lf, C, n, m):
        h, (C2, n2, m2) = JX._mlstm_chunk(q, k, v, li, lf, (C, n, m),
                                          chunk=chunk)
        return sum(jnp.sum(a.astype(jnp.float32) * w)
                   for a, w in zip((h, C2, n2, m2), wts))

    def pf(q, k, v, li, lf, C, n, m):
        h, (C2, n2, m2) = PX._mlstm_chunk(q, k, v, li, lf, (C, n, m),
                                          chunk=chunk)
        return sum(torch.sum(a.float() * torch.from_numpy(w))
                   for a, w in zip((h, C2, n2, m2), wts))

    inputs = bf + [li, lf] + st
    with jax.disable_jit():
        want = jax.grad(jf, argnums=tuple(range(8)))(*inputs)
    got = _torch_grads(pf, inputs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), i
        if i < 3:
            # bf16 cotangents: the reference rounds each use's share to
            # bf16 and sums them in bf16, torch sums in fp32 and rounds
            # once
            frob, worst = _leaf_gaps(_f32(w), _f32(g))
            assert frob <= GRAD_FROB and worst <= GRAD_MAX, (i, frob, worst)
        else:
            _within_order(_f32(g), _f32(w), 2 * chunk + 2 * dh)


def test_slstm_block_gradients_match_reference():
    """The sLSTM block (its time loop under autograd) over 12 positions:
    the gradients to its input and every weight."""
    jcfg, jp, pcfg, pp = _pair("xlstm-1.3b")
    pos = next(i for i, (m, _) in enumerate(pcfg.layer_kinds())
               if m == "slstm")
    jcell = jax.tree.map(lambda a: a[0],
                         jp["blocks"][0][f"pos{pos}"]["slstm"])
    pcell = pp["layers"][pos]["slstm"]
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, 12, pcfg.d_model)), jnp.bfloat16)
    w = rng.standard_normal((2, 12, pcfg.d_model)).astype(np.float32)

    def jf(cell, x):
        out = JX.slstm_block(cell, x, n_heads=jcfg.n_heads)
        return jnp.sum(out.astype(jnp.float32) * w)

    with jax.disable_jit():
        jgc, jgx = jax.grad(jf, argnums=(0, 1))(jcell, x)
    xt = torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16)
    xt.requires_grad_(True)
    leaves = TR.tensors(pcell)
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = PX.slstm_block(pcell, xt, n_heads=pcfg.n_heads)
        g = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(w)),
                                [xt] + leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    g = [torch.zeros_like(t) if d is None else d
         for t, d in zip([xt] + leaves, g)]
    want = [jgx] + jax.tree.leaves(jgc)
    assert len(want) == len(g)
    for a, b in zip(want, g):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        frob, worst = _leaf_gaps(_f32(a), _f32(b))
        assert frob <= GRAD_FROB and worst <= GRAD_MAX, (frob, worst)


def test_ssm_chunked_gradients_match_reference():
    """``_ssm_chunked`` at chunk 4 over 16 positions (four chunks, the
    carry between them and the associative scan's interleaving writes
    under autograd): the gradients to every input, h0 included."""
    rng = np.random.default_rng(9)
    B, S, d, n, chunk = 2, 16, 8, 4, 4
    u = rng.standard_normal((B, S, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)) - 2)).astype(
        np.float32)
    Bt = rng.standard_normal((B, S, n)).astype(np.float32)
    Ct = rng.standard_normal((B, S, n)).astype(np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    D = np.ones(d, np.float32)
    h0 = rng.standard_normal((B, d, n)).astype(np.float32)
    wy = rng.standard_normal((B, S, d)).astype(np.float32)
    wh = rng.standard_normal((B, d, n)).astype(np.float32)
    inputs = [jnp.asarray(a) for a in (u, dt, Bt, Ct, A, D, h0)]

    def jf(*a):
        y, h = JMB._ssm_chunked(*a, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    def pf(*a):
        y, h = PMB._ssm_chunked(*a, chunk=chunk)
        return (torch.sum(y * torch.from_numpy(wy))
                + torch.sum(h * torch.from_numpy(wh)))

    with jax.disable_jit():
        want = jax.grad(jf, argnums=tuple(range(7)))(*inputs)
    got = _torch_grads(pf, inputs)
    for g, w in zip(got, want):
        _within_order(_f32(g), _f32(w), 4 * S + 2 * n)


def _replayed(monkeypatch, picks):
    """``moe.route`` made to take ``picks`` [T, k] (the reference's)."""
    orig = PM.route

    def route(probs, top_k, capacity_factor, picks_=None):
        return orig(probs, top_k, capacity_factor, picks)

    monkeypatch.setattr(PM, "route", route)


def test_moe_block_gradients_with_aux_match_reference(monkeypatch):
    """``moe_block(return_aux=True)`` at capacity 1.25 (some pairs drop)
    with the shared expert: the gradients of a fixed functional of the
    output plus the aux loss to the router, the expert buffers, the
    shared MLP and the input; an expert without a kept token gets a
    zero gradient in both."""
    E, k, d, f = 8, 2, 64, 128
    jp = JM.init_moe(jax.random.PRNGKey(11), d, f, E, k,
                     JPolicy(**POLICY), n_shared=1, shared_d_ff=64,
                     tile=16)
    pp = _port_moe(jp)
    rng = np.random.default_rng(12)
    # tokens that share one direction route alike: some experts get no
    # kept token and some pairs drop
    x = jnp.asarray(3.0 * rng.standard_normal((1, 1, d))
                    + 0.3 * rng.standard_normal((1, 12, d)), jnp.bfloat16)
    w = rng.standard_normal((1, 12, d)).astype(np.float32)

    def jf(p, x):
        out, aux = JM.moe_block(p, x, top_k=k, capacity_factor=1.25,
                                return_aux=True)
        return jnp.sum(out.astype(jnp.float32) * w) + aux

    with jax.disable_jit():
        jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, x)
        ref = _jax_tables(np.asarray(x.astype(jnp.float32).reshape(-1, d)
                                     @ np.asarray(jp["router"])), E, k, 1.25)
    xt = torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16)
    own = PM._dispatch_tables(xt.reshape(-1, d), pp["router"], k, 1.25)
    if not np.array_equal(own.flat_e.numpy(), ref["flat_e"]):
        # a pick flip must sit at a margin the summation order can move
        margin = _topk_margin(ref["probs"], k)
        assert margin <= 2 * d * U32 * float(np.abs(ref["probs"]).max()), \
            margin
        _replayed(monkeypatch, torch.from_numpy(ref["flat_e"].reshape(-1, k)))
    kept = np.bincount(ref["flat_e"][ref["keep"]], minlength=E)
    assert (kept == 0).any() and not ref["keep"].all()
    xt.requires_grad_(True)
    leaves = TR.tensors(pp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        out, aux = PM.moe_block(pp, xt, top_k=k, capacity_factor=1.25,
                                return_aux=True)
        g = torch.autograd.grad(
            torch.sum(out.float() * torch.from_numpy(w)) + aux,
            [xt] + leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    g = [torch.zeros_like(t) if d is None else d
         for t, d in zip([xt] + leaves, g)]
    want = [jgx] + [a for _, _, a in _jax_leaves(jgp)]
    names = ["x"] + [leaf.name for leaf in TR.walk(pp)]
    assert names[1:] == [n for n, _, _ in _jax_leaves(jgp)]
    for name, a, b in zip(names, want, g):
        frob, worst = _leaf_gaps(_f32(a), _f32(b))
        assert frob <= GRAD_FROB and worst <= GRAD_MAX, (name, frob, worst)
    for name in ("gate", "up", "down"):
        for buf in (pp[name].w_hi, pp[name].w_lo):
            gb = g[1 + next(i for i, t in enumerate(leaves) if t is buf)]
            nonzero = gb.float().reshape(E, -1).abs().amax(1) > 0
            assert np.array_equal(nonzero.numpy(), kept > 0), name


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "xlstm-1.3b"])
def test_train_state_checkpoints_cross_restore(name, tmp_path):
    """Params and AdamW state after one update: the port's checkpoint
    restores in the reference leaf for leaf, and the reference's (its own
    update) in the port."""
    jcfg, jp, pcfg, pp = _pair(name)
    _, pb = _batches(name)
    ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    p = TR.map_tensors(torch.clone, pp)
    p, state, _ = make_train_step(pcfg, ocfg, 1)(p, adamw.init(p, ocfg), pb)
    ppath, jpath = str(tmp_path / "p"), str(tmp_path / "j")
    PCK.save(ppath, {"params": p, "opt": state}, step=1)
    jo = JA.AdamWConfig()
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                        {"params": jp, "opt": JA.init(jp, jo)})
    jgot, man = JCK.restore(ppath, like)
    assert man["step"] == 1 and int(jgot["opt"].count) == 1
    want = _port_leaves({"params": p, "opt": state})
    got = _jax_leaves(jgot)
    assert [w[0] for w in want] == [g[0] for g in got]
    for (key, pdt, a), (_, jdt, b) in zip(want, got):
        assert pdt == jdt, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    # the reverse: the reference's own update, read by the port
    g = jax.tree.map(lambda a: (jnp.ones(a.shape) * 1e-3).astype(a.dtype),
                     jp)
    jp1, js, _ = JA.update(jp, g, JA.init(jp, jo), jo)
    JCK.save(jpath, {"params": jp1, "opt": js}, step=4)
    fresh = PT.init_model(torch.Generator().manual_seed(1), pcfg)
    got, man = PCK.restore(jpath, {"params": fresh,
                                   "opt": adamw.init(fresh, ocfg)})
    assert man["step"] == 4 and int(got["opt"].count) == 1
    want = _jax_leaves({"params": jp1, "opt": js})
    mine = _port_leaves(got)
    assert [w[0] for w in want] == [m[0] for m in mine]
    for (key, jdt, a), (_, pdt, b) in zip(want, mine):
        assert jdt == pdt, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    # ... and the bridge's reading of that state is the restored one
    ps = opt_state_from_numpy(
        {"mu": numpy_tree(js.mu), "nu": numpy_tree(js.nu),
         "master": numpy_tree(js.master), "count": np.asarray(js.count)},
        pcfg, "cpu")
    for a, b in zip(TR.tensors(ps), TR.tensors(got["opt"])):
        assert torch.equal(a, b)


