"""Port parity of the optimizer and gradient compression (twin of
``tests/test_optim.py``).

AdamW from identical state and gradients (the reference's, bridged):
the learning rate equals the reference's; the master weights and
moments agree within ``ULPS`` fp32 ulps of the magnitudes each formula
combines — not of the result's own ulp, which is no measure where
``b1·mu`` and ``(1-b1)·g`` cancel (compiled, XLA contracts them into one
fused multiply-add; torch's CPU ``sqrt`` is not always correctly rounded);
the storage buffers are bit-equal wherever the masters are, and
elsewhere (counted rounding ties) one storage ulp apart.  Error-feedback
compression and accumulation are elementwise and bit for bit the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import grad_compress as JGC
from repro_torch import tree as TR
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.configs import get, reduced
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from test_torch_models import numpy_tree

#: fp32 ulps of the combined magnitudes a master or moment may differ by
ULPS = 8
U32 = 2.0 ** -24


def test_adamw_converges_quadratic():
    ocfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                             weight_decay=0.0, grad_clip=10.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params, ocfg)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw.update(params, {"w": g}, state, ocfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_adamw_master_weights_keep_bf16_params_training():
    """With bf16 params, tiny updates accumulate in the fp32 master; the
    storage buffer keeps its memory across steps."""
    ocfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=0, total_steps=1000,
                             weight_decay=0.0)
    params = {"w": torch.ones(8, dtype=torch.bfloat16) * 100.0}
    ptr = params["w"].data_ptr()
    state = adamw.init(params, ocfg)
    for _ in range(50):
        params, state, _ = adamw.update(params, {"w": torch.ones(8)}, state,
                                        ocfg)
    assert float((state.master["w"] - 100.0).abs().max()) > 1e-4
    assert params["w"].data_ptr() == ptr and int(state.count) == 50


def test_lr_schedule_shape_and_reference_values():
    ocfg = adamw.AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100)
    jcfg = JA.AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100)
    lrs = [adamw.lr_schedule(ocfg, s) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] == pytest.approx(0.1, rel=0.15)
    assert all(a >= b - 1e-6 for a, b in zip(lrs[1:], lrs[2:]))
    for s in range(0, 120, 3):
        want = float(JA.lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        assert adamw.lr_schedule(ocfg, s) == pytest.approx(want, rel=3e-7)


def test_moment_dtype_bf16():
    ocfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.zeros(4)}
    st_ = adamw.init(params, ocfg)
    assert st_.mu["w"].dtype == torch.bfloat16
    p2, st2, _ = adamw.update(params, {"w": torch.ones(4)}, st_, ocfg)
    assert st2.mu["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(p2["w"]).all())


def _ref_pair():
    jcfg = jreduced(load_all()["internlm2-1.8b"], tp=2)
    return jcfg, JT.init_model(jax.random.PRNGKey(0), jcfg), \
        reduced(get("internlm2-1.8b"))


def test_decay_rule_sees_the_reference_names():
    _, jp, pcfg = _ref_pair()
    pp = params_from_numpy(numpy_tree(jp), pcfg, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves = TR.walk(pp)
    assert [JA._is_decayable(p) for p, _ in flat] == [
        adamw._is_decayable(leaf.name) for leaf in leaves]
    decayed = {leaf.key for leaf in leaves if adamw._is_decayable(leaf.name)}
    assert "embed" in decayed and "final_norm" not in decayed
    assert "blocks/[0]/pos0/norm1" not in decayed


def _bridge_state(js, pcfg):
    return opt_state_from_numpy(
        {"mu": numpy_tree(js.mu), "nu": numpy_tree(js.nu),
         "master": numpy_tree(js.master), "count": np.asarray(js.count)},
        pcfg, "cpu")


def _logical(leaf):
    t = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
    return t.float().numpy().astype(np.float64)


def _ulps_apart(a: np.ndarray, b: np.ndarray, bf16: bool) -> np.ndarray:
    """Distance in storage ulps of two fp32 arrays holding fp32 or bf16
    values (sign-magnitude bit patterns mapped to ordered integers)."""
    def ordered(x):
        bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(
            np.int64)
        mag, neg = bits & 0x7FFFFFFF, bits >> 31
        if bf16:
            mag >>= 16
        return np.where(neg == 1, -mag, mag)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("grad_scale", [0.002, 0.05])
def test_adamw_update_matches_reference_from_identical_state(grad_scale,
                                                             compiled):
    """Step 2 of AdamW from the reference's state after step 1 (bridged),
    against the reference run op by op and compiled, with gradients whose
    global norm is under the clip (0.002) and over it (0.05: the clip
    scale then carries the two global norms' summation-order difference,
    ``s``, into every gradient-fed term of the bound)."""
    jcfg, jp, pcfg = _ref_pair()
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10)
    jo, po = JA.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * grad_scale
        ).astype(p.dtype), jp)

    step = lambda p, g, s: JA.update(p, g, s, jo)  # noqa: E731
    if compiled:
        step = jax.jit(step)
    jp1, js1, _ = step(jp, grads(), JA.init(jp, jo))
    g2 = grads()
    jp2, js2, jm = step(jp1, g2, js1)
    pp = params_from_numpy(numpy_tree(jp1), pcfg, "cpu")
    ps = _bridge_state(js1, pcfg)
    pg = params_from_numpy(numpy_tree(g2), pcfg, "cpu")
    ptrs = [t.data_ptr() for t in TR.tensors(pp)]
    pp2, ps2, pm = adamw.update(pp, pg, ps, po)
    assert [t.data_ptr() for t in TR.tensors(pp2)] == ptrs
    assert int(ps2.count) == int(js2.count) == 2
    assert pm["lr"] == float(jm["lr"])
    gn_ref = float(jm["grad_norm"])
    s = abs(float(pm["grad_norm"]) - gn_ref) / gn_ref
    assert s < 1e-5
    if grad_scale < 0.01:
        assert gn_ref < po.grad_clip    # unclipped: the scale is 1 in both
        s = 0.0

    e = ULPS * U32
    count = 2.0
    b1c, b2c = 1 - po.b1 ** count, 1 - po.b2 ** count
    lr = pm["lr"]
    scale = min(1.0, po.grad_clip / (gn_ref + 1e-9))
    ties = 0
    for fields in zip(*(jax.tree_util.tree_flatten_with_path(t)[0]
                        for t in (g2, js1.mu, js1.nu, js1.master, jp2,
                                  js2.mu, js2.nu, js2.master)),
                      TR.walk(pp2), TR.walk(ps2.mu), TR.walk(ps2.nu),
                      TR.walk(ps2.master)):
        (path, g), (_, mu), (_, nu), (_, m), (_, p_ref), (_, mu_ref), \
            (_, nu_ref), (_, m_ref), lp, lmu, lnu, lm = fields
        if not np.asarray(g).size:
            continue
        g, mu, nu, m = (np.asarray(a, np.float32).astype(np.float64)
                        for a in (g, mu, nu, m))
        gs = g * scale
        mu_mag = po.b1 * np.abs(mu) + (1 - po.b1) * np.abs(gs)
        nu_mag = po.b2 * nu + (1 - po.b2) * gs * gs
        assert (np.abs(_logical(lmu) - np.asarray(mu_ref, np.float64))
                <= e * mu_mag + s * (1 - po.b1) * np.abs(gs)).all(), lp.key
        assert (np.abs(_logical(lnu) - np.asarray(nu_ref, np.float64))
                <= e * nu_mag + 2 * s * (1 - po.b2) * gs * gs).all(), lp.key
        d = np.sqrt(nu_mag / b2c) + po.eps
        wd = po.weight_decay if adamw._is_decayable(lp.name) else 0.0
        m_bound = e * np.abs(m) + lr * ((2 * e + 2 * s) * mu_mag / b1c / d
                                        + e * wd * np.abs(m))
        m_port = _logical(lm)
        m_want = np.asarray(m_ref, np.float64)
        assert (np.abs(m_port - m_want) <= m_bound).all(), lp.key
        # storage: bit-equal where the masters are; an fp32 buffer is its
        # master, a bf16 one at most one bf16 ulp from the reference's
        pw = np.asarray(p_ref).astype(np.float32)
        p_port = _logical(lp).astype(np.float32)
        same_master = m_port == m_want
        assert (p_port[same_master] == pw[same_master]).all(), lp.key
        if np.asarray(p_ref).dtype.name == "float32":
            assert (p_port == m_port.astype(np.float32)).all(), lp.key
            continue
        apart = _ulps_apart(p_port, pw, bf16=True)
        assert apart.max() <= 1, lp.key
        ties += int((apart > 0).sum())
    print(f"storage elements at rounding ties: {ties}")


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(2, 32))
def test_error_feedback_unbiased_accumulation(seed, n):
    """bf16 accumulator + error feedback ≈ fp32 accumulation (within one
    final rounding), and bit for bit the reference's at every step."""
    rng = np.random.default_rng(seed)
    gs = rng.normal(size=(n, 64)).astype(np.float32) * 1e-3
    acc = {"g": torch.zeros(64, dtype=torch.bfloat16)}
    err = GC.ef_init(acc)
    jacc = {"g": jnp.zeros(64, jnp.bfloat16)}
    jerr = JGC.ef_init(jacc)
    for i in range(n):
        acc, err = GC.accumulate(acc, {"g": torch.from_numpy(gs[i])}, err)
        jacc, jerr = JGC.accumulate(jacc, {"g": jnp.asarray(gs[i])}, jerr)
    assert acc["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(acc["g"].float().numpy(),
                                  np.asarray(jacc["g"], np.float32))
    np.testing.assert_array_equal(err["g"].numpy(), np.asarray(jerr["g"]))
    total = acc["g"].float().numpy() + err["g"].numpy()
    np.testing.assert_allclose(total, gs.sum(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc["g"].float().numpy(), gs.sum(0),
                               rtol=1e-2, atol=1e-4)


def test_compress_roundtrip_error_feedback():
    a = np.random.default_rng(0).normal(size=128).astype(np.float32)
    e0 = np.random.default_rng(1).normal(size=128).astype(np.float32) * 1e-4
    gc, err2 = GC.compress({"w": torch.from_numpy(a)},
                           {"w": torch.from_numpy(e0)})
    jgc, jerr2 = JGC.compress({"w": jnp.asarray(a)}, {"w": jnp.asarray(e0)})
    assert gc["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(gc["w"].float().numpy(),
                                  np.asarray(jgc["w"], np.float32))
    np.testing.assert_array_equal(err2["w"].numpy(), np.asarray(jerr2["w"]))
    recon = gc["w"].float().numpy() + err2["w"].numpy()
    np.testing.assert_allclose(recon, a + e0, rtol=1e-6)


def test_accumulate_over_a_parameter_tree_keeps_its_structure():
    _, jp, pcfg = _ref_pair()
    pp = params_from_numpy(numpy_tree(jp), pcfg, "cpu")
    acc = TR.map_tensors(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16),
                         pp)
    err = GC.ef_init(pp)
    acc2, err2 = GC.accumulate(acc, pp, err)
    assert [lf.key for lf in TR.walk(acc2)] == [lf.key for lf in TR.walk(pp)]
    for a, e, p in zip(TR.tensors(acc2), TR.tensors(err2), TR.tensors(pp)):
        assert a.dtype == torch.bfloat16 and e.dtype == torch.float32
        assert torch.equal(a.float() + e, p.float())
