"""Port parity of ``repro_torch.models.moe`` with ``repro.models.moe``.

* Dispatch: from equal router probabilities the port's routing tables,
  gates, ``keep`` and capacity equal the reference's bit for bit (a
  normal draw, a forced over-capacity case, a tie between experts).
  From equal router *logits* the integer tables are equal too, and the
  gates agree to ``GATE_ULPS`` fp32 ulps: XLA's and torch's ``exp`` (and
  softmax's sum) differ in the last bit on ~60% of entries.  A routing
  that differs between the frameworks fails with its top-k margin.
* Expert products (``MoEKSplit``, ``MoENSplit``): fp32 sums of exact
  products in both, so they agree within the summation-order bound
  ``2·K·2^-24·Σ|x·w|``.
* ``moe_block`` with and without the shared expert, for both down
  layouts, on the reference's weights: equal routing, outputs within one
  bf16 rounding of the order bound (``BLOCK_TOL``), and the load-balance
  aux within ``AUX_RTOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import Policy as JPolicy
from repro.models import moe as JM
from repro_torch.bridge import _linear, tensor_from_numpy
from repro_torch.core.precision import Policy as PPolicy
from repro_torch.models import moe as PM
from test_torch_models import numpy_tree

#: fp32 ulps between gates from the two frameworks' softmax
GATE_ULPS = 4
#: |port - reference| of moe_block's bf16 output, relative to the row's
#: largest magnitude: one bf16 rounding (2^-8) of an fp32 value whose
#: summation order differs, twice over (the gate/up product feeds a bf16
#: cast before the down product)
BLOCK_TOL = 2.0 ** -7
#: the aux loss: a mean and a sum of E products in fp32
AUX_RTOL = 1e-6

POLICY = dict(kind="ratio", ratio_high=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits(case: str, T: int, E: int, rng) -> np.ndarray:
    x = rng.standard_normal((T, E)).astype(np.float32)
    if case == "over_capacity":
        x[:, 0] += 6.0                  # most tokens pick expert 0 first
    elif case == "tie":
        x[:, 2] = x[:, 5] = x.max(1) + 1.0   # experts 2 and 5 tie on top
    return x


def _topk_margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th probability."""
    s = -np.sort(-probs, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if probs.shape[1] > k \
        else float("inf")


def _jax_tables(logits, E, k, cf):
    t, g, probs, flat_e, keep, C = JM._dispatch_tables(
        jnp.asarray(logits), jnp.eye(E, dtype=jnp.float32), k, cf)
    return {"table": np.asarray(t), "gate_table": np.asarray(g),
            "probs": np.asarray(probs), "flat_e": np.asarray(flat_e),
            "keep": np.asarray(keep), "C": C}


CASES = [("normal", 24, 8, 2, 1.25), ("over_capacity", 24, 8, 2, 1.25),
         ("tie", 16, 8, 2, 1.25), ("normal", 32, 60, 4, 1.25),
         ("over_capacity", 32, 60, 4, 16.0)]


@pytest.mark.parametrize("case,T,E,k,cf", CASES)
def test_route_bit_equal_from_equal_probs(case, T, E, k, cf):
    rng = np.random.default_rng(CASES.index((case, T, E, k, cf)))
    ref = _jax_tables(_logits(case, T, E, rng), E, k, cf)
    got = PM.route(torch.from_numpy(ref["probs"].copy()), k, cf)
    assert got.capacity == ref["C"]
    np.testing.assert_array_equal(got.table.numpy(), ref["table"])
    np.testing.assert_array_equal(got.flat_e.numpy(), ref["flat_e"])
    np.testing.assert_array_equal(got.keep.numpy(), ref["keep"])
    assert np.array_equal(got.gate_table.numpy().view(np.uint32),
                          ref["gate_table"].view(np.uint32))
    if ref["C"] >= T:                   # capacity covers every token
        assert ref["keep"].all()
    elif case == "over_capacity":
        assert not ref["keep"].all()
    if case == "tie":   # the lower index wins, as jax.lax.top_k
        assert np.all(ref["flat_e"].reshape(T, k)[:, :2] == [2, 5])


@pytest.mark.parametrize("case,T,E,k,cf", CASES)
def test_dispatch_tables_from_equal_logits(case, T, E, k, cf):
    rng = np.random.default_rng(CASES.index((case, T, E, k, cf)))
    logits = _logits(case, T, E, rng)
    ref = _jax_tables(logits, E, k, cf)
    got = PM._dispatch_tables(torch.from_numpy(logits), torch.eye(E), k, cf)
    margin = _topk_margin(ref["probs"], k)
    assert np.array_equal(got.flat_e.numpy(), ref["flat_e"]), (
        f"routing differs between the frameworks; top-k margin {margin:.3g}")
    assert got.capacity == ref["C"]
    np.testing.assert_array_equal(got.table.numpy(), ref["table"])
    np.testing.assert_array_equal(got.keep.numpy(), ref["keep"])
    gp, gr = got.gate_table.numpy(), ref["gate_table"]
    ulps = np.abs(gp.view(np.int32).astype(np.int64)
                  - gr.view(np.int32).astype(np.int64))
    assert ulps.max() <= GATE_ULPS


def _port_moe_weight(d: dict):
    cls = PM.MoEKSplit if d["kind"] == "moe_ksplit" else PM.MoENSplit
    return cls(tensor_from_numpy(d["w_hi"], "cpu"),
               tensor_from_numpy(d["w_lo"], "cpu"), np.asarray(d["cls"]),
               d["tile"], tuple(d["shape"]))


def _port_moe(jp) -> dict:
    nt = numpy_tree(jp)
    out = {"router": tensor_from_numpy(nt["router"], "cpu")}
    for name in ("gate", "up", "down"):
        out[name] = _port_moe_weight(nt[name])
    if "shared" in nt:
        out["shared"] = {k: _linear(v, None, "cpu")
                         for k, v in nt["shared"].items()}
    return out


@pytest.mark.parametrize("kind", ["ksplit", "nsplit"])
def test_expert_products_within_order_bound(kind):
    E, K, N, C = 6, 96, 80, 5
    cls = JM.MoEKSplit if kind == "ksplit" else JM.MoENSplit
    jw = cls.init(jax.random.PRNGKey(3), E, K, N, JPolicy(**POLICY), 16)
    pw = _port_moe_weight(numpy_tree(jw))
    assert pw.storage_bytes() == jw.storage_bytes()
    x = jnp.asarray(np.random.default_rng(4).standard_normal((E, C, K)),
                    jnp.bfloat16)
    ref = np.asarray(jw(x), np.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = pw(xt)
    assert got.dtype == torch.float32
    dense = np.asarray(jw.to_dense(), np.float64)
    absprod = np.abs(np.asarray(x.astype(jnp.float32), np.float64)) @ np.abs(
        dense)
    bound = 2 * K * 2.0 ** -24 * absprod
    assert np.all(np.abs(got.numpy() - ref) <= bound)
    np.testing.assert_array_equal(pw.to_dense().numpy(),
                                  np.asarray(jw.to_dense()))


@pytest.mark.parametrize("ep", [True, False], ids=["ksplit_down",
                                                   "nsplit_down"])
@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
def test_moe_block_matches_reference(ep, n_shared):
    E, k, d, f = 8, 2, 64, 128
    jp = JM.init_moe(jax.random.PRNGKey(ep + 2 * n_shared), d, f, E, k,
                     JPolicy(**POLICY), n_shared=n_shared, shared_d_ff=64,
                     tile=16, ep=ep)
    pp = _port_moe(jp)
    assert isinstance(pp["down"], PM.MoEKSplit if ep else PM.MoENSplit)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 16, d)),
                    jnp.bfloat16)
    with jax.disable_jit():
        jo, jaux = JM.moe_block(jp, x, top_k=k, capacity_factor=1.25,
                                return_aux=True)
        ref = _jax_tables(np.asarray(x.astype(jnp.float32).reshape(-1, d)
                                     @ np.asarray(jp["router"])), E, k, 1.25)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    po, paux = PM.moe_block(pp, xt, top_k=k, capacity_factor=1.25,
                            return_aux=True)
    r = PM._dispatch_tables(xt.reshape(-1, d), pp["router"], k, 1.25)
    assert np.array_equal(r.flat_e.numpy(), ref["flat_e"]), (
        f"routing differs; top-k margin {_topk_margin(ref['probs'], k):.3g}")
    assert not r.keep.all()             # the case drops some pairs
    jo = np.asarray(jo, np.float32)
    po = po.float().numpy()
    scale = np.abs(jo).max(-1, keepdims=True)
    assert np.all(np.abs(po - jo) <= BLOCK_TOL * scale)
    assert abs(float(paux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_drop_counter_counts_dropped_pairs():
    E, k, d = 8, 2, 64
    jp = JM.init_moe(jax.random.PRNGKey(0), d, 128, E, k,
                     JPolicy(**POLICY), tile=16)
    pp = _port_moe(jp)
    x = torch.randn((1, 24, d), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    r = PM._dispatch_tables(x.reshape(-1, d), pp["router"], k, 0.5)
    drops: list = []
    plain = PM.moe_block(pp, x, top_k=k, capacity_factor=0.5)
    PM.moe_block(pp, x, top_k=k, capacity_factor=0.5, drops=drops)
    counted = PM.moe_block(pp, x, top_k=k, capacity_factor=0.5, drops=drops)
    assert [int(n) for n in drops] == [int((~r.keep).sum())] * 2
    assert int((~r.keep).sum()) > 0
    assert torch.equal(plain, counted)    # counting changes no number


def test_route_replays_given_picks():
    """``route(..., picks=)`` takes the given experts and gates them from
    ``probs``: its own picks replayed give its own dispatch bit for bit;
    other picks give their tables."""
    rng = np.random.default_rng(3)
    T, E, k = 12, 8, 2
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, E)).astype(np.float32)), -1)
    own = PM.route(probs, k, 1.25)
    again = PM.route(probs, k, 1.25, picks=own.flat_e.reshape(T, k))
    for f in ("table", "gate_table", "flat_e", "keep", "slot"):
        assert torch.equal(getattr(own, f), getattr(again, f)), f
    other = torch.from_numpy(np.stack(
        [rng.choice(E, k, replace=False) for _ in range(T)]))
    r = PM.route(probs, k, 16.0, picks=other)
    assert torch.equal(r.flat_e, other.reshape(-1)) and bool(r.keep.all())
    for t in range(T):
        g = probs[t, other[t]] / probs[t, other[t]].sum()
        for j in range(k):
            e = int(other[t, j])
            col = int((r.table[e] == t).nonzero()[0, 0])
            assert r.gate_table[e, col] == g[j]


def test_init_layout_matches_reference():
    """``MoEKSplit.init`` puts the first k_hi rows in fp32 and the rest in
    bf16, with the reference's class vector and tile."""
    gen = torch.Generator().manual_seed(0)
    pw = PM.MoEKSplit.init(gen, 4, 256, 64, PPolicy(**POLICY))
    jw = JM.MoEKSplit.init(jax.random.PRNGKey(0), 4, 256, 64,
                           JPolicy(**POLICY))
    assert (pw.tile, pw.shape) == (jw.tile, jw.shape)
    np.testing.assert_array_equal(pw.k_cls, jw.k_cls.arr)
    assert pw.w_hi.shape == jw.w_hi.shape and pw.w_hi.dtype == torch.float32
    assert pw.w_lo.shape == jw.w_lo.shape and pw.w_lo.dtype == torch.bfloat16
    pn = PM.MoENSplit.init(gen, 4, 64, 256, None)
    jn = JM.MoENSplit.init(jax.random.PRNGKey(0), 4, 64, 256, None)
    np.testing.assert_array_equal(pn.n_cls, jn.n_cls.arr)
    assert pn.w_hi.shape == jn.w_hi.shape and pn.w_lo.shape == jn.w_lo.shape
