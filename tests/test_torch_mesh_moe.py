"""Port parity: ``repro_torch.models.moe.moe_block_sharded`` on a
``launch.mesh.Mesh`` of spawned gloo ranks against the JAX
``repro.models.moe.moe_block_sharded`` on the same mesh shape of forced
host devices (``host_grid_devices``).

Every case runs in one spawn of four CPU ranks made once for the module
(``call_all``; a (1, 2) mesh uses the first two ranks): (1, 2) and
(2, 2) meshes of ("data", "model"), with expert parallelism (E % tp == 0,
the K-split down) and without (the experts' d_ff sharded, the N-split
down), a sequence length that tp divides (the sequence sharded over
"model" and all-gathered on entry) and one it does not.  The reference's
weights and numpy-seeded tokens go to both.

Tolerances.  The dispatch tables of every data shard (computed from the
same tokens) are equal bit for bit.  The outputs take the same roundings
in both (each rank's fp32 partial to bf16, their sum to bf16, then the
shared expert in fp32), so they differ only through the fp32 summation
order of the expert products (F3), which can move a bf16 rounding of a
partial, of the sum or of the output by one step: within ``2^-7`` of
``A``, the sum of the magnitudes of a token's weighted expert
contributions (which bounds every partial), per element.  The aux loss
within ``AUX_RTOL``.  The reference runs compiled (``jax.jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import Policy as JPolicy
from repro.models import moe as JM
from repro_torch.launch import mesh as MS
from repro_torch.launch import mesh_checks as MC
from repro_torch.launch.grid import call_all
from repro_torch.models import moe as PM
from test_torch_moe import _port_moe

E, K_TOP, D, F = 8, 2, 64, 128
B = 2
MESHES = [(1, 2), (2, 2)]
#: (ep, shared expert)
KINDS = [(True, 0), (False, 1)]
SEQS = [16, 15]
CF = 1.25
#: per element, relative to the sum of |contributions|: one bf16 step
#: (2^-8) of a partial, of the sum and of the output, twice over for the
#: fp32 order of the products feeding a bf16 cast
TOL = 2.0 ** -7
AUX_RTOL = 1e-6

CASES = [(m, ep, sh, s) for m in MESHES for ep, sh in KINDS for s in SEQS]


def _case_id(c):
    m, ep, sh, s = c
    return f"{m[0]}x{m[1]}-{'ep' if ep else 'dff'}-S{s}"


def _inputs(case):
    (dp, tp), ep, n_shared, S = case
    seed = CASES.index(case)
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, F, E, K_TOP,
                     JPolicy(kind="ratio", ratio_high=0.5),
                     n_shared=n_shared, shared_d_ff=64, tile=16, ep=ep)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    return jp, _port_moe(jp), xj, xt


@pytest.fixture(scope="module")
def ranks():
    """Every case in one spawn of four CPU ranks over gloo."""
    calls = []
    for case in CASES:
        (dp, tp), ep, _, _ = case
        _, pp, _, xt = _inputs(case)
        calls.append((MC.moe_on_mesh, (pp, xt),
                      {"top_k": K_TOP, "ep": ep, "capacity_factor": CF},
                      ((dp, tp), ("data", "model"))))
    out = MS.run_on_mesh((2, 2), ("data", "model"), call_all, calls,
                         device="cpu", backend="gloo")
    return dict(zip(CASES, out))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_moe_block_sharded_matches_reference(case, ranks, host_grid_devices):
    (dp, tp), ep, n_shared, S = case
    jp, pp, xj, xt = _inputs(case)
    mesh = jax.make_mesh((dp, tp), ("data", "model"))
    # compiled: op by op, shard_map takes ~11 s a call on the CPU
    jy, jaux = jax.jit(lambda p, x: JM.moe_block_sharded(
        p, x, top_k=K_TOP, mesh=mesh, ep=ep, capacity_factor=CF))(jp, xj)
    got = ranks[case]
    jy = np.asarray(jy.astype(jnp.float32))
    py = got["y"].float().numpy()
    assert py.shape == (B, S, D)
    bound = np.zeros_like(py)
    drops = 0
    for i in range(dp):                   # each data shard routes alone
        rows = slice(i * B // dp, (i + 1) * B // dp)
        xs = xt[rows]
        r = PM._dispatch_tables(xs.reshape(-1, D), pp["router"], K_TOP, CF)
        xf = jnp.asarray(xj[rows]).reshape(-1, D)
        table, gate_table, _, flat_e, keep, C = JM._dispatch_tables(
            xf, jp["router"], K_TOP, CF)
        assert C == r.capacity
        np.testing.assert_array_equal(r.table.numpy(), np.asarray(table))
        np.testing.assert_array_equal(r.flat_e.numpy(), np.asarray(flat_e))
        np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
        if i == 0:
            drops = int((~np.asarray(keep)).sum())
        a = MC._contributions(pp, xs, K_TOP, CF).numpy()
        bound[rows] = a.reshape(xs.shape)
    assert got["drops"] == drops
    err = np.abs(py - jy)
    assert np.all(err <= TOL * bound + 2.0 ** -8 * np.abs(jy)), err.max()
    assert abs(got["aux"] - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_moe_block_sharded_keeps_rank_slices():
    """A rank given the whole expert weights is refused: it must hold
    its 1/tp slice (``shard_experts``)."""
    _, pp, _, xt = _inputs(CASES[0])

    class OneRank:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

        @staticmethod
        def index(axis):
            return 0

    with pytest.raises(ValueError, match="slice"):
        PM.moe_block_sharded(pp, xt, top_k=K_TOP, mesh=OneRank(), ep=True)


def test_moe_block_sharded_refuses_autograd():
    """The mesh path is forward only (its collectives move detached
    bytes): ``forward_train`` under ``hints_enabled``, as the trainer's
    ``loss_and_grads`` runs it, raises instead of training the router and
    the experts on no gradient; so does the block with an input that
    requires grad.  Under ``torch.no_grad`` the guard lets it through to
    the slice check."""
    from repro_torch.configs import get, reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as PT
    from repro_torch.models.shard_hints import hints_enabled
    from repro_torch.train.train_step import loss_and_grads

    class OneRank:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

        @staticmethod
        def index(axis):
            return 0

    cfg = reduced(get("qwen2-moe-a2.7b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    batch = make_batch(cfg, 16, 2, seed=0, step=0, device="cpu")
    with hints_enabled(OneRank()):
        with pytest.raises(RuntimeError, match="forward only"):
            loss_and_grads(params, cfg, batch)
    _, pp, _, xt = _inputs(CASES[0])
    with pytest.raises(RuntimeError, match="forward only"):
        PM.moe_block_sharded(pp, xt.clone().requires_grad_(True),
                             top_k=K_TOP, mesh=OneRank(), ep=True)
    with torch.no_grad(), pytest.raises(ValueError, match="slice"):
        PM.moe_block_sharded(pp, xt.clone().requires_grad_(True),
                             top_k=K_TOP, mesh=OneRank(), ep=True)
