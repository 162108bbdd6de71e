"""The port's mesh layer on spawned gloo ranks: ``launch.mesh``, the
cross-pod mean, checkpoint re-meshing, the meshed prefill and the train
launcher's ``--devices``/``--mesh``, against the JAX package where it
has a counterpart.

One spawn of four CPU ranks, made once for the module, runs every call
(``call_all``) on the mesh (pod=2, data=1, model=2) or on a (2, 2)
("data", "model") mesh of the same ranks; the JAX side runs in this
process on the forced host devices (``host_grid_devices``).

* ``cross_pod_mean``: with every pod holding the same gradients, rank 0's
  result and residual equal the reference's bit for bit (its
  ``shard_map`` sums the same values over the pods); with distinct
  gradients every rank's result equals the mean over pods of the
  compressed trees, bit for bit (``launch.mesh_checks.cross_pod_check``).
* re-meshing, the twin of ``tests/test_checkpoint.py::
  test_elastic_remesh``: a save of DTensor leaves holds the same leaves
  (bytes, shapes, dtypes) and manifest hash as an unsharded save of the
  same tree; restores onto (data=4, model=1) and onto
  ``shrink_mesh_shape``'s (2, 1) hold every rank's slice bit for bit,
  uneven shards included; a dict ``sharding_tree`` raises ``ValueError``
  in both packages.
* the meshed prefill of reduced Qwen1.5-MoE (``_ffn`` under
  ``hints_enabled``: the non-EP path) and Phi-3.5-MoE's block (EP): the
  rules ``chip_smoke.py`` phase 15 gates on the card.
"""
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.optim import grad_compress as JGC
from repro_torch import tree as TR
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get, reduced
from repro_torch.launch import mesh as MS
from repro_torch.launch import mesh_checks as MC
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as LT
from repro_torch.launch.grid import call_all

MESH = ((2, 1, 2), ("pod", "data", "model"))
DM = ((2, 2), ("data", "model"))
#: the meshed forward's allowance over the one-extra-rounding gap
ROUNDINGS = 3.0


def _qwen_dff():
    """Reduced Qwen1.5-MoE with its 4 experts not dividing ep_axis 3: the
    d_ff-sharded path, as at full width (60 % 16)."""
    import dataclasses
    return dataclasses.replace(reduced(get("qwen2-moe-a2.7b")), ep_axis=3)


def _uneven():
    x = torch.arange(35, dtype=torch.float32).reshape(7, 5)
    return {"x": x, "y": x.to(torch.bfloat16)[:, :3].contiguous()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ilm = reduced(get("internlm2-1.8b"))
    base = tmp_path_factory.mktemp("remesh")
    dirs = {k: str(base / k) for k in ("model", "twin", "uneven")}
    for d in dirs.values():
        os.makedirs(d)
    x = torch.arange(64.0).reshape(8, 8)
    calls = {
        "report": (MS.mesh_report, (), {}),
        "report dm": (MS.mesh_report, (), {}, DM),
        "equal pods": (MC.cross_pod_check, (ilm, 0),
                       {"equal_pods": True, "return_trees": True}),
        "distinct pods": (MC.cross_pod_check, (ilm, 1),
                          {"return_trees": True}),
        "remesh model": (MC.remesh_check, (ilm, 0, dirs["model"]), {}),
        "remesh twin": (MC.remesh_tree_check, (
            {"x": x}, {"x": SH.P("data", "model")}, dirs["twin"]), {}, DM),
        "remesh uneven": (MC.remesh_tree_check, (
            _uneven(), {"x": SH.P("data", "model"), "y": SH.P("model")},
            dirs["uneven"]), {}, DM),
        "prefill": (MC.prefill_mesh_check, (_qwen_dff(), 0, 32), {}),
        "phi block": (MC.moe_block_check, (
            reduced(get("phi3.5-moe-42b-a6.6b")), 0, 32), {}),
    }
    out = MS.run_on_mesh(*MESH, call_all, list(calls.values()),
                         device="cpu", backend="gloo")
    return dict(zip(calls, out)), dirs


def test_mesh_layout(ranks):
    res, _ = ranks
    rep = res["report"]
    assert [r["coordinate"] for r in [rep]] == [
        {"pod": 0, "data": 0, "model": 0}]
    assert rep["shape"] == {"pod": 2, "data": 1, "model": 2}
    assert rep["data_axes"] == ("pod", "data") and rep["model"] == 2
    assert res["report dm"]["shape"] == {"data": 2, "model": 2}
    assert res["report dm"]["data_axes"] == ("data",)


def test_require_devices_is_descriptive():
    """Outside a spawned world the process counts as one rank, and a
    mesh that needs more raises the reference's descriptive error,
    counted in ranks."""
    with pytest.raises(RuntimeError, match=r"make_host_mesh\(2x2\) needs "
                       r"4 ranks .*--devices 4"):
        MS.make_host_mesh(2, 2)
    with pytest.raises(RuntimeError, match="make_production_mesh needs 512"):
        MS.make_production_mesh(multi_pod=True)
    assert MS.production_shape(True) == {"pod": 2, "data": 16, "model": 16}
    assert MS.data_axes({"data": 4, "model": 2}) == ("data",)
    assert MS.model_axis_size({"data": 4, "model": 2}) == 2


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 4}
    assert MS.placements(mesh, SH.P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert MS.placements(mesh, SH.P()) == [Replicate()] * 3
    named = SH.to_named({"w": SH.P(None, "model"), "b": SH.P()}, mesh)
    assert named["w"].placements == [Replicate(), Replicate(), Shard(1)]
    assert named["b"].spec == SH.P() and named["b"].mesh is mesh
    with pytest.raises(ValueError, match="order"):
        MS.placements(mesh, SH.P(("data", "pod")))


def _flat32(tree) -> np.ndarray:
    """Every tensor of a port tree widened to fp32 (exact) and joined."""
    return np.concatenate([t.float().numpy().reshape(-1)
                           for t in TR.tensors(tree)])


def test_cross_pod_mean_equal_pods_bit_for_bit(ranks, host_grid_devices):
    """The reference's ``cross_pod_mean`` takes one array (a tree fails
    in its ``shard_map``, ``ROADMAP.md`` queue 3), so it runs once on
    every tensor widened to fp32 and joined: ``compress`` widens the
    gradient to fp32 first, so each element's result is the same."""
    res, _ = ranks
    reports = res["equal pods"]
    assert all(r["equal"] and r["err_equal"] for r in reports)
    trees = reports[0]["trees"]
    mesh = jax.make_mesh(*MESH)
    jgc, jerr = jax.jit(lambda g, e: JGC.cross_pod_mean(g, e, mesh))(
        jnp.asarray(_flat32(trees["grads"])),
        jnp.asarray(_flat32(trees["err_in"])))
    gc = torch.cat([t.reshape(-1) for t in TR.tensors(trees["gc"])])
    assert gc.dtype == torch.bfloat16
    np.testing.assert_array_equal(gc.view(torch.int16).numpy(),
                                  np.asarray(jgc).view(np.int16))
    np.testing.assert_array_equal(_flat32(trees["err"]).view(np.int32),
                                  np.asarray(jerr).view(np.int32))


def test_reference_cross_pod_mean_refuses_a_tree(host_grid_devices):
    """The reference fault the port does not share: its ``shard_map``'s
    ``in_specs`` is the tree itself, not a one-argument tuple."""
    mesh = jax.make_mesh(*MESH)
    g = {"a": jnp.ones((4, 4)), "b": jnp.ones(3)}
    e = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
    with pytest.raises(ValueError, match="pytree structure"):
        JGC.cross_pod_mean(g, e, mesh)


def test_cross_pod_mean_distinct_pods_is_the_mean(ranks):
    """Each rank's result is the mean over pods of the compressed trees
    (checked bit for bit on the rank); it is not its own pod's compressed
    tree, and both pods end with the same mean."""
    from repro_torch.optim.grad_compress import compress
    res, _ = ranks
    reports = res["distinct pods"]
    assert [r["pod"] for r in reports] == [0, 0, 1, 1]
    assert all(r["equal"] and r["err_equal"] for r in reports)
    trees = reports[0]["trees"]
    own, _ = compress(trees["grads"], trees["err_in"])
    assert any(not torch.equal(a, b) for a, b in zip(
        TR.tensors(trees["gc"]), TR.tensors(own)))
    assert reports[0]["comm"]["calls"]["cross_pod"] == reports[0]["tensors"]


def _leaves(path):
    data = np.load(os.path.join(path, "leaves.npz"))
    return {k: data[k].tobytes() for k in data.files}


@pytest.mark.parametrize("name", ["model", "twin", "uneven"])
def test_sharded_save_and_remesh(ranks, name):
    res, dirs = ranks
    reports = res[f"remesh {name}"]
    assert reports[0]["hash_equal"] and reports[0]["leaves_equal"]
    assert all(r["sharded_leaves"] > 0 for r in reports)
    for r in reports:
        assert r["remesh"]["equal"] and r["remesh"]["shape"] == {
            "data": 4, "model": 1}
        assert (r["shrink"] is not None) == (r["rank"] < 2)
        assert r["shrink"] is None or r["shrink"]["equal"]
    # byte for byte the unsharded save's leaves
    d = dirs[name]
    assert _leaves(os.path.join(d, "sharded")) == _leaves(
        os.path.join(d, "plain"))


@pytest.mark.parametrize("name", ["model", "twin", "uneven"])
def test_sharded_save_gathers_to_the_writer_only(ranks, name):
    """Only the rank at the mesh's origin receives shards (and assembles
    and hashes the arrays); every rank returns the writer's manifest."""
    res, _ = ranks
    reports = res[f"remesh {name}"]
    assert reports[0]["comm"]["bytes"]["gather"] > 0
    assert all(r["comm"]["bytes"].get("gather", 0) == 0
               for r in reports[1:])
    assert len({r["hash"] for r in reports}) == 1


def test_restore_maps_members_and_hashes_in_pieces(tmp_path):
    """``restore`` reads the npz's stored members through memory maps (a
    sharded restore slices them, reading only its slice): their values
    are ``np.load``'s, a compressed member is read whole, and the hash
    read in pieces is ``save``'s."""
    tree = {"a": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
            "b": torch.randn(5, 7, generator=torch.Generator().manual_seed(
                0)).to(torch.bfloat16),
            "c": torch.ones(3).to(torch.float8_e4m3fn),
            "d": torch.tensor(3.5)}
    path = str(tmp_path / "ck")
    man = CK.save(path, tree, step=1)
    data = CK._Npz(os.path.join(path, "leaves.npz"))
    with np.load(os.path.join(path, "leaves.npz")) as ref:
        for name in ref.files:
            got = data[name]
            assert isinstance(got, np.memmap) == (ref[name].ndim > 0)
            np.testing.assert_array_equal(got, ref[name])
            assert got.dtype == ref[name].dtype
        packed = {k: ref[k] for k in ref.files}
    assert CK._hash(data, man, tree) == man["hash"]
    np.savez_compressed(os.path.join(path, "leaves.npz"), **packed)
    back, _ = CK.restore(path, tree)
    raw = lambda t: t.reshape(-1).view(torch.uint8)   # noqa: E731
    assert all(torch.equal(raw(back[k]), raw(tree[k])) for k in tree)


def test_remesh_twin_restores_logical_values(ranks, tmp_path):
    """The port restores the reference test's array (its sharded save)
    whole when no sharding is given, and a dict sharding_tree raises
    ValueError in both packages."""
    res, dirs = ranks
    path = os.path.join(dirs["twin"], "sharded")
    like = {"x": torch.zeros(8, 8)}
    got, man = CK.restore(path, like)
    np.testing.assert_array_equal(got["x"].numpy(),
                                  np.arange(64.0).reshape(8, 8))
    with pytest.raises(ValueError):
        CK.restore(path, like, sharding_tree={"x": None})


def test_reference_restore_refuses_a_dict(tmp_path, host_grid_devices):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    path = str(tmp_path / "ck")
    x = jnp.arange(64.0).reshape(8, 8)
    JCK.save(path, {"x": x}, step=1)
    mesh = jax.make_mesh((4,), ("data",))
    with pytest.raises(ValueError):
        JCK.restore(path, {"x": x}, sharding_tree={
            "x": NamedSharding(mesh, P("data", None))})


def test_meshed_prefill_within_rounding_allowance(ranks):
    """Reduced Qwen1.5-MoE through ``moe_block_sharded`` (non-EP, the
    sequence sharded over "model"): layer 0's kept pairs equal the
    unmeshed run's, the logits and hidden states within ROUNDINGS times
    the one-extra-rounding gap (floored at one bf16 rounding)."""
    res, _ = ranks
    for r in res["prefill"]:
        assert r["layer0_kept_equal"] and r["finite"]
        assert r["shape"] == [1, 1, 128]
        assert r["logits_gap"] <= max(ROUNDINGS * r["logits_gap_extra"],
                                      2.0 ** -8 * r["logits_max"])
        assert r["hidden_gap"] <= max(ROUNDINGS * r["hidden_gap_extra"],
                                      2.0 ** -8 * r["hidden_max"])
        calls = r["comm"]["calls"]
        assert calls["x_gather"] == calls["expert_psum"] == r["moe_layers"]


def test_ep_block_within_rounding_allowance(ranks):
    res, _ = ranks
    assert all(r["worst_ratio"] <= 1.0 for r in res["phi block"])


def _train(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = LT.main(argv)
    return rc, [line for line in buf.getvalue().splitlines()
                if line.startswith("done:")]


def test_train_launcher_devices_and_mesh(tmp_path):
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--summa", "",
            "--ckpt-dir"]
    rc0, plain = _train(base + [str(tmp_path / "a")])
    rc1, meshed = _train(base + [str(tmp_path / "b"), "--devices", "4",
                                 "--mesh", "2x2"])
    assert rc0 == rc1 == 0
    assert plain and plain == meshed


def test_train_launcher_devices_bound_the_summa_grid():
    with pytest.raises(RuntimeError, match=r"make_grid_mesh\(2x2\) needs "
                       r"4 ranks but only 2"):
        LT.main(["--smoke", "--device", "cpu", "--steps", "1", "--summa",
                 "2x2", "--devices", "2"])


def test_shard_hints_scope_and_identities():
    """``hints_enabled`` makes a mesh active for this thread only; the
    hints are identities (eager PyTorch has no partitioner), as are the
    reference's without a mesh."""
    import threading

    from repro.models import shard_hints as JH
    from repro_torch.models import shard_hints as H
    x = torch.ones(2, 3, 4, 5)
    seen = []
    mesh = object()
    assert H.active_mesh() is None and JH.active_mesh() is None
    with H.hints_enabled(mesh):
        assert H.active_mesh() is mesh
        t = threading.Thread(target=lambda: seen.append(H.active_mesh()))
        t.start()
        t.join()
        assert H.hint(x, "data", None) is x
        assert H.batch_hint(x) is x and H.heads_hint(x) is x
        tree = {"w": x}
        assert H.constrain_layer_params(tree, None, zero=True) is tree
    assert seen == [None] and H.active_mesh() is None
