"""Port parity of checkpointing (twin of ``tests/test_checkpoint.py``).

The port writes the reference's format: the same leaf keys, layer-stacked
arrays, dtype names, npz array bytes and manifest hash for the same
state; each package reads what the other wrote.  The reference's
``test_elastic_remesh`` has no twin: restoring onto another device mesh
waits for ``torch.distributed`` (``ROADMAP.md`` queue 1, item 6).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro.configs.base import load_all
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import tree as TR
from repro_torch.bridge import (opt_state_from_numpy, params_from_numpy,
                                tensor_from_numpy)
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get, reduced
from repro_torch.optim import adamw
from test_torch_models import numpy_tree


def _jtree():
    k = jax.random.PRNGKey(0)
    return {"a": jax.random.normal(k, (8, 16)),
            "b": {"c": jnp.arange(10, dtype=jnp.int32),
                  "d": (jnp.arange(4.0) / 3).astype(jnp.bfloat16),
                  "e": jnp.asarray([1.0, 500.0, -3.0]).astype(
                      jnp.float8_e4m3fn)}}


def _tree():
    return jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x), "cpu"),
                        _jtree())


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    man = ckpt.save(path, t, step=7, extra={"note": "x"})
    assert man["step"] == 7
    like = TR.map_tensors(torch.zeros_like, t)
    got, man2 = ckpt.restore(path, like)
    assert man2["step"] == 7 and man2["extra"] == {"note": "x"}
    for a, b in zip(TR.tensors(t), TR.tensors(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_restore_detects_corruption(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    ckpt.save(path, t, step=0)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    man["hash"] = "0" * 64
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError):
        ckpt.restore(path, t)


def test_restore_shape_mismatch(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    ckpt.save(path, t, step=0)
    bad = dict(t, a=torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        ckpt.restore(path, bad)


def test_async_checkpointer_keeps_latest(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        saver.submit(t, s)
        saver.wait()
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000003", "step_00000004"]
    assert saver.latest().endswith("step_00000004")
    assert saver.last_saved_step == 4


def test_async_submit_copies_before_returning(tmp_path):
    """The tree may change after ``submit`` returns (the trainer's next
    step updates its buffers in place): the checkpoint holds the values
    at submission."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    saver.submit(t, 1)
    t["a"].add_(1.0)
    saver.wait()
    got, _ = ckpt.restore(saver.latest(), t)
    assert torch.equal(got["a"], want)


def _npz(path):
    with np.load(os.path.join(path, "leaves.npz")) as data:
        return {k: data[k] for k in data.files}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_bytes_and_hash_equal_reference(tmp_path):
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    JC.save(jpath, _jtree(), step=3)
    ckpt.save(ppath, _tree(), step=3)
    jm, pm = _manifest(jpath), _manifest(ppath)
    assert pm["leaves"] == jm["leaves"]
    assert pm["hash"] == jm["hash"]
    ja, pa = _npz(jpath), _npz(ppath)
    assert ja.keys() == pa.keys()
    for k in ja:
        assert ja[k].dtype == pa[k].dtype
        np.testing.assert_array_equal(ja[k], pa[k])


@pytest.fixture(scope="module")
def train_state():
    """The reference's reduced params and AdamW state after one update,
    and the port's bridged twins."""
    jcfg = jreduced(load_all()["internlm2-1.8b"], tp=2)
    pcfg = reduced(get("internlm2-1.8b"))
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jo = JA.AdamWConfig()
    g = jax.tree.map(lambda p: (jnp.ones(p.shape) * 1e-3).astype(p.dtype), jp)
    jp, js, _ = JA.update(jp, g, JA.init(jp, jo), jo)
    pp = params_from_numpy(numpy_tree(jp), pcfg, "cpu")
    ps = opt_state_from_numpy(
        {"mu": numpy_tree(js.mu), "nu": numpy_tree(js.nu),
         "master": numpy_tree(js.master), "count": np.asarray(js.count)},
        pcfg, "cpu")
    return {"jtree": {"params": jp, "opt": js}, "ptree": {"params": pp,
                                                          "opt": ps},
            "pcfg": pcfg}


def test_train_state_checkpoint_equals_reference(train_state, tmp_path):
    """The port's params + AdamW state (layers as a list) write the
    reference's stacked keys, bytes and hash."""
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    JC.save(jpath, train_state["jtree"], step=1)
    ckpt.save(ppath, train_state["ptree"], step=1)
    jm, pm = _manifest(jpath), _manifest(ppath)
    assert pm["leaves"] == jm["leaves"]
    assert "opt/count" in pm["leaves"]
    assert "params/blocks/[0]/pos0/attn/wq/0/1" in pm["leaves"]
    assert pm["hash"] == jm["hash"]


def test_port_restores_reference_checkpoint(train_state, tmp_path):
    path = str(tmp_path / "j")
    JC.save(path, train_state["jtree"], step=5)
    pcfg = train_state["pcfg"]
    from repro_torch.models import transformer as PT
    fresh = PT.init_model(torch.Generator().manual_seed(1), pcfg)
    like = {"params": fresh, "opt": adamw.init(fresh, adamw.AdamWConfig())}
    got, man = ckpt.restore(path, like)
    assert man["step"] == 5
    assert int(got["opt"].count) == 1
    for a, b in zip(TR.tensors(train_state["ptree"]), TR.tensors(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.float(), b.float())


def test_reference_restores_port_checkpoint(train_state, tmp_path):
    path = str(tmp_path / "p")
    ckpt.save(path, train_state["ptree"], step=2)
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                        train_state["jtree"])
    got, man = JC.restore(path, like)
    assert man["step"] == 2
    for a, b in zip(jax.tree.leaves(train_state["jtree"]),
                    jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
