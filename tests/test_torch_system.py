"""Twins of ``tests/test_system.py`` for the port: the tile-centric
mixed-precision GEMM as the matmul substrate of a small LM, trained on
the CPU, checkpointed, restored and served — each with the reference
test's own assertions and limits.

(The reference file's other two tests, the sharding specs and the HLO
analysis, wait for ``ROADMAP.md`` queue 1, items 6b and 11.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get, reduced
from repro_torch.core.layout import KSplitWeight, NSplitWeight
from repro_torch.core.linear import MPLinear
from repro_torch.core.precision import Policy
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.optim import adamw
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tensors
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """The port's tune state confined to this test (its plan cache under
    tmp_path, a fresh registry and metrics)."""
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.delenv(DV.DEVICE_ENV, raising=False)
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_weights(node):
    """Every K- or N-split weight of a parameter tree, in tree order."""
    if isinstance(node, (KSplitWeight, NSplitWeight)):
        yield node
    elif isinstance(node, MPLinear):
        yield from _split_weights(node.w)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _split_weights(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _split_weights(v)


def _batch(cfg, **kw):
    return make_batch(cfg, 16, 2, kind="train", device="cpu", **kw)


def _opt():
    return adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def test_mp_policy_changes_storage_not_semantics():
    """Same seed, different policy ratio: losses start close (bf16 vs fp32
    storage noise only), storage bytes differ exactly 2x."""
    base = reduced(get("llama3-8b"))
    losses, bytes_ = {}, {}
    for ratio in (0.0, 1.0):
        cfg = dataclasses.replace(
            base, mp_policy=Policy(kind="ratio", ratio_high=ratio))
        params = PT.init_model(torch.Generator().manual_seed(0), cfg)
        loss, _ = PT.forward_train(params, cfg, _batch(cfg, seed=1))
        losses[ratio] = float(loss)
        bytes_[ratio] = sum(w.storage_bytes()
                            for w in _split_weights(params))
    assert abs(losses[0.0] - losses[1.0]) < 0.2, losses
    assert bytes_[0.0] * 2 == bytes_[1.0]


def test_norm_topk_policy_trains():
    cfg = dataclasses.replace(
        reduced(get("internlm2-1.8b")),
        mp_policy=Policy(kind="norm_topk", ratio_high=0.25))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    ocfg = _opt()
    opt = adamw.init(params, ocfg)
    step = make_train_step(cfg, ocfg, 1)
    batch = _batch(cfg)
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        assert bool(torch.isfinite(m["loss"]))


def test_train_then_serve_roundtrip(tmp_path):
    """Train a few steps → checkpoint → restore → decode greedily."""
    cfg = reduced(get("internlm2-1.8b"))
    ocfg = _opt()
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init(params, ocfg)
    step = make_train_step(cfg, ocfg, 1)
    for s in range(3):
        params, opt, _ = step(params, opt, _batch(cfg, step=s))
    ckpt.save(str(tmp_path / "ck"), {"params": params}, step=3)
    restored, _ = ckpt.restore(str(tmp_path / "ck"), {"params": params})
    eng = Engine(cfg, restored["params"],
                 ServeConfig(max_batch=1, max_seq=32))
    [req] = eng.generate([Request(np.array([1, 2, 3], np.int32),
                                  max_new_tokens=3)])
    assert len(req.out_tokens) == 3
    assert all(0 <= t < cfg.vocab for t in req.out_tokens)


def test_fp8_low8_class_end_to_end():
    """Beyond-paper LOW8 (fp8 e4m3) storage class: a model whose matmul
    weights carry a 25D:50S:25Q map trains with finite loss, and storage
    accounting reflects the 1-byte class."""
    cfg = dataclasses.replace(
        reduced(get("llama3-8b")),
        mp_policy=Policy(kind="ratio", ratio_high=0.25, ratio_low8=0.25))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    n_fp8 = sum(t.numel() for t in tensors(params)
                if t.dtype == torch.float8_e4m3fn)
    assert n_fp8 > 0
    ocfg = _opt()
    opt = adamw.init(params, ocfg)
    step = make_train_step(cfg, ocfg, 1)
    batch = _batch(cfg)
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        assert bool(torch.isfinite(m["loss"])), float(m["loss"])
    # storage: 25% fp32 + 50% bf16 + 25% fp8 ≈ 2.25 B/elem on split weights
    # (block-rounding makes small matrices deviate; check the effective rate)
    w = next(_split_weights(params))
    rate = w.storage_bytes() / sum(b.numel() for b in w.bufs)
    assert 2.0 <= rate <= 2.75, rate
