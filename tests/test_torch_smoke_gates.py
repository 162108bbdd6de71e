"""CPU rehearsals of ``chip_smoke.py``'s cached-decode gates
(``decode_vs_bulk``, phases 9 and 10) at reduced size: a clean run
passes, and a fault that only the kernel decode makes fails the gate
meant to see it.

The wrappers run their plain versions on CPU tensors; with the device
spec forced to ``gpu-h100`` the linears take the kernel route, so the
script's swaps of the ksplit function (plain, a second summation order,
the kernel) take effect.  A fault goes into the kernel-decode run only:
the run in which the ksplit function is the original one.

* MoE (reduced qwen2, capacity 16): the kernel decode routes through a
  swapped router (its expert columns rolled by one).  Every run replays
  the bulk's picks, so only the own-pick gate can see it: it must fail
  on own picks that differ at ordinary router margins.
* xLSTM (reduced, one pattern period, 64 positions): the kernel decode
  drops the mLSTM conv state every step; the kernel-decode gate fails.
"""
import dataclasses
import os
import sys

import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.kernels import ksplit_gemm as K
from repro_torch.models import transformer as PT
from repro_torch.obs import metrics as PM
from repro_torch.tune import device as DV
from repro_torch.tune import dispatch as PD
from repro_torch.tune import search as PS

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(autouse=True)
def _rehearsal(tmp_path, monkeypatch):
    monkeypatch.setattr(CS, "DEVICE", "cpu")
    monkeypatch.setenv(DV.DEVICE_ENV, "gpu-h100")
    monkeypatch.setenv(PS.CACHE_ENV, str(tmp_path / "torch.json"))
    monkeypatch.setattr(PD, "_REGISTRY", {})
    monkeypatch.setattr(PS, "_default_cache", None)
    monkeypatch.setattr(PM, "_DEFAULT", PM.MetricsRegistry())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fault_in_kernel_decode(monkeypatch, fault):
    """Run ``fault(params, caches)`` -> params before every step of the
    kernel-decode run only."""
    kernel_fn = K.ksplit_gemm_multi
    orig = PT.forward_decode

    def forward_decode(params, cfg, tokens, caches, *a, **kw):
        if K.ksplit_gemm_multi is kernel_fn:
            params = fault(params, caches)
        return orig(params, cfg, tokens, caches, *a, **kw)

    monkeypatch.setattr(PT, "forward_decode", forward_decode)


def _qwen2():
    cfg = dataclasses.replace(reduced(get("qwen2-moe-a2.7b")),
                              capacity_factor=16.0)
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def test_moe_own_pick_gate_passes_clean_run():
    cfg, params = _qwen2()
    out = CS.decode_vs_bulk(cfg, params, 16, 0, "rehearsal")
    assert out["routing"]["above_bound"] == 0


def test_moe_own_pick_gate_fails_swapped_router(monkeypatch):
    cfg, params = _qwen2()

    def swap_router(p, caches):
        layers = [dict(lp, moe=dict(lp["moe"], router=torch.roll(
            lp["moe"]["router"], 1, dims=-1))) for lp in p["layers"]]
        return dict(p, layers=type(p["layers"])(layers, p["layers"].period))

    _fault_in_kernel_decode(monkeypatch, swap_router)
    with pytest.raises(SystemExit, match="own expert picks differ"):
        CS.decode_vs_bulk(cfg, params, 16, 0, "rehearsal")


def _xlstm_period():
    cfg = reduced(get("xlstm-1.3b"))
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def test_xlstm_decode_gates_pass_clean_run():
    cfg, params = _xlstm_period()
    out = CS.decode_vs_bulk(cfg, params, 64, 0, "rehearsal")
    assert out["gaps"]["kernel_decode"]["max"] <= out["allowance"]


def test_xlstm_decode_gate_fails_dropped_conv_state(monkeypatch):
    cfg, params = _xlstm_period()

    def drop_conv(p, caches):
        for c in caches:
            if "conv" in c:
                c["conv"].zero_()
        return p

    _fault_in_kernel_decode(monkeypatch, drop_conv)
    with pytest.raises(SystemExit, match="kernel decode and bulk logits"):
        CS.decode_vs_bulk(cfg, params, 64, 0, "rehearsal")
