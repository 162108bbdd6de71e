"""Per-architecture smoke tests of the port (twin of
``tests/test_models_smoke.py``): the reduced config of every arch the
reference registers, on the CPU with random weights from a seeded
generator — the training forward (every family trains: a finite loss
near ln(vocab)), prefill shapes, three decode steps, the encoder's
missing decode step, and the published parameter counts of the full
configs.
"""
import numpy as np
import pytest
import torch

from repro.configs import load_all as jload_all
from repro_torch.configs import get, load_all, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T

ARCHS = sorted(jload_all().keys())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    return reduced(get(name), tp=2)


def _params(cfg):
    return T.init_model(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    cfg = _cfg(arch)
    B, S = 2, 16
    params = _params(cfg)
    batch = make_batch(cfg, S, B, kind="train", seed=0, step=0,
                       device="cpu")
    with torch.no_grad():
        loss, _ = T.forward_train(params, cfg, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), (arch, float(loss))
    # a tiny model on random labels should start near ln(vocab)
    assert 0.5 * np.log(cfg.vocab) < float(loss) < 3 * np.log(cfg.vocab) + 5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_shapes(arch):
    cfg = _cfg(arch)
    B, S = 2, 16
    batch = make_batch(cfg, S, B, kind="prefill", seed=0, step=0,
                       device="cpu")
    with torch.no_grad():
        logits = T.forward_prefill(_params(cfg), cfg, batch)
    assert logits.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), arch


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if not get(a).encoder_only])
def test_decode_steps(arch):
    cfg = _cfg(arch)
    B = 2
    params = _params(cfg)
    caches = T.init_cache(cfg, B, 32, "cpu")
    tok = torch.zeros((B, 1), dtype=torch.long)
    with torch.no_grad():
        for pos in range(3):
            logits, caches = T.forward_decode(params, cfg, tok, caches, pos)
            assert logits.shape == (B, 1, cfg.vocab)
            assert bool(torch.isfinite(logits).all()), (arch, pos)
            tok = logits.argmax(-1)


def test_encoder_only_has_no_decode():
    cfg = _cfg("hubert-xlarge")
    params = _params(cfg)
    with pytest.raises(ValueError):
        T.forward_decode(params, cfg, torch.zeros((1, 1), dtype=torch.long),
                         T.init_cache(cfg, 1, 8, "cpu"), 0)


def test_param_counts_match_published():
    reg = load_all()
    expect = {"llama3-8b": 8.0e9, "llama3-405b": 405.8e9,
              "jamba-v0.1-52b": 51.6e9, "phi3.5-moe-42b-a6.6b": 41.9e9,
              "qwen2-moe-a2.7b": 14.3e9, "llava-next-34b": 34.4e9}
    for name, want in expect.items():
        got = reg[name].param_count()
        assert got == jload_all()[name].param_count(), name
        assert abs(got - want) / want < 0.03, (name, got, want)
