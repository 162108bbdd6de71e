"""Port parity of the data pipeline (twin of ``tests/test_serve_data.py``):
the port's batches are bit for bit the reference's for the same (seed,
step), the prefetcher replays the same stream from any step, and the
engine's greedy serving is deterministic.  The batches are compared on
the reduced InternLM2 and Llama-3-8B shapes (tokens) and on the reduced
HuBERT-XLarge (fp32 frames) and LLaVA-NeXT-34B (fp32 patch embeddings
ahead of the tokens, labels over the text) shapes.
"""
import numpy as np
import pytest
import torch

from repro.configs import load_all as jload_all
from repro.configs import reduced as jreduced
from repro.data.pipeline import batch_spec as jbatch_spec
from repro.data.pipeline import make_batch as jmake_batch
from repro_torch.configs import get, reduced
from repro_torch.data.pipeline import (Prefetcher, batch_spec, make_batch,
                                       to_device)


def _cfg():
    return reduced(get("internlm2-1.8b"), tp=2)


def test_pipeline_deterministic():
    cfg = _cfg()
    b1 = make_batch(cfg, 16, 4, kind="train", seed=3, step=11, device="cpu")
    b2 = make_batch(cfg, 16, 4, kind="train", seed=3, step=11, device="cpu")
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    b3 = make_batch(cfg, 16, 4, kind="train", seed=3, step=12, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama3-8b",
                                  "hubert-xlarge", "llava-next-34b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batches_equal_reference(arch, kind):
    jcfg = jreduced(jload_all()[arch], tp=2)
    cfg = reduced(get(arch), tp=2)
    assert cfg.vocab == jcfg.vocab
    for seed, step in ((0, 0), (3, 11), (7, 2 ** 19 + 5)):
        want = jmake_batch(jcfg, 16, 4, kind=kind, seed=seed, step=step)
        got = make_batch(cfg, 16, 4, kind=kind, seed=seed, step=step,
                         device="cpu")
        assert list(got) == list(want)
        for k in want:
            assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefetcher_order_and_restart():
    cfg = _cfg()
    pf = Prefetcher(cfg, 16, 2, kind="train", seed=0, start_step=5,
                    device="cpu")
    it = iter(pf)
    s0, b0 = next(it)
    s1, b1 = next(it)
    pf.close()
    assert (s0, s1) == (5, 6)
    assert not pf._thread.is_alive()
    want = make_batch(cfg, 16, 2, seed=0, step=6, device="cpu")
    assert torch.equal(b1["tokens"], want["tokens"])
    # restart from the same step reproduces the same batch
    pf2 = Prefetcher(cfg, 16, 2, kind="train", seed=0, start_step=5,
                     device="cpu")
    s0b, b0b = next(iter(pf2))
    pf2.close()
    assert s0b == 5
    assert torch.equal(b0["tokens"], b0b["tokens"])


def test_batch_spec_matches_batch_and_reference():
    cfg = _cfg()
    jcfg = jreduced(jload_all()["internlm2-1.8b"], tp=2)
    for kind in ("train", "prefill", "decode"):
        spec = batch_spec(cfg, 16, 2, kind)
        jspec = jbatch_spec(jcfg, 16, 2, kind)
        batch = make_batch(cfg, 16, 2, kind=kind, device="cpu")
        assert set(spec) == set(batch) == set(jspec)
        for k, (shape, dtype) in spec.items():
            assert batch[k].shape == shape == jspec[k].shape
            assert batch[k].dtype == dtype
    with pytest.raises(ValueError):
        batch_spec(cfg, 16, 2, "nonsense")


def test_to_device_keeps_bits_and_defaults_to_the_card():
    b = make_batch(_cfg(), 8, 2, device="cpu")
    moved = to_device(b, "cpu")
    assert all(torch.equal(b[k], moved[k]) for k in b)
    import inspect
    for fn in (make_batch, Prefetcher.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_engine_greedy_deterministic():
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = _cfg()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = T.init_model(torch.Generator().manual_seed(0), cfg)
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=32))
        prompts = [np.array([1, 2, 3]), np.array([4, 5])]
        r1 = eng.generate([Request(p, max_new_tokens=4) for p in prompts])
        r2 = eng.generate([Request(p, max_new_tokens=4) for p in prompts])
    finally:
        torch.set_num_threads(n)
    for a, b in zip(r1, r2):
        assert a.done and b.done
        assert len(a.out_tokens) == 4
        assert a.out_tokens == b.out_tokens
