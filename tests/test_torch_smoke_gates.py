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
* Jamba (reduced, 64 positions): the kernel decode drops the Mamba
  state every step; the run fails before the plain-decode gate.

``decode_step_bytes`` (by part; the bound is their sum) counts by
mixer: attention layers read their visible KV and write one slot,
recurrent layers (Mamba, mLSTM, sLSTM) read and write their fp32 state.
At full width (caches on the meta device, no memory) it keeps qwen2's
bound as it was, gives xLSTM-1.3B the 10.71 GB at batch 4 that phase 10
printed, and counts the Jamba period's one KV cache and seven Mamba
states.

Phase 12's gates (reduced HuBERT, LLaVA and Llama-3-405B; the ksplit
function wrapped so that each call on a CPU tensor counts as a launch,
as the kernel's wrapper counts on the card):

* the encoder gate passes, and fails when the encoder attends causally;
* the image and text-order gates pass, and fail when the patches are
  dropped or placed after the text;
* the per-step launch gate passes at the expected count (194 per HuBERT
  forward, 42 per LLaVA prefill at 8 layers, 41 per its model step, 11
  per Llama-3-405B step at 2 layers), and fails when one step launches
  one more;
* the kernel-against-plain gate fails on a kernel whose output is off
  by more than twice the plain orders' gap.

Phase 14's gates (a reduced InternLM2 served by a two-replica cluster):

* the token gate passes, and fails when one replica is built with
  another ``rng_seed`` (its sampled requests change);
* the trace gate passes on the cluster's trace, and fails on a line of
  an unknown ``cat`` or an ``X`` span without ``dur``;
* the cache-only spy passes on resolutions from the cache, and fails on
  a cache-only resolution that calls ``measure``.
"""
import dataclasses
import os
import sys

import numpy as np

import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.data import pipeline as DP
from repro_torch.kernels import ksplit_gemm as K
from repro_torch.models import common as PC
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


def test_jamba_decode_gate_fails_dropped_mamba_state(monkeypatch):
    """Reduced Jamba (capacity 16): the kernel decode zeroes every Mamba
    layer's state h before each step; a gate checked before the
    plain-decode one fails (the MoE layers' inputs move, so the own-pick
    gate sees it first; the kernel-decode gate would next).  (At reduced
    width the second bulk order adds as the plain one does, so the
    plain-decode gate has only its 2^-8 floor here; on the card its
    allowance is the orders' gap.)"""
    cfg = dataclasses.replace(reduced(get("jamba-v0.1-52b")),
                              capacity_factor=16.0)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)

    def drop_state(p, caches):
        for c in caches:
            if "h" in c:
                c["h"].zero_()
        return p

    _fault_in_kernel_decode(monkeypatch, drop_state)
    with pytest.raises(SystemExit, match="own expert picks differ|kernel "
                       "decode and bulk logits"):
        CS.decode_vs_bulk(cfg, params, 64, 0, "rehearsal")


def _old_decode_step_bytes(cfg, kinds, batch, position):
    """The bound as phases 9 and 10 computed it before it counted by
    mixer: a KV read for every layer."""
    dims = PT.dims_of(cfg)
    kv = 0
    for mixer, _ in cfg.layer_kinds():
        seen = position + 1
        if mixer == "attn_local":
            seen = min(seen, cfg.local_window)
        kv += batch * (seen + 1) * dims.n_kv * dims.head_dim * 2 * 2
    weights = sum(v for k, v in kinds.items() if k != "embedding")
    return weights + batch * cfg.d_model * 2 + kv + batch * cfg.vocab * 4


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "gemma3-4b"])
def test_decode_bytes_unchanged_for_attention_models(name):
    kinds = {"experts": 12_345_678_901, "attention": 98_765_432,
             "embedding": 1_000_000_000, "other": 7}
    for position in (0, 74, 2047):
        assert sum(CS.decode_step_bytes(get(name), kinds, 4,
                                        position).values()) == \
            _old_decode_step_bytes(get(name), kinds, 4, position)


def test_decode_bytes_xlstm_matches_phase_10():
    """42 mLSTM cells (C, n, m, conv) and 6 sLSTM cells (c, n, m, h) of
    fp32 state per row, read and written at batch 4, no KV; with the
    5.047 GB of non-embedding weights phase 10 printed, 10.71 GB."""
    cfg = get("xlstm-1.3b")
    d_in, nh = 2 * cfg.d_model, cfg.n_heads
    dh = d_in // nh
    mlstm = 4 * (nh * dh * dh + nh * dh + nh + 3 * d_in)
    slstm = 4 * 4 * nh * (cfg.d_model // nh)
    parts = CS.decode_step_bytes(cfg, {"recurrent": 5.047e9,
                                       "embedding": 2e8}, 4, 11)
    assert parts["kv"] == 0
    assert parts["state"] == 2 * 4 * (42 * mlstm + 6 * slstm)
    assert round(parts["state"] / 8 / 1e6, 2) == 707.59
    assert round(sum(parts.values()) / 1e9, 2) == 10.71


def test_decode_bytes_jamba_period():
    """One attention layer's KV (8 kv heads of 128) and seven Mamba states
    (h [8192, 16] and conv [3, 8192], fp32) at batch 4."""
    cfg = dataclasses.replace(get("jamba-v0.1-52b"), n_layers=8)
    parts = CS.decode_step_bytes(cfg, {"experts": 10, "embedding": 3}, 4,
                                 74)
    assert parts["kv"] == 4 * 76 * 8 * 128 * 2 * 2
    assert parts["state"] == 2 * 4 * 7 * 4 * (8192 * 16 + 3 * 8192)
    assert parts["weights"] == 10
    assert parts["logits"] == 4 * 65536 * 4
    assert parts["embedding_rows"] == 4 * 4096 * 2
    assert np.isclose(parts["state"] / 4 / 2 / 7, 622592)


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """Each ksplit call counts as a launch (on the card the kernel's
    wrapper counts; its plain version on the CPU does not)."""
    plain = K.ksplit_gemm_multi

    def launch(*a, **kw):
        K.launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(K, "ksplit_gemm_multi", launch)
    return launch


def _model(name, **kw):
    cfg = dataclasses.replace(reduced(get(name)), **kw)
    return cfg, PT.init_model(torch.Generator().manual_seed(0), cfg)


def test_expected_launch_counts_at_the_card_depths():
    hubert = get("hubert-xlarge")
    llava = dataclasses.replace(get("llava-next-34b"),
                                n_layers=CS.LLAVA_LAYERS)
    llama = dataclasses.replace(get("llama3-405b"),
                                n_layers=CS.LLAMA405_LAYERS)
    assert CS.ksplit_linears(hubert, frontend=True) == 48 * 4 + 2 == 194
    assert CS.ksplit_linears(llava, frontend=True) == 8 * 5 + 2 == 42
    assert CS.ksplit_linears(llava, frontend=False) == 8 * 5 + 1 == 41
    assert CS.ksplit_linears(llama, frontend=False) == 2 * 5 + 1 == 11


def test_encoder_gate_passes_clean_run():
    cfg, params = _model("hubert-xlarge")
    batch = DP.make_batch(cfg, 16, 2, kind="train", device="cpu")
    assert CS.encoder_attends_both_ways(params, cfg, batch, "rehearsal") > 0


def test_encoder_gate_fails_causal_attention(monkeypatch):
    cfg, params = _model("hubert-xlarge")
    batch = DP.make_batch(cfg, 16, 2, kind="train", device="cpu")
    orig = PC.attention_block

    def causal(*a, **kw):
        return orig(*a, **dict(kw, causal=True))

    monkeypatch.setattr(PC, "attention_block", causal)
    with pytest.raises(SystemExit, match="attends causally"):
        CS.encoder_attends_both_ways(params, cfg, batch, "rehearsal")


def _llava_gates(cfg, params):
    batch = DP.make_batch(cfg, 16, 1, kind="prefill", device="cpu")

    def prefill():
        with torch.no_grad():
            return PT.forward_prefill(params, cfg, batch)

    logits, plain, plain2 = CS.three_orders(prefill)
    gate = CS.order_gate("rehearsal", logits, plain, plain2)
    return CS.image_and_text_order(params, cfg, batch, logits,
                                   gate["allowance"], "rehearsal")


def test_image_gates_pass_clean_run():
    assert _llava_gates(*_model("llava-next-34b")) > 0


@pytest.mark.parametrize("fault, match", [
    ("dropped", "does not see the image"),
    ("after", "not the prompt's last part")])
def test_image_gates_fail_misplaced_patches(monkeypatch, fault, match):
    cfg, params = _model("llava-next-34b")

    def embed(params, cfg, batch):
        te = PC.embed(params["embed"], batch["tokens"])
        pe = params["frontend_proj"](
            batch["patch_embeds"].to(torch.bfloat16)).to(torch.bfloat16)
        x = te if fault == "dropped" else torch.cat([te, pe], dim=1)
        B, S = x.shape[:2]
        return x, torch.arange(S)[None].expand(B, S)

    monkeypatch.setattr(PT, "_embed_inputs", embed)
    with pytest.raises(SystemExit, match=match):
        _llava_gates(cfg, params)


@pytest.mark.parametrize("extra", [0, 1])
def test_step_launch_gate(counted, monkeypatch, extra):
    """Reduced Llama-3-405B served in masked mode: every model step's
    launches are read apart and must equal ksplit_linears (5 per layer,
    the lm_head); one extra launch in one step fails the gate."""
    from repro_torch.serve import Engine, ServeConfig
    cfg, params = _model("llama3-405b")
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=32, refill=False, prefix_cache=False,
        chunked_prefill=False))
    eng.warmup()
    if extra:
        orig, calls = PT.forward_decode, []

        def one_more(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                K.launches += 1
            return orig(*a, **kw)

        monkeypatch.setattr(PT, "forward_decode", one_more)

    def stream():
        return CS.family_stream(cfg.vocab, (4, 4, 8, 8), 3, 0)

    want = CS.ksplit_linears(cfg, frontend=False)
    assert want == cfg.n_layers * 5 + 1
    if extra:
        with pytest.raises(SystemExit, match=f"not {want} in each"):
            CS.served_counted(eng, stream, want, "rehearsal")
        return
    reqs, _, launches, st, steps = CS.served_counted(eng, stream, want,
                                                     "rehearsal")
    assert len(steps) == st["prefill_steps"] + st["decode_steps"] > 0
    assert launches["ksplit_gemm"] == want * len(steps)


def test_hubert_forward_launch_count(counted):
    """One encoder pass of reduced HuBERT launches ksplit_linears(cfg,
    frontend=True) times: 4 per layer, frontend_proj, lm_head."""
    from repro_torch.kernels import ops
    cfg, params = _model("hubert-xlarge")
    batch = DP.make_batch(cfg, 16, 2, kind="prefill", device="cpu")
    ops.reset_launch_counts()
    CS.all_logits(params, cfg, batch)
    n = ops.launch_counts()["ksplit_gemm"]
    assert n == CS.ksplit_linears(cfg, frontend=True) == 4 * 2 + 2
    CS.check_counts("rehearsal", [n], n)
    with pytest.raises(SystemExit):
        CS.check_counts("rehearsal", [n + 1], n)


def test_order_gate_fails_an_off_kernel():
    plain = torch.linspace(-4.0, 4.0, 1000)
    plain2 = plain + 1e-4
    assert CS.order_gate("rehearsal", plain + 1e-4, plain, plain2)
    off = plain.clone()
    off[7] += 0.1            # beyond 2x the orders' gap and the bf16 floor
    with pytest.raises(SystemExit, match="off its plain version"):
        CS.order_gate("rehearsal", off, plain, plain2)



# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

@pytest.fixture
def counted_convert(monkeypatch):
    """Each non-empty storage cast counts as a convert launch (on the card
    the kernel's wrapper counts; its plain version on the CPU does not)."""
    from repro_torch.kernels import convert as CV
    plain = CV.convert

    def launch(x, dtype):
        if x.numel():
            CV.launches += 1
        return plain(x, dtype)

    monkeypatch.setattr(CV, "convert", launch)


def test_phase13_launch_reckoning_matches_a_step(counted, counted_convert):
    """``step_launches`` reckons what one step of each family launches
    (ksplit once per KSplit linear, convert once per tensor below fp32
    and per NSplit linear with an fp32 segment); the per-step gate passes
    on the counts read, and fails with one launch more in one step."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    for name, want in (("qwen2-moe-a2.7b", (11, 26)),
                       ("xlstm-1.3b", (9, 48)),
                       ("jamba-v0.1-52b", (19, 63))):
        cfg, params = _model(name)
        got = CS.step_launches(params)
        assert (got["ksplit_gemm"], got["convert"]) == want, name
        ocfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
        opt = adamw.init(params, ocfg)
        step = make_train_step(cfg, ocfg, 1)
        batch = DP.make_batch(cfg, 16, 2, kind="train", device="cpu")
        per_step = []
        for _ in range(2):
            ops.reset_launch_counts()
            params, opt, _ = step(params, opt, batch)
            per_step.append(ops.launch_counts())
        keys = {k: got[k] for k in ("ksplit_gemm", "convert")}
        CS.check_step_launches("rehearsal", per_step, keys)
        per_step[1] = dict(per_step[1], convert=per_step[1]["convert"] + 1)
        with pytest.raises(SystemExit, match="convert launches per step"):
            CS.check_step_launches("rehearsal", per_step, keys)


def _scanned(name, S):
    cfg, params = _model(name)
    batch = DP.make_batch(cfg, S, 2, kind="train", device="cpu")
    x, _ = PT._embed_inputs(params, cfg, batch)
    return cfg, params, x


@pytest.mark.parametrize("name, S", [("xlstm-1.3b", 512),
                                     ("jamba-v0.1-52b", 256)])
def test_cross_chunk_gate_passes_clean_run(name, S):
    cfg, params, x = _scanned(name, S)
    out = CS.cross_chunk_gate(params, cfg, x, "rehearsal")
    assert out["layers"] == sum(m in CS.SCAN_CHUNK
                                for m, _ in cfg.layer_kinds())
    assert out["min_moved"] > 0 and out["max_still"] == 0


@pytest.mark.parametrize("name, S, fn", [("xlstm-1.3b", 512, "_mlstm_chunk"),
                                         ("jamba-v0.1-52b", 256,
                                          "_ssm_chunked")])
def test_cross_chunk_gate_fails_detached_carry(monkeypatch, name, S, fn):
    """The scan run chunk by chunk with its carry detached between
    chunks: the last chunk's loss no longer reaches position 0."""
    from repro_torch.models import mamba as PMB
    from repro_torch.models import xlstm as PX
    mod = PX if fn == "_mlstm_chunk" else PMB
    orig = getattr(mod, fn)

    def detached(*args, chunk):
        S = args[0].shape[1]
        c = min(chunk, S)
        seq, state = args[:-1], args[-1]
        if fn == "_ssm_chunked":       # (u, dt, B, C | A, D), h0
            seq, fixed = args[:4], args[4:6]
        outs = []
        for i in range(0, S, c):
            part = [t[:, i:i + c] for t in seq]
            if fn == "_ssm_chunked":
                y, state = orig(*part, *fixed, state, chunk=c)
                state = state.detach()
            else:
                y, state = orig(*part, state, chunk=c)
                state = tuple(t.detach() for t in state)
            outs.append(y)
        return torch.cat(outs, dim=1), state

    monkeypatch.setattr(mod, fn, detached)
    cfg, params, x = _scanned(name, S)
    with pytest.raises(SystemExit, match="moves position 0"):
        CS.cross_chunk_gate(params, cfg, x, "rehearsal")


def _moe_step0(monkeypatch=None):
    from repro_torch.train.train_step import loss_and_grads
    cfg, params = _model("qwen2-moe-a2.7b")
    batch = DP.make_batch(cfg, 16, 2, kind="train", device="cpu")
    caught = []
    undo = CS._record_routing(caught)
    try:
        loss, metrics, grads = loss_and_grads(params, cfg, batch)
    finally:
        undo()
    return cfg, params, batch, loss, metrics, grads, caught


def test_aux_gate_passes_clean_run():
    cfg, params, batch, loss, metrics, _, _ = _moe_step0()
    out = CS.aux_in_loss(params, cfg, batch, loss, metrics, "rehearsal")
    assert out["aux"] > 0


def test_aux_gate_fails_when_the_aux_term_is_dropped(monkeypatch):
    orig = PT.forward_train

    def no_aux(params, cfg, batch):
        loss, m = orig(params, cfg, batch)
        loss = loss - CS.AUX_WEIGHT * m["aux"]
        return loss, dict(m, ce=loss)

    monkeypatch.setattr(PT, "forward_train", no_aux)
    cfg, params, batch, loss, metrics, _, _ = _moe_step0()
    with pytest.raises(SystemExit, match="not ce \\+ 0.01 x aux"):
        CS.aux_in_loss(params, cfg, batch, loss, metrics, "rehearsal")


def _probe(cfg, params, batch):
    from repro_torch.train.train_step import loss_and_grads
    probe = {k: v[:1, :CS.EXPERT_PROBE] for k, v in batch.items()}
    caught = []
    undo = CS._record_routing(caught)
    try:
        _, _, grads = loss_and_grads(params, cfg, probe)
    finally:
        undo()
    return CS.expert_grads_follow_kept(cfg, caught, grads, "rehearsal")


def test_expert_gradient_gate_passes_clean_run():
    cfg, params, batch, _, _, grads, caught = _moe_step0()
    full = CS.expert_grads_follow_kept(cfg, caught, grads, "rehearsal")
    assert full["experts_with_tokens"] > 0
    probe = _probe(cfg, params, batch)
    assert probe["experts_without"] > 0


def test_expert_gradient_gate_fails_wrong_expert_gathered(monkeypatch):
    """The dispatch table's rows rolled by one expert: each expert
    computes on its neighbour's tokens, so the experts whose gradient is
    nonzero are not the ones that kept a token."""
    import dataclasses as dc
    from repro_torch.models import moe as PMOE
    orig = PMOE.route

    def wrong(*a, **kw):
        r = orig(*a, **kw)
        return dc.replace(r, table=torch.roll(r.table, 1, dims=0))

    monkeypatch.setattr(PMOE, "route", wrong)
    cfg, params, batch, *_ = _moe_step0()
    with pytest.raises(SystemExit, match="does not follow their kept"):
        _probe(cfg, params, batch)


# ---------------------------------------------------------------------------
# phase 14: cluster tokens, trace hygiene, the cache-only spy
# ---------------------------------------------------------------------------

def _cluster_run(tmp_path, fault=None, trace=None):
    """Phase 14's requests on a reduced InternLM2 through one engine and
    a two-replica cluster (``fault(cluster)`` before serving); runs
    ``cluster_gate`` and returns the cluster."""
    import repro_torch
    from repro_torch.serve import Cluster, Engine, ServeConfig
    cfg = reduced(get("internlm2-1.8b"))
    params = PT.init_model(torch.Generator().manual_seed(0), cfg)
    single = CS.cluster_requests(cfg.vocab)
    CS.served_run(Engine(cfg, params, ServeConfig()), single)
    cl = Cluster(cfg, params, ServeConfig(replicas=CS.CLUSTER_REPLICAS))
    if fault is not None:
        fault(cl)
    reqs = CS.cluster_requests(cfg.vocab)
    if trace:
        repro_torch.configure(obs_trace=trace)
    try:
        CS.served_run(cl, reqs)
    finally:
        repro_torch.configure(obs_trace=None)
    CS.cluster_gate("rehearsal", reqs, [r.out_tokens for r in single],
                    cl.stats())
    return cl


def test_cluster_gates_pass_clean_run(tmp_path):
    path = str(tmp_path / "cluster.jsonl")
    cl = _cluster_run(tmp_path, trace=path)
    events = CS.trace_gate("rehearsal", path, CS.CLUSTER_REPLICAS)
    assert {"serve.microbatch", "serve.prefill", "serve.decode",
            "serve.warmup"} <= set(CS.span_summary(events))
    assert cl.stats()["healthy"] == 2


def test_cluster_token_gate_fails_replica_with_another_seed(tmp_path):
    def reseed(cl):
        eng = cl.replicas[1]
        eng.config = dataclasses.replace(eng.config, rng_seed=7)

    with pytest.raises(SystemExit, match="differ from one engine"):
        _cluster_run(tmp_path, fault=reseed)


@pytest.mark.parametrize("bad", [
    {"name": "serve.route", "cat": "rogue", "ph": "i", "ts": 1.0,
     "pid": 1, "tid": 1, "s": "t", "args": {"replica": 0}},
    {"name": "serve.decode", "cat": "serve", "ph": "X", "ts": 1.0,
     "pid": 1, "tid": 1, "args": {}}], ids=["unknown-cat", "span-no-dur"])
def test_trace_gate_fails_schema_faults(tmp_path, bad):
    import json
    path = str(tmp_path / "cluster.jsonl")
    _cluster_run(tmp_path, trace=path)
    CS.trace_gate("rehearsal", path, CS.CLUSTER_REPLICAS)
    with open(path, "a") as f:
        f.write(json.dumps(bad) + "\n")
    with pytest.raises(SystemExit, match="fails hygiene"):
        CS.trace_gate("rehearsal", path, CS.CLUSTER_REPLICAS)


def test_cache_only_spy_fails_a_measuring_resolution(tmp_path, monkeypatch):
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    rng = np.random.default_rng(0)
    A, B, C = (MPMatrix.from_dense(
        torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)),
        make_map((64, 64), 16, Policy("ratio", 0.5, seed=s)), 16)
        for s in range(3))
    monkeypatch.setenv(PS.CACHE_ONLY_ENV, "1")
    plan = PS.autotune(A, B, C)                 # model pick, in memory
    assert CS.cache_only_gate("rehearsal", lambda: PS.autotune(A, B, C)) \
        == plan
    monkeypatch.setattr(PS, "cache_only", lambda: False)   # the fault
    with pytest.raises(SystemExit, match="cache-only mode measured"):
        CS.cache_only_gate("rehearsal",
                           lambda: PS.autotune(A, B, C, force=True,
                                               warmup=1, iters=1))
