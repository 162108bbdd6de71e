"""The harness: errors collected while the run goes on, a clean run, the
last line's keys, unknown names refused, a cell added as data alone,
the CLI's refusal without a card, each request's latency stamped at its
completion, ``correct`` coming out false with the timed path broken
underneath (one test per fault a cell can have), and the control put in
the program's place going through the run's own comparison."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.tests import tiny
from portbench import harness
from portbench.reference import checks

torch.set_num_threads(1)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_errors_are_collected_and_the_run_keeps_going(capsys):
    calls = []

    def ok():
        calls.append("ok")
        return 1.0

    def boom():
        calls.append("boom")
        raise RuntimeError("kaput")

    def late():
        calls.append("late")
        return 2.0

    got, errors = harness.collect([("ok", ok), ("boom", boom),
                                   ("late", late)])
    assert calls == ["ok", "boom", "late"]
    assert got == {"ok": 1.0, "late": 2.0}
    assert errors == [{"name": "boom", "error": "RuntimeError: kaput"}]
    assert "kaput" in capsys.readouterr().err


@pytest.mark.parametrize("cell", [tiny.CHAT, tiny.PRETRAIN])
def test_a_clean_run_has_no_errors(cell):
    got, errors = tiny.run(cell)
    assert errors == []
    assert got["correct"] is True and got["failed"] == 0
    bench = harness.load_benchmark()
    e2e, _ = harness.cell_metrics(bench, cell)
    assert sorted(got["metrics"]) == sorted(m["name"] for m in e2e)


def test_the_last_line_has_exactly_the_contracts_keys():
    line = harness.result_line(True, 3, 0, {"x_s": (1.5, "s")},
                               {"platform": "gpu"}, [("gap", 0.1, 0.2)])
    assert list(json.loads(line)) == KEYS + ["checks"]
    line = harness.result_line(False, 3, 1, {}, {"platform": "gpu"},
                               [("gap", float("inf"), 0.2)],
                               breakdown={"device_ops": [],
                                          "idle_gaps": []})
    got = json.loads(line)
    assert list(got) == KEYS + ["breakdown", "checks"]
    assert got["checks"]["gap"] == {"value": None, "limit": 0.2}


def test_unknown_workload_or_metric_is_refused(capsys):
    from portbench import run
    assert run.main(["--workload", "no-such-cell", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    for kind, name in (("metrics", "no_such.metric"),
                       ("workloads", "no-such-cell"),
                       ("metrics", "../run")):
        with pytest.raises(harness.UnknownName):
            (harness.load_metric(name) if kind == "metrics"
             else harness.load_json(kind, name))


def test_without_a_card_the_cli_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", tiny.CHAT,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_outside_a_checkout_the_cli_fails(tmp_path):
    """With only BENCHMARK.json and the benchmark's own files, there is
    no program to run."""
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"),
                    tmp_path / "portbench")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", tiny.CHAT,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_added_as_data_alone(tmp_path, monkeypatch):
    """A new cell is a workload file and an entry in BENCHMARK.json: no
    file that is there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"),
                    root / "portbench")
    bench = harness.load_benchmark()
    w = tiny.workload(tiny.CHAT)
    w.update(name="internlm2-1.8b.chat-long")
    w["traffic"]["new_tokens"] = {"dist": "uniform", "lo": 20, "hi": 30}
    (root / "portbench" / "workloads" / (w["name"] + ".json")).write_text(
        json.dumps(w))
    bench["workloads"].append({"name": w["name"], "config": w["config"],
                               "traffic": "serve_bursts", "chips": 1,
                               "why": "longer answers"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if tiny.CHAT in m.get("workloads", ()):
            m["workloads"].append(w["name"])
    monkeypatch.setattr(harness, "HERE", str(root / "portbench"))
    line, errors = harness.run_cell(
        w["name"], 5, 0.2, False, t_start=0.0, device="cpu", bench=bench,
        config=tiny.config())
    got = json.loads(line)
    assert errors == [] and got["correct"] is True
    assert set(got["metrics"]) == {"serve_tokens_per_s", "request_p95_s",
                                   "setup_s"}
    assert got["attempted"] % 4 == 0


def test_latency_is_stamped_per_request_at_its_completion():
    """In one masked microbatch a request with fewer new tokens retires
    at an earlier step, so it is done sooner; none is later than the
    burst's return."""
    ctx = harness.make_context(tiny.CHAT, tiny.SEED, "cpu",
                               tiny.workload(tiny.CHAT), tiny.config())
    cell = harness.load_module("traffic", "serve_bursts").Cell(ctx)
    cell.setup()
    reqs = cell.traffic.burst(0)
    t0, t1 = cell._generate(reqs)
    cell.free()
    done = sorted(reqs, key=lambda r: r.max_new_tokens)
    assert all(t0 < r.t_done <= t1 for r in done)
    assert len({r.max_new_tokens for r in done}) > 1
    for a, b in zip(done, done[1:]):
        if a.max_new_tokens < b.max_new_tokens:
            assert a.t_done < b.t_done


# -- the timed path broken underneath: correct comes out false -----------

def _tokens_altered(monkeypatch):
    from repro_torch.serve import engine
    real = engine.Engine._sample

    def altered(self, *a, **k):
        return (real(self, *a, **k) + 1) % self.cfg.vocab
    monkeypatch.setattr(engine.Engine, "_sample", altered)


def _kv_state_unchanged(monkeypatch):
    from repro_torch.models import common

    real = common.decode_attention

    def unchanged(params, x, dims, cache_k, cache_v, **kw):
        k0, v0 = cache_k.clone(), cache_v.clone()
        out = real(params, x, dims, cache_k, cache_v, **kw)
        cache_k.copy_(k0)
        cache_v.copy_(v0)
        return out
    monkeypatch.setattr(common, "decode_attention", unchanged)


def _half_the_requests(monkeypatch):
    from repro_torch.serve import engine
    real = engine.Engine.generate

    def half(self, reqs):
        real(self, reqs[:len(reqs) // 2])
        return reqs
    monkeypatch.setattr(engine.Engine, "generate", half)


def _train_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(params, grads, state, cfg):
        return params, state, {"lr": 0.0, "grad_norm": torch.zeros(())}
    monkeypatch.setattr(adamw, "update", unchanged)


def _half_the_batch(monkeypatch):
    from repro_torch.models import transformer as T
    real = T.forward_train

    def half(params, cfg, batch):
        n = batch["tokens"].shape[1] // 2
        return real(params, cfg, {k: v[:, :n] for k, v in batch.items()})
    monkeypatch.setattr(T, "forward_train", half)


@pytest.mark.parametrize("cell,fault", [
    (tiny.CHAT, _tokens_altered), (tiny.CHAT, _kv_state_unchanged),
    (tiny.CHAT, _half_the_requests), (tiny.PRETRAIN, _train_state_unchanged),
    (tiny.PRETRAIN, _half_the_batch)],
    ids=["chat-token-altered", "chat-state-unchanged", "chat-half-batch",
         "pretrain-state-unchanged", "pretrain-half-batch"])
def test_a_fault_underneath_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    got, _ = tiny.run(cell)
    assert got["correct"] is False


# -- the control in the program's place ----------------------------------

def _control_served(monkeypatch):
    """The reference stored one precision lower serves: the tokens
    judged are those it puts first at each position."""
    from portbench.traffic import serve_bursts as SB
    real = SB.Cell.sample

    def control(self):
        ctx = self.ctx
        return checks.control_tokens(ctx.family.REFERENCE, ctx.config,
                                     ctx.seed, real(self), ctx.device)
    monkeypatch.setattr(SB.Cell, "sample", control)


def _control_trained(monkeypatch):
    """The reference stored one precision lower trains: its losses,
    first gradients and changes stand for the program's."""
    from portbench.traffic import train_steps as TS
    real = TS.Cell.check

    def control(self):
        ctx = self.ctx
        self.free()
        self.free = lambda: None
        got = checks.train_readings(
            ctx.family.REFERENCE, ctx.config, ctx.seed,
            ctx.workload["traffic"]["optimizer"],
            [self.batch_at(k) for k in range(len(self.losses))],
            ctx.device, demote=True)
        self.losses, self.grad1, self.change = (got["loss"], got["grad1"],
                                                got["change"])
        return real(self)
    monkeypatch.setattr(TS.Cell, "check", control)


CONTROLS = [(tiny.CHAT, _control_served, "served_logit_gap"),
            (tiny.PRETRAIN, _control_trained, "grad_gap")]


def test_the_served_control_goes_through_the_runs_comparison(monkeypatch):
    """The run's own comparison reads the control's tokens as it reads
    the program's: the reported gap is the control's.  (At this size the
    control need not cross the cell's limit; the test on the card below
    holds it to the limit at the cell's size.)"""
    from portbench.traffic import serve_bursts as SB
    seen = []
    real = SB.Cell.sample

    def keep(self):
        seen.append(real(self))
        return seen[-1]
    monkeypatch.setattr(SB.Cell, "sample", keep)
    _control_served(monkeypatch)
    got, errors = tiny.run(tiny.CHAT)
    assert errors == [] and len(seen) == 1
    want = checks.control_gaps(harness.load_module(
        "families", "dense_gqa").REFERENCE, tiny.config(), tiny.SEED,
        seen[0], "cpu")
    assert got["checks"]["served_logit_gap"]["value"] == max(want)


def test_the_trained_control_is_not_correct(monkeypatch):
    _control_trained(monkeypatch)
    got, errors = tiny.run(tiny.PRETRAIN)
    assert errors == [] and got["correct"] is False
    assert got["checks"]["grad_gap"]["value"] \
        > got["checks"]["grad_gap"]["limit"]


# -- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CLI refuses the CPU")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [tiny.PRETRAIN, tiny.CHAT])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(tiny.SEED), "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["correct"] is True
    assert got["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control,number", CONTROLS,
                         ids=["chat", "pretrain"])
def test_the_control_at_the_cells_size_is_not_correct(card, cell, control,
                                                      number, monkeypatch):
    """A run of the cell as it is timed, with the control in the
    program's place, comes out not correct by the cell's own limits."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ops.ensure_built()
    control(monkeypatch)
    line, errors = harness.run_cell(cell, tiny.SEED + 7, 1.0, False,
                                    t_start=time.time(), device="cuda")
    got = json.loads(line)
    print(json.dumps(got["checks"]))
    assert errors == [] and got["failed"] == 0
    assert got["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in got["checks"].values())
