"""Training loop: step + prefetch + async checkpoint + watchdog (twin of
``repro.train.trainer``).

The loop is restart-safe: on ``RestartSignal`` (a straggler or failure,
or one injected by a test) it restores the newest checkpoint and resumes
from its step, and the deterministic data pipeline replays the exact
stream, so the resumed steps equal an uninterrupted run's bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import Prefetcher
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.fault import Heartbeat, RestartSignal, Watchdog
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    heartbeat_path: str = ""
    fault_injector: Optional[Callable[[int], None]] = None  # tests
    #: where a fresh model is built (given params keep their device)
    device: str = "cuda"


def train(cfg: ArchConfig, ocfg: adamw.AdamWConfig, tcfg: TrainerConfig,
          *, params=None, opt_state=None, start_step: int = 0,
          log: Callable[[str], None] = print, _history=None):
    """Returns (params, opt_state, history)."""
    if params is None:
        params = T.init_model(
            torch.Generator(device=tcfg.device).manual_seed(tcfg.seed), cfg)
    if opt_state is None:
        opt_state = adamw.init(params, ocfg)
    device = params["embed"].device

    step_fn = make_train_step(
        cfg, ocfg, tcfg.microbatches, tune_params=params,
        tune_tokens=tcfg.seq_len * tcfg.global_batch // tcfg.microbatches)
    saver = ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
    hb = Heartbeat(tcfg.heartbeat_path) if tcfg.heartbeat_path else None
    wd = Watchdog()
    history = _history if _history is not None else []

    pf = Prefetcher(cfg, tcfg.seq_len, tcfg.global_batch, kind="train",
                    seed=tcfg.seed, start_step=start_step, device=device)
    it = iter(pf)
    step = start_step
    try:
        while step < tcfg.steps:
            got_step, batch = next(it)
            assert got_step == step, (got_step, step)
            t0 = time.monotonic()
            try:
                if tcfg.fault_injector is not None:
                    tcfg.fault_injector(step)
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                loss = float(metrics["loss"])
            except RestartSignal as e:
                log(f"[fault] step {step}: {e.reason} → restore+resume")
                pf.close()
                return _recover(cfg, ocfg, tcfg, saver, e, params, opt_state,
                                step, log, history)
            dt = time.monotonic() - t0
            wd.record(dt)
            if hb:
                hb.beat(step, dt)
            fault = wd.check()
            if fault and "straggler" in fault:
                log(f"[watchdog] {fault}")
            if step % tcfg.log_every == 0:
                log(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            history.append({"step": step, "loss": loss, "time": dt})
            step += 1
            if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                saver.submit({"params": params, "opt": opt_state}, step)
    finally:
        pf.close()
    saver.wait()
    return params, opt_state, history


def _recover(cfg, ocfg, tcfg, saver, sig: RestartSignal, params, opt_state,
             step, log, history):
    """Restore from the newest checkpoint and resume (the injector is
    cleared for the steps already survived, so a fault cannot loop)."""
    saver.wait()
    latest = saver.latest()
    if latest is None:
        log("[fault] no checkpoint yet → restart from step 0 state")
        restored = {"params": params, "opt": opt_state}
        resume_step = 0
    else:
        restored, manifest = ckpt.restore(latest,
                                          {"params": params,
                                           "opt": opt_state})
        resume_step = manifest["step"]
        log(f"[fault] restored step {resume_step} from {latest}")
    inj = tcfg.fault_injector
    tcfg2 = dataclasses.replace(
        tcfg, fault_injector=(lambda s: None if s <= step else inj(s))
        if inj else None)
    kept = [h for h in history if h["step"] < resume_step]
    return train(cfg, ocfg, tcfg2, params=restored["params"],
                 opt_state=restored["opt"], start_step=resume_step, log=log,
                 _history=kept)
