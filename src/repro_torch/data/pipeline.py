"""Deterministic synthetic data pipeline (twin of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``, drawn from the same
numpy generator as the reference's, so the batches are bit for bit the
reference's and a replay after a restart is exact.  A background thread
keeps ``depth`` batches ahead of the training loop; each batch is staged
in pinned host memory and copied to the device without blocking the
host.  The frontends' inputs are drawn as the reference draws them: an
audio config takes fp32 ``frames`` [B, S, frontend_dim], a vision config
fp32 ``patch_embeds`` [B, P, frontend_dim] and ``tokens`` [B, S - P],
its ``labels`` covering the text only.  Fields are drawn in the
reference's spec order, since that order consumes the generator.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def batch_spec(cfg: ArchConfig, seq_len: int, global_batch: int,
               kind: str) -> dict:
    """``{name: (shape, dtype)}`` of every model input of ``kind``
    (``train``, ``prefill`` or ``decode``)."""
    B, S = global_batch, seq_len
    f32, i32 = torch.float32, torch.int32
    if kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            spec = {"frames": ((B, S, cfg.frontend_dim), f32)}
        elif cfg.frontend == "vision":
            P = cfg.n_patches
            spec = {"patch_embeds": ((B, P, cfg.frontend_dim), f32),
                    "tokens": ((B, S - P), i32)}
        else:
            spec = {"tokens": ((B, S), i32)}
        if kind == "train":
            lab_s = S - cfg.n_patches if cfg.frontend == "vision" else S
            spec["labels"] = ((B, lab_s), i32)
        return spec
    if kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    raise ValueError(kind)


def _host_batch(cfg: ArchConfig, seq_len: int, global_batch: int,
                kind: str, seed: int, step: int) -> dict:
    rng = np.random.default_rng((seed << 20) ^ step)
    out = {}
    for name, (shape, dtype) in batch_spec(cfg, seq_len, global_batch,
                                           kind).items():
        if dtype == torch.int32:
            a = rng.integers(0, cfg.vocab, size=shape, dtype=np.int32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
        out[name] = torch.from_numpy(a)
    return out


def to_device(batch: dict, device) -> dict:
    """The batch on ``device``: pinned host staging and non-blocking
    copies for a card (the tensors are ready in stream order)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: v.to(device) for k, v in batch.items()}
    return {k: v.pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def make_batch(cfg: ArchConfig, seq_len: int, global_batch: int, *,
               kind: str = "train", seed: int = 0, step: int = 0,
               device="cuda") -> dict:
    """One deterministic batch matching :func:`batch_spec`, on
    ``device``."""
    return to_device(_host_batch(cfg, seq_len, global_batch, kind, seed,
                                 step), device)


class Prefetcher:
    """Background-thread prefetch of host batches keyed by step; the
    iterator copies each to ``device`` as it hands it out."""

    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int, *,
                 kind: str = "train", seed: int = 0, start_step: int = 0,
                 depth: int = 2, device="cuda"):
        self.cfg, self.seq, self.gb = cfg, seq_len, global_batch
        self.kind, self.seed, self.device = kind, seed, device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = _host_batch(self.cfg, self.seq, self.gb, self.kind,
                            self.seed, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            step, b = self._q.get()
            yield step, to_device(b, self.device)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
