"""Fault tolerance: heartbeats, straggler detection, restart signalling
(a copy of ``repro.runtime.fault``; it is plain Python).

The trainer emits per-step heartbeats; the watchdog declares a straggler
when a step exceeds ``factor ×`` the running median and a failure when
the heartbeat goes silent for ``dead_after`` seconds.  Recovery is
checkpoint-restore.  The elastic shrink is :func:`shrink_mesh_shape`
followed by ``checkpoint.ckpt.restore(..., sharding_tree=...)`` onto a
mesh of that shape over the surviving ranks (``launch.mesh``): the
checkpoint holds logical arrays, so it restores onto any mesh.
"""
from __future__ import annotations

import json
import os
import statistics
import time
from typing import Optional


class RestartSignal(Exception):
    """Raised into the training loop to trigger checkpoint-restore."""

    def __init__(self, reason: str, shrink: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.shrink = shrink


class Heartbeat:
    """Per-process heartbeat file: {step, time, step_time}."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, step_time: float):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "step_time": step_time}, f)
        os.replace(tmp, self.path)

    def read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None


class Watchdog:
    """Straggler/failure detector over recent step times."""

    def __init__(self, straggler_factor: float = 3.0,
                 dead_after: float = 300.0, window: int = 32,
                 min_samples: int = 5):
        self.factor = straggler_factor
        self.dead_after = dead_after
        self.window = window
        self.min_samples = min_samples
        self._times: list[float] = []
        self._last_beat = time.time()

    def record(self, step_time: float):
        self._times.append(step_time)
        self._times = self._times[-self.window:]
        self._last_beat = time.time()

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0

    def check(self, now: float | None = None) -> Optional[str]:
        """Returns a fault reason or None."""
        now = now if now is not None else time.time()
        if now - self._last_beat > self.dead_after:
            return f"dead: no heartbeat for {now - self._last_beat:.0f}s"
        if len(self._times) >= self.min_samples:
            if self._times[-1] > self.factor * self.median:
                return (f"straggler: step {self._times[-1]:.2f}s vs median "
                        f"{self.median:.2f}s")
        return None


def shrink_mesh_shape(shape: tuple[int, ...], axis: int = 0
                      ) -> tuple[int, ...]:
    """Elastic shrink: halve the (data) axis — the re-mesh target after
    losing up to half the nodes.  Checkpoint restore handles re-sharding."""
    new = list(shape)
    if new[axis] % 2:
        raise ValueError(f"cannot halve axis {axis} of {shape}")
    new[axis] //= 2
    return tuple(new)
