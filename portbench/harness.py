"""One run of one cell: set-up, the measured window, the per-layer
metrics of a traced run, the comparison that decides ``correct``, and
the result line.

The harness is driven by data.  A cell is ``workloads/<cell>.json``; it
names its configuration (``configs/<config>.json``, whose ``family``
names ``families/<family>.py``, ``reference/<family>.py`` and
``work/<family>.py``) and its traffic kind (``traffic/<kind>.py``, whose
``Cell`` has ``setup``, ``window`` and ``check``).  ``BENCHMARK.json``
says which metrics the cell reports; a per-layer metric ``m`` is read by
``metrics/<m>.py``'s ``read(ctx)``, which returns None where it finds
nothing to read.  A failure in one metric is collected and the run goes
on; the run then exits non-zero.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")

#: top-level module names no run may load (compared whole: the port's
#: own name, ``repro_torch``, begins with ``repro``)
BANNED = ("jax", "jaxlib", "flax", "repro")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class UnknownName(ValueError):
    """A workload, configuration, traffic kind or metric that has no
    file of its own."""


def _path(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise UnknownName(f"{kind} name {name!r} is not a benchmark name")
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    _path(kind, name, ".py")
    return importlib.import_module(f"portbench.{kind}.{name}")


def load_metric(name: str):
    """``metrics/<name>.py``'s ``read`` (metric names hold dots, so the
    file is loaded by path)."""
    path = _path("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def banned_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(BANNED))


@dataclasses.dataclass
class Context:
    """What a traffic kind and a metric reader see."""
    cell: str
    seed: int
    device: str
    workload: dict
    config: dict
    family: object = None
    work: object = None
    facts: dict = dataclasses.field(default_factory=dict)
    slice: object = None


def make_context(cell: str, seed: int, device: str,
                 workload: dict | None = None,
                 config: dict | None = None) -> Context:
    w = workload if workload is not None else load_json("workloads", cell)
    c = config if config is not None else load_json("configs", w["config"])
    return Context(cell, int(seed), device, w, c,
                   family=load_module("families", c["family"]),
                   work=load_module("work", c["family"]))


def collect(jobs: list) -> tuple[dict, list]:
    """Run every ``(name, fn)``; a failure is recorded and the rest still
    run.  Returns ({name: result}, [{"name", "error"}])."""
    out, errors = {}, []
    for name, fn in jobs:
        try:
            out[name] = fn()
        except Exception as e:           # a boundary that keeps going
            traceback.print_exc(file=sys.stderr)
            errors.append({"name": name,
                           "error": f"{type(e).__name__}: {e}"})
    return out, errors


def _num(x):
    return x if x is None or math.isfinite(x) else None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None
                ) -> str:
    """The last line: the contract's keys, then the numbers compared with
    their limits under a key of their own, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": _num(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": _num(v), "limit": lim}
                     for n, v, lim in checks}
    return json.dumps(out)


def device_info(device: str, chips: int) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(chips),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             bench: dict | None = None, workload: dict | None = None,
             config: dict | None = None) -> tuple[str, list]:
    """One run; returns (the result line, the collected errors)."""
    import torch
    bench = bench if bench is not None else load_benchmark()
    e2e, layer = cell_metrics(bench, cell)
    readers, errors = collect([(m["name"], lambda m=m: load_metric(
        m["name"])) for m in layer] if trace else [])
    ctx = make_context(cell, seed, device, workload, config)
    traffic = load_module("traffic", ctx.workload["traffic"]["kind"])
    run = traffic.Cell(ctx)
    t0 = time.time()
    run.setup()
    print(f"set-up: the cell's own {time.time() - t0:.4f} s", flush=True)
    # what set-up made lives on: keep it out of the collector's scans
    gc.collect()
    gc.freeze()
    gpu = device != "cpu"
    if gpu:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    res = run.window(seconds, trace)
    t_window = time.time()
    dev = device_info(device, ctx.workload["chips"])
    if gpu:
        ctx.facts["peak_window_bytes"] = torch.cuda.max_memory_allocated()
        dev["memory_peak_bytes"] = int(max(setup_peak,
                                           dev["memory_peak_bytes"]))
    ctx.facts.update(res["facts"])
    ctx.slice = getattr(run, "slice", None)
    metrics: dict = {}
    breakdown = None
    if trace:
        got, errs = collect([(n, lambda n=n: readers[n](ctx))
                             for n in readers])
        errors += errs
        for m in layer:
            if got.get(m["name"]) is not None:
                metrics[m["name"]] = (got[m["name"]], m["unit"])
        sl = ctx.slice
        if sl is not None:
            dev["busy_s"] = sl.busy_s
            dev["window_s"] = sl.window_s
            breakdown = {"device_ops": sl.top_ops(),
                         "idle_gaps": sl.idle_gaps()}
    else:
        res["metrics"]["setup_s"] = (setup_s, "s")
        for m in e2e:
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = res["metrics"][m["name"]]
            else:
                errors.append({"name": m["name"],
                               "error": "the traffic kind gives no such "
                                        "end-to-end metric"})
    checks = [("failed", float(res["failed"]), 0.0)]
    t_check = time.time()
    got, errs = collect([("check", run.check)])
    errors += errs
    print(f"seconds: setup {setup_s:.4f}, window and traced slice "
          f"{t_window - t_start - setup_s:.4f}, metrics "
          f"{t_check - t_window:.4f}, check {time.time() - t_check:.4f}",
          flush=True)
    checks += got.get("check", [("check_crashed", 1.0, 0.0)])
    correct = all(v is not None and math.isfinite(v) and v <= lim
                  for _, v, lim in checks)
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    return (result_line(correct, res["attempted"], res["failed"], metrics,
                        dev, checks, breakdown), errors)
