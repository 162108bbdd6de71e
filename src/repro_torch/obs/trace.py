"""Structured span/event tracer — JSON lines on disk, Chrome-trace export
(twin of ``repro.obs.trace``: the same fields line for line, span ids
in ``args``, and one more category, ``model``).

Every emitted line is one Chrome ``trace_event`` dict (``ph="X"``
complete spans with microsecond ``ts``/``dur``, ``ph="i"`` instants), so
the JSONL file is greppable and streamable, and exporting for Perfetto
or ``chrome://tracing`` wraps the lines in ``{"traceEvents": [...]}``
(:func:`chrome_payload` / :func:`export_chrome`).

Each complete span carries, in ``args``, its ``span_id`` and the
``parent_id`` of the span that caused it: the innermost span open on the
same thread when it opened (None at the top).  Ids are unique within one
process (``pid``).

Times are the host's, read from ``time.perf_counter``: ``ts`` is
microseconds since the tracer's ``t0`` (a ``perf_counter`` instant),
``dur`` the host microseconds a ``with`` block took.  A device trace
aligned to ``perf_counter`` (``portbench/devtrace.py``) so lies on the
spans' timeline.  The tracer never waits for the card, so a span around
work that ends before a host read (``.item()``, ``.cpu()``, a
synchronize) covers only the time it took to enqueue that work; a span
that contains the read covers the device time too.  Tracing therefore
changes no result and adds no wait.

Event taxonomy — ``cat`` is closed-world (:data:`CATEGORIES`); the trace
hygiene validator (``repro_torch.obs.hygiene``) fails on anything
outside it:

* ``plan``  — plan-registry resolutions (``plan.resolve``)
* ``gemm``  — single-device dispatch (``gemm.dispatch``)
* ``summa`` — distributed GEMM (``summa.gemm`` spans, ``summa.panel``
  instants with the static owner schedule)
* ``serve`` — request lifecycle: ``serve.admit`` → ``serve.warmup`` →
  ``serve.microbatch``/``serve.prefill``/``serve.decode`` →
  ``serve.retire``, plus the cluster's ``serve.route``,
  ``serve.replica_stall`` and ``serve.reroute``.  ``serve.admit``,
  ``serve.retire``, ``serve.refill`` and ``serve.evict`` carry the
  engine's ``req_id``, ``serve.microbatch`` its ``req_ids``.  Inside a
  microbatch, at each step that retires a row, ``serve.retire_pass``
  around ``serve.drain``
* ``solve`` — ``solve.run``/``solve.factor``/``solve.sweep`` spans and
  ``solve.escalate`` events carrying the promoted tiles' coordinates
* ``train`` — tune-once setup (``train.tune_setup``, ``train.step_config``)
  and the step: ``train.step`` ⊃ ``train.accumulate`` (microbatches > 1)
  ⊃ ``model.forward``, ``train.backward``; ``train.optimizer``
* ``model`` — one model step's forward (``model.forward``: embed to
  logits); inside a training or bulk prefill forward each layer's mixer
  (``model.attention``, ``model.mamba``, ``model.mlstm``,
  ``model.slstm``) and FFN (``model.mlp``, ``model.moe``), each with its
  norm and ``layer=i``, and ``model.head``

The disabled path is :class:`NullTracer`: ``span()`` returns a shared
no-op context manager and ``event()`` returns at once — no file, no
allocation, no timestamp, no id (``repro_torch.obs.configure`` swaps it
in).
Writes hold a lock and carry ``tid = threading.get_ident()``, so threads
(the cluster's drain threads) share one tracer.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

#: closed-world event categories (span/event ``cat`` values)
CATEGORIES = ("plan", "gemm", "summa", "serve", "solve", "train", "obs",
              "model")

#: fields every event must carry; "X" spans additionally need ``dur``
REQUIRED_FIELDS = ("name", "cat", "ph", "ts", "pid", "tid")

#: event phases the schema admits (complete span / instant / counter;
#: the port writes no counter samples, a trace of the reference may hold
#: them)
PHASES = ("X", "i", "C")


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a constant-time no-op
    returning shared singletons."""

    enabled = False
    path = None

    def span(self, name, cat, **args):
        return _NULL_SPAN

    def event(self, name, cat, **args):
        return None

    def flush(self):
        return None

    def close(self):
        return None


NULL_TRACER = NullTracer()


def _check_cat(cat: str) -> None:
    if cat not in CATEGORIES:
        raise ValueError(
            f"unknown trace category {cat!r} — the taxonomy is "
            f"closed-world ({CATEGORIES}); add new subsystems to "
            "repro_torch.obs.trace.CATEGORIES deliberately")


class _Span:
    """Context manager emitting one complete ("X") event on exit, its id
    pushed on the thread's stack of open spans while it is open."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0", "_id", "_parent")

    def __init__(self, tr, name, cat, args):
        self._tr, self._name, self._cat, self._args = tr, name, cat, args

    def __enter__(self):
        stack = self._tr._open_spans()
        self._parent = stack[-1] if stack else None
        self._id = next(self._tr._ids)
        stack.append(self._id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tr._open_spans().pop()
        self._tr._emit_span(self._name, self._cat, self._t0, t1,
                            dict(self._args, span_id=self._id,
                                 parent_id=self._parent))
        return False


class Tracer:
    """JSONL span/event writer (or an in-memory ``buffer`` when
    ``path=None``).  ``t0`` is the ``time.perf_counter()`` instant that
    ``ts`` counts from (default: now); the clock is system-wide, so a
    spawned rank given its parent's ``t0`` writes on the parent's
    timeline (see :meth:`absorb`)."""

    enabled = True

    def __init__(self, path: str | None = None, t0: float | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._t0 = time.perf_counter() if t0 is None else t0
        self._pid = os.getpid()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.buffer: list[dict] = []
        self._f = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(path, "w")

    @property
    def t0(self) -> float:
        return self._t0

    # -- emission ---------------------------------------------------------

    def _open_spans(self) -> list:
        """This thread's stack of open span ids, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _write(self, ev: dict) -> None:
        with self._lock:
            if self._f is not None:
                self._f.write(json.dumps(ev, sort_keys=True) + "\n")
            else:
                self.buffer.append(ev)

    def _base(self, name: str, cat: str, ph: str, ts_us: float) -> dict:
        _check_cat(cat)
        return {"name": name, "cat": cat, "ph": ph,
                "ts": round(ts_us, 3), "pid": self._pid,
                "tid": threading.get_ident()}

    def span(self, name: str, cat: str, **args) -> _Span:
        """``with tracer.span("serve.prefill", "serve", bucket=...):`` —
        one complete event spanning the block (host time)."""
        _check_cat(cat)              # fail at creation, not at exit
        return _Span(self, name, cat, args)

    def _emit_span(self, name, cat, t0, t1, args) -> None:
        ev = self._base(name, cat, "X", self._us(t0))
        ev["dur"] = round((t1 - t0) * 1e6, 3)
        ev["args"] = args
        self._write(ev)

    def event(self, name: str, cat: str, **args) -> None:
        """Instant event (``ph="i"``, thread scope)."""
        ev = self._base(name, cat, "i", self._us(time.perf_counter()))
        ev["s"] = "t"
        ev["args"] = args
        self._write(ev)

    def absorb(self, events: list[dict]) -> None:
        """Write events recorded elsewhere (a spawned rank's buffer,
        on this tracer's timeline) into this trace, in order."""
        for ev in events:
            self._write(dict(ev))

    # -- lifecycle --------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------------------------------
# reading / exporting
# ---------------------------------------------------------------------------

def read_events(path: str) -> list[dict]:
    """Parse a JSONL trace file back into event dicts."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSONL ({e})")
    return events


def chrome_payload(events: list[dict]) -> dict:
    """Wrap events in the Chrome/Perfetto trace-file envelope."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def chrome_path_for(jsonl_path: str) -> str:
    """Chrome-export sibling of a JSONL trace path (``trace.jsonl`` →
    ``trace.trace.json``)."""
    base = jsonl_path[:-6] if jsonl_path.endswith(".jsonl") else jsonl_path
    return base + ".trace.json"


def export_chrome(jsonl_path: str, out_path: str | None = None) -> str:
    """Convert a JSONL trace to a Chrome-trace JSON file; returns the
    output path (loadable in Perfetto / ``chrome://tracing``)."""
    out_path = out_path or chrome_path_for(jsonl_path)
    payload = chrome_payload(read_events(jsonl_path))
    with open(out_path, "w") as f:
        json.dump(payload, f, sort_keys=True)
        f.write("\n")
    return out_path


def span_types(events: list[dict]) -> list[str]:
    """Distinct names of complete ("X") spans in a trace, sorted."""
    return sorted({e.get("name", "?") for e in events
                   if e.get("ph") == "X"})


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="inspect / export a repro_torch.obs JSONL trace")
    ap.add_argument("trace", help="JSONL trace file")
    ap.add_argument("--chrome", default="",
                    help="write a Chrome-trace JSON here "
                         "(default: <trace>.trace.json)")
    args = ap.parse_args(argv)
    events = read_events(args.trace)
    out = export_chrome(args.trace, args.chrome or None)
    cats = sorted({e.get("cat", "?") for e in events})
    print(f"{args.trace}: {len(events)} events, cats={cats}, "
          f"span_types={span_types(events)}")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
