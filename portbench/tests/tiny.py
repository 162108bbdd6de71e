"""A tiny preset of the benchmark's cells for the CPU tests: the same
files, family and traffic kinds, at a size a test run can hold (the
port's kernels run their plain versions on the CPU)."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

CHAT = "internlm2-1.8b.chat"
PRETRAIN = "internlm2-1.8b.pretrain"
SEED = 2 ** 31 + 977


def config() -> dict:
    c = harness.load_json("configs", "internlm2-1.8b")
    c.update(name="tiny", num_hidden_layers=2, hidden_size=64,
             intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=128, mp_tile=16)
    return c


#: the training limits at this size, set by the cell's rules from readings
#: on the CPU over 12 seeds (2**31 + 977 and 1-11): the program's
#: ``grad_gap`` up to 3.4e-3, ``change_gap`` 1.7e-3; the control's
#: ``grad_gap`` from 0.0136, half the batch's from 0.111, a state left
#: unchanged 1.  (``loss_gap``, up to 5.7e-4, has no upper reading here
#: either: the control reads from 1.3e-4, half the batch from 4.6e-4.)
#: The cell's own limits are read at its size on the card.
TINY_TRAIN_LIMITS = {"grad_gap": 0.008, "change_gap": 0.006}


def workload(cell: str) -> dict:
    """The cell's own file with its sizes cut; a serving cell keeps its
    limit, a training cell takes :data:`TINY_TRAIN_LIMITS`."""
    w = harness.load_json("workloads", cell)
    t = w["traffic"]
    if t["kind"] == "serve_bursts":
        t.update(serve={"max_batch": 4, "max_seq": 48, "buckets": [16]},
                 burst=4, prompt_len={"dist": "uniform", "lo": 4, "hi": 16},
                 new_tokens={"dist": "lognormal", "median": 6,
                             "sigma": 0.6, "lo": 2, "hi": 24},
                 check_requests=3)
    else:
        t.update(batch=2, seq=16)
        w["limits"] = dict(TINY_TRAIN_LIMITS)
    return w


def run(cell: str, seed: int = SEED, trace: bool = False,
        bench: dict | None = None, w: dict | None = None):
    """(parsed result line, errors) of one tiny run on the CPU."""
    import json
    import time
    line, errors = harness.run_cell(
        cell, seed, 0.2, trace, t_start=time.time(), device="cpu",
        bench=bench, workload=w or workload(cell), config=config())
    return json.loads(line), errors
