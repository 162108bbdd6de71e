"""Parameter bridge: the JAX package's dense-decoder parameters and
AdamW state, handed over as numpy arrays plus class maps, into the
port's — so both packages compute from the same state in the parity
tests.  (Checkpoints need no bridge: ``repro_torch.checkpoint`` reads
and writes the reference's format.)

It imports no JAX.  The numpy tree follows the reference's layout::

    {"embed": [V, d], "final_norm": [d], "lm_head": LIN,
     "blocks": [{"pos0": {"norm1": [R, d], "norm2": [R, d],
                          "attn": {"wq": LIN, "wk": LIN, "wv": LIN,
                                   "wo": LIN},
                          "mlp": {"up": LIN, "gate": LIN, "down": LIN}}},
                ...]}

where each segment's leaves carry a leading repeat dim R (the reference
stacks the layers it scans), and each ``LIN`` is a dict
``{"kind": "ksplit" | "nsplit" | "dense", "bufs": [array per class code]
(or "w": array for dense), "cls": k_cls / n_cls, "tile": int,
"shape": (K, N), "formats": FormatSet key, "b": array or None}``.
bf16 and fp8 arrays may arrive in their ``ml_dtypes`` dtypes; they are
reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import FormatSet
from repro_torch.core.layout import KSplitWeight, NSplitWeight
from repro_torch.core.linear import MPLinear

#: numpy dtype name -> (same-width integer view, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Bit-exact numpy → torch (including bf16/fp8 ``ml_dtypes`` arrays);
    the data is copied, so the tensor never aliases a read-only array."""
    a = np.array(a, order="C")
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        return torch.from_numpy(a.view(view[0])).view(view[1]).to(device)
    return torch.from_numpy(a).to(device)


def _linear(lin: dict, r: int | None, device) -> MPLinear:
    def pick(a):
        return a if r is None else a[r]

    b = lin.get("b")
    b = None if b is None else tensor_from_numpy(pick(b), device)
    kind = lin["kind"]
    if kind == "dense":
        return MPLinear(tensor_from_numpy(pick(lin["w"]), device), b)
    fset = FormatSet.from_key(lin["formats"])
    bufs = tuple(tensor_from_numpy(pick(x), device) for x in lin["bufs"])
    cls = np.asarray(lin["cls"], np.int8)
    shape = tuple(int(s) for s in lin["shape"])
    if kind == "ksplit":
        return MPLinear(KSplitWeight(bufs, cls, int(lin["tile"]), shape,
                                     fset), b)
    if kind == "nsplit":
        return MPLinear(NSplitWeight(bufs, cls, int(lin["tile"]), shape,
                                     fset), b)
    raise ValueError(f"unknown linear kind {kind!r}")


def _layer(p: dict, r: int, device) -> dict:
    vec = lambda a: tensor_from_numpy(a[r], device)   # noqa: E731
    return {
        "norm1": vec(p["norm1"]),
        "attn": {k: _linear(v, r, device) for k, v in p["attn"].items()},
        "norm2": vec(p["norm2"]),
        "mlp": {k: _linear(v, r, device) for k, v in p["mlp"].items()},
    }


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The port's parameter dict (see :mod:`repro_torch.models.
    transformer`) from the reference's numpy tree."""
    if cfg.family != "dense":
        raise NotImplementedError("only dense decoders are bridged")
    layers = []
    for seg in tree["blocks"]:
        if set(seg) != {"pos0"}:
            raise ValueError("a dense decoder has one layer per period")
        p = seg["pos0"]
        for r in range(np.shape(p["norm1"])[0]):
            layers.append(_layer(p, r, device))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    return {"embed": tensor_from_numpy(tree["embed"], device),
            "final_norm": tensor_from_numpy(tree["final_norm"], device),
            "lm_head": _linear(tree["lm_head"], None, device),
            "layers": layers}


def opt_state_from_numpy(state: dict, cfg: ArchConfig, device="cuda"):
    """The port's :class:`~repro_torch.optim.adamw.AdamWState` from the
    reference's, handed over as ``{"mu", "nu", "master", "count"}``:
    three parameter-shaped numpy trees (``master`` may be None) and the
    step count."""
    from repro_torch.optim.adamw import AdamWState
    master = state.get("master")
    return AdamWState(
        params_from_numpy(state["mu"], cfg, device),
        params_from_numpy(state["nu"], cfg, device),
        None if master is None else params_from_numpy(master, cfg, device),
        torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32))
