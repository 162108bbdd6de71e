"""Parameter bridge: the JAX package's model parameters (dense and MoE,
full or local/global attention, xLSTM, the Mamba hybrid, the audio
encoder and the vision-language decoder) and AdamW state, handed over as numpy arrays plus class maps, into the port's —
so both packages compute from the same state in the parity tests.
(Checkpoints need no bridge:
``repro_torch.checkpoint`` reads and writes the reference's format.)

It imports no JAX.  The numpy tree follows the reference's layout::

    {"embed": [V, d], "final_norm": [d], "lm_head": LIN,
     ["frontend_proj": LIN, "pos_embed": [65536, d]],
     "blocks": [{"pos0": {"norm1": [R, d], "norm2": [R, d],
                          "attn": {"wq": LIN, "wk": LIN, "wv": LIN,
                                   "wo": LIN},
                          "mlp": {"up": LIN, "gate": LIN, "down": LIN}}},
                ...]}

where segment s holds positions ``pos0 .. pos{p-1}`` of the pattern
(``ArchConfig.segments``), each leaf carrying a leading repeat dim R
(the reference stacks the layers it scans); an MoE layer holds ``"moe":
{"router": [R, d, E], "gate": MOE, "up": MOE, "down": MOE, "shared":
{"up": LIN, "gate": LIN, "down": LIN}}`` in place of ``"mlp"``; an
xLSTM layer holds only ``"norm1"`` and ``"mlstm": {"up_proj": LIN,
"conv_w", "conv_b", "wq", "wk", "wv", "w_if", "b_if", "skip",
"down_proj": LIN}`` or ``"slstm": {"w_in", "b_in", "r", "ff_up": LIN,
"ff_down": LIN}``; a Mamba layer holds ``"mamba": {"in_proj": LIN,
"conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
"out_proj": LIN}`` in place of ``"attn"`` (every other leaf an array
with the repeat dim); each
``MOE`` a dict ``{"kind": "moe_ksplit" | "moe_nsplit", "w_hi": array,
"w_lo": array, "cls": k_cls / n_cls, "tile": int, "shape": (E, K, N)}``;
and each ``LIN`` is a dict
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
from repro_torch.models.moe import MoEKSplit, MoENSplit
from repro_torch.models.transformer import check_family
from repro_torch.tree import LayerList, segment_layers

_MOE_KINDS = {"moe_ksplit": MoEKSplit, "moe_nsplit": MoENSplit}

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


def _moe_weight(lin: dict, r: int, device):
    return _MOE_KINDS[lin["kind"]](
        tensor_from_numpy(lin["w_hi"][r], device),
        tensor_from_numpy(lin["w_lo"][r], device),
        np.asarray(lin["cls"], np.int8), int(lin["tile"]),
        tuple(int(s) for s in lin["shape"]))


def _cell(p: dict, r: int, device) -> dict:
    """A recurrent mixer's dict (an xLSTM cell, a Mamba mixer): linears as
    MPLinear, arrays as tensors."""
    return {k: (_linear(v, r, device) if isinstance(v, dict)
                else tensor_from_numpy(v[r], device))
            for k, v in p.items()}


def _layer(p: dict, r: int, device) -> dict:
    vec = lambda a: tensor_from_numpy(a[r], device)   # noqa: E731
    out = {"norm1": vec(p["norm1"])}
    for cell in ("mlstm", "slstm", "mamba"):
        if cell in p:
            out[cell] = _cell(p[cell], r, device)
    if "attn" in p:
        out["attn"] = {k: _linear(v, r, device)
                       for k, v in p["attn"].items()}
    if "norm2" in p:
        out["norm2"] = vec(p["norm2"])
    if "mlp" in p:
        out["mlp"] = {k: _linear(v, r, device) for k, v in p["mlp"].items()}
    if "moe" in p:
        m = p["moe"]
        moe = {"router": vec(m["router"])}
        for name in ("gate", "up", "down"):
            moe[name] = _moe_weight(m[name], r, device)
        if "shared" in m:
            moe["shared"] = {k: _linear(v, r, device)
                             for k, v in m["shared"].items()}
        out["moe"] = moe
    return out


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The port's parameter dict (see :mod:`repro_torch.models.
    transformer`) from the reference's numpy tree."""
    check_family(cfg)
    period = cfg.pattern_period()
    segs = segment_layers(cfg.n_layers, period)
    if len(tree["blocks"]) != len(segs):
        raise ValueError(f"tree holds {len(tree['blocks'])} segments, "
                         f"config {len(segs)}")
    layers = [None] * cfg.n_layers
    for seg, positions in zip(tree["blocks"], segs):
        if set(seg) != {f"pos{q}" for q in range(len(positions))}:
            raise ValueError(f"segment positions {sorted(seg)} do not "
                             f"match the config's {len(positions)}")
        for q, idx in enumerate(positions):
            p = seg[f"pos{q}"]
            if np.shape(p["norm1"])[0] != len(idx):
                raise ValueError(f"pos{q} holds {np.shape(p['norm1'])[0]} "
                                 f"repeats, config {len(idx)}")
            for r, i in enumerate(idx):
                layers[i] = _layer(p, r, device)
    out = {"embed": tensor_from_numpy(tree["embed"], device),
           "final_norm": tensor_from_numpy(tree["final_norm"], device),
           "lm_head": _linear(tree["lm_head"], None, device)}
    # the frontend's projection and an encoder's position table
    for key, want in (("frontend_proj", cfg.frontend != "none"),
                      ("pos_embed", cfg.encoder_only)):
        if (key in tree) != want:
            raise ValueError(f"tree {'holds' if key in tree else 'lacks'} "
                             f"{key!r}; config {cfg.name} "
                             f"{'needs' if want else 'has none'}")
    if cfg.frontend != "none":
        out["frontend_proj"] = _linear(tree["frontend_proj"], None, device)
    if cfg.encoder_only:
        out["pos_embed"] = tensor_from_numpy(tree["pos_embed"], device)
    out["layers"] = LayerList(layers, period)
    return out


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
