"""The program's side of a dense GQA decoder configuration: the port's
``ArchConfig`` and parameter tree, built through the port's public
constructors from the dense tensors of :mod:`portbench.inputs` (never
through the port's own ``init_model``), and each weight read back from
the program's trees as a dense fp32 tensor.
"""
from __future__ import annotations

import torch

from portbench.reference import dense_gqa as ref

REFERENCE = ref


def arch(c: dict):
    """The port's configuration for ``c`` (a ``configs/*.json``)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.precision import Policy
    if c["activations"] != "bf16" or c["hidden_act"] != "silu" \
            or c["bias"] or c["tie_word_embeddings"]:
        raise ValueError(f"{c['name']}: the port's dense decoder runs bf16 "
                         "activations, SiLU-gated MLPs, no biases and an "
                         "untied head")
    pol = c["mp_policy"]
    return ArchConfig(
        name=c["name"], family="dense",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"],
        mp_policy=Policy(kind=pol["kind"], ratio_high=pol["ratio_high"],
                         ratio_low8=pol.get("ratio_low8", 0.0)),
        mp_tile=c["mp_tile"], mp_formats="+".join(c["mp_formats"]),
        kv_dup_to_tp=True)


def build(c: dict, seed: int, device) -> dict:
    """The port's parameter tree for run ``seed``."""
    from repro_torch.core.formats import format_set
    from repro_torch.core.layout import KSplitWeight, NSplitWeight
    from repro_torch.core.linear import MPLinear, split_cls
    from repro_torch.tree import LayerList
    a = arch(c)
    fs = format_set(*c["mp_formats"])
    t = c["mp_tile"]

    def make(lf):
        w = ref.dense(seed, lf, device)
        if lf.kind == "norm":
            return w
        if lf.kind == "embed":
            return w.to(torch.bfloat16)
        if lf.kind == "ksplit":
            cls = split_cls(lf.shape[0] // t, a.mp_policy, fset=fs)
            return MPLinear(KSplitWeight.from_dense(w, cls, t, fs))
        cls = split_cls(lf.shape[1] // t, a.mp_policy, fset=fs)
        return MPLinear(NSplitWeight.from_dense(w, cls, t, fs))

    params: dict = {"layers": [{} for _ in range(a.n_layers)]}
    for lf in ref.leaves(c):
        node, *path = lf.name.split(".")
        if node != "layers":
            params[node] = make(lf)
            continue
        d = params["layers"][int(path[0])]
        for key in path[1:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = make(lf)
    params["layers"] = LayerList(params["layers"], a.pattern_period())
    return params


def read(tree, name: str) -> torch.Tensor:
    """Weight ``name`` of a program tree (the parameters, or the
    optimizer's masters or moments, which share their structure) as a
    dense fp32 tensor in the logical layout."""
    node = tree
    for key in name.split("."):
        node = node[int(key)] if key.isdigit() else node[key]
    w = getattr(node, "w", node)
    return w.to_dense() if hasattr(w, "to_dense") else w.float()
