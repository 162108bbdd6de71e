#!/usr/bin/env python3
"""How far the training step's loss and gradients move when only the
fp32 summation order of the KSplit linears changes, at growing depth
(InternLM2-1.8B at full width, random weights from seed 0, the
``make_batch(seed=0)`` batch of 4 x 128 tokens; one card):

    python3 train_order_gaps.py [--layers 1,4,12,24] [--out FILE]

Per depth it runs step 0's loss and gradients (``loss_and_grads``) four
ways: through the ksplit kernel twice (it must repeat bit for bit),
with the kernel's plain version swapped in (one library matmul per
class segment, added in storage order), and in a third order (the
segments as one library matmul, ``chip_smoke.ksplit_one_matmul``).  It
prints, for each pair, the loss's relative gap, the worst gradient
leaf's ``||d||/||g||`` and ``max|d|/max|g|`` (``chip_smoke.leaf_gaps``),
and the share of the final residual stream's bf16 elements that differ.
The gap between two plain orders is the scale against which
``chip_smoke.py`` phase 7 holds the kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="1,4,12,24")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_order_gaps.py needs a CUDA card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as C
    from repro_torch.configs import get
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tune import dispatch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.ensure_built()
    orders = {"kernel": K.ksplit_gemm_multi, "plain": K.ksplit_gemm_plain,
              "one_matmul": C.ksplit_one_matmul}
    kernel_fn = K.ksplit_gemm_multi

    def run(name, params, cfg, batch):
        K.ksplit_gemm_multi = orders[name]
        try:
            loss, _, grads = loss_and_grads(params, cfg, batch)
            with torch.no_grad():
                x, _ = T._run_layers(params, cfg, batch["tokens"])
        finally:
            K.ksplit_gemm_multi = kernel_fn
        return float(loss), grads, x.float()

    print(f"card: {C.smi_line()}")
    out = []
    for nl in (int(v) for v in args.layers.split(",")):
        cfg = dataclasses.replace(get("internlm2-1.8b"), n_layers=nl)
        params = T.init_model(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        batch = DP.make_batch(cfg, C.TRAIN_SEQ, C.TRAIN_BATCH, seed=0,
                              step=0, device="cuda")
        dispatch.tune_linear_params(params,
                                    m_hint=C.TRAIN_SEQ * C.TRAIN_BATCH)
        runs = {name: run(name, params, cfg, batch)
                for name in ("kernel", "plain", "one_matmul")}
        again = run("kernel", params, cfg, batch)
        repeat = again[0] == runs["kernel"][0] and C.leaf_gaps(
            again[1], runs["kernel"][1])[0] == 0.0
        row = {"layers": nl, "loss": runs["plain"][0],
               "kernel_repeats_bitwise": repeat}
        for a, b in (("kernel", "plain"), ("one_matmul", "plain"),
                     ("kernel", "one_matmul")):
            (la, ga, xa), (lb, gb, xb) = runs[a], runs[b]
            frob, worst, where = C.leaf_gaps(ga, gb)
            row[f"{a}_vs_{b}"] = {
                "loss_gap": abs(la - lb) / abs(lb), "grad_frob": frob,
                "grad_max": worst, "grad_max_leaf": where,
                "x_differ": float((xa != xb).float().mean())}
        print(json.dumps(row))
        out.append(row)
        del params, runs, again
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": C.smi_line(), "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
