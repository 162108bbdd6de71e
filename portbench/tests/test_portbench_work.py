"""The frozen work counts against counts taken from tensor shapes at a
tiny size: the port's stored weights, and the FLOPs that PyTorch's
counter reads off the reference's forward pass."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.tests import tiny
from portbench import peaks
from portbench.families import dense_gqa as fam
from portbench.reference import dense_gqa as ref
from portbench.work import dense_gqa as work


def _linears(tree):
    from repro_torch.core.linear import MPLinear
    out = []

    def walk(node):
        if isinstance(node, MPLinear):
            out.append(node.w)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(tree)
    return out


def test_weights_and_linears_match_the_ports_tree():
    from repro_torch.core.layout import KSplitWeight
    c = tiny.config()
    params = fam.build(c, tiny.SEED, "cpu")
    lins = _linears(params)
    assert sum(lin[3] == "ksplit" for lin in work.linears(c)) == sum(
        isinstance(w, KSplitWeight) for w in lins)
    assert work.matmul_params(c) == sum(w.shape[0] * w.shape[1]
                                        for w in lins)
    stored = sum(b.numel() * b.element_size() for w in lins for b in w.bufs)
    norms = sum(v.numel() * 4 for k, v in params.items() if "norm" in k) \
        + sum(v.numel() * 4 for lp in params["layers"]
              for k, v in lp.items() if "norm" in k)
    assert work.weight_bytes(c) == stored + norms


def test_ksplit_work_by_class():
    c = tiny.config()
    t = c["mp_tile"]
    name, k, n, kind, fmts = next(x for x in work.linears(c)
                                  if x[3] == "ksplit")
    flops, nbytes = work.linear_work(3, k, n, kind, fmts, t)
    assert flops == {"fp32": 2.0 * 3 * (k // 2) * n,
                     "bf16": 2.0 * 3 * (k // 2) * n}
    assert nbytes == (k // 2) * n * 4 + (k // 2) * n * 2 + 3 * k * 2 \
        + 3 * n * 4
    assert peaks.least_seconds(flops, nbytes) == max(
        2.0 * 3 * k * n / peaks.BF16_FLOPS, nbytes / peaks.BYTES_PER_S)


def test_forward_flops_match_the_counter():
    """The linears' FLOPs are every matmul of rank 2 operands; the
    attention's, counted over all keys, the batched ones.  The frozen
    count charges causal attention for the keys each query needs."""
    c = tiny.config()
    B, S = 2, 12
    w = ref.weights(c, tiny.SEED, "cpu")
    toks = torch.zeros((B, S), dtype=torch.int64)
    with FlopCounterMode(display=False) as fc:
        ref.logits(w.__getitem__, c, toks)
    counts = fc.get_flop_counts()["Global"]
    mm = sum(v for op, v in counts.items() if "bmm" not in str(op))
    bmm = sum(v for op, v in counts.items() if "bmm" in str(op))
    assert mm == 2 * B * S * work.matmul_params(c)
    assert bmm == B * work.attn_flops(c, S * S)
    causal = 2.0 * B * S * work.matmul_params(c) \
        + B * work.attn_flops(c, S * (S + 1) / 2)
    assert work.train_step_flops(c, B, S) == 3 * causal


def test_decode_step_counts_rows_and_their_keys():
    c = tiny.config()
    g = ref.dims(c)
    kv = [3, 5]
    flops = 2.0 * 2 * work.matmul_params(c) + work.attn_flops(c, 8)
    nbytes = work.weight_bytes(c) + 8 * 2 * g["nkv"] * g["dh"] * 2 \
        * g["L"] + 2 * g["d"] * 2 + 2 * g["V"] * 4
    assert work.decode_step_seconds(c, kv) == peaks.least_seconds(
        {"bf16": flops}, nbytes)
    assert work.decode_step_seconds(c, []) == 0.0
