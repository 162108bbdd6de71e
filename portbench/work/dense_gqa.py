"""Frozen work counts of a dense GQA decoder: FLOPs and bytes per KSplit
linear (by K-class), per model step of serving and per training step,
from the configuration's shapes and the traffic's token counts alone.

Bytes count each input read once and each output written once: a
KSplit linear at m rows reads its stored weight, m bf16 rows of x and
writes m fp32 rows of y.
"""
from __future__ import annotations

from portbench import peaks
from portbench.reference import dense_gqa as ref
from portbench.reference import rounding as R

ACT_BYTES = 2      # bf16 activations and KV
OUT_BYTES = 4      # fp32 linear outputs and logits


def linears(c: dict) -> list:
    """(name, K, N, kind, per-block formats) of every linear."""
    t = c["mp_tile"]
    out = []
    for lf in ref.leaves(c):
        if lf.kind in ("ksplit", "nsplit"):
            dim = 0 if lf.kind == "ksplit" else 1
            fmts = R.block_formats(lf.shape[dim] // t, c["mp_formats"],
                                   c["mp_policy"])
            out.append((lf.name, lf.shape[0], lf.shape[1], lf.kind, fmts))
    return out


def linear_work(m: int, k: int, n: int, kind: str, fmts: list, t: int
                ) -> tuple[dict, float]:
    """({format: FLOPs}, bytes) of one linear at m rows."""
    flops: dict = {}
    wbytes = 0.0
    for f in fmts:
        flops[f] = flops.get(f, 0.0) + 2.0 * m * t * (n if kind == "ksplit"
                                                      else k)
        wbytes += t * (n if kind == "ksplit" else k) * peaks.BYTES[f]
    return flops, wbytes + m * k * ACT_BYTES + m * n * OUT_BYTES


def ksplit_seconds(c: dict, m: int) -> float:
    """Least time of one model step's KSplit linears at m rows each."""
    t = c["mp_tile"]
    return sum(peaks.least_seconds(*linear_work(m, k, n, kind, fmts, t))
               for _, k, n, kind, fmts in linears(c) if kind == "ksplit")


def matmul_params(c: dict) -> int:
    return sum(k * n for _, k, n, _, _ in linears(c))


def weight_bytes(c: dict) -> float:
    """Stored bytes of every linear and norm (the embedding is read a row
    per token)."""
    t = c["mp_tile"]
    total = 0.0
    for _, k, n, kind, fmts in linears(c):
        total += sum(t * (n if kind == "ksplit" else k) * peaks.BYTES[f]
                     for f in fmts)
    g = ref.dims(c)
    return total + (2 * g["L"] + 1) * g["d"] * 4


def attn_flops(c: dict, kv_len: float) -> float:
    """Attention FLOPs of one query over ``kv_len`` keys, all layers."""
    g = ref.dims(c)
    return 4.0 * g["nq"] * g["dh"] * kv_len * g["L"]


def kv_bytes_per_position(c: dict) -> float:
    g = ref.dims(c)
    return 2.0 * g["nkv"] * g["dh"] * ACT_BYTES * g["L"]


def decode_step_seconds(c: dict, kv_lens: list) -> float:
    """Least time of one model step that feeds one token to each row
    whose visible length (after the step) is in ``kv_lens``: FLOPs of the
    linears and attention; bytes of the weights once, each row's keys and
    values, its embedding row, its new key and value, and its logits."""
    if not kv_lens:
        return 0.0
    g = ref.dims(c)
    r = len(kv_lens)
    kv = float(sum(kv_lens))
    flops = 2.0 * r * matmul_params(c) + attn_flops(c, kv)
    nbytes = (weight_bytes(c) + kv * kv_bytes_per_position(c)
              + r * g["d"] * ACT_BYTES + r * g["V"] * OUT_BYTES)
    return peaks.least_seconds({"bf16": flops}, nbytes)


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: three times the forward's
    (forward, and the backward's two products per matmul), with causal
    attention counted for the keys each query needs."""
    fwd = 2.0 * batch * seq * matmul_params(c) \
        + batch * attn_flops(c, seq * (seq + 1) / 2.0)
    return 3.0 * fwd
