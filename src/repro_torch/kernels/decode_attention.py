"""One-token decode attention over the bf16 KV cache: the CUDA kernel
``csrc/decode_attention.cu`` (it replaces no Pallas kernel: the JAX
package's decode attention is plain jnp) and its plain PyTorch version,
the composition ``models/common.py`` used before the kernel::

    out = softmax((q·scale)·Kᵀ masked by kv_valid) · V     (fp32 → bf16)

with the kv heads repeated to the q heads (q head ``h·G + g`` reads kv
head ``h``).  ``q``: [B, 1, n_q, dh] bf16; ``cache_k``/``cache_v``: [B,
S_max, n_kv, dh] bf16; ``kv_valid``: [B, S_max] bool (a row-stride-0
expand is read as it is).  Returns [B, 1, n_q·dh], the layout ``wo``
takes.

The kernel reads the cache in place, each kv head once for its group, and
skips the 64-key tiles without a visible key (exactly: their keys weigh 0
in the plain path).  It sums in another fp32 order than the plain
version and nothing else differs.  The key chunks a row is split into
depend on S_max alone (:data:`CHUNK_TILES`), so a row's bits do not
depend on the batch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.layout import fp32_matmul
from repro_torch.kernels import _build

#: launches of the CUDA kernel by :func:`decode_attention` (the plain
#: version does not count)
launches = 0

#: 64-key tiles the launches covered (B · n_kv · ceil(S_max / 64) each);
#: the tiles they read are on the card (:func:`tiles_read`)
tiles_total = 0

#: keys per tile (the kernel's DA_TILE)
TILE = 64
#: tiles per key chunk: a row's chunks are ceil(ceil(S_max / 64) / 8), so
#: up to 512 slots take one launch and no combine (at InternLM2 .chat's
#: step 1, 2, 4 and 8 tiles a chunk took 0.158, 0.134, 0.126 and 0.123 ms
#: over the whole cache on an H100)
CHUNK_TILES = 8
#: head dims the kernel is built for
HEAD_DIMS = (16, 128, 320)
#: largest group (q heads per kv head): one warp each
MAX_GROUP = 16

#: score of a masked-out key (exp underflows to exactly 0; the model's
#: attention uses it too)
MASKED = -1e30

#: per device: the int64 count of tiles the kernel read
_tiles_read: dict[int, torch.Tensor] = {}


def decode_attention_plain(q, cache_k, cache_v, kv_valid,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain version: the kv heads repeated, everything cast to fp32, the
    masked softmax and two library matmuls, rounded to ``out_dtype``."""
    B, _, nq, dh = q.shape
    group = nq // cache_k.shape[2]
    k, v = cache_k, cache_v
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(dh)
    qh = (q.float() * scale).transpose(1, 2)          # [B, H, 1, dh]
    kh = k.float().permute(0, 2, 3, 1)                # [B, H, dh, S]
    s = fp32_matmul(qh, kh)                           # [B, H, 1, S]
    s = torch.where(kv_valid[:, None, None, :], s,
                    torch.full_like(s, MASKED))
    p = torch.softmax(s, dim=-1)
    out = fp32_matmul(p, v.float().transpose(1, 2))  # [B, H, 1, dh]
    return out.transpose(1, 2).to(out_dtype).reshape(B, 1, nq * dh)


def decode_attention(q, cache_k, cache_v, kv_valid,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The attention of one decode step over the cache, [B, 1, n_q·dh] in
    ``out_dtype`` (bf16 on the model's path; fp32 to compare sums before
    the rounding).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    global launches, tiles_total
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, kv_valid,
                                      out_dtype)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    B, one, nq, dh = q.shape
    _, S, nkv, dhk = cache_k.shape
    if one != 1 or cache_k.shape[0] != B or dhk != dh \
            or cache_v.shape != cache_k.shape:
        raise ValueError(f"decode attention needs q [B, 1, n_q, dh] and "
                         f"caches [B, S, n_kv, dh], not {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    if q.dtype != torch.bfloat16 or cache_k.dtype != torch.bfloat16 \
            or cache_v.dtype != torch.bfloat16:
        raise TypeError(f"decode attention kernel reads bf16, not {q.dtype}, "
                        f"{cache_k.dtype}, {cache_v.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode attention writes bf16 or fp32, not "
                        f"{out_dtype}")
    if dh not in HEAD_DIMS or nq % nkv or nq // nkv > MAX_GROUP:
        raise ValueError(f"decode attention kernel takes head_dim "
                         f"{HEAD_DIMS} and up to {MAX_GROUP} q heads per kv "
                         f"head, not dh {dh}, {nq}/{nkv} heads")
    if any(t.device != q.device for t in (cache_k, cache_v, kv_valid)):
        raise ValueError("decode attention's tensors must share q's device")
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"kv_valid must be bool [{B}, {S}], not "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}")
    for c in (cache_k, cache_v):
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("decode attention needs contiguous, 16-byte "
                             "aligned caches")
    q = q.contiguous()
    tiles = -(-S // TILE)
    nc = -(-tiles // CHUNK_TILES)             # key chunks of a row
    out = torch.empty((B, 1, nq * dh), dtype=out_dtype, device=q.device)
    part = (torch.empty(B * nq * nc * (dh + 2), dtype=torch.float32,
                        device=q.device) if nc > 1 else None)
    dev, stream = _build.cuda_args(q)
    err = _lib().decode_attention_launch(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        kv_valid.data_ptr(), kv_valid.stride(0), kv_valid.stride(1),
        out.data_ptr(), int(out_dtype == torch.float32),
        part.data_ptr() if part is not None else None,
        _counter(q.device).data_ptr(), B, S, nkv, nq // nkv, dh,
        CHUNK_TILES, 1.0 / math.sqrt(dh), dev, stream)
    _build.check_launch("decode_attention", err)
    with _build.COUNT_LOCK:
        launches += 1
        tiles_total += B * nkv * tiles
    return out


def _counter(dev: torch.device) -> torch.Tensor:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _build.COUNT_LOCK:
        c = _tiles_read.get(idx)
        if c is None:
            c = _tiles_read[idx] = torch.zeros(1, dtype=torch.int64,
                                               device=torch.device("cuda",
                                                                   idx))
        return c


def tiles_read() -> int:
    """Tiles the kernel has read on every card since the last
    :func:`reset_tiles` (waits for the cards: read it at stats time, never
    inside a step)."""
    with _build.COUNT_LOCK:
        counters = list(_tiles_read.values())
    return sum(int(c.item()) for c in counters)


def reset_tiles() -> None:
    """Zero both tile counts."""
    global tiles_total
    with _build.COUNT_LOCK:
        tiles_total = 0
        for c in _tiles_read.values():
            c.zero_()


def stats() -> dict:
    """``{"kernel_calls", "tiles_read", "tiles_total"}`` since the last
    reset: ``tiles_read / tiles_total`` is the share of the cache's tiles
    the kernel read."""
    return {"kernel_calls": launches, "tiles_read": tiles_read(),
            "tiles_total": tiles_total}


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
