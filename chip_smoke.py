#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure, so a failing run never exits 0):

1. print the card (``nvidia-smi`` name and power limit) and the device
   spec dispatch resolves for it (must be ``gpu-h100``), build the six
   CUDA kernels from ``src/repro_torch/csrc`` (nvcc in parallel), print
   every kernel's registers and spills from ptxas, and read the SASS of
   the tile, grouped and split libraries (``cuobjdump -sass``): each must
   hold ``HGMMA`` (wgmma) instructions;
2. hold each kernel to its plain PyTorch version on the card: the ksplit kernel
   at the served InternLM2-1.8B, Qwen1.5-MoE-A2.7B, Gemma-3-4B,
   xLSTM-1.3B, Jamba-v0.1, HuBERT-XLarge, LLaVA-NeXT-34B and Llama-3-405B
   shapes (m = 1 and 4, rows bitwise equal across m and across two
   forced launch geometries), at m = 4096, and at phase 12's bulk shapes
   (M = 2048 at K = 1280, N = 5120; M = 3072 at K = 7168, N = 20480), the
   tile kernel at M = N =
   K = 1024 and 4096 and the grouped kernel at 4096³, both at t = 64 and
   128, over four class mixes and one integer-class format set, and both on
   e4m3-overflow NaN, inf·0 and subnormal operands; the split kernel at
   4096³, t = 64 and 128, for split2_fp16 and split3_e5m2 C classes and a
   mix with an int8 class, on the same edge operands, plus its slices bit
   for bit (B = I), and its slice pass alone against its plain version on
   both operands, bit for bit, at each of those cases and at the solve's
   residual shape; at t = 16 and 32 the split kernel bit for bit against
   ``split_gemm_ref`` (the same fixed summation order) for split2 and split3
   C classes beside fp8, bf16 and int8 ones; the convert kernel at 8192²
   into every output dtype, bit for bit, and its class-map form (the
   layouts' storage cast) bit for bit against its plain version under mixed
   and split maps at 8192², at the solve's 8064² C and 8064×128 panel and on
   a ragged shape; the decode-attention kernel's fp32 output within
   2e-5·max|V| of its plain version's at the served decode shapes
   (``DECODE_ATTN_SHAPES``), its bf16 output that output rounded, a row
   alone bit for bit as in a batch of 128, and no tile past every row's
   position read (counted, and those slots overwritten change no bit);
3. ``mp_matmul`` at 1024³ through dispatch: the plan must be ``tile``
   (``split`` with split C classes), the kernel must launch, and the
   result must sit inside the registry-derived error bounds against numpy
   fp64;
4. serve InternLM2-1.8B at full width (random weights from a seeded
   ``torch.Generator``): 8 requests, 16 greedy tokens each, batched tokens
   equal to the unbatched reference, no fresh plan resolution after
   warmup, every KSplit linear on the ksplit kernel;
   A profiled decode step then shows where its time goes (wall vs device
   busy time, top kernels by device time);
4b. the serve state at full width and 6 of 24 layers (the depth cut
   keeps the run inside its time limit; every gate is depth-free):
   InternLM2-1.8B with the reference's serve defaults (refill, paged prefix cache, chunked prefill;
   ``max_batch=4``, ``max_seq=320``) over a three-call stream — six
   requests sharing a 40-token prefix that retire early, so two enter as
   page-reused refills, two sampled requests (temperature 0.8, seeds 1
   and 2), a 150-token chunked prompt, then a 170-token one whose cached
   chain lets it skip its first chunk.  Every request's tokens must equal
   the unbatched reference's, greedy and sampled; the sampled streams
   must differ; at least two refills (one page-reused), two chunked
   prefills and exactly one chunk skipped; no page leaked after the
   drain; no fresh plan resolution; every KSplit linear on the kernel.
   It prints the stream's tokens/s, the page and chunk counters, the host
   ms of copying a 16-page chain into a cache row, and (no gate) whether
   a row's logits are bit-equal at m = 1 and m = 4;
4c. quantized weight variants at full width, 8 of InternLM2's 24 layers
   (QUANT_LAYERS: the depth is cut to keep the run inside its time
   limit; no gate depends on it): ``quantize_params`` with
   activation statistics from phase 4's prompts' embeddings (int8_pt in
   the LOW role beside the set's HIGH fp32, a quarter of the K-blocks kept
   HIGH), and a mixed stream of default and int8 requests through one
   engine: every request equal to ``generate_reference`` and to its
   replay, both buckets served, no fresh plan resolution, and every
   linear on the path its map's sortedness calls for (sorted: the ksplit
   kernel; a calibrated, unsorted map: the gathering path, as in the
   reference).  It prints the stream's tokens/s and the variant's
   storage against fp32, and reproduces the rows of
   ``results/bench_baseline/BENCH_quant.json`` (rel_err within a decade,
   bytes_frac and calib_ok exact);
5. the refinement solver on the card: ``graded_spd`` n = 8192, tile 128,
   start 0D:100S, LU, tol 0.01, three solves — storage escalation (tile
   kernel), split compute escalation (split kernel only) and the grouped
   residual path (grouped kernel); each must escalate, converge (fp64
   HPL-MxP metric ≤ tol) with a forward error ≤ 1e-2 and no fresh
   mid-solve plan resolution, on its kernel and the convert kernel's
   class-map form (the layouts' storage casts: no class map expanded on
   the host; the non-copy GEMM seconds and convert launches by form are
   printed); each solve's last step-0 trailing update and
   last residual GEMM are replayed through their kernel and its plain
   version; every tile and grouped launch must take the path its C
   map's classes call for (the solve's C maps are uniform HIGH, fp32, as
   in the reference, so its GEMMs run the fp32 path).  The same three
   solves at n = 1024 on the card and on the CPU (plain versions) must
   take the same decisions; every split-solve launch runs one slice
   pass;
6. time each kernel (CUDA events, median, the stream held while the
   call is enqueued, and also unheld) beside its bound, its plain
   version (unheld) and one PyTorch call computing the same function; the tile
   and grouped kernels at 4096³ under three maps (0D100S, 50D50S,
   100D0S: each must take the tensor-core path exactly where C has
   bf16-class tiles) and at the solve's trailing-update and residual
   shapes and maps; the split kernel at 4096³ under split2 and split3
   50D50S and at the solve's two shapes with uniform split2 C; the ksplit
   kernel at every served shape and at the training phase's M = 512,
   also at one block per column strip, and at Llama-3-405B's up/gate at
   m = 4 and phase 12's two bulk shapes; the
   convert kernel into every output dtype beside ``x.to``, and its
   class-map form at the solve's 8064² C and an 8192² 5D95S operand
   beside its bound and the per-class path (integer sets' path); the
   decode-attention kernel at InternLM2 ``.chat``'s step (B 128, S_max
   512, 8 x 2 heads of 128) with every row at positions 63, 255 and 511,
   beside the bytes of the visible keys, its plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it);
7. (run between 5 and 6) train InternLM2-1.8B at full width, 12 of its
   24 layers (TRAIN_LAYERS), seq 128 x batch 4: the step-0 loss and every gradient leaf through the ksplit kernel
   (under autograd; the backward is the gathering path's VJP) within a
   stated allowance of the same step with ``ksplit_gemm_plain`` swapped
   in (and no further from it than a second plain order is); every forward KSplit linear on the kernel, no fresh resolution
   after setup; one step at two microbatches against one; eight steps on
   one repeated batch with a finite, falling loss (per-step wall ms,
   tokens/s, launches per step, peak memory, one profiled step); and at
   one layer a checkpoint, an injected ``RestartSignal`` and a restore
   whose replayed losses equal the uninterrupted run's bit for bit.
8. (run after 7) SUMMA on one card: a 1x1 grid over nccl in this
   process runs a 4096³ GEMM (t = 128, the default set, A and B
   sorted-balanced and C balanced at 50% D, 25% Q) on the grouped local
   path — K/t grouped launches, within twice the per-class bound of the
   ref local path and of single-device ``mp_matmul``, and bit for bit the
   single-device grouped path; four ranks spawned on the card over gloo
   run the 2x2, 1x4 and 4x1 grids on the same operands: every output
   equals the 1x1 output bit for bit, every rank launches the grouped
   kernel K/t times and moves the wire-byte model's share (counts read
   in each rank and gathered); the grouped kernel's accumulate-into
   launch is timed at the 1x1 and 2x2 local shapes beside its bound and
   ``torch.matmul``; then phase 5's operator at n = 2048 with balanced
   escalation is solved single-device (grouped residual), on the 1x1
   grid and on a 2x2 grid of spawned ranks: all three converge with 0
   fresh resolutions and 0 SUMMA table rebuilds and are equal bit for bit
   (x, map, metric trajectory); it prints each solve's wall seconds and
   the 2x2 solve's broadcast share.

9. (run after 4c) the MoE and local/global families through the engine's
   equal mode (phases 9 and 10 cut depth, not width, to keep the run
   inside its time limit; no gate depends on depth). Qwen1.5-MoE-A2.7B at
   full width, 4 of its 24 layers (60 experts top-4, random weights from
   a seeded generator; its parameter bytes by kind printed): eight
   requests (four 32-token, four 64-token prompts, 12
   new tokens, two sampled) at ``max_batch=4``. (a) At the published
   capacity factor 1.25 the same stream twice gives the same tokens; the
   dropped (token, expert) pairs per microbatch and the requests that
   differ from the no-drop reference of (b) are printed, not gated (the
   reference's batched behaviour). (b) At capacity factor 16 nothing drops
   and batched tokens equal ``generate_reference``. (c) A 64-token row
   decoded through the cache with the kernels agrees with
   ``forward_prefill`` computed with the plain versions within twice the
   plain stepped decode's gap, and that decode within twice the gap of a
   summation-order change (the bulk with the ksplit segments summed as
   one matmul). Every run replays the plain bulk's expert picks, since an
   order change flips picks at small router margins; the kernel decode's
   own picks may differ from the bulk's only at decisions whose bulk
   top-k margin is within twice the largest margin at which the plain
   orders' own picks differ (floored at 2^-8 of the largest router
   probability), and each run's differing picks are printed. Then the
   median decode step
   beside its byte bound, the idle share of profiled steps, the expert
   products' and the ksplit kernel's device time, the bf16 upcast's time,
   the ksplit launches read per step and the peak memory. Gemma-3-4B at
   full width, 6 of its 34 layers (one period of 5 local layers and 1
   global, window 1024): two 64-token and two
   32-token requests equal to ``generate_reference``; then that pattern
   period decoded through 2048 positions, past the window, against the
   bulk forward under rule (c).
10. (run after 9) the xLSTM family through the engine's equal mode:
   xLSTM-1.3B at full width, 8 of its 48 layers (7 mLSTM and 1 sLSTM,
   d 2048, 4 heads, vocab 50304; random weights from a seeded generator;
   its fp32 recurrent state per row printed), two 32-token and two
   64-token requests at ``max_batch=4``, 12 new tokens each: every
   request equal to ``generate_reference``, 9 ksplit launches in every
   model step (7 ``up_proj``, 1 ``ff_up``, the lm_head: counted per
   step), no
   fresh resolution, every KSplit linear on the kernel; then the first
   pattern period (1 sLSTM, 7 mLSTM layers) decoded through 128
   positions against the bulk forward under rule (c) (the gaps also
   printed as shares of the reference test's tolerance, not gated), and
   the decode step's median wall beside its byte bound (weights, state
   read and written), its idle share over profiled steps and the peak
   memory.
11. (run after 10) the Mamba-hybrid family through the engine's equal
   mode: Jamba-v0.1's first pattern period (8 of 32 layers at every
   published width: d 4096, 32 heads / 8 kv, d_ff 14336, 16 experts
   top-2, vocab 65536, Mamba d_state 16, expand 2; 7 Mamba mixers,
   attention at layer 4 without RoPE, MoE on odd layers; the 32 layers'
   51.6e9 parameters do not fit one card), two 32-token and two 64-token
   requests at ``max_batch=4``, 12 new tokens each: (b) at capacity
   factor 16 every request equal to ``generate_reference``, (a) at the
   published 1.25 the same stream twice equal (drops printed); 19 ksplit
   launches in every model step of both (7 ``in_proj``, 4 MLP up and
   gate, wq/wk/wv, the lm_head: counted per step), all on the kernel, no
   fresh resolution; then one row decoded through 256 positions (two of
   the scan's 128-token chunks, so the bulk forward crosses a chunk)
   against the bulk forward under rule (c) with the bulk's expert picks
   replayed, and the decode step's median wall beside its byte bound
   (weights, the attention layer's KV, the Mamba state read and
   written), its idle share and expert-product span over profiled
   steps, the Mamba state per row and the peak memory.
12. (run after 11) the frontends and the large configs, the card emptied
   between the three: (a) HuBERT-XLarge at full width, all 48 layers (d
   1280, 16 heads, GELU d_ff 5120, vocab 504, the learned position
   table): the encoder pass over 4 x 512 frames (10.24 s of audio at 50
   Hz each) through the ksplit kernel, 194 launches (wq, wk, wv, up per
   layer, frontend_proj, lm_head), its logits within twice the gap of two
   plain summation orders of the plain run (floored at one bf16 rounding
   of the largest logit); negating the last frame moves position 0's
   loss in a run that repeats bit for bit (the encoder attends both
   ways); step 0's per-token losses and gradients within twice the plain
   orders' gaps; HUBERT_STEPS AdamW steps on the repeated batch, a
   falling loss and 194 launches read in each (convert launches, step
   wall, idle share and peak memory printed). (b) LLaVA-NeXT-34B's first
   LLAVA_LAYERS layers at every published width (64 q heads, 16 kv, the
   reference's padding): one prefill of 2880 patch embeddings and 192
   tokens, 42 launches, last-position logits under the same rule;
   negated patches move them by more than that allowance; a changed last
   token leaves every earlier position's hidden state bit for bit (the
   text comes last); then four text requests through the engine's equal
   mode, equal to ``generate_reference``, 41 launches in every model
   step. (c) Llama-3-405B's first LLAMA405_LAYERS layers at published
   widths (128 q heads, 16 kv) in masked mode, as phase 4: the same four
   requests equal to their reference, 11 launches in every model step,
   the batch-4 decode step beside its byte bound and the peak memory.
13. (run after 12) training the MoE, xLSTM and Mamba-hybrid families at
   published widths, depth the only cut (``FT_CELLS``): Qwen1.5-MoE-
   A2.7B's first 2 layers at seq 128 x batch 4, xLSTM-1.3B's first 8
   at 512 x 2 (the mLSTM scan crosses its 256-position chunk), Jamba-
   v0.1's layer 0 at 256 x 2 (the selective scan crosses its 128-
   position chunk); each prints the bytes of weights, gradients and
   AdamW state before its run.  Gates: (a) step 0 through the ksplit
   kernel, its per-token losses and gradients within twice the gaps of
   two plain orders (an MoE's every run replays the kernel run's expert
   picks); (b) every forward KSplit linear on the kernel, and each
   step's ksplit and convert launches, read per step, equal to
   ``step_launches``' reckoning, with no fresh resolution; (c)
   FT_STEPS AdamW steps at 3e-4 on a repeated batch, a finite falling
   loss; (d) for every mLSTM and Mamba layer, a loss on the last chunk
   moves position 0's input and one on the first chunk leaves position
   S - 1's exactly unmoved; (e) the MoE loss is the cross entropy plus
   0.01 x aux, and every expert's gradient is nonzero exactly where it
   kept a token (the full batch and an 8-token probe; drops counted).
   Each prints the step's wall, its busy and idle share over 3 profiled
   steps and the peak memory.  Then qwen2's depth on a fresh init serves
   four requests in equal mode, two on an ``int8_pt+fp32`` variant whose
   expert tensors are the default weights' own, each equal to
   ``generate_reference``.

14. (run after 8) the replica cluster, tracing and the measured
   autotuner: (a) InternLM2-1.8B at published widths, STATE_LAYERS deep,
   the serve defaults, phase 4's eight prompt lengths (four of them
   sampled), 16 new tokens, served by ``Cluster(ServeConfig(replicas=2))``
   (two engines sharing one parameter tree, each draining on its own
   thread) and by one ``Engine``: every request's tokens equal bit for
   bit, both replicas healthy and serving, none rejected, no fresh
   resolution after warmup, every KSplit linear on the kernel; the
   placement and both runs' tokens/s printed; (b) the same cluster run
   traced (``repro_torch.configure(obs_trace=...)``): the same tokens,
   the JSONL clean under ``repro_torch.obs.hygiene`` with at least
   MIN_SPAN_TYPES span names, its Chrome export parsing back, and
   ``serve.route`` naming both replicas; each span's count and host ms,
   and the traced wall beside the untraced; (c) phase 5's operator at n
   = TRACE_SOLVE_N solved untraced and traced (equal sweeps, promotions
   and forward error; the trace holds solve.run, solve.factor,
   solve.sweep and solve.escalate), and a SUMMA GEMM traced on a 1x1 grid
   (one summa.gemm span, one summa.panel per k-panel); (d) the measured
   search, in a child process with a cache file of its own (so its plans
   never reach this process's registry): ``tune_linear_params(measure=True)``
   at m = 4 on (a)'s weights (the same seed) and ``autotune`` on AUTOTUNE_CASES (the ref,
   tile, grouped and split paths timed on the card): every winner
   measured, the cache clean under ``repro_torch.tune.hygiene``, then
   cache-only mode resolving the same plans from the file with no
   measurement (a spy on ``measure``); one row per candidate (path,
   measured and predicted µs); (e) ``launch.serve --smoke --replicas 2 --trace`` and
   ``launch.solve --trace`` as subprocesses: exit 0, clean traces.
15. (run after 8) the mesh layer: one spawn of four ranks sharing the
   card over gloo, the mesh (pod=2, data=1, model=2), a miniature of
   ``make_production_mesh(multi_pod=True)``; every call in that spawn
   (``launch.mesh_checks``, gated here, see :func:`mesh_phase`): (a)
   Qwen1.5-MoE-A2.7B at published widths, 2 layers, the prefill (one
   pass of the layers) of one 256-token sequence per pod through
   ``moe_block_sharded`` (the
   non-EP, d_ff-sharded path) against the unmeshed forward of that
   sequence (layer 0's kept pairs equal, logits and hidden states within
   three times the gap of one extra bf16 rounding per MoE layer, 11
   ksplit launches in every rank), and Phi-3.5-MoE's MoE block (the EP
   path) against ``moe_block`` within its rounding allowance; (b)
   ``cross_pod_mean`` on InternLM2-1.8B's gradient tree (2 layers, embed,
   lm_head) bit for bit the mean over pods of the compressed trees; (c)
   that model's parameters sharded by ``param_specs``, saved
   collectively to the mesh's first rank (the manifest equals a
   single-process save's), restored
   onto (data=4, model=1) and onto ``shrink_mesh_shape``'s (2, 1) on two
   ranks, each rank reading only its slices, every shard bit for bit
   its slice.  The gloo collectives' ms and bytes per MoE block and the
   cross-pod all-reduce's seconds and GB are
   printed: four ranks on one card measure the protocol, not scaling.

Every phase's seconds are printed (``phase ...: s``) and summed up in
the ``phase seconds`` line.  The second-to-last lines are a JSON object ``{"kernels": [...]}`` and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
there is no CUDA device or the package is not next to this script.
It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet), the denominators of
#: every bound below: HBM3 bytes/s, dense bf16 FLOP/s, fp32 (non-tensor)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

#: served ksplit shapes (K, N) of InternLM2-1.8B on one card: wq, wk/wv,
#: up/gate, lm_head; the large-M ksplit check; the tile-kernel checks
SERVED_KN = ((2048, 2048), (2048, 1024), (2048, 8192), (2048, 92544))
#: phases 9, 10 and 11's further ksplit shapes (K, N): Qwen1.5-MoE-A2.7B's
#: shared expert up/gate and lm_head (its wq/wk/wv are 2048 x 2048),
#: Gemma-3-4B's wq, wk/wv, up/gate and lm_head, xLSTM-1.3B's sLSTM ff_up
#: and lm_head (its mLSTM up_proj is 2048 x 8192), Jamba-v0.1's Mamba
#: in_proj, MLP up/gate, wq, wk/wv and lm_head
FAMILY_KN = ((2048, 5632), (2048, 151936), (2560, 2560), (2560, 1280),
             (2560, 10240), (2560, 262144), (2048, 2688), (2048, 50304),
             (4096, 16384), (4096, 14336), (4096, 4096), (4096, 1024),
             (4096, 65536),
             # phase 12: HuBERT-XLarge's wq/wk/wv, up, lm_head and
             # frontend_proj; LLaVA-NeXT-34B's wq (64 heads), wk/wv (16),
             # up/gate, lm_head and frontend_proj; Llama-3-405B's wq,
             # wk/wv (16 heads), up/gate and lm_head (2.10e9 elements)
             (1280, 1280), (1280, 5120), (1280, 504), (512, 1280),
             (7168, 8192), (7168, 2048), (7168, 20480), (7168, 64000),
             (1024, 7168), (16384, 16384), (16384, 2048), (16384, 53248),
             (16384, 128256))
#: phase 12's bulk shapes (M, K, N), held to the order bound in phase 2:
#: HuBERT's up at its 4 x 512 frames, LLaVA's up/gate at its 3072-token
#: prompt
LARGE_M_KN = ((2048, 1280, 5120), (3072, 7168, 20480))
#: phase 6's further ksplit timings (M, K, N): Llama-3-405B's up/gate at
#: decode, then the two bulk shapes above
KSPLIT_TIMED = ((4, 16384, 53248), (3072, 7168, 20480), (2048, 1280, 5120))
KSPLIT_BIG = (4096, 2048, 8192)
TILE_SIZES = (1024, 4096)
TILE = 128
#: tile edges of the tile and grouped checks (the staged dot's two)
CHECK_TILES = (64, 128)
DEVICE = "cuda"
#: the split and grouped kernel checks and timings (M = N = K)
SPLIT_SIZE = 4096
#: the convert kernel's matrix edge
CONVERT_SIZE = 8192
#: the decode-attention checks (label, B, S_max, n_kv, group, head_dim):
#: InternLM2 .chat's step, Jamba's, Llama-3-405B's (group 16), LLaVA's
#: (group 7), Gemma-3-4B's (head_dim 320) and the reduced configs'
DECODE_ATTN_SHAPES = (("internlm2.chat", 128, 512, 8, 2, 128),
                      ("jamba", 32, 512, 8, 4, 128),
                      ("llama405", 4, 1024, 8, 16, 128),
                      ("llava", 4, 3072, 8, 7, 128),
                      ("gemma3", 8, 1024, 4, 2, 320),
                      ("reduced", 4, 80, 2, 2, 16))
#: its fp32 agreement with the plain version, a share of max|V|
DECODE_ATTN_TOL = 2e-5
#: the positions every row sits at in the timed .chat steps
DECODE_ATTN_POSITIONS = (63, 255, 511)
#: the solve phase: operator edge (the launcher's graded_spd defaults)
SOLVE_N = 8192
#: the solves' HPL-MxP tolerance: at n = 8192 the launcher's tol 1 stops
#: after one sweep on the bf16-stored operator (metric 0.435, forward
#: error 1.54); at 0.01 every solve must escalate
SOLVE_TOL = 0.01
#: largest relative forward error max|x - x_true| / max|x_true| accepted
FORWARD_TOL = 1e-2
#: the card-against-CPU solve parity: operator edge and x tolerance (two
#: converged iterates whose products differ in summation order)
PARITY_N = 1024
PARITY_X_TOL = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def peak_for(dtype) -> float:
    import torch
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


#: device cycles the stream is held before each timed launch (~2.5 ms
#: at the H100's clock): longer than any kernel wrapper's host work, so
#: the launch is queued before the first event is reached
HOLD_CYCLES = 5_000_000


def event_ms(fn, iters: int = 20, flush=None,
             hold: bool = True) -> tuple[float, float]:
    """Median of per-call CUDA-event times (warm-up first; ``flush`` runs
    between calls, outside the timed span; the garbage collector is off
    while timing), and the share of calls whose hold lasted.  With
    ``hold`` the stream is held busy (``torch.cuda._sleep``) before the
    first event while the host enqueues the call, so the span holds the
    call's device work and not its host time (a Python wrapper takes
    tens of us, longer than a decode-width kernel); the hold lasted if
    the first event was still pending when the call returned, and the
    median is over those calls only (a call that waits on the stream ends
    every hold early; a host stall, some).  Without ``hold`` the span
    also holds the host time the call spends after the first event."""
    import gc
    import torch
    fn()
    torch.cuda.synchronize()
    times, lasted = [], []
    gc.disable()
    try:
        for _ in range(iters):
            if flush is not None:
                flush()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if hold:
                torch.cuda._sleep(HOLD_CYCLES)
            e0.record()
            fn()
            ok = not (hold and e0.query())
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            lasted.append(ok)
    finally:
        gc.enable()
    kept = [v for v, ok in zip(times, lasted) if ok] or times
    return float(np.median(kept)), sum(lasted) / iters


def time_ms(fn, iters: int = 20, flush=None, hold: bool = True) -> float:
    """:func:`event_ms`'s median; fails if the hold did not last in at
    least half the calls (the call waits on the stream, so its time
    would hold host work).  Kernels and single library calls are timed
    held; the plain versions, which wait on the stream for host-side maps
    and launch many kernels, are timed unheld: their host time is part
    of a call."""
    ms, lasted = event_ms(fn, iters, flush, hold)
    if lasted < 0.5:
        fail(f"a timed call's hold lasted in {lasted:.0%} of {iters} "
             "calls: the call waits on the stream, and its time would "
             "hold host work")
    return ms


def device_ms(fn, kernel: str, iters: int = 20, flush=None) -> float:
    """Mean device time per call of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` (``flush`` between calls): the
    kernel's own duration, with neither the host's enqueue time nor the
    launch latency that an event pair around one launch can take in."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if kernel in e.key) / iters / 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def ksplit_case(m, k, n, gen, policy):
    """A KSplitWeight [k, n] under ``policy`` (InternLM2's default map)
    and bf16 activations [m, k]."""
    import torch
    from repro_torch.core.formats import DEFAULT_FORMATS as FS
    from repro_torch.core.layout import KSplitWeight
    from repro_torch.core.linear import split_cls
    w = torch.randn((k, n), generator=gen, device=DEVICE) / k ** 0.5
    ws = KSplitWeight.from_dense(w, split_cls(k // TILE, policy, fset=FS),
                                 TILE, FS)
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(torch.bfloat16)
    return x, ws


def ksplit_within(x, ws, y_kernel, y_plain) -> tuple[float, float]:
    """(max |kernel - plain|, worst ratio to the summation-order bound
    ``ksplit_gemm.order_bound``)."""
    from repro_torch.kernels import ksplit_gemm as K
    fs = ws.fset
    bound = K.order_bound(x, [ws.bufs[c] for c in fs.class_order],
                          [fs.fmt(c) for c in fs.class_order])
    err = (y_kernel - y_plain).abs()
    return float(err.max()), float((err / (bound + 1e-30)).max())


def ksplit_args(ws):
    fs = ws.fset
    return ([ws.bufs[c] for c in fs.class_order],
            [fs.fmt(c) for c in fs.class_order])


def check_geometries(x, ws) -> str:
    """The ksplit kernel at its chosen geometry and at one block per
    strip (zsplit 1) must give the same bits; returns both."""
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    bufs, fmts = ksplit_args(ws)
    m, k = x.shape
    n = bufs[0].shape[1]
    chosen = K.choose_geometry(m, n, k)
    single = K.Geometry(K.rows_per_block(m), 1)
    ya = K.ksplit_gemm_at(x, bufs, fmts, chosen)
    yb = K.ksplit_gemm_at(x, bufs, fmts, single)
    sync()
    if not torch.equal(ya, yb):
        fail(f"ksplit m={m} K={k} N={n}: geometry {chosen} and {single} "
             "give different bits")
    return f"{chosen} == {single} bitwise"


def check_ksplit(gen, policy) -> dict:
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    out = {}
    for m in (1, 4):
        for k, n in SERVED_KN + FAMILY_KN:
            x, ws = ksplit_case(4, k, n, gen, policy)
            y4 = ops.ksplit_matmul_kernel(x, ws)
            y = ops.ksplit_matmul_kernel(x[:m].contiguous(), ws)
            yp = K.ksplit_gemm_plain(x[:m], *ksplit_args(ws))
            sync()
            err, ratio = ksplit_within(x[:m], ws, y, yp)
            if not torch.equal(y, y4[:m]):
                fail(f"ksplit m={m} k={k} n={n}: rows differ from the m=4 "
                     "launch (batch invariance)")
            geo = check_geometries(x[:m].contiguous(), ws)
            print(f"ksplit m={m} K={k} N={n}: max|kernel-plain| {err:.3e}, "
                  f"worst/bound {ratio:.3e} (bound 2*K*2^-24*sum|x*w|), "
                  f"rows bitwise equal to the m=4 launch; geometries {geo}")
            if not ratio <= 1.0:
                fail(f"ksplit m={m} K={k} N={n} outside tolerance")
            out[(m, k, n)] = err
            del x, ws, y4, y, yp
    mb, kb, nb = KSPLIT_BIG
    x, ws = ksplit_case(mb, kb, nb, gen, policy)
    y = ops.ksplit_matmul_kernel(x, ws)
    y4 = ops.ksplit_matmul_kernel(x[:4].contiguous(), ws)
    y1 = ops.ksplit_matmul_kernel(x[:1].contiguous(), ws)
    yp = K.ksplit_gemm_plain(x, *ksplit_args(ws))
    sync()
    err, ratio = ksplit_within(x, ws, y, yp)
    if not (torch.equal(y[:4], y4) and torch.equal(y[:1], y1)):
        fail(f"ksplit m={mb}: first rows differ from the m=1 / m=4 launches")
    print(f"ksplit m={mb} K={kb} N={nb}: max|kernel-plain| {err:.3e}, "
          f"worst/bound {ratio:.3e}, rows 0-3 bitwise equal to m=4 and row "
          "0 to m=1")
    if not ratio <= 1.0:
        fail(f"ksplit m={mb} outside tolerance")
    out[KSPLIT_BIG] = err
    # the served shapes at training's M (batch x sequence rows), and
    # phase 12's bulk shapes, from a generator of their own so the draws
    # above stay as they were
    m_train = TRAIN_SEQ * TRAIN_BATCH
    gen_t = torch.Generator(device=DEVICE).manual_seed(m_train)
    for mt, k, n in ([(m_train, k, n) for k, n in SERVED_KN]
                     + list(LARGE_M_KN)):
        x, ws = ksplit_case(mt, k, n, gen_t, policy)
        y = ops.ksplit_matmul_kernel(x, ws)
        yp = K.ksplit_gemm_plain(x, *ksplit_args(ws))
        sync()
        err, ratio = ksplit_within(x, ws, y, yp)
        print(f"ksplit m={mt} K={k} N={n}: max|kernel-plain| {err:.3e}, "
              f"worst/bound {ratio:.3e}")
        if not ratio <= 1.0:
            fail(f"ksplit m={mt} K={k} N={n} outside tolerance")
        out[(mt, k, n)] = err
        del x, ws, y, yp
    return out


TILE_MIXES = (
    # (label, format-set key, ratio_high, ratio_low8) of every map
    ("0D100S", "fp8_e4m3+bf16+fp32", 0.0, 0.0),
    ("50D50S", "fp8_e4m3+bf16+fp32", 0.5, 0.0),
    ("100D0S", "fp8_e4m3+bf16+fp32", 1.0, 0.0),
    ("40D40S20Q", "fp8_e4m3+bf16+fp32", 0.4, 0.2),
    ("40D40S20Q-int8", "int8_pt+bf16+fp32", 0.4, 0.2),
)


def gemm_case(m, k, n, t, fkey, hi, q, gen, seed0=1, scale=None,
              high=()):
    """MPMatrix A [m, k], B [k, n], C [m, n] from seeded normal values
    (``scale(values, index)`` may reshape A's and B's first), each under
    its own ratio map, or uniform HIGH for the operand indices in
    ``high``; returns (format set, (A, B, C), maps)."""
    import torch
    from repro_torch.core.formats import FormatSet
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    fs = FormatSet.from_key(fkey)
    mats, maps = [], []
    for s, shape in enumerate(((m, k), (k, n), (m, n))):
        v = torch.randn(shape, generator=gen, device=DEVICE)
        if scale is not None and s < 2:
            v = scale(v, s)
        p = (np.full((shape[0] // t, shape[1] // t), fs.high, np.int8)
             if s in high else
             make_map(shape, t, Policy("ratio", hi, q, seed=seed0 + s),
                      fset=fs))
        mats.append(MPMatrix.from_dense(v, p, t, fs))
        maps.append(p)
    return fs, mats, maps


def tile_case(size, t, fkey, hi, q, gen, seed0=1):
    return gemm_case(size, size, size, t, fkey, hi, q, gen, seed0)


def zero_c(C):
    """C's map and format set with zero values (the grouped kernel's C)."""
    import torch
    from repro_torch.core.layout import MPMatrix
    return MPMatrix.from_dense(torch.zeros(C.shape, device=DEVICE), C.cls,
                               C.tile, C.fset)


def kernel_vs_plain(path, A, B, C, alpha=1.0, beta=0.0):
    """One launch of the ``path`` kernel (``tile``, ``split`` or
    ``grouped``) against its plain version on the same MPMatrix operands:
    (max |kernel - plain|, worst ratio to the summation-order allowance
    ``order_allowance`` of the tile or split module).  The grouped kernel
    takes the operands as CompactMPMatrix, as dispatch's grouped path
    does, and computes C = A·B.  NaN in both counts as equal, NaN in one
    only as an infinite error."""
    import torch
    from repro_torch.core.layout import CompactMPMatrix
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import mp_gemm_tile as MT
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import split_format_specs
    t, fs = A.tile, A.fset
    if path == "grouped":
        if (alpha, beta) != (1.0, 0.0):
            fail("the grouped kernel computes C = A·B only")
        ac = CompactMPMatrix.from_dense(A.to_dense(), A.cls, t, fs)
        bc = CompactMPMatrix.from_dense(B.to_dense(), B.cls, t, fs)
        out = GG.grouped_mp_gemm(ac, bc, C.cls)
        plain = GG.grouped_gemm_plain(ac, bc, C.cls)
        sync()
        if any(tuple(k.shape) != tuple(p.shape) or k.dtype != p.dtype
               for k, p in zip(out.tiles, plain)):
            fail("grouped kernel's compact outputs differ in shape or dtype")
        dk = out.to_dense()
        dp = CompactMPMatrix(plain, out.cls, out.slot, t, out.shape,
                             fs).to_dense()
        zero = tuple(torch.zeros_like(b) for b in C.bufs)
        allow = MT.order_allowance(A.bufs, B.bufs, zero, C.cls, dp, tile=t,
                                   specs=MT.format_specs(fs))
        return MT.within(dk, dp, allow)
    if path == "tile":
        mod, specs, run = MT, MT.format_specs(fs), MT.mp_gemm_tile_multi
        plain_fn = MT.mp_gemm_tile_plain
    elif path == "split":
        mod, specs, run = SG, split_format_specs(fs), SG.split_gemm_tile_multi
        plain_fn = SG.split_gemm_plain
    else:
        fail(f"no kernel for the path {path!r}")
    args = (A.bufs, B.bufs, C.bufs, A.cls, B.cls, C.cls)
    kw = dict(tile=t, specs=specs, alpha=alpha, beta=beta)
    ok = run(*args, **kw)
    op = plain_fn(*args, **kw)
    sync()
    dk = sum(o.float() for o in ok)
    dp = sum(o.float() for o in op)
    allow = mod.order_allowance(A.bufs, B.bufs, C.bufs, C.cls, dp, **kw)
    return MT.within(dk, dp, allow)


def check_tile(gen) -> dict:
    out = {}
    for t in CHECK_TILES:
        for size in TILE_SIZES:
            for label, fkey, hi, q in TILE_MIXES:
                fs, (A, B, C), maps = tile_case(size, t, fkey, hi, q, gen)
                err, ratio = kernel_vs_plain("tile", A, B, C, 1.5, 0.5)
                print(f"tile {size}^3 t={t} {label} [{fkey}]: "
                      f"max|kernel-plain| {err:.3e}, worst/allowance "
                      f"{ratio:.3e} (2*K*2^-24*(|a||A||B|+|b||C|) + one "
                      "output rounding or quantization step)")
                if not ratio <= 1.0:
                    fail(f"tile {size} t={t} {label} outside tolerance")
                out[(t, size, label)] = err
                del A, B, C
    return out


def edge_scale(kind):
    """The ``scale`` of an edge case: e4m3 overflow (|a| = 1000 in every
    class: NaN where A's tile is fp8_e4m3), inf·0 (rows of A at ±inf
    against rows of B at 0), subnormal operands (A scaled by 1e-39, so
    bf16 and fp32 subnormals in A and subnormal products)."""
    def scale(v, s):
        if kind == "e4m3-overflow" and s == 0:
            v[::7, ::5] = 1e3
        elif kind == "inf*0":
            if s == 0:
                v[1, :] = float("inf")
                v[5, 3] = -float("inf")
            else:
                v[3, :] = 0.0
                v[:, 2] = 0.0
        elif kind == "subnormal" and s == 0:
            v = v * 1e-39
        return v
    return scale


def check_edges(gen) -> dict:
    """Tile and grouped kernels on the edge cases of ``edge_scale`` at
    each checked tile edge, mix 30D40S30Q (fp32, bf16, fp8 C tiles), C = 0
    and beta = 0 so subnormal sums reach the outputs: NaN where the plain
    version has NaN and nowhere else, the rest within the allowance."""
    out = {}
    for t in CHECK_TILES:
        for kind in ("e4m3-overflow", "inf*0", "subnormal"):
            fs, (A, B, C), _ = gemm_case(2 * t, 3 * t, 2 * t, t,
                                         "fp8_e4m3+bf16+fp32", 0.3, 0.3, gen,
                                         seed0=71, scale=edge_scale(kind))
            C = zero_c(C)
            for path in ("tile", "grouped"):
                err, ratio = kernel_vs_plain(path, A, B, C)
                print(f"edge {kind} {path} t={t}: max|kernel-plain| "
                      f"{err:.3e}, worst/allowance {ratio:.3e} (NaN as NaN)")
                if not ratio <= 1.0:
                    fail(f"{path} kernel on {kind} at t={t} outside "
                         "tolerance or NaN elsewhere than the plain version")
                out[(path, t, kind)] = err
    return out


SPLIT_MIXES = (
    # (label, format-set key, ratio_high, ratio_low8) of every map
    ("split2 50D50S", "fp8_e4m3+bf16+split2_fp16", 0.5, 0.0),
    ("split3 50D50S", "fp8_e4m3+bf16+split3_e5m2", 0.5, 0.0),
    ("split2 40D40S20Q-int8", "int8_pt+bf16+split2_fp16", 0.4, 0.2),
)


def check_split(gen) -> dict:
    """The split kernel against its plain version over the SPLIT_MIXES and
    on the edge operands of ``edge_scale`` at each checked tile edge, then
    its slices bit for bit: with B = I and C = 0 every dot is exact, so a
    split C tile's output is the fp32 sum of A's slices, bitwise.  The
    slice pass alone is held to its plain version on every case's
    operands and at the solve's residual shape (:func:`check_slices`)."""
    import torch
    from repro_torch.core.formats import FormatSet, split_slices
    from repro_torch.core.layout import MPMatrix
    from repro_torch.kernels import ops
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import recombine, split_format_specs
    out = {}
    size = SPLIT_SIZE
    ops.reset_launch_counts()
    for t in CHECK_TILES:
        for label, fkey, hi, q in SPLIT_MIXES:
            fs, (A, B, C), maps = tile_case(size, t, fkey, hi, q, gen,
                                            seed0=31)
            err, ratio = kernel_vs_plain("split", A, B, C, 1.5, 0.5)
            out[("slices", t, label)] = check_slices(A, B, C,
                                                     f"{size}^3 {label}")
            print(f"split {size}^3 t={t} {label} [{fkey}]: max|kernel-plain| "
                  f"{err:.3e}, worst/allowance {ratio:.3e} (split classes: "
                  "2*K*s^2*2^-24*(|a|*sum|A slices|*sum|B slices|+|b||C|) + "
                  "two split round trips; others as the tile kernel)")
            if not ratio <= 1.0:
                fail(f"split {label} t={t} outside tolerance")
            out[(t, label)] = err
            del A, B, C
        for fkey in ("fp8_e4m3+bf16+split2_fp16", "fp8_e4m3+bf16+split3_e5m2"):
            for kind in ("e4m3-overflow", "inf*0", "subnormal"):
                fs, (A, B, C), _ = gemm_case(2 * t, 3 * t, 2 * t, t, fkey,
                                             0.3, 0.3, gen, seed0=71,
                                             scale=edge_scale(kind))
                err, ratio = kernel_vs_plain("split", A, B, zero_c(C))
                out[("slices", t, kind, fkey)] = check_slices(
                    A, B, C, f"edge {kind} [{fkey}]")
                print(f"edge {kind} split t={t} [{fkey}]: max|kernel-plain| "
                      f"{err:.3e}, worst/allowance {ratio:.3e} (NaN as NaN)")
                if not ratio <= 1.0:
                    fail(f"split kernel on {kind} at t={t} [{fkey}] outside "
                         "tolerance or NaN elsewhere than the plain version")
                out[(t, kind, fkey)] = err
        for fkey in ("fp8_e4m3+bf16+split2_fp16", "fp8_e4m3+bf16+split3_e5m2"):
            fs = FormatSet.from_key(fkey)
            mt = size // t
            a = torch.randn((size, size), generator=gen, device=DEVICE) * (
                10.0 ** torch.randint(-7, 4, (size, 1), generator=gen,
                                      device=DEVICE).float())
            hm = np.full((mt, mt), fs.high, np.int8)
            A = MPMatrix.from_dense(a, hm, t, fs)
            B = MPMatrix.from_dense(torch.eye(size, device=DEVICE), hm, t, fs)
            C = MPMatrix.from_dense(torch.zeros((size, size), device=DEVICE),
                                    hm, t, fs)
            ok = SG.split_gemm_tile_multi(A.bufs, B.bufs, C.bufs, hm, hm, hm,
                                          tile=t,
                                          specs=split_format_specs(fs))
            f = fs.fmt(fs.high)
            want = recombine(split_slices(A.bufs[fs.high], f.slices,
                                          f.slice_dtype))
            sync()
            same = torch.equal(ok[fs.high], want)
            print(f"split slices {f.name} {size}^2 t={t} (B = I, |A| over "
                  f"1e-7..1e3): kernel output == recombine(split_slices(A)) "
                  f"bitwise: {same}")
            if not same:
                fail(f"split kernel's {f.name} slices differ from "
                     f"split_slices at t={t}")
            del a, A, B, C, ok, want
    # the solve's residual shape under its end map, C and X uniform split2
    fs, (A, B, C), _ = gemm_case(SOLVE_N, SOLVE_N, TILE, TILE,
                                 "fp8_e4m3+bf16+split2_fp16", 0.05, 0.0, gen,
                                 seed0=91, high=(1, 2))
    out[("slices", "residual")] = check_slices(
        A, B, C, f"solve residual {SOLVE_N}x{SOLVE_N}.{SOLVE_N}x{TILE} 5D95S")
    print(f"split checks: {SG.launches} launches, {SG.prep_launches} slice "
          "passes")
    return out


#: the split kernel's fixed summation order at t = 16 and 32 (label,
#: format-set key, ratio_high, ratio_low8): split2 and split3 C classes
#: beside fp8 and bf16 ones, and beside an int8 class (fp32 compute)
ORDER_TILES = (16, 32)
ORDER_SIZE = 256
ORDER_MIXES = (
    ("split2 40D30S30Q", "fp8_e4m3+bf16+split2_fp16", 0.4, 0.3),
    ("split3 40D30S30Q", "fp8_e4m3+bf16+split3_e5m2", 0.4, 0.3),
    ("split2 40D40S20Q-int8", "int8_pt+bf16+split2_fp16", 0.4, 0.2),
)


def check_split_order(gen) -> None:
    """At t = 16 and 32 the split kernel sums in a fixed order (one FMA
    chain per slice pair and k tile, pairs in slice_pair_order; simple
    classes one chain over K), which ``split_gemm_ref`` follows operation
    for operation: every output buffer, i.e. every C class, must be equal
    to it bit for bit (NaN as NaN)."""
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import split_format_specs, split_gemm_ref
    for t in ORDER_TILES:
        for label, fkey, hi, q in ORDER_MIXES:
            fs, (A, B, C), maps = tile_case(ORDER_SIZE, t, fkey, hi, q, gen,
                                            seed0=61)
            got = SG.split_gemm_tile_multi(
                A.bufs, B.bufs, C.bufs, *maps, tile=t,
                specs=split_format_specs(fs), alpha=1.5, beta=0.5)
            want = split_gemm_ref(A, B, C, 1.5, 0.5).bufs
            sync()
            for code in np.unique(maps[2]):
                same = same_bits(got[code], want[code])
                print(f"split order {ORDER_SIZE}^3 t={t} {label} [{fkey}] "
                      f"class {fs.fmt(int(code)).name}: kernel == "
                      f"split_gemm_ref bitwise (NaN as NaN): {same}")
                if not same:
                    fail(f"the split kernel's {fs.fmt(int(code)).name} "
                         f"tiles at t={t} ({label}) differ from "
                         "split_gemm_ref")


def check_slices(A, B, C, label) -> float:
    """The split kernel's slice pass alone (``slice_operands``) for every
    split class of A's format set against its plain version
    (``slice_operand_plain``) on both operands, bit for bit (NaN as NaN),
    so max |kernel - plain| over the other slices is 0.0, returned."""
    import torch
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import split_format_specs
    fs, t = A.fset, A.tile
    specs = split_format_specs(fs)
    for code, spec in enumerate(specs):
        if spec[3] < 2:
            continue
        got = SG.slice_operands(A.bufs, B.bufs, C.bufs, A.cls, B.cls, C.cls,
                                tile=t, specs=specs, code=code)
        st = SG.slice_store_dtype(spec)
        for name, M, kern in (("A", A, got[0]), ("B", B, got[1])):
            want = SG.slice_operand_plain(M.bufs, M.cls, t, spec[3], spec[4],
                                          st)
            nan = torch.isnan(kern) & torch.isnan(want)
            same = bool(((kern.view(torch.int16) == want.view(torch.int16))
                         | nan).all())
            print(f"split slice pass {label} t={t} {fs.fmt(code).name} "
                  f"{name} {tuple(kern.shape)}: == slice_operand_plain "
                  f"bitwise (NaN as NaN): {same}")
            if not same:
                fail(f"the slice pass's {name} slices at {label} t={t} "
                     "differ from slice_operand_plain")
        del got
    return 0.0


def check_grouped(gen) -> dict:
    """The grouped kernel over every TILE_MIXES map at each checked tile
    edge, C = A·B into compact class arrays."""
    out = {}
    size = SPLIT_SIZE
    for t in CHECK_TILES:
        for label, fkey, hi, q in TILE_MIXES:
            fs, (A, B, C), _ = tile_case(size, t, fkey, hi, q, gen, seed0=41)
            err, ratio = kernel_vs_plain("grouped", A, B, zero_c(C))
            print(f"grouped {size}^3 t={t} {label} [{fkey}]: max|kernel-"
                  f"plain| {err:.3e}, worst/allowance {ratio:.3e} (2*K*"
                  "2^-24*|A||B| + one output rounding or quantization "
                  "step); one launch for every output class")
            if not ratio <= 1.0:
                fail(f"grouped {size} t={t} {label} outside tolerance")
            out[(t, label)] = err
            del A, B, C
    return out


def convert_input(gen):
    """fp32 [CONVERT_SIZE]^2 spanning 1e-12..1e6 (subnormal, overflow and
    e4m3-NaN ranges of every target) plus the rounding edge cases."""
    import torch
    n = CONVERT_SIZE
    x = torch.randn((n, n), generator=gen, device=DEVICE) * (
        10.0 ** (torch.rand((n, n), generator=gen, device=DEVICE) * 18
                 - 12))
    edges = torch.tensor(
        [0.0, -0.0, 448.0, 464.0, 464.01, -480.0, 57344.0, 61439.99,
         61440.0, 65504.0, 65520.0, 1e5, float("inf"), -float("inf"),
         float("nan"), 2.0 ** -16, 2.0 ** -17, 3 * 2.0 ** -17, 2.0 ** -24,
         2.0 ** -25, 3 * 2.0 ** -25, 2.0 ** -133, 3e38], device=DEVICE)
    x.view(-1)[: edges.numel()] = edges
    return x


def same_bits(got, want) -> bool:
    """Bitwise equal where ``want`` is a number, NaN where it is NaN
    (NaN payloads differ between PyTorch's and CUDA's casts)."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    nan = torch.isnan(want.float())
    if not torch.equal(torch.isnan(got.float()), nan):
        return False
    g = got.view(ints[got.element_size()])
    w = want.view(ints[want.element_size()])
    return torch.equal(torch.where(nan, torch.zeros_like(g), g),
                       torch.where(nan, torch.zeros_like(w), w))


def check_convert(gen) -> dict:
    import torch
    from repro_torch.kernels import convert as CV
    x = convert_input(gen)
    out = {}
    for dt in CV.OUT_DTYPES:
        got = CV.convert(x, dt)
        want = CV.convert_plain(x, dt)
        sync()
        ok = same_bits(got, want)
        g, w = got.float(), want.float()
        differ = ~(torch.isnan(g) | torch.isnan(w)) & (g != w)
        err = float(torch.where(differ, (g - w).abs(), 0.0).nan_to_num(
            float("inf")).max())
        print(f"convert {CONVERT_SIZE}^2 fp32 -> {dt}: bitwise equal to the "
              f"plain cast (NaN where it is NaN): {ok}; max|kernel-plain| "
              f"over numbers {err}")
        if not ok:
            fail(f"convert to {dt} differs from its plain version")
        out[str(dt)] = err
        del got, want, g, w, differ
    for label, m, n, fkey, hi, q in CLASS_CASES:
        fs, cls = class_case(m, n, fkey, hi, q)
        xs = x[:m, :n].contiguous()
        got = CV.convert_by_class(xs, cls, TILE, fs)
        want = CV.convert_by_class_plain(xs, cls, TILE, fs)
        sync()
        ok = all(same_bits(g, w) for g, w in zip(got, want))
        print(f"convert_by_class {label} [{fkey}] t={TILE}: every buffer "
              f"bitwise equal to the plain version (NaN as NaN): {ok}")
        if not ok:
            fail(f"convert_by_class {label} differs from its plain version")
        out[label] = 0.0
        del got, want, xs
    return out


#: the class-map form's checks (label, rows, cols, format-set key,
#: ratio_high, ratio_low8; ratio_high None = uniform HIGH): 8192² maps
#: with the edge values of convert_input, the solve's trailing-update C
#: (uniform HIGH) and L panel, and a ragged shape (padding in the kernel)
CLASS_CASES = (
    ("8192^2 5D95S", 8192, 8192, "fp8_e4m3+bf16+fp32", 0.05, 0.0),
    ("8192^2 50D50S", 8192, 8192, "fp8_e4m3+bf16+fp32", 0.5, 0.0),
    ("8192^2 40D30S30Q split2", 8192, 8192, "fp8_e4m3+bf16+split2_fp16",
     0.4, 0.3),
    ("8192^2 50D50S split3", 8192, 8192, "fp16+split3_e5m2", 0.5, 0.0),
    ("trailing C 8064^2 HIGH", 8064, 8064, "fp8_e4m3+bf16+fp32", None,
     0.0),
    ("L panel 8064x128 5D95S", 8064, 128, "fp8_e4m3+bf16+fp32", 0.05, 0.0),
    ("ragged 8000x8100 40D30S30Q", 8000, 8100, "fp8_e4m3+bf16+fp32", 0.4,
     0.3),
)


def decode_attn_case(B, S, nkv, group, dh, seed):
    """(q, k, v, valid): random bf16 operands on the card, row i at
    position i·(S - 1)/(B - 1) (masked decode's per-row prefixes)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 1, nkv * group, dh), generator=g).to(torch.bfloat16)
    k = torch.randn((B, S, nkv, dh), generator=g).to(torch.bfloat16)
    v = (torch.randn((B, S, nkv, dh), generator=g) * 3).to(torch.bfloat16)
    pos = torch.arange(B) * (S - 1) // max(B - 1, 1)
    valid = torch.arange(S)[None, :] <= pos[:, None]
    return [t.to(DEVICE) for t in (q, k, v, valid)]


def check_decode_attention() -> dict:
    """The decode-attention kernel against its plain version (fp32 outputs,
    gap over max|V|) at every DECODE_ATTN_SHAPES row, under per-row
    prefixes and a stride-0 equal-mode mask; bf16 = the fp32 output
    rounded; rows bitwise across the batch; no tile past every row's
    position read."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    gaps = {}
    for label, B, S, nkv, group, dh in DECODE_ATTN_SHAPES:
        q, k, v, valid = decode_attn_case(B, S, nkv, group, dh, 1)
        eq = (torch.arange(S, device=DEVICE) <= S // 3)[None, :].expand(B, S)
        vmax = v.float().abs().max()
        for mask_name, mask in (("prefixes", valid), ("equal", eq)):
            got = DA.decode_attention(q, k, v, mask, out_dtype=torch.float32)
            want = DA.decode_attention_plain(q, k, v, mask, torch.float32)
            gap = float((got - want).abs().max() / vmax)
            gaps[(label, mask_name)] = gap
            if not gap <= DECODE_ATTN_TOL:
                fail(f"decode attention {label} ({mask_name}): kernel vs "
                     f"plain {gap:.3e}·max|V| > {DECODE_ATTN_TOL}")
            if not torch.equal(DA.decode_attention(q, k, v, mask),
                               got.to(torch.bfloat16)):
                fail(f"decode attention {label} ({mask_name}): the bf16 "
                     "output is not the fp32 output rounded")
        print(f"check decode_attention {label} (B {B}, S_max {S}, {nkv} x "
              f"{group} heads of {dh}): kernel vs plain "
              f"{gaps[(label, 'prefixes')]:.3e} (prefixes), "
              f"{gaps[(label, 'equal')]:.3e} (equal mode) of max|V|")
    q, k, v, valid = decode_attn_case(*DECODE_ATTN_SHAPES[0][1:], 2)
    out = DA.decode_attention(q, k, v, valid)
    for i in (0, 37, 127):
        one = DA.decode_attention(q[i:i + 1], k[i:i + 1].contiguous(),
                                  v[i:i + 1].contiguous(), valid[i:i + 1])
        if not torch.equal(one[0], out[i]):
            fail(f"decode attention: row {i} alone differs from the batch")
    pos = torch.arange(16, device=DEVICE) * 9 + 60          # 60 … 195
    valid = torch.arange(512, device=DEVICE)[None, :] <= pos[:, None]
    q, k, v = q[:16], k[:16].contiguous(), v[:16].contiguous()
    DA.reset_tiles()
    out = DA.decode_attention(q, k, v, valid)
    want = int(((pos // DA.TILE + 1) * 8).sum())
    if DA.tiles_read() != want:
        fail(f"decode attention read {DA.tiles_read()} tiles, not {want}")
    k[:, 256:] = 7.0
    v[:, 256:] = -5.0
    if not torch.equal(DA.decode_attention(q, k, v, valid), out):
        fail("decode attention: slots past every position changed the "
             "output")
    DA.reset_tiles()
    print("check decode_attention: rows bitwise across the batch; tiles "
          f"past every position unread ({want} of {16 * 8 * 8} read)")
    return gaps


def class_case(m, n, fkey, hi, q):
    """(format set, tile class map at TILE covering m x n) of a
    CLASS_CASES row."""
    from repro_torch.core.formats import FormatSet
    from repro_torch.core.precision import Policy, make_map
    fs = FormatSet.from_key(fkey)
    grid = (-(-m // TILE), -(-n // TILE))
    if hi is None:
        return fs, np.full(grid, fs.high, np.int8)
    return fs, make_map((grid[0] * TILE, grid[1] * TILE), TILE,
                        Policy("ratio", hi, q, seed=7), fset=fs)


# ---------------------------------------------------------------------------
# phase 3: mp_matmul through dispatch
# ---------------------------------------------------------------------------

def check_mp_matmul(gen) -> None:
    import torch
    from repro_torch.core.accuracy import check_against_fp64
    from repro_torch.core.formats import DEFAULT_FORMATS as FS
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    from repro_torch.kernels import ops
    from repro_torch.tune import dispatch as D
    n, t = TILE_SIZES[0], TILE
    dense = [torch.randn((n, n), generator=gen, device=DEVICE)
             for _ in range(3)]
    maps = [make_map((n, n), t, Policy("ratio", 0.4, 0.2, seed=s), fset=FS)
            for s in (11, 12, 13)]
    A, B, C = (MPMatrix.from_dense(d, p, t, FS) for d, p in zip(dense, maps))
    prob = D.problem_of(A, B, C, beta=0.5)
    plan, _ = D.resolve_plan(prob, D.detect_device(A.device))
    if plan.path != "tile":
        fail(f"mp_matmul resolved {plan.path!r}, not 'tile'")
    ops.reset_launch_counts()
    out = D.mp_matmul(A, B, C, beta=0.5)
    sync()
    launches = ops.launch_counts()["mp_gemm_tile"]
    if launches < 1:
        fail("mp_matmul did not launch the tile kernel")
    rep = check_against_fp64(out.to_dense().cpu().numpy(),
                             dense[0].cpu().numpy(), dense[1].cpu().numpy(),
                             dense[2].cpu().numpy(), *maps, t, FS, beta=0.5)
    print(f"mp_matmul {n}^3 plan={plan.key()} tile launches={launches} "
          f"fp64 worst/bound per C class {rep['worst_ratio']}")
    if not rep["ok"]:
        fail(f"mp_matmul outside the fp64 error bounds: {rep}")


def check_mp_matmul_split(gen) -> None:
    """``mp_matmul`` with split C classes: dispatch must pick ``split`` and
    the split kernel must launch, inside the fp64 error bounds."""
    import torch
    from repro_torch.core.accuracy import check_against_fp64
    from repro_torch.core.formats import DEFAULT_FORMATS
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy, make_map
    from repro_torch.kernels import ops
    from repro_torch.split import split_variant
    from repro_torch.tune import dispatch as D
    fs = split_variant(DEFAULT_FORMATS)
    n, t = TILE_SIZES[0], TILE
    dense = [torch.randn((n, n), generator=gen, device=DEVICE)
             for _ in range(3)]
    maps = [make_map((n, n), t, Policy("ratio", 0.4, 0.2, seed=s), fset=fs)
            for s in (14, 15, 16)]
    A, B, C = (MPMatrix.from_dense(d, p, t, fs) for d, p in zip(dense, maps))
    prob = D.problem_of(A, B, C, beta=0.5)
    plan, _ = D.resolve_plan(prob, D.detect_device(A.device))
    if plan.path != "split":
        fail(f"mp_matmul with split C classes resolved {plan.path!r}")
    ops.reset_launch_counts()
    out = D.mp_matmul(A, B, C, beta=0.5)
    sync()
    launches = ops.launch_counts()["split_gemm"]
    if launches < 1:
        fail("mp_matmul did not launch the split kernel")
    rep = check_against_fp64(out.to_dense().cpu().numpy(),
                             dense[0].cpu().numpy(), dense[1].cpu().numpy(),
                             dense[2].cpu().numpy(), *maps, t, fs, beta=0.5)
    print(f"mp_matmul {n}^3 [{fs.key()}] plan={plan.key()} split launches="
          f"{launches} fp64 worst/bound per C class {rep['worst_ratio']}")
    if not rep["ok"]:
        fail(f"split mp_matmul outside the fp64 error bounds: {rep}")


# ---------------------------------------------------------------------------
# phase 4: serve InternLM2-1.8B at full width
# ---------------------------------------------------------------------------

def serve(cfg, seed: int = 0) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, Request, ServeConfig
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_model(gen, cfg)
    sync()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=256, refill=False, prefix_cache=False,
        chunked_prefill=False))
    eng.warmup()
    rng = np.random.default_rng(seed)
    lens = np.linspace(8, 96, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab, L).astype(np.int64) for L in lens]
    reqs = [Request(p, max_new_tokens=16) for p in prompts]
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    eng.generate(reqs)
    sync()
    serve_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    st = eng.stats()
    refs = eng.generate_reference([Request(p, max_new_tokens=16)
                                   for p in prompts])
    bad = [i for i, (r, f) in enumerate(zip(reqs, refs))
           if not r.done or r.out_tokens != f.out_tokens]
    lin = st["linear_dispatch_since_warmup"]
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    gen_toks = st["tokens"]["generated"]
    print(f"serve {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab}, weights {param_bytes(params) / 1e9:.3f} GB, "
          f"init {init_s:.2f} s")
    print(f"serve: {len(reqs)} requests (prompts {[int(v) for v in lens]}), "
          f"{gen_toks} tokens in {serve_s:.3f} s = {gen_toks / serve_s:.2f} "
          f"tokens/s; microbatches {st['microbatches']}; prefill steps "
          f"{st['prefill_steps']}, decode steps {st['decode_steps']}")
    print(f"serve: kernel launches {launches}; linear dispatch since "
          f"warmup {lin}; post-warmup fresh resolutions {fresh}")
    print(f"serve: batched tokens == unbatched reference for "
          f"{len(reqs) - len(bad)}/{len(reqs)} requests")
    if bad:
        fail(f"batched tokens differ from the reference for requests {bad}")
    if fresh != 0:
        fail(f"{fresh} fresh plan resolutions after warmup")
    if launches["ksplit_gemm"] < 1:
        fail("serving never launched the ksplit kernel")
    if lin.get("ksplit_torch", 0) != 0:
        fail(f"{lin['ksplit_torch']} KSplit linears ran off the kernel")
    for r in reqs:
        if len(r.out_tokens) != 16 or not all(
                0 <= tok < cfg.vocab for tok in r.out_tokens):
            fail("malformed output tokens")
    steps = st["prefill_steps"] + st["decode_steps"]
    if launches["decode_attention"] != cfg.n_layers * steps:
        fail(f"{launches['decode_attention']} decode-attention launches in "
             f"{steps} model steps, not {cfg.n_layers} a step")
    attn = st["attention"]
    print(f"serve: decode attention {launches['decode_attention']} launches "
          f"({cfg.n_layers} a model step), tiles read "
          f"{attn['tiles_read']} of {attn['tiles_total']}")
    prof = profile_decode(cfg, params)
    return {"launches": launches["ksplit_gemm"],
            "attn_launches": launches["decode_attention"], "tokens_per_s":
            gen_toks / serve_s, "launches_per_step":
            launches["ksplit_gemm"] / max(1, steps), **prof}


# ---------------------------------------------------------------------------
# phase 4b: the serve state at full width
# ---------------------------------------------------------------------------

#: phase 4b's KV-cache length: the 170-token prompt pads to 256 (two
#: chunks of the largest bucket, 128) and decodes 16 tokens
STATE_MAX_SEQ = 320
#: phase 4b's depth: its gates (tokens equal the reference, refills,
#: chunk skips, page leaks) do not depend on it, and 6 of the 24 layers
#: take a quarter of the host-bound model steps (phase 9 added ~260 s)
STATE_LAYERS = 6


def state_stream(vocab: int, seed: int) -> list:
    """Phase 4b's three ``generate`` calls, from a numpy seed: six requests
    sharing a 40-token prefix (bucket 64, P = 32) that retire early so two
    of them enter as refills, and two sampled 12-token requests; a
    150-token prompt (chunked, pad 256); a 170-token prompt sharing its
    first 144 tokens (its chain covers the first chunk)."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 40)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, t)])
              for t in (4, 8, 12, 16, 20, 24)]
    short = rng.integers(0, vocab, 12)
    long2 = rng.integers(0, vocab, 150)
    long3 = np.concatenate([long2[:144], rng.integers(0, vocab, 26)])
    call1 = [Request(p, max_new_tokens=n)
             for p, n in zip(shared, (4, 16, 8, 16, 4, 12))]
    call1 += [Request(short, max_new_tokens=12, temperature=0.8, seed=s)
              for s in (1, 2)]
    return [call1, [Request(long2, max_new_tokens=16)],
            [Request(long3, max_new_tokens=16)]]


def serve_state(cfg, seed: int = 0) -> dict:
    """Serve the phase-4b stream through the engine at the reference's
    defaults (refill, paged prefix cache, chunked prefill), hold every
    request to ``generate_reference`` and gate the counters."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.kv_pages import page_digests
    t_phase = time.perf_counter()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    eng = Engine(cfg, params, ServeConfig(max_batch=4,
                                          max_seq=STATE_MAX_SEQ))
    eng.warmup()
    calls = state_stream(cfg.vocab, seed)
    skipped = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for batch in calls:
        eng.generate(batch)
        skipped.append(int(eng.metrics.value("serve.chunks_skipped")))
    sync()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = eng.stats()
    reqs = [r for batch in calls for r in batch]
    refs = eng.generate_reference(
        [r for batch in state_stream(cfg.vocab, seed) for r in batch])
    bad = [i for i, (r, f) in enumerate(zip(reqs, refs))
           if not r.done or r.out_tokens != f.out_tokens]
    mb, pc, pages = st["microbatches"], st["prefix_cache"], st["kv_pages"]
    reused = int(eng.metrics.value("serve.prefix.reused_prefills"))
    lin = st["linear_dispatch_since_warmup"]
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    gen_toks = st["tokens"]["generated"]
    call_skips = [skipped[0], skipped[1] - skipped[0],
                  skipped[2] - skipped[1]]
    # the host time of one 16-page chain copied into a cache row
    digs = page_digests("default", calls[1][0].prompt, eng.pool.page_tokens,
                        limit=len(calls[1][0].prompt) - 1)[:16]
    pids = eng.prefix.chain(digs)
    caches = T.init_cache(cfg, 4, STATE_MAX_SEQ, DEVICE)
    scatter_ms = host_clock_ms(lambda: eng.write_pages(
        caches, 1, [eng.pool.payload(p) for p in pids]))
    print(f"serve state: {cfg.n_layers} layers, {len(reqs)} requests in 3 "
          f"calls, {gen_toks} "
          f"tokens in {wall_s:.3f} s = {gen_toks / wall_s:.2f} tokens/s; "
          f"microbatches {mb['total']}, refills {mb['refills']} "
          f"({mb['reused_refills']} page-reused), reused prefills "
          f"{reused}, chunked prefills {st['chunked_prefills']} (chunks "
          f"run {st['chunks']['run']}, skipped {st['chunks']['skipped']}; "
          f"skipped per call {call_skips})")
    print(f"serve state: prefix hits {pc['hits']} misses {pc['misses']} "
          f"inserts {pc['inserts']} entries {pc['entries']}; pages in use "
          f"{pages['in_use']} (high water {pages['high_water']}); prefill "
          f"steps {st['prefill_steps']}, decode steps {st['decode_steps']}")
    print(f"serve state: kernel launches {launches}; linear dispatch "
          f"since warmup {lin}; post-warmup fresh resolutions {fresh}")
    print(f"serve state: {len(pids)}-page chain copied into a cache row "
          f"in {scatter_ms:.3f} ms (host clock, device synchronized)")
    print(f"serve state: batched tokens == unbatched reference for "
          f"{len(reqs) - len(bad)}/{len(reqs)} requests (sampled: "
          f"{reqs[6].out_tokens[:6]}... vs {reqs[7].out_tokens[:6]}...)")
    if bad:
        fail(f"serve state: batched tokens differ from the reference for "
             f"requests {bad}")
    if reqs[6].out_tokens == reqs[7].out_tokens:
        fail("serve state: the two sampled streams are equal")
    if mb["refills"] < 2 or mb["reused_refills"] < 1:
        fail(f"serve state: {mb['refills']} refills, "
             f"{mb['reused_refills']} page-reused (want >= 2, >= 1)")
    if reused < 1 and mb["reused_refills"] < 1:
        fail("serve state: no prefill reused a page")
    if st["chunked_prefills"] < 2 or call_skips[2] != 1:
        fail(f"serve state: {st['chunked_prefills']} chunked prefills, "
             f"call 3 skipped {call_skips[2]} chunks (want >= 2, 1)")
    if pages["in_use"] != pc["entries"]:
        fail(f"serve state: {pages['in_use']} pages in use for "
             f"{pc['entries']} cache entries after the drain (a leak)")
    if len(pids) != 16:
        fail(f"serve state: the 150-token chain holds {len(pids)} pages")
    if fresh != 0:
        fail(f"serve state: {fresh} fresh plan resolutions after warmup")
    if launches["ksplit_gemm"] < 1:
        fail("serve state never launched the ksplit kernel")
    if lin.get("ksplit_torch", 0) != 0:
        fail(f"serve state: {lin['ksplit_torch']} KSplit linears ran off "
             "the kernel")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= tok < cfg.vocab for tok in r.out_tokens):
            fail("serve state: malformed output tokens")
    rows_equal(cfg, params)
    phase_s = time.perf_counter() - t_phase
    print(f"serve state: phase {phase_s:.1f} s")
    return {"launches": launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "scatter_ms": scatter_ms,
            "phase_s": phase_s}


def rows_equal(cfg, params, steps: int = 8) -> None:
    """Informational, no gate: the same token stream through
    ``forward_decode`` at m = 1 and at m = 4 (rows repeating it); prints
    whether row 0's logits are bit-equal at every step, which says
    whether a batch-1 refill prefill could be exact."""
    import torch
    from repro_torch.models import transformer as T
    toks = np.random.default_rng(7).integers(0, cfg.vocab, steps)
    logits = {}
    for m in (1, 4):
        caches = T.init_cache(cfg, m, 64, DEVICE)
        out = []
        for s, t in enumerate(toks):
            tok = torch.full((m, 1), int(t), dtype=torch.int64,
                             device=DEVICE)
            lg, _ = T.forward_decode(params, cfg, tok, caches, s)
            out.append(lg[0, 0].float().cpu())
        logits[m] = torch.stack(out)
    same = [bool(torch.equal(a, b)) for a, b in zip(logits[1], logits[4])]
    diff = float((logits[1] - logits[4]).abs().max())
    print(f"rows m=1 vs m=4: row 0's logits bit-equal at {sum(same)}/"
          f"{steps} decode steps (max abs diff {diff:.3e})")


def profile_decode(cfg, params, steps: int = 5) -> dict:
    """Where a decode step's time goes: wall time per step (host clock
    around synchronized steps) and, under ``torch.profiler``, the device
    time per step by kernel name.  The device's idle share is 1 - busy /
    wall (the profiler's own overhead is kept out of the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    B = 4
    tok = torch.zeros((B, 1), dtype=torch.int64, device=DEVICE)
    caches = T.init_cache(cfg, B, 256, DEVICE)
    T.forward_decode(params, cfg, tok, caches, 0)
    sync()
    t0 = time.perf_counter()
    for s in range(steps):
        T.forward_decode(params, cfg, tok, caches, 1 + s)
    sync()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(steps):
            T.forward_decode(params, cfg, tok, caches, 1 + s)
        sync()
    # kernel rows only: a CPU op's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / steps / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if not busy_ms:
        print(f"profile decode step (batch {B}): wall {wall_ms:.2f} ms; "
              "the profiler saw no device time: busy share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None}
    ksplit_ms = sum(ms for name, ms in rows if "ksplit" in name)
    print(f"profile decode step (batch {B}): wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.1%}; ksplit kernel {ksplit_ms:.3f} ms")
    for name, ms in rows[:8]:
        print(f"profile   {ms:8.3f} ms/step  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "ksplit_ms": ksplit_ms}


def param_bytes(params) -> int:
    from repro_torch.core.linear import MPLinear
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, MPLinear):
            total += sum(b.numel() * b.element_size() for b in node.w.bufs)
        else:
            total += node.numel() * node.element_size()
    visit(params)
    return total


# ---------------------------------------------------------------------------
# phase 4c: quantized weight variants at full width
# ---------------------------------------------------------------------------

#: phase 4c's calibration: the int8 class in the LOW role beside the
#: set's HIGH format, with a quarter of the K-blocks kept HIGH
QUANT_RATIO = 0.25
#: the rows of results/bench_baseline/BENCH_quant.json (operator edge,
#: tile) and the file itself
QUANT_N, QUANT_TILE = 64, 16
#: phase 4c's depth: 8 of InternLM2-1.8B's 24 layers (every width as
#: published).  At 24 it took 59-80 s, three quarters of it in its three
#: serving runs; the cut keeps the whole script inside its time limit on
#: a slow host, and no gate depends on depth
QUANT_LAYERS = 8
QUANT_BASELINE = os.path.join(HERE, "results", "bench_baseline",
                              "BENCH_quant.json")


def linear_counts_by_formats() -> dict:
    """``{formats key: {path: calls}}`` of the KSplit linears dispatched
    since the last reset of the metrics registry."""
    from repro_torch import obs
    from repro_torch.tune import dispatch
    out: dict = {}
    for labels, c in obs.metrics_registry().series(dispatch.DISPATCH_METRIC):
        if labels["op"] == "linear":
            per = out.setdefault(labels["formats"], {})
            per[labels["path"]] = per.get(labels["path"], 0) + int(c.value)
    return out


def ksplit_weights(params) -> list:
    """The KSplit weights of a dense model, lm_head first."""
    from repro_torch.core.layout import KSplitWeight
    lins = [params["lm_head"]] + [
        lp[blk][name] for lp in params["layers"]
        for blk, names in (("attn", ("wq", "wk", "wv")),
                           ("mlp", ("up", "gate"))) for name in names]
    return [lin.w for lin in lins if isinstance(lin.w, KSplitWeight)]


def quant_rows() -> dict:
    """The rows of ``BENCH_quant.json`` at its shapes (n = 64, tile 16) on
    the card, through the port's dispatch: the same loud-band operator
    (numpy seed 11), forward error against fp64 and storage bytes over
    fp32.  Gated as ``benchmarks/compare.py`` gates them: rel_err no more
    than one decade worse, bytes_frac and calib_ok exact."""
    import torch
    from repro_torch.core.formats import format_set
    from repro_torch.core.layout import KSplitWeight
    from repro_torch.quant import ActStats, block_scores, calibrated_cls
    from repro_torch.tune import dispatch
    n, t = QUANT_N, QUANT_TILE
    rng = np.random.default_rng(11)
    w = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal((8, n)).astype(np.float32)
    x[:, : int(n * 0.125)] *= 30.0
    exact = x.astype(np.float64) @ w.astype(np.float64)
    s8, s4 = format_set("int8_pt", "fp32"), format_set("int4_pt", "fp32")
    kt = n // t
    maps = {
        "int8_uniform": (s8, np.full(kt, s8.low, np.int8)),
        "int4_uniform": (s4, np.full(kt, s4.low, np.int8)),
        "mixed_calibrated": (s8, calibrated_cls(block_scores(
            w, ActStats().observe(x).get(n), t), 0.25, s8)),
    }
    xd = torch.from_numpy(x).to(DEVICE)
    got = {}
    for tag, (fs, cls) in maps.items():
        W = KSplitWeight.from_dense(torch.from_numpy(w).to(DEVICE), cls, t,
                                    fs)
        y = dispatch.linear_matmul(xd, W).double().cpu().numpy()
        rel = float(np.abs(y - exact).max() / np.abs(exact).max())
        got[tag] = (rel, float(W.storage_bytes()) / (w.size * 4))
    with open(QUANT_BASELINE) as f:
        base = {r["name"]: dict(kv.split("=") for kv in
                                r["derived"].split(";"))
                for r in json.load(f)["rows"]}
    for tag, (rel, frac) in got.items():
        calib_ok = 1
        if tag == "mixed_calibrated":
            calib_ok = int(rel < got["int8_uniform"][0] and frac < 0.5)
        b = base[f"quant_{tag}_{n}"]
        worse = np.log10(max(rel, 1e-30)) - np.log10(float(b["rel_err"]))
        print(f"quant row {tag}: rel_err {rel:.3g} (baseline "
              f"{b['rel_err']}), bytes_frac {frac:.4f} (baseline "
              f"{b['bytes_frac']}), calib_ok {calib_ok}")
        if worse > 1.0 or f"{frac:.4f}" != b["bytes_frac"] \
                or str(calib_ok) != b["calib_ok"]:
            fail(f"quant row {tag} does not reproduce BENCH_quant.json")
    return got


def serve_quant(cfg, seed: int = 0) -> dict:
    """Serve a mixed stream of default and int8-variant requests through
    one engine at full width; every request must equal
    ``generate_reference`` and its replay, both buckets must serve, and
    every KSplit linear must take the path its map's sortedness calls
    for (a calibrated map is not sorted by class: the gathering path, as
    in the reference)."""
    import torch
    from repro_torch.core.formats import FormatSet, format_set
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant import ActStats, map_report, quantize_params
    from repro_torch.serve import Engine, Request, ServeConfig
    t_phase = time.perf_counter()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    rng = np.random.default_rng(seed)
    lens = np.linspace(8, 96, 8).astype(int)       # phase 4's prompts
    prompts = [rng.integers(0, cfg.vocab, L).astype(np.int64) for L in lens]
    stats = ActStats()
    for p in prompts:
        stats.observe(params["embed"][torch.from_numpy(p).to(DEVICE)])
    fs = FormatSet.from_key(cfg.mp_formats)
    qset = format_set("int8_pt", fs.names[fs.high])
    tag = qset.key()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    qparams = quantize_params(params, stats, fset=qset,
                              ratio_high=QUANT_RATIO)
    sync()
    quant_s = time.perf_counter() - t0
    cal_convert = ops.launch_counts()["convert"]
    qws = ksplit_weights(qparams)
    n_sorted = sum(w.sorted for w in qws)
    reports = [map_report(w) for w in qws]
    storage = sum(r["storage_bytes"] for r in reports)
    dense = sum(4 * r["shape"][0] * r["shape"][1] for r in reports)
    classes: dict = {}
    for r in reports:
        for name, count in r["classes"].items():
            classes[name] = classes.get(name, 0) + count
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=128, refill=False, prefix_cache=False,
        chunked_prefill=False), variants={tag: qparams})
    eng.warmup()
    stream = [(p[:int(L) // 2], ("default", tag)[i % 2])
              for i, (p, L) in enumerate(zip(prompts, lens))]

    def reqs():
        return [Request(p, max_new_tokens=8, fset=f) for p, f in stream]

    before = linear_counts_by_formats()
    ops.reset_launch_counts()
    first = reqs()
    t1 = time.perf_counter()
    eng.generate(first)
    sync()
    wall_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    by_fmt = {f: {p: v - before.get(f, {}).get(p, 0) for p, v in c.items()
                  if v - before.get(f, {}).get(p, 0)}
              for f, c in linear_counts_by_formats().items()}
    st = eng.stats()
    replay = reqs()
    eng.generate(replay)
    refs = eng.generate_reference(reqs())
    bad = [i for i, (r, p, f) in enumerate(zip(first, replay, refs))
           if not r.done or r.out_tokens != f.out_tokens
           or r.out_tokens != p.out_tokens]
    buckets = {r.bucket.split("/", 1)[1] for r in first}
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    gen_toks = sum(len(r.out_tokens) for r in first)
    q = by_fmt.get(tag, {})
    steps = sum(q.values()) // max(1, len(qws))
    print(f"serve quant: variant {tag} (ratio_high {QUANT_RATIO}) in "
          f"{quant_s:.2f} s ({cal_convert} convert launches); KSplit "
          f"classes {classes}; {n_sorted}/{len(qws)} maps sorted; "
          f"bytes_vs_fp32 {storage / dense:.4f} ({storage / 1e9:.3f} GB "
          f"of {dense / 1e9:.3f})")
    print(f"serve quant: {len(first)} requests ({len(first) // 2} per "
          f"variant), {gen_toks} tokens in {wall_s:.3f} s = "
          f"{gen_toks / wall_s:.2f} tokens/s; buckets "
          f"{sorted(r.bucket for r in first)}; linear dispatch by formats "
          f"{by_fmt}; kernel launches {launches}")
    print(f"serve quant: tokens == unbatched reference and replay for "
          f"{len(first) - len(bad)}/{len(first)} requests; post-warmup "
          f"fresh resolutions {fresh}")
    if bad:
        fail(f"serve quant: requests {bad} differ from their reference or "
             "replay")
    if buckets != {"default", tag}:
        fail(f"serve quant: buckets {buckets}, want both variants")
    if fresh != 0:
        fail(f"serve quant: {fresh} fresh plan resolutions after warmup")
    if "int8_pt" not in classes:
        fail("serve quant: the variant holds no int8_pt class")
    if not steps or q != {k: v for k, v in (
            ("ksplit_cuda", steps * n_sorted),
            ("ksplit_torch", steps * (len(qws) - n_sorted))) if v}:
        fail(f"serve quant: variant dispatch {q} is not {steps} steps of "
             f"{n_sorted} sorted (kernel) and {len(qws) - n_sorted} "
             "unsorted (gathering) linears")
    if by_fmt.get(cfg.mp_formats, {}).get("ksplit_torch", 0) != 0:
        fail("serve quant: a default-weight linear ran off the kernel")
    rows = quant_rows()
    phase_s = time.perf_counter() - t_phase
    print(f"serve quant: phase {phase_s:.1f} s")
    return {"launches": launches["ksplit_gemm"],
            "convert_launches": cal_convert,
            "tokens_per_s": gen_toks / wall_s,
            "bytes_vs_fp32": storage / dense, "rows": rows,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

#: phase 7: tokens per step (global batch x sequence), the steps of the
#: loss gate, and the depth of the checkpoint-and-restart gate (its state
#: on disk is ~6.4 GB per checkpoint at one layer, the vocab's two
#: 92544 x 2048 matrices most of it)
TRAIN_SEQ, TRAIN_BATCH = 128, 4
TRAIN_STEPS = 8
RESTART_LAYERS = 1
#: phase 7's depth: 12 of InternLM2-1.8B's 24 layers at full width (24
#: until phase 15 took the script past 900 s); the allowances below were
#: set at 24 layers, where the summation-order gaps are largest
TRAIN_LAYERS = 12
#: the kernel-against-plain allowance at step 0 (loss, and per gradient
#: leaf ||d||/||g|| and max|d|/max|g|).  Any change of fp32 summation
#: order in the KSplit linears flips bf16 activation roundings, and 24
#: random-init layers amplify the flips: two plain orders (the segments
#: summed one by one, or as one library matmul) differ by 3.5e-5 in loss
#: and 3.5e-2 in gradient norm at 24 layers, as much as kernel and plain
#: do (1.5e-4, 3.4e-2), and both grow alike with depth from 1.4e-5 /
#: 7.5e-3 at one layer (train_order_gaps.py, one H100 80GB HBM3, 700 W).
#: The gate is that fixed allowance, and that the kernel's gaps in the
#: gradients and in the per-token losses (||d||/||l|| over the batch's
#: tokens, which bounds the mean loss's gap) are no more than
#: TRAIN_ORDER_RATIO times the two plain orders' gaps.  The mean loss's
#: own gap is one scalar whose ratio between orders swings 0.1-10x
#: across depths (train_order_gaps.py), so it is not the order-relative
#: term
TRAIN_LOSS_RTOL, TRAIN_GRAD_FROB, TRAIN_GRAD_MAX = 1e-3, 0.1, 0.1
TRAIN_ORDER_RATIO = 2.0
#: train steps under the profiler (device busy per step)
PROFILE_STEPS = 3


def host_copy(tree):
    from repro_torch import tree as TR
    return [t.detach().to("cpu", copy=True) for t in TR.tensors(tree)]


def put_back(tree, saved) -> None:
    import torch
    from repro_torch import tree as TR
    with torch.no_grad():
        for t, s in zip(TR.tensors(tree), saved):
            t.copy_(s)


def ksplit_one_matmul(x, bufs, fmts):
    """The ksplit sum in another valid order: the compute-rounded
    segments as one library matmul over all of K (the plain version adds
    one matmul per segment)."""
    import torch
    from repro_torch.core.layout import fp32_matmul, round_to_compute
    xs, ws, off = [], [], 0
    for b, f in zip(bufs, fmts):
        kc = b.shape[0]
        if kc:
            xs.append(round_to_compute(x[:, off:off + kc], f))
            ws.append(round_to_compute(b, f))
            off += kc
    return fp32_matmul(torch.cat(xs, 1), torch.cat(ws, 0))


def all_logits(params, cfg, batch):
    """Every position's logits [B, S, V] fp32 of the bulk forward over
    ``batch`` (the pipeline's dict; ``forward_prefill`` keeps only the
    last position), without grad."""
    import torch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    with torch.no_grad():
        x, _ = T._run_layers(params, cfg, batch)
        x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return params["lm_head"](x).float()


def losses_of(logits, labels):
    """Per-token loss of ``forward_train``'s cross entropy (its z-loss
    term included; the mean is the step's loss) over the last
    ``labels.shape[1]`` positions (a vision config's text)."""
    import torch
    logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll + 1e-4 * lse ** 2


def token_losses(params, cfg, batch):
    """Per-token loss [B*S] of ``forward_train``'s cross entropy, without
    grad."""
    return losses_of(all_logits(params, cfg, batch),
                     batch["labels"]).flatten()


def rel_gap(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def leaf_gaps(ga, gb) -> tuple[float, float, str]:
    """(worst ‖Δ‖/‖g‖, worst max|Δ|/max|g|, the leaf of the latter) over
    the leaves of two gradient trees."""
    import torch
    from repro_torch import tree as TR
    frob = worst = 0.0
    where = ""
    for la, lb in zip(TR.walk(ga), TR.walk(gb)):
        for a, b in zip(la.parts, lb.parts):
            if not a.numel():
                continue
            if a.dtype != b.dtype:
                fail(f"train: gradient dtypes differ at {la.key}")
            a, b = a.float(), b.float()
            d = (a - b)
            f = float(torch.linalg.vector_norm(d)
                      / torch.linalg.vector_norm(b).clamp_min(1e-30))
            m = float(d.abs().max() / b.abs().max().clamp_min(1e-30))
            frob = max(frob, f)
            if m > worst:
                worst, where = m, la.key
    return frob, worst, where


def profile_step(step_fn, params, opt, batch, wall_ms: float) -> dict:
    """PROFILE_STEPS train steps under ``torch.profiler``: device busy
    time per step, its idle share of ``wall_ms`` (the median unprofiled
    step's wall), and the top kernels.  It records the device activity
    alone and sums the kernels' durations from the profiler's raw events:
    the busy time is the same as with host ops recorded and read through
    ``key_averages()`` (199.63 against 199.52 ms a qwen2 step, 480.90
    against 480.90 an xLSTM one on one H100), and ``key_averages()``
    alone took 66.9 s over xLSTM's 352k kernels of three steps, the raw
    events 3.4 s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():       # a CPU rehearsal
        print("profile train step: no card: busy share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None}
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            params, opt, _ = step_fn(params, opt, batch)
        sync()
    total: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            total[e.name()] = total.get(e.name(), 0) + e.duration_ns()
    rows = sorted(((name, ns / 1e6 / PROFILE_STEPS)
                   for name, ns in total.items() if ns > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows)
    if not busy_ms:
        print("profile train step: the profiler saw no device time: busy "
              "share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None}
    ksplit_ms = sum(ms for name, ms in rows if "ksplit" in name)
    convert_ms = sum(ms for name, ms in rows if "convert" in name)
    print(f"profile train step ({PROFILE_STEPS} steps): device busy "
          f"{busy_ms:.1f} ms per step against the median step wall "
          f"{wall_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}; "
          f"ksplit kernel {ksplit_ms:.2f} ms, convert kernel "
          f"{convert_ms:.2f} ms")
    for name, ms in rows[:10]:
        print(f"profile   {ms:9.3f} ms/step  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "ksplit_ms": ksplit_ms,
            "convert_ms": convert_ms}


def train_phase(cfg, seed: int = 0) -> dict:
    """Train InternLM2-1.8B at full width on one card: the step-0 loss and
    gradients through the ksplit kernel against the same step with its
    plain version swapped in; every forward KSplit linear on the kernel;
    eight steps on one repeated batch (finite, falling loss; per-step
    wall time and launches, profiled steps, peak memory); one step at two
    microbatches against one; and, at reduced depth, a checkpoint,
    an injected RestartSignal and a restore whose replayed steps equal
    the uninterrupted run's losses bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import RestartSignal
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.trainer import TrainerConfig, train
    from repro_torch.tune import dispatch
    t_phase = time.perf_counter()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    n_linear = len(ksplit_weights(params))
    batch = DP.make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0, step=0,
                          device=DEVICE)
    dispatch.warm_registry()
    dispatch.tune_linear_params(params, m_hint=tokens)
    fresh0 = dispatch.fresh_resolutions()

    # gates 1 and 2: step 0 through the kernel, then with the plain
    # version swapped in; every forward KSplit linear on the kernel
    ops.reset_launch_counts()
    lin0 = dispatch.dispatch_counts("linear")
    loss_k, _, g_k = loss_and_grads(params, cfg, batch)
    sync()
    step0 = ops.launch_counts()
    fresh_fwd = dispatch.fresh_resolutions() - fresh0
    lin = {p: v - lin0.get(p, 0)
           for p, v in dispatch.dispatch_counts("linear").items()}
    tok_k = token_losses(params, cfg, batch)
    kernel_fn = K.ksplit_gemm_multi
    try:
        K.ksplit_gemm_multi = K.ksplit_gemm_plain
        loss_p, _, g_p = loss_and_grads(params, cfg, batch)
        tok_p = token_losses(params, cfg, batch)
        K.ksplit_gemm_multi = ksplit_one_matmul
        loss_a, _, g_a = loss_and_grads(params, cfg, batch)
        tok_a = token_losses(params, cfg, batch)
        sync()
    finally:
        K.ksplit_gemm_multi = kernel_fn
    frob, worst, where = leaf_gaps(g_k, g_p)
    frob_a, worst_a, _ = leaf_gaps(g_a, g_p)
    loss_gap = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    loss_gap_a = abs(float(loss_a) - float(loss_p)) / abs(float(loss_p))
    tok_gap, tok_gap_a = rel_gap(tok_k, tok_p), rel_gap(tok_a, tok_p)
    del g_k, g_p, g_a, tok_k, tok_p, tok_a
    print(f"train {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} vocab="
          f"{cfg.vocab}, seq {TRAIN_SEQ} x batch {TRAIN_BATCH} = {tokens} "
          f"tokens/step; weights {param_bytes(params) / 1e9:.3f} GB")
    print(f"train step 0: loss kernel {float(loss_k):.6f} plain "
          f"{float(loss_p):.6f} (rel gap {loss_gap:.2e}, allowance "
          f"{TRAIN_LOSS_RTOL:g}); gradients worst ||d||/||g|| {frob:.2e} "
          f"(allowance {TRAIN_GRAD_FROB:g}), worst max|d|/max|g| "
          f"{worst:.2e} at {where} (allowance {TRAIN_GRAD_MAX:g}); plain "
          f"in another order (one matmul): loss gap {loss_gap_a:.2e}, "
          f"||d||/||g|| {frob_a:.2e}, max|d|/max|g| {worst_a:.2e}")
    print(f"train step 0: per-token losses ||d||/||l|| kernel vs plain "
          f"{tok_gap:.2e}, one matmul vs plain {tok_gap_a:.2e} (ratio "
          f"{tok_gap / max(tok_gap_a, 1e-30):.2f}, allowance "
          f"{TRAIN_ORDER_RATIO:g})")
    print(f"train step 0: forward KSplit linears {lin}, launches "
          f"{step0} for {n_linear} linears, fresh resolutions after setup "
          f"{fresh_fwd}")
    if not (np.isfinite(float(loss_k)) and loss_gap <= TRAIN_LOSS_RTOL
            and tok_gap <= TRAIN_ORDER_RATIO * tok_gap_a):
        fail("train: step-0 loss through the kernel is off its plain "
             "version")
    if frob > TRAIN_GRAD_FROB or worst > TRAIN_GRAD_MAX \
            or frob > TRAIN_ORDER_RATIO * frob_a:
        fail("train: step-0 gradients through the kernel are off their "
             "plain version")
    if lin.get("ksplit_torch", 0) or lin.get("ksplit_cuda", 0) != n_linear \
            or step0["ksplit_gemm"] != n_linear:
        fail("train: a forward KSplit linear ran off the ksplit kernel")
    if fresh_fwd:
        fail(f"train: {fresh_fwd} fresh plan resolutions after setup")

    # gate 4: one step at two microbatches against one (from one state)
    ocfg4 = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    opt = adamw.init(params, ocfg4)
    saved = host_copy({"p": params, "o": opt})
    params, opt, m1 = make_train_step(cfg, ocfg4, 1)(params, opt, batch)
    p1 = host_copy(params)
    put_back({"p": params, "o": opt}, saved)
    params, opt, m2 = make_train_step(
        cfg, ocfg4, 2, tune_params=params, tune_tokens=tokens // 2)(
        params, opt, batch)
    mb_loss = abs(float(m1["loss"]) - float(m2["loss"])) / abs(
        float(m1["loss"]))
    from repro_torch import tree as TR
    mb_worst = max(float((a.float() - b.cpu().float()).abs().max())
                   for a, b in zip(p1, TR.tensors(params)) if a.numel())
    put_back({"p": params, "o": opt}, saved)
    del saved, p1
    print(f"train microbatches 2 vs 1: loss rel gap {mb_loss:.2e} (rtol "
          f"2e-2), worst leaf |d| {mb_worst:.3e} (< 5e-2)")
    if not (mb_loss <= 2e-2 and mb_worst < 5e-2):
        fail("train: two microbatches do not match one")

    # gate 3: eight steps on one repeated batch, as the trainer builds the
    # step (its loop's closing checkpoint of the full-width state is left
    # to the reduced-depth restart gate below)
    ocfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1,
                             total_steps=TRAIN_STEPS)
    opt = adamw.init(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, 1, tune_params=params,
                              tune_tokens=tokens)
    fresh0 = dispatch.fresh_resolutions()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        now = ops.launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    loop = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fresh = dispatch.fresh_resolutions() - fresh0
    steady = float(np.median(step_ms[1:]))
    prof = profile_step(step_fn, params, opt, batch, steady)
    print(f"train: losses {[round(v, 4) for v in losses]}")
    print(f"train: step wall ms {[round(v, 1) for v in step_ms]}; median "
          f"of steps 1-{TRAIN_STEPS - 1} {steady:.1f} ms = "
          f"{tokens / steady * 1e3:.1f} tokens/s; ksplit launches per "
          f"step {[c['ksplit_gemm'] for c in per_step]}, convert "
          f"{[c['convert'] for c in per_step]}; in the {TRAIN_STEPS} steps "
          f"{loop}; peak memory {peak_gb:.2f} GB "
          "(torch.cuda.max_memory_allocated); fresh resolutions after "
          f"setup {fresh}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite and falling")
    if fresh:
        fail(f"train: {fresh} fresh plan resolutions after setup")
    if any(c["ksplit_gemm"] != n_linear for c in per_step):
        fail("train: a step did not launch the ksplit kernel once per "
             "KSplit linear")
    del params, opt, step_fn
    torch.cuda.empty_cache()

    # gate 5: checkpoint and restart at reduced depth
    cfg5 = dataclasses.replace(cfg, n_layers=RESTART_LAYERS)
    ocfg5 = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4)
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def run(name, injector):
            tc = TrainerConfig(steps=4, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               ckpt_dir=os.path.join(base, name),
                               ckpt_every=2, log_every=100, seed=seed,
                               fault_injector=injector, device=DEVICE)
            logs = []
            t0 = time.perf_counter()
            _, _, hist = train(cfg5, ocfg5, tc, log=logs.append)
            sync()
            secs = time.perf_counter() - t0
            shutil.rmtree(os.path.join(base, name))
            return hist, logs, secs

        fired = []

        def injector(step):
            if step == 3 and not fired:
                fired.append(step)
                raise RestartSignal("injected by chip_smoke")

        hist_a, _, secs_a = run("plain", None)
        hist_b, logs_b, secs_b = run("faulted", injector)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    la = [h["loss"] for h in hist_a]
    lb = [h["loss"] for h in hist_b]
    print(f"train restart ({RESTART_LAYERS} layer, full width): "
          f"uninterrupted {la} in {secs_a:.1f} s; faulted {lb} in "
          f"{secs_b:.1f} s; {[ln for ln in logs_b if '[fault]' in ln]}")
    if not fired or not any("restored step 2" in ln for ln in logs_b):
        fail("train restart: the fault did not restore the step-2 "
             "checkpoint")
    if la != lb or [h["step"] for h in hist_b] != [0, 1, 2, 3]:
        fail("train restart: the replayed losses differ from the "
             "uninterrupted run's")
    phase_s = time.perf_counter() - t_phase
    print(f"train: phase {phase_s:.1f} s")
    return {"launches": step0["ksplit_gemm"] + loop["ksplit_gemm"],
            "convert_launches": step0["convert"] + loop["convert"],
            "step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
            "peak_gb": peak_gb, "phase_s": phase_s, **prof}


# ---------------------------------------------------------------------------
# phase 5: the refinement solver
# ---------------------------------------------------------------------------

#: (label, SolveConfig overrides, the kernel its GEMMs must launch)
SOLVES = (("store", {}, "mp_gemm_tile"),
          ("split", {"compute_escalation": "split"}, "split_gemm"),
          ("grouped", {"residual_path": "grouped"}, "grouped_gemm"))


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``; returns its result and the
    device time it caused: kernels, memory copies, their sum and the top
    rows by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    rows = [(e.key, e.self_device_time_total / 1e6)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    copy_s = sum(sec for name, sec in rows if "memcpy" in name.lower()
                 or "memset" in name.lower())
    busy_s = sum(sec for _, sec in rows)
    return out, {"busy_s": busy_s, "copy_s": copy_s,
                 "kernel_s": busy_s - copy_s, "top": rows[:6]}


class SolveSpy:
    """Wraps ``dispatch.mp_matmul`` while a solve runs and keeps the
    operands of its last step-0 trailing update (K = t, M = N = n - t) and
    of its last residual GEMM (M = K = n, N = the padded RHS width), with
    the path of the plan each ran under — the operands of the last
    factorization and sweep, after any escalation.  Also counts the
    solve's ``MPMatrix.from_dense`` calls (its storage casts)."""

    def __init__(self, n: int):
        from repro_torch.core.layout import MPMatrix
        from repro_torch.tune import dispatch as D
        self.D, self.real, self.n, self.seen = D, D.mp_matmul, n, {}
        #: dispatch path -> the kernel paths its C maps call for
        self.paths: dict[str, set] = {}
        self.MP, self.real_from_dense = MPMatrix, MPMatrix.__dict__[
            "from_dense"]
        self.from_dense_calls = 0

    def __enter__(self):
        def spy(a, b, c=None, *, alpha=1.0, beta=0.0, plan=None):
            if plan is None:
                fail("the solve ran a GEMM without a prefetched plan")
            if plan.path in ("tile", "grouped"):
                self.paths.setdefault(plan.path, set()).update(
                    expected_paths(c.cls, a.tile, a.fset))
            if a.shape[1] == self.n:
                self.seen["residual"] = (a, b, c, alpha, beta, plan.path)
            elif a.shape[0] == self.n - a.tile:
                self.seen["trailing"] = (a, b, c, alpha, beta, plan.path)
            return self.real(a, b, c, alpha=alpha, beta=beta, plan=plan)
        def from_dense(klass, *args, **kw):
            self.from_dense_calls += 1
            return self.real_from_dense.__func__(klass, *args, **kw)
        self.D.mp_matmul = spy
        self.MP.from_dense = classmethod(from_dense)
        return self

    def __exit__(self, *exc):
        self.D.mp_matmul = self.real
        self.MP.from_dense = self.real_from_dense


def solve_phase() -> dict:
    """Three solves of graded_spd(SOLVE_N) at tile 128 from 0D:100S at
    SOLVE_TOL.  Each must escalate (promotion, re-quantization and
    refactorization run on the card), converge on the fp64 HPL-MxP metric
    with a forward error at most FORWARD_TOL and no fresh mid-solve
    resolution, and launch its kernel and the convert kernel (the split
    solve no other GEMM kernel).  Then the kernel of each captured
    trailing update and residual GEMM is held to its plain version on
    those operands."""
    from repro_torch.kernels import ops
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    from repro_torch.tune import dispatch as D
    t0 = time.perf_counter()
    a = graded_spd(SOLVE_N, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, nrhs=1, seed=1)
    print(f"solve: graded_spd n={SOLVE_N} cond=1e4 rho=0.9, nrhs 1, tile "
          f"{TILE}, start 0D:100S, LU, tol {SOLVE_TOL} (operator built in "
          f"{time.perf_counter() - t0:.1f} s)")
    out = {}
    for label, kw, kernel in SOLVES:
        cfg = SolveConfig(tile=TILE, ratio_high=0.0, ratio_low8=0.0,
                          tol=SOLVE_TOL, **kw)
        d0 = D.dispatch_counts()
        with SolveSpy(SOLVE_N) as spy:
            ops.reset_launch_counts()
            if label == "store":
                rep, busy = profiled(lambda: solve(a, b, cfg, device=DEVICE))
            else:
                rep = solve(a, b, cfg, device=DEVICE)
            sync()
            launches = ops.launch_counts()
            path_counts = ops.path_launch_counts()
            prep = ops.KERNELS["split_gemm"].prep_launches
            launches["convert_by_class"] = ops.KERNELS[
                "convert"].class_launches
        d1 = D.dispatch_counts()
        paths = {p: v - d0.get(p, 0) for p, v in d1.items()
                 if v != d0.get(p, 0)}
        err = forward_error(rep.x, xt)
        share = rep.trail_copy_seconds / max(rep.factor_seconds, 1e-12)
        print(f"solve {label}: converged={rep.converged} sweeps "
              f"{rep.sweeps} escalations {rep.escalations} factorizations "
              f"{rep.factorizations} mode {rep.compute_mode}; metric "
              f"history {[float(f'{v:.3g}') for v in rep.metric_history]} "
              f"(tol {cfg.tol}), forward err {err:.3g} (limit "
              f"{FORWARD_TOL}); map {' -> '.join(rep.ratio_history)} "
              f"({rep.storage_bytes} B vs {rep.uniform_high_bytes} B "
              "uniform HIGH)")
        print(f"solve {label}: total {rep.total_seconds:.2f} s, GEMM "
              f"{rep.gemm_seconds:.2f} s, factorizations "
              f"{rep.factor_seconds:.2f} s of which trailing-update host "
              f"copies {rep.trail_copy_seconds:.2f} s ({share:.1%}); "
              f"sweeps {[round(v, 3) for v in rep.sweep_seconds]} s; fresh "
              f"resolutions {rep.fresh_resolutions}; dispatch {paths}; "
              f"kernel launches {launches}; launches per path "
              f"{path_counts}")
        print(f"solve {label}: GEMM s without the trailing-update host "
              f"copies {rep.gemm_seconds - rep.trail_copy_seconds:.2f} s; "
              f"MPMatrix.from_dense calls {spy.from_dense_calls}; convert "
              f"launches: class-map form {launches['convert_by_class']}, "
              f"plain form {launches['convert']}")
        if label == "store":
            idle = 1 - busy["busy_s"] / rep.total_seconds
            print(f"solve store, profiled: device busy {busy['busy_s']:.3f} s "
                  f"of {rep.total_seconds:.2f} s wall (kernels "
                  f"{busy['kernel_s']:.3f} s, copies {busy['copy_s']:.3f} "
                  f"s), idle share {idle:.1%}")
            for name, sec in busy["top"]:
                print(f"solve store, profiled: {sec * 1e3:9.2f} ms  "
                      f"{name[:90]}")
        if not (rep.converged and rep.metric <= cfg.tol):
            fail(f"solve {label} did not converge: {rep.metric_history}")
        if rep.escalations < 1:
            fail(f"solve {label} converged without escalating")
        if not err <= FORWARD_TOL:
            fail(f"solve {label}: forward error {err:.3g} > {FORWARD_TOL}")
        if rep.fresh_resolutions:
            fail(f"solve {label}: {rep.fresh_resolutions} fresh mid-solve "
                 "plan resolutions")
        for k in (kernel, "convert_by_class"):
            if launches[k] < 1:
                fail(f"solve {label} never launched the {k} kernel")
        if launches["convert_by_class"] != spy.from_dense_calls:
            # the solves' sets have no integer class
            fail(f"solve {label}: {spy.from_dense_calls} MPMatrix.from_dense "
                 f"calls launched {launches['convert_by_class']} class-map "
                 "converts: each must be one")
        for path, name in (("tile", "mp_gemm_tile"),
                           ("grouped", "grouped_gemm")):
            took = {p for p, v in path_counts[name].items() if v}
            if took != spy.paths.get(path, set()):
                fail(f"solve {label}: {name} took the paths {took}, its C "
                     f"maps call for {spy.paths.get(path, set())}")
        if label == "split" and (set(paths) != {"split"} or any(
                v for k, v in launches.items()
                if k not in (kernel, "convert", "convert_by_class"))):
            fail(f"the split solve ran GEMMs off the split kernel: {paths}, "
                 f"{launches}")
        if label == "split":
            print(f"solve split: {prep} slice passes for "
                  f"{launches[kernel]} split launches (every C map is "
                  "uniform split2)")
            if prep != launches[kernel]:
                fail("the split solve's launches did not each run one "
                     "slice pass")
        for kind in ("trailing", "residual"):
            A, B, C, alpha, beta, path = spy.seen[kind]
            e, ratio = kernel_vs_plain(path, A, B, C, alpha, beta)
            print(f"solve {label} {kind} GEMM {A.shape[0]}x{A.shape[1]} . "
                  f"{B.shape[0]}x{B.shape[1]} [{path}]: max|kernel-plain| "
                  f"{e:.3e}, worst/allowance {ratio:.3e}")
            if not ratio <= 1.0:
                fail(f"solve {label}: the {path} kernel's {kind} GEMM is "
                     "outside tolerance")
        out[label] = {"launches": launches[kernel],
                      "paths": path_counts.get(kernel),
                      "convert_launches": launches["convert"],
                      "class_launches": launches["convert_by_class"],
                      "from_dense_calls": spy.from_dense_calls,
                      "gemm_s_no_copies": (rep.gemm_seconds
                                           - rep.trail_copy_seconds),
                      "prep_launches": prep,
                      "seconds": rep.total_seconds}
        del spy
    return out


def forward_error(x, xt) -> float:
    return float(np.abs(x - xt).max() / np.abs(xt).max())


def parity_phase() -> None:
    """The three solves at PARITY_N on the card and again on the CPU with
    the kernels' plain versions under the same device spec: every
    decision (converged, sweeps, escalations, factorizations, final map)
    must be equal and the solutions must agree to PARITY_X_TOL."""
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    from repro_torch.tune.device import DEVICE_ENV
    a = graded_spd(PARITY_N, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, nrhs=1, seed=1)
    for label, kw, _ in SOLVES:
        cfg = SolveConfig(tile=TILE, tol=SOLVE_TOL, **kw)
        card = solve(a, b, cfg, device=DEVICE)
        prev = os.environ.get(DEVICE_ENV)
        os.environ[DEVICE_ENV] = "gpu-h100"    # the card's plans, on CPU
        try:
            host = solve(a, b, cfg, device="cpu")
        finally:
            if prev is None:
                del os.environ[DEVICE_ENV]
            else:
                os.environ[DEVICE_ENV] = prev
        keys = ("converged", "sweeps", "escalations", "factorizations",
                "compute_mode")
        same = all(getattr(card, k) == getattr(host, k) for k in keys) and (
            np.array_equal(card.final_map, host.final_map))
        dx = forward_error(card.x, host.x)
        print(f"parity {label} n={PARITY_N}: card sweeps {card.sweeps} "
              f"escalations {card.escalations} map {card.final_ratio} "
              f"forward err {forward_error(card.x, xt):.3g}; decisions "
              f"equal to the CPU solve: {same}; max|x_card - x_cpu| / "
              f"max|x_cpu| {dx:.3g} (limit {PARITY_X_TOL})")
        if not same:
            fail(f"parity {label}: decisions differ, card "
                 f"{[getattr(card, k) for k in keys]} vs CPU "
                 f"{[getattr(host, k) for k in keys]}")
        if not dx <= PARITY_X_TOL:
            fail(f"parity {label}: solutions differ by {dx:.3g}")


# ---------------------------------------------------------------------------
# phase 6: timings beside bounds
# ---------------------------------------------------------------------------

def time_ksplit(gen, policy) -> list[dict]:
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEVICE)
    flush = lambda: flush_buf.zero_()   # noqa: E731  (evict the 50 MB L2)
    rows = []
    shapes = ([(4, k, n) for k, n in SERVED_KN] + [(1, 2048, 8192)]
              + [(TRAIN_SEQ * TRAIN_BATCH, k, n) for k, n in SERVED_KN]
              + list(KSPLIT_TIMED))
    for m, k, n in shapes:
        x, ws = ksplit_case(m, k, n, gen, policy)
        fs = ws.fset
        bufs = [ws.bufs[c] for c in fs.class_order]
        fmts = [fs.fmt(c) for c in fs.class_order]
        ms = time_ms(lambda: ops.ksplit_matmul_kernel(x, ws), flush=flush)
        span_ms = time_ms(lambda: ops.ksplit_matmul_kernel(x, ws),
                          flush=flush, hold=False)
        geom = K.choose_geometry(m, n, k)
        single = K.Geometry(K.rows_per_block(m), 1)
        one_ms = time_ms(lambda: K.ksplit_gemm_at(x, bufs, fmts, single),
                         flush=flush)
        dev_ms = device_ms(lambda: ops.ksplit_matmul_kernel(x, ws), "ksplit",
                           flush=flush)
        plain_ms = time_ms(lambda: K.ksplit_gemm_plain(x, bufs, fmts),
                           iters=5, flush=flush, hold=False)
        wb = torch.randn((k, n), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(x, wb), flush=flush)
        nbytes = (x.numel() * x.element_size()
                  + sum(b.numel() * b.element_size() for b in bufs)
                  + m * n * 4)
        ops_s = sum(2.0 * m * n * b.shape[0] / peak_for(f.compute_dtype)
                    for b, f in zip(bufs, fmts))
        bound_ms = max(nbytes / PEAK_BYTES_S, ops_s) * 1e3
        by = "bytes" if nbytes / PEAK_BYTES_S >= ops_s else "operations"
        print(f"time ksplit m={m} K={k} N={n}: kernel {ms:.4f} ms at "
              f"{geom} (unheld {span_ms:.4f} ms; device {dev_ms:.4f} ms; "
              f"{one_ms:.4f} ms at zsplit 1), bound {bound_ms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), "
              f"plain {plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms")
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": lib_ms, "device_ms": dev_ms,
                     "span_ms": span_ms})
        del x, ws, bufs, wb
    return rows


def _ops_bound_s(pc, t, k, fs) -> float:
    """Σ over C classes of 2·(class tiles)·t²·K·slices² over the peak of
    the dtype the class's passes run on (fp32 67, bf16/fp16 989 TFLOP/s)."""
    total = 0.0
    for c in np.unique(pc):
        f = fs.fmt(int(c))
        s = getattr(f, "slices", 1)
        total += (2.0 * int((pc == c).sum()) * t * t * k * s * s
                  / peak_for(f.compute_dtype))
    return total


def _bound(nbytes, ops_s) -> tuple[float, str]:
    by = "bytes" if nbytes / PEAK_BYTES_S >= ops_s else "operations"
    return max(nbytes / PEAK_BYTES_S, ops_s) * 1e3, by


#: the split timings (label, M, K, N, format-set key, ratio_high, the
#: operands whose map is uniform HIGH): 4096³ under split2 and split3
#: 50D50S, and the split solve's two GEMM shapes at n = 8192 (A under the
#: start map 0D100S, C and the residual's X uniform split2)
SPLIT_TIMES = (
    ("split2 50D50S", 4096, 4096, 4096, "fp8_e4m3+bf16+split2_fp16", 0.5, ()),
    ("split3 50D50S", 4096, 4096, 4096, "fp8_e4m3+bf16+split3_e5m2", 0.5, ()),
    ("trailing split2 C", 8064, 128, 8064, "fp8_e4m3+bf16+split2_fp16", 0.0,
     (2,)),
    ("residual split2 C", 8192, 8192, 128, "fp8_e4m3+bf16+split2_fp16", 0.0,
     (1, 2)))


def time_split(gen) -> dict:
    """The split kernel at each SPLIT_TIMES case, t = 128: kernel (its
    slice pass included), plain version and fp32 torch.matmul (TF32 off)
    times beside the bound.  Returns label -> row; the first is the
    kernels line's."""
    import torch
    from repro_torch.core.precision import map_storage_bytes
    from repro_torch.kernels import split_gemm as SG
    from repro_torch.split import split_format_specs
    t = TILE
    rows = {}
    for label, m, k, n, fkey, hi, high in SPLIT_TIMES:
        fs, (A, B, C), maps = gemm_case(m, k, n, t, fkey, hi, 0.0, gen,
                                        seed0=51, high=high)
        specs = split_format_specs(fs)
        run = lambda: SG.split_gemm_tile_multi(  # noqa: E731
            A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs)
        ms = time_ms(run, iters=10)
        span_ms = time_ms(run, iters=10, hold=False)
        prep_ms = device_ms(run, "split_slices", iters=5)
        gemm_ms = device_ms(run, "split_gemm_staged", iters=5)
        plain_ms = time_ms(lambda: SG.split_gemm_plain(
            A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs), iters=3,
            hold=False)
        a32, b32 = A.to_dense(), B.to_dense()
        lib_ms = time_ms(lambda: torch.matmul(a32, b32), iters=10)
        nbytes = (sum(map_storage_bytes(p, t, fs) for p in maps)
                  + sum(m * n * torch.empty((), dtype=sp[2]).element_size()
                        for sp in specs))
        bound_ms, by = _bound(nbytes, _ops_bound_s(maps[2], t, k, fs))
        print(f"time split {label} {m}x{k}x{n} t={t}: kernel {ms:.4f} ms "
              f"(unheld {span_ms:.4f} ms; device: slice pass {prep_ms:.4f} ms, GEMM {gemm_ms:.4f} "
              f"ms), bound {bound_ms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), "
              f"plain {plain_ms:.4f} ms, torch.matmul fp32 (TF32 off) "
              f"{lib_ms:.4f} ms")
        rows[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": by, "library_ms": lib_ms}
        if label == SPLIT_TIMES[0][0]:
            rows["slice pass"] = time_slice_pass(A, B, C, maps, fs, specs)
        del A, B, C, a32, b32
    return rows


def time_slice_pass(A, B, C, maps, fs, specs) -> dict:
    """The split kernel's slice pass alone (``slice_operands``, the first
    split class) beside its bound and its plain version on both operands;
    no PyTorch call computes it."""
    import torch
    from repro_torch.core.precision import map_storage_bytes
    from repro_torch.kernels import split_gemm as SG
    t = A.tile
    code = next(c for c, sp in enumerate(specs) if sp[3] > 1)
    spec = specs[code]
    st = SG.slice_store_dtype(spec)
    run = lambda: SG.slice_operands(  # noqa: E731
        A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs, code=code)
    ms = time_ms(run, iters=10)
    span_ms = time_ms(run, iters=10, hold=False)
    plain_ms = time_ms(lambda: [SG.slice_operand_plain(
        M.bufs, M.cls, t, spec[3], spec[4], st) for M in (A, B)], iters=3,
        hold=False)
    elems = A.shape[0] * A.shape[1] + B.shape[0] * B.shape[1]
    nbytes = (map_storage_bytes(maps[0], t, fs)
              + map_storage_bytes(maps[1], t, fs)
              + spec[3] * elems * torch.empty((), dtype=st).element_size())
    # per element and slice: one subtraction and one rounding, fp32 pipes
    bound_ms, by = _bound(nbytes, 2.0 * spec[3] * elems / PEAK_FP32_FLOPS)
    print(f"time split slice pass {A.shape[0]}x{A.shape[1]} and "
          f"{B.shape[0]}x{B.shape[1]} t={t} {fs.fmt(code).name}: kernel "
          f"{ms:.4f} ms (unheld {span_ms:.4f} ms), bound {bound_ms:.4f} ms "
          f"({by}, {nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, no "
          "library call")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


#: phase 6's maps of the 4096³ tile and grouped timings (label,
#: ratio_high on fp8_e4m3+bf16+fp32); one torch.matmul computes the same
#: function at 0D100S (bf16) and 100D0S (fp32, TF32 off), at 50D50S
#: neither does
TIME_MAPS = (("0D100S", 0.0), ("50D50S", 0.5), ("100D0S", 1.0))
#: the solve's GEMM shapes at n = 8192, t = 128 (label, M, K, N, the
#: operands whose map is uniform HIGH): the step-0 trailing update (L and
#: U panels under the operator's map, C uniform HIGH) and the residual (A
#: under the operator's map, X and C uniform HIGH), as ``solve/refine.py``
#: builds them; timed under the solve's start and end maps
SOLVE_SHAPES = (("trailing", 8064, 128, 8064, (2,)),
                ("residual", 8192, 8192, 128, (1, 2)))
SOLVE_MAPS = (("0D100S", 0.0), ("5D95S", 0.05))


def expected_paths(pc, t, fs) -> set:
    """The paths the C tiles of map ``pc`` must take at tile edge t."""
    import torch
    if t < 64:
        return {"simple"}
    return {"tensor_core" if fs.fmt(int(c)).compute_dtype in (
        torch.bfloat16, torch.float16) else "fp32" for c in np.unique(pc)}


def time_tile_grouped(gen) -> dict:
    """The tile and grouped kernels at 4096³ under TIME_MAPS and at the
    SOLVE_SHAPES under SOLVE_MAPS, t = 128: kernel, plain version and
    torch.matmul (bf16 and fp32) times, the bound, and the paths the
    launches took (each must match the C map's classes)."""
    import torch
    from repro_torch.core.layout import CompactMPMatrix
    from repro_torch.core.precision import map_storage_bytes
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import mp_gemm_tile as MT
    from repro_torch.kernels import ops
    t, size = TILE, SPLIT_SIZE
    cases = ([("4096^3", size, size, size, (), lab, hi)
              for lab, hi in TIME_MAPS]
             + [(shape, m, k, n, high, lab, hi)
                for shape, m, k, n, high in SOLVE_SHAPES
                for lab, hi in SOLVE_MAPS])
    rows = {}
    for shape, m, k, n, high, label, hi in cases:
        fs, (A, B, C), maps = gemm_case(m, k, n, t, "fp8_e4m3+bf16+fp32", hi,
                                        0.0, gen, seed0=21, high=high)
        specs = MT.format_specs(fs)
        ac = CompactMPMatrix.from_dense(A.to_dense(), A.cls, t, fs)
        bc = CompactMPMatrix.from_dense(B.to_dense(), B.cls, t, fs)
        runs = {
            "tile": (lambda: MT.mp_gemm_tile_multi(
                A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs),
                lambda: MT.mp_gemm_tile_plain(
                    A.bufs, B.bufs, C.bufs, *maps, tile=t, specs=specs)),
            "grouped": (lambda: GG.grouped_mp_gemm(ac, bc, C.cls),
                        lambda: GG.grouped_gemm_plain(ac, bc, C.cls))}
        ops.reset_launch_counts()
        for run, _ in runs.values():
            run()
        sync()
        taken = ops.path_launch_counts()
        want = expected_paths(maps[2], t, fs)
        for name in ("mp_gemm_tile", "grouped_gemm"):
            got = {p for p, v in taken[name].items() if v}
            if got != want:
                fail(f"{name} at {shape} {label} took the paths {got}, not "
                     f"{want}")
        a16, b16 = A.to_dense().to(torch.bfloat16), B.to_dense().to(
            torch.bfloat16)
        a32, b32 = A.to_dense(), B.to_dense()
        lib16 = time_ms(lambda: torch.matmul(a16, b16), iters=10)
        lib32 = time_ms(lambda: torch.matmul(a32, b32), iters=10)
        # one torch.matmul computes the same function where every C tile
        # has one compute dtype: bf16 (0D100S) or fp32 (100D0S, and the
        # solve shapes, whose C is uniform HIGH)
        same_dt = ("fp32" if want == {"fp32"} else
                   "bf16" if label == "0D100S" and not high else None)
        same = {"fp32": lib32, "bf16": lib16}.get(same_dt)
        ops_s = _ops_bound_s(maps[2], t, k, fs)
        out_es = sum(torch.empty((), dtype=sp[1]).element_size()
                     for sp in specs)
        nbytes = {
            "tile": (sum(map_storage_bytes(p, t, fs) for p in maps)
                     + m * n * out_es),
            "grouped": (ac.storage_bytes() + bc.storage_bytes()
                        + map_storage_bytes(maps[2], t, fs))}
        for kern, (run, plain) in runs.items():
            ms = time_ms(run, iters=10)
            span_ms = time_ms(run, iters=10, hold=False)
            plain_ms = time_ms(plain, iters=3, hold=False)
            bound_ms, by = _bound(nbytes[kern], ops_s)
            print(f"time {kern} {shape} {m}x{k}x{n} t={t} {label}: kernel "
                  f"{ms:.4f} ms ({2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s; "
                  f"unheld {span_ms:.4f} ms), "
                  f"bound {bound_ms:.4f} ms ({by}, {nbytes[kern] / 1e6:.1f} "
                  f"MB), plain {plain_ms:.4f} ms, torch.matmul bf16 "
                  f"{lib16:.4f} ms, fp32 (TF32 off) {lib32:.4f} ms"
                  + (f" (same function: {same_dt})" if same_dt else
                     " (yardsticks, not the same function)")
                  + f"; paths {sorted(want)}")
            rows[(kern, shape, label)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": same}
        del A, B, C, ac, bc, a16, b16, a32, b32
    return rows


def time_convert(gen) -> dict:
    """Every output dtype, then the class-map form at CLASS_TIMES beside
    its bound and the per-class path (integer sets' path); the bf16 row, with the
    class-map rows in it, is the one the kernels line carries."""
    import torch
    from repro_torch.core.layout import per_class_cast
    from repro_torch.kernels import convert as CV
    x = torch.randn((CONVERT_SIZE, CONVERT_SIZE), generator=gen,
                    device=DEVICE)
    rows = {}
    for dt in CV.OUT_DTYPES:
        ms = time_ms(lambda: CV.convert(x, dt))
        span_ms = time_ms(lambda: CV.convert(x, dt), hold=False)
        plain_ms = time_ms(lambda: CV.convert_plain(x, dt), hold=False)
        lib_ms = time_ms(lambda: x.to(dt))
        nbytes = x.numel() * (4 + torch.empty((), dtype=dt).element_size())
        bound_ms, by = _bound(nbytes, 0.0)
        print(f"time convert {CONVERT_SIZE}^2 fp32 -> {dt}: kernel "
              f"{ms:.4f} ms (unheld {span_ms:.4f} ms), bound {bound_ms:.4f} "
              f"ms ({by}), plain "
              f"{plain_ms:.4f} ms, x.to(dtype) {lib_ms:.4f} ms")
        rows[dt] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib_ms}
    row = rows[torch.bfloat16]
    for label, m, n, fkey, hi, q in CLASS_TIMES:
        fs, cls = class_case(m, n, fkey, hi, q)
        xs = x[:m, :n].contiguous()
        run = lambda: CV.convert_by_class(xs, cls, TILE, fs)  # noqa: E731
        chain = lambda: per_class_cast(xs, cls, TILE, fs)  # noqa: E731
        ms = time_ms(run)
        span_ms = time_ms(run, hold=False)
        plain_ms = time_ms(
            lambda: CV.convert_by_class_plain(xs, cls, TILE, fs),
            hold=False)
        host_ms, chain_ms = host_clock_ms(run), host_clock_ms(chain)
        nbytes = xs.numel() * 4 + sum(b.numel() * b.element_size()
                                      for b in run())
        bound_ms, by = _bound(nbytes, 0.0)
        print(f"time convert_by_class {label} [{fkey}] t={TILE}: kernel "
              f"{ms:.4f} ms (unheld {span_ms:.4f} ms), bound {bound_ms:.4f} "
              f"ms ({by}), plain {plain_ms:.4f} ms; host clock with a "
              f"device sync: kernel {host_ms:.4f} ms, the per-class path "
              f"(map expanded on the card, masked copies, one convert per "
              f"float class) {chain_ms:.4f} ms")
        row[f"class_map {label}"] = {
            "ms": ms, "unheld_ms": span_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "host_clock_ms": host_ms, "per_class_path_host_clock_ms":
            chain_ms}
        del xs
    return row


def time_decode_attention() -> dict:
    """The decode-attention kernel at .chat's step with every row at each
    of DECODE_ATTN_POSITIONS: held kernel ms beside the bytes of the
    visible keys' K and V at 3.35 TB/s, its plain version (unheld) and
    ``scaled_dot_product_attention`` on the same bf16 operands (GQA, the
    mask as a boolean mask; a yardstick only).  The row at position 511
    (the whole cache) is the one the kernels line carries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    _, B, S, nkv, group, dh = DECODE_ATTN_SHAPES[0]
    q, k, v, _ = decode_attn_case(B, S, nkv, group, dh, 5)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = {}
    for p in DECODE_ATTN_POSITIONS:
        valid = (torch.arange(S, device=DEVICE) <= p)[None, :] \
            .expand(B, S).contiguous()
        ms = time_ms(lambda: DA.decode_attention(q, k, v, valid))
        plain_ms = time_ms(lambda: DA.decode_attention_plain(q, k, v, valid),
                           hold=False)
        mask = valid[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True))
        nbytes = (B * nkv * (p + 1) * dh * 2 * 2 + q.numel() * 2
                  + B * nkv * group * dh * 2)
        bound_ms, by = _bound(nbytes, 0.0)
        print(f"time decode_attention B {B}, S_max {S}, {nkv} x {group} "
              f"heads of {dh}, every row at position {p}: kernel {ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} "
              f"ms, scaled_dot_product_attention {lib_ms:.4f} ms")
        rows[p] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": by, "library_ms": lib_ms}
    return rows


#: the class-map form's timings (CLASS_CASES rows): the solve's
#: trailing-update C and L panel, and an 8192² operand under the solve's
#: end map
CLASS_TIMES = (CLASS_CASES[4], CLASS_CASES[5], CLASS_CASES[0])


def host_clock_ms(fn, iters: int = 10) -> float:
    """Median host-clock time of ``fn`` followed by a device sync (what a
    caller that waits for the result sees)."""
    fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 9: serving the MoE and local/global families
# ---------------------------------------------------------------------------

#: the depths phases 9 and 10 serve at (every width as published): the
#: whole script must finish well inside its time limit on a slow host
#: (at full depths it took 1161 s on one H100 machine), and no gate
#: depends on depth. Qwen1.5-MoE-A2.7B: 4 of 24 layers (8 until phase 15
#: took the script past 900 s); Gemma-3-4B: 6 of 34 (one period of 5 local
#: layers and 1 global; 12 until the script passed 900 s on a slow host);
#: xLSTM-1.3B: 8 of 48 (one period of 1 sLSTM and 7 mLSTM layers; 16, two
#: periods, until phase 15)
MOE_LAYERS, GEMMA_LAYERS, XLSTM_LAYERS = 4, 6, 8
#: phase 9's qwen2 stream: four 32-token and four 64-token prompts, 12 new
#: tokens each, requests 1 and 5 sampled (temperature 0.8); the cache
#: holds the 64-token bucket's 64 + 12 - 1 slots
FAMILY_LENS = (32, 32, 32, 32, 64, 64, 64, 64)
FAMILY_NEW = 12
FAMILY_SAMPLED = (1, 5)
FAMILY_MAX_SEQ = 80
#: gate (b)'s capacity factor: C = ceil(4·4/60·16) = 5 >= the 4 rows of a
#: decode step, so no (token, expert) pair can drop
NO_DROP_CF = 16.0
#: gate (c): the prompt decoded through the cache against the bulk forward
ORDER_PROMPT = 64
#: decode steps timed one by one (host clock, synchronized), then profiled
DECODE_STEPS, PROFILE_DECODE_STEPS = 10, 3
#: gemma3 at full depth: two 64-token and two 32-token requests
GEMMA_LENS = (64, 64, 32, 32)
GEMMA_NEW = 8
#: gemma3 at one period of its pattern (5 local layers, 1 global): one row
#: decoded through twice the 1024 window, so the local ring buffers wrap
#: (the bulk's windowed attention needs a multiple of the window)
WINDOW_POSITIONS = 2048


def bytes_by_kind(params) -> dict:
    """Parameter bytes by kind (experts, shared expert, attention, the
    recurrent mixers: xLSTM cells and Mamba; embedding, the frontend's
    projection and position table, lm_head; dense MLPs, norms and routers
    as other); a kind the model lacks is left out."""
    from repro_torch import tree as TR
    out = dict.fromkeys(("experts", "shared", "attention", "recurrent",
                         "embedding", "frontend", "lm_head", "other"), 0)
    for leaf in TR.walk(params):
        key = leaf.key
        if "/mlstm/" in key or "/slstm/" in key or "/mamba/" in key:
            kind = "recurrent"
        elif "/moe/shared/" in key:
            kind = "shared"
        elif "/moe/" in key and not key.endswith("/router"):
            kind = "experts"
        elif "/attn/" in key:
            kind = "attention"
        elif key == "embed":
            kind = "embedding"
        elif key.startswith("frontend_proj") or key == "pos_embed":
            kind = "frontend"
        elif key.startswith("lm_head"):
            kind = "lm_head"
        else:
            kind = "other"
        out[kind] += sum(t.numel() * t.element_size() for t in leaf.parts)
    return {k: v for k, v in out.items() if v or k == "other"}


def decode_step_bytes(cfg, kinds: dict, batch: int, position: int) -> dict:
    """Bytes one decode step must move, by part (every model's byte bound
    is their sum, computed here): every weight but the embedding table
    read once (every expert runs, its capacity slots full or not), the
    batch's embedding rows, each attention layer's visible KV read and
    one slot written, each recurrent layer's fp32 state (Mamba, mLSTM,
    sLSTM) read and written once, and the fp32 logits written."""
    from repro_torch.models import transformer as T
    dims = T.dims_of(cfg)
    kv = state = 0
    for (mixer, _), cache in zip(cfg.layer_kinds(),
                                 T.init_cache(cfg, 1, 1, "meta")):
        if mixer.startswith("attn"):
            seen = position + 1
            if mixer == "attn_local":
                seen = min(seen, cfg.local_window)
            kv += batch * (seen + 1) * dims.n_kv * dims.head_dim * 2 * 2
        else:
            state += 2 * batch * sum(t.numel() * t.element_size()
                                     for t in cache.values())
    return {"weights": sum(v for k, v in kinds.items() if k != "embedding"),
            "embedding_rows": batch * cfg.d_model * 2, "kv": kv,
            "state": state, "logits": batch * cfg.vocab * 4}


def family_stream(vocab: int, lens, new: int, seed: int,
                  sampled=()) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, L).astype(np.int64),
                    max_new_tokens=new,
                    temperature=0.8 if i in sampled else 0.0, seed=i)
            for i, L in enumerate(lens)]


#: the reference's decode-against-bulk tolerance
#: (``tests/test_models_smoke.py::test_decode_consistent_with_prefill``)
DECODE_RTOL, DECODE_ATOL = 0.1, 0.15


def _logit_gaps(a, b) -> dict:
    """max |a - b|, ||a - b|| / ||b|| and the worst ratio to the
    reference's decode tolerance (atol + rtol·|b|)."""
    import torch
    d = (a - b).abs()
    return {"max": float(d.max()),
            "rel": float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b)),
            "ref_ratio": float((d / (DECODE_ATOL
                                     + DECODE_RTOL * b.abs())).max())}


def _record_routing(log: list):
    """Wrap ``moe.route`` to log each call's expert picks [T, k], the gap
    between the k-th and (k+1)-th probability [T], the largest
    probability [T] and the :class:`Routing` itself; returns the function
    to restore."""
    import torch
    from repro_torch.models import moe as MOE
    orig = MOE.route

    def route(probs, top_k, capacity_factor, picks=None):
        r = orig(probs, top_k, capacity_factor, picks)
        top = torch.topk(probs.detach().float(), top_k + 1, dim=-1).values
        log.append((r.flat_e.reshape(-1, top_k), top[:, -2] - top[:, -1],
                    top[:, 0], r))
        return r

    MOE.route = route
    return lambda: setattr(MOE, "route", orig)


def _replay_routing(recorded: list, stepped: bool, flips: list):
    """Wrap ``moe.route`` to take the expert picks ``recorded`` (one
    ``(picks [n, k], margin [n], top p [n])`` per layer, from a bulk
    forward) in place of the call's own: call ``i`` of a one-row stepped
    decode is layer ``i % L`` at position ``i // L`` and takes that
    token's picks; a bulk call takes its layer's whole table.  The gates
    still come from the call's own probabilities.  Where the call's own
    top-k set differs from the replayed one, the bulk's top-k margin of
    that decision goes into ``flips``; returns the function to
    restore."""
    import torch
    from repro_torch.models import moe as MOE
    orig = MOE.route
    L = len(recorded)
    calls = [0]

    def route(probs, top_k, capacity_factor, picks=None):
        i = calls[0]
        calls[0] += 1
        want, margin = recorded[i % L][0], recorded[i % L][1]
        if stepped:
            want = want[i // L:i // L + 1]
            margin = margin[i // L:i // L + 1]
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        own = top.indices[:, :top_k]
        differ = (torch.sort(own, -1).values
                  != torch.sort(want, -1).values).any(-1)
        if bool(differ.any()):
            flips.extend(float(g) for g in margin[differ].cpu())
        return orig(probs, top_k, capacity_factor, want)

    MOE.route = route
    return lambda: setattr(MOE, "route", orig)


def decode_vs_bulk(cfg, params, n: int, seed: int, label: str) -> dict:
    """One row decoded through ``n`` positions of the cache with the kernels,
    against ``forward_prefill``'s bulk last-position logits with the ksplit
    kernel's plain version swapped in (``plain``). Two gates, each at
    least one bf16 rounding of the largest logit: the kernel decode within
    twice the plain stepped decode's gap (what the kernels add), and the
    plain stepped decode within twice the gap of a pure summation-order
    change, the bulk forward with the ksplit segments summed as one
    matmul (``ksplit_one_matmul``): what the cached decode path adds,
    which the first gate cannot see because both decodes share it.

    Under MoE the plain bulk forward's expert picks of every (layer,
    token) are recorded and replayed into every other run (gates from
    each run's own router): at random weights the router's top-k margins
    are ~3e-3 in probability, so any change of summation order flips some
    picks, and each flip moves the logits by a whole expert's output.
    With the picks fixed the gap measures what the cached decode
    computes, not which expert a near-tie went to.  The picks each run
    would have made itself are compared with the replayed ones, and a
    third gate, checked first, holds the kernel decode's own picks: none
    may differ from the bulk's at a decision whose bulk top-k margin
    exceeds the own-pick bound, twice the largest such margin at which
    the two plain orders' own picks differ, floored at one bf16 rounding
    of the largest router probability (2^-8·max p).  A routing fault that
    only the stepped decode makes flips picks at ordinary margins."""
    import torch
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, n))).to(DEVICE)
    moe = bool(cfg.n_experts)
    recorded: list = []

    def stepped():
        caches = T.init_cache(cfg, 1, n, DEVICE)
        for s in range(n):
            logits, _ = T.forward_decode(params, cfg, toks[:, s:s + 1],
                                         caches, s)
        return logits[0, 0].float()

    def bulk():
        return T.forward_prefill(params, cfg, toks)[0, 0].float()

    def routed(fn, wrap):
        restore = wrap() if moe else (lambda: None)
        try:
            out = fn()
            sync()
        finally:
            restore()
        return out

    def replay(stepped_run: bool, flips: list):
        return lambda: _replay_routing(recorded, stepped_run, flips)

    kernel_fn = K.ksplit_gemm_multi
    others = {}
    flips = {k: [] for k in ("plain_decode", "bulk_order2",
                             "kernel_decode")}
    try:
        K.ksplit_gemm_multi = K.ksplit_gemm_plain
        bulk_p = routed(bulk, lambda: _record_routing(recorded))
        others["plain_decode"] = routed(
            stepped, replay(True, flips["plain_decode"]))
        K.ksplit_gemm_multi = ksplit_one_matmul
        others["bulk_order2"] = routed(
            bulk, replay(False, flips["bulk_order2"]))
    finally:
        K.ksplit_gemm_multi = kernel_fn
    t0 = time.perf_counter()
    dec_k = routed(stepped, replay(True, flips["kernel_decode"]))
    stepped_s = time.perf_counter() - t0
    gaps = {"kernel_decode": _logit_gaps(dec_k, bulk_p)}
    gaps.update({k: _logit_gaps(v, bulk_p) for k, v in others.items()})
    top = float(bulk_p.abs().max())
    floor = 2.0 ** -8 * top
    allow = max(2.0 * gaps["plain_decode"]["max"], floor)
    allow_path = max(2.0 * gaps["bulk_order2"]["max"], floor)
    out = {"gaps": gaps, "allowance": allow, "path_allowance": allow_path}
    print(f"{label}: last logits through {n} positions (kernel decode "
          f"{stepped_s:.1f} s) against the plain bulk forward (max |logit| "
          f"{top:.3f}"
          + ("; every run replays the bulk's expert picks" if moe else "")
          + "): " + "; ".join(
              f"{k} max {v['max']:.4e} rel {v['rel']:.3e} (reference "
              f"test's tolerance ratio {v['ref_ratio']:.3f})"
              for k, v in gaps.items())
          + f"; kernel decode allowance {allow:.4e} = max(2 x plain_decode, "
            f"2^-8 x max |logit|); plain decode allowance {allow_path:.4e} "
            f"= max(2 x bulk_order2, 2^-8 x max |logit|)")
    if moe:
        margins = torch.cat([m for _, m, *_ in recorded]).float().cpu()
        max_p = float(torch.cat([p for _, _, p, _ in recorded]).max())
        plain_max = max(flips["plain_decode"] + flips["bulk_order2"],
                        default=0.0)
        bound = max(2.0 * plain_max, 2.0 ** -8 * max_p)
        above = [g for g in flips["kernel_decode"] if g > bound]
        decisions = n * len(recorded)
        out["routing"] = {"decisions": decisions,
                          "flipped": {k: len(v) for k, v in flips.items()},
                          "flip_margin_max": {k: max(v, default=0.0)
                                              for k, v in flips.items()},
                          "own_pick_bound": bound, "above_bound": len(above),
                          "margin_median": float(margins.median())}
        print(f"{label}: routing: {decisions} (layer, token) decisions, the "
              f"bulk's median top-k margin {float(margins.median()):.3e}; "
              "own picks differing from the bulk's: " + "; ".join(
                  f"{k} {len(v)} (bulk margins max {max(v, default=0.0):.3e})"
                  for k, v in flips.items())
              + f"; own-pick bound {bound:.3e} = max(2 x the plain orders' "
                f"largest flip margin, 2^-8 x max p = "
                f"{2.0 ** -8 * max_p:.3e}); kernel decode flips above it "
                f"{len(above)}")
        if above:
            fail(f"{label}: the kernel decode's own expert picks differ from "
                 f"the bulk's at {len(above)} decisions with a bulk margin "
                 f"above the own-pick bound {bound:.3e} (largest "
                 f"{max(above):.3e})")
    if not gaps["kernel_decode"]["max"] <= allow:
        fail(f"{label}: kernel decode and bulk logits differ by "
             f"{gaps['kernel_decode']['max']:.4e} > {allow:.4e}")
    if not gaps["plain_decode"]["max"] <= allow_path:
        fail(f"{label}: plain decode and bulk logits differ by "
             f"{gaps['plain_decode']['max']:.4e} > {allow_path:.4e}")
    return out


def moe_decode_profile(cfg, params, kinds: dict, label: str = "moe",
                       step_launches: int | None = None) -> dict:
    """The decode step at batch 4 over zeroed caches (the timing needs no
    real history): median wall (host clock around synchronized steps),
    ksplit launches read per step (each must equal ``step_launches`` when
    given), then steps under ``torch.profiler`` with the expert products
    in a named range (device busy, idle share, ksplit kernel and
    expert-product device time), the held-event time of upcasting one MoE
    layer's bf16 expert segments, and the byte bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    B, p0 = 4, ORDER_PROMPT
    caches = T.init_cache(cfg, B, p0 + DECODE_STEPS + PROFILE_DECODE_STEPS
                          + 2, DEVICE)
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, 1))).to(DEVICE)
    T.forward_decode(params, cfg, tok, caches, p0)
    sync()
    walls, launches = [], []
    for s in range(DECODE_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        T.forward_decode(params, cfg, tok, caches, p0 + 1 + s)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(ops.launch_counts()["ksplit_gemm"])
    wall_ms = float(np.median(walls))
    range_name = "expert_product"
    saved = {cls: cls.__call__ for cls in MOE.MOE_WEIGHTS}

    def named(orig):
        def call(self, x):
            with record_function(range_name):
                return orig(self, x)
        return call

    for cls, orig in saved.items():
        cls.__call__ = named(orig)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for s in range(PROFILE_DECODE_STEPS):
                T.forward_decode(params, cfg, tok, caches,
                                 p0 + 1 + DECODE_STEPS + s)
            sync()
    finally:
        for cls, orig in saved.items():
            cls.__call__ = orig
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / PROFILE_DECODE_STEPS / 1e3)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    # the named range's device row is its span on the card, not a kernel
    expert_ms = sum(ms for name, ms in rows if name == range_name)
    rows = [r for r in rows if r[0] != range_name]
    busy_ms = sum(ms for _, ms in rows) or None
    ksplit_ms = sum(ms for name, ms in rows if "ksplit" in name)
    moe_layers = [lp["moe"] for lp in params["layers"] if "moe" in lp]
    upcast_ms = sum(time_ms(lambda w=moe_layers[0][n].w_lo: w.float())
                    for n in ("gate", "up", "down"))
    n_moe = len(moe_layers)
    parts = decode_step_bytes(cfg, kinds, B, p0 + DECODE_STEPS)
    nbytes = sum(parts.values())
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    idle = (f"{1 - busy_ms / wall_ms:.1%}" if busy_ms
            else "not measured (the profiler saw no device time)")
    print(f"{label} decode step (batch {B}, position ~{p0 + DECODE_STEPS}): "
          f"median wall {wall_ms:.2f} ms over {DECODE_STEPS} steps "
          f"({[round(w, 2) for w in walls]}); byte bound {bound_ms:.2f} ms "
          f"({nbytes / 1e9:.2f} GB at {PEAK_BYTES_S / 1e12:.2f} TB/s: "
          + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items())
          + f"); ksplit launches per step {launches}")
    print(f"{label} decode profile ({PROFILE_DECODE_STEPS} steps): device "
          f"busy {busy_ms or 0:.2f} ms/step, idle share {idle}; expert "
          f"products' span {expert_ms:.2f} ms/step (of which the bf16 "
          f"segments' fp32 upcast, timed apart: {upcast_ms:.3f} ms per MoE "
          f"layer x {n_moe} = {upcast_ms * n_moe:.2f} ms); ksplit kernel "
          f"{ksplit_ms:.2f} ms/step")
    for name, ms in rows[:8]:
        print(f"profile   {ms:8.3f} ms/step  {name[:90]}")
    if len(set(launches)) != 1 or launches[0] < 1 or (
            step_launches is not None and launches[0] != step_launches):
        fail(f"{label} decode: ksplit launches per step {launches}"
             + ("" if step_launches is None else f", not {step_launches}"))
    return {"wall_ms": wall_ms, "bound_ms": bound_ms, "busy_ms": busy_ms,
            "expert_ms": expert_ms, "ksplit_ms": ksplit_ms,
            "upcast_ms_per_step": upcast_ms * n_moe,
            "launches_per_step": launches[0], "bound_parts": parts}


def check_served(label, cfg, reqs, refs, st, launches) -> None:
    """Every request equal to its reference, well-formed, no fresh plan
    resolution after warmup, every KSplit linear on the kernel."""
    bad = [i for i, (r, f) in enumerate(zip(reqs, refs))
           if not r.done or r.out_tokens != f.out_tokens]
    lin = st["linear_dispatch_since_warmup"]
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    print(f"{label}: batched tokens == unbatched reference for "
          f"{len(reqs) - len(bad)}/{len(reqs)} requests; kernel launches "
          f"{launches}; linear dispatch since warmup {lin}; post-warmup "
          f"fresh resolutions {fresh}")
    if bad:
        fail(f"{label}: batched tokens differ from the reference for "
             f"requests {bad}")
    if fresh != 0:
        fail(f"{label}: {fresh} fresh plan resolutions after warmup")
    if launches["ksplit_gemm"] < 1 or lin.get("ksplit_torch", 0) != 0:
        fail(f"{label}: KSplit linears off the ksplit kernel ({lin})")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"{label}: malformed output tokens")


def serve_moe(cfg, seed: int = 0) -> dict:
    """Qwen1.5-MoE-A2.7B at full width (``MOE_LAYERS`` deep) through the
    engine's equal mode: gates (a) determinism at the published
    capacity, (b) batched == unbatched where nothing drops, (c) cached
    decode against the bulk forward; then the decode step beside its
    byte bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    total = sum(kinds.values())
    print(f"serve moe {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"E={cfg.n_experts} top-{cfg.top_k} capacity_factor "
          f"{cfg.capacity_factor}, down {'K' if cfg.moe_ep else 'N'}-split; "
          f"weights {total / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s")

    def stream():
        return family_stream(cfg.vocab, FAMILY_LENS, FAMILY_NEW, seed,
                             FAMILY_SAMPLED)

    sc = ServeConfig(max_batch=4, max_seq=FAMILY_MAX_SEQ)
    eng = Engine(cfg, params, sc)
    if eng.mode != "equal":
        fail(f"serve moe: engine mode {eng.mode!r}, not equal")
    eng.warmup()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run1 = eng.generate(stream())
    sync()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = eng.stats()
    drops = list(st["moe"]["dropped_per_microbatch"])
    run2 = eng.generate(stream())
    drops2 = eng.stats()["moe"]["dropped_per_microbatch"][len(drops):]
    gen_toks = st["tokens"]["generated"]
    print(f"serve moe: {len(run1)} requests (prompts {list(FAMILY_LENS)}, "
          f"{FAMILY_NEW} new, sampled {list(FAMILY_SAMPLED)}), {gen_toks} "
          f"tokens in {wall_s:.3f} s = {gen_toks / wall_s:.2f} tokens/s; "
          f"microbatches {st['microbatches']['total']}, prefill steps "
          f"{st['prefill_steps']}, decode steps {st['decode_steps']}")
    print(f"serve moe (a) capacity {cfg.capacity_factor}: dropped (token, "
          f"expert) pairs per microbatch {drops} (replay {drops2})")
    if [r.out_tokens for r in run1] != [r.out_tokens for r in run2]:
        fail("serve moe (a): the same stream twice gave different tokens")
    if drops != drops2:
        fail(f"serve moe (a): drops {drops} then {drops2}")
    if len(set(tuple(r.out_tokens) for r in run1)) < 2:
        fail("serve moe (a): every request produced the same tokens")
    for r in run1:
        if len(r.out_tokens) != FAMILY_NEW or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            fail("serve moe: malformed output tokens")
    lin = st["linear_dispatch_since_warmup"]
    if st["plans"]["post_warmup_fresh_resolutions"] != 0 or lin.get(
            "ksplit_torch", 0) != 0 or launches["ksplit_gemm"] < 1:
        fail(f"serve moe: fresh resolutions or KSplit linears off the "
             f"kernel ({st['plans']}, {lin}, {launches})")
    cfg16 = dataclasses.replace(cfg, capacity_factor=NO_DROP_CF)
    eng16 = Engine(cfg16, params, sc)
    eng16.warmup()
    ops.reset_launch_counts()
    got = eng16.generate(stream())
    launches16 = ops.launch_counts()
    st16 = eng16.stats()
    refs16 = eng16.generate_reference(stream())
    differ = [i for i, (r, f) in enumerate(zip(run1, refs16))
              if r.out_tokens != f.out_tokens]
    print(f"serve moe (b) capacity {NO_DROP_CF}: dropped pairs per "
          f"microbatch {st16['moe']['dropped_per_microbatch']}; requests "
          f"of (a) differing from this no-drop reference {differ} (not "
          f"gated: the reference's batched behaviour)")
    check_served("serve moe (b)", cfg16, got, refs16, st16, launches16)
    if any(st16["moe"]["dropped_per_microbatch"]):
        fail("serve moe (b): a pair dropped at C >= B")
    order = decode_vs_bulk(cfg16, params, ORDER_PROMPT, seed,
                           "serve moe (c)")
    prof = moe_decode_profile(cfg, params, kinds)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    rate = prof["bound_ms"] / prof["wall_ms"]
    print(f"serve moe: decode step {prof['wall_ms']:.2f} ms vs byte bound "
          f"{prof['bound_ms']:.2f} ms ({rate:.1%} of the bound's rate); "
          f"peak memory {peak_gb:.2f} GB; phase {phase_s:.1f} s")
    del eng, eng16, params
    free_card()
    return {"launches": launches["ksplit_gemm"],
            "launches16": launches16["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "drops": drops,
            "differ": differ, "peak_gb": peak_gb, "weights_gb": total / 1e9,
            "phase_s": phase_s, "order": order, **prof}


def free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_windowed(cfg, seed: int = 0) -> dict:
    """Gemma-3-4B through equal mode at ``GEMMA_LAYERS`` (tokens ==
    reference), then its first pattern period (5 local layers, 1 global)
    decoded through WINDOW_POSITIONS positions against the bulk
    forward."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import LayerList
    t_phase = time.perf_counter()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=max(GEMMA_LENS) + GEMMA_NEW))
    if eng.mode != "equal":
        fail(f"serve gemma3: engine mode {eng.mode!r}, not equal")
    eng.warmup()

    def stream():
        return family_stream(cfg.vocab, GEMMA_LENS, GEMMA_NEW, seed)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = eng.generate(stream())
    sync()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = eng.stats()
    refs = eng.generate_reference(stream())
    gen_toks = st["tokens"]["generated"]
    print(f"serve gemma3 {cfg.name}: {cfg.n_layers} layers "
          f"({sum(m == 'attn_local' for m, _ in cfg.layer_kinds())} local, "
          f"window {cfg.local_window}), weights "
          f"{sum(bytes_by_kind(params).values()) / 1e9:.3f} GB; "
          f"{len(reqs)} requests (prompts {list(GEMMA_LENS)}), {gen_toks} "
          f"tokens in {wall_s:.3f} s = {gen_toks / wall_s:.2f} tokens/s, "
          f"microbatches {st['microbatches']['total']}")
    check_served("serve gemma3", cfg, reqs, refs, st, launches)
    period = cfg.pattern_period()
    cfg1 = dataclasses.replace(cfg, n_layers=period)
    params1 = dict(params, layers=LayerList(params["layers"][:period],
                                            period))
    window = decode_vs_bulk(cfg1, params1, WINDOW_POSITIONS, seed,
                            f"gemma3 window ({period} layers)")
    phase_s = time.perf_counter() - t_phase
    print(f"serve gemma3: phase {phase_s:.1f} s")
    del eng, params, params1
    free_card()
    return {"launches": launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "window": window,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 10: serving the xLSTM family
# ---------------------------------------------------------------------------

#: phase 10's stream: two 32-token and two 64-token prompts, 12 new tokens
XLSTM_LENS = (32, 32, 64, 64)
XLSTM_NEW = 12
#: positions of the first pattern period decoded against the bulk forward
XLSTM_POSITIONS = 128


def xlstm_step_launches(cfg) -> int:
    """ksplit launches in every xLSTM model step: each mLSTM up_proj, each
    sLSTM ff_up, the lm_head (49 at xLSTM-1.3B's 48 layers, 17 at 16)."""
    return cfg.n_layers + 1


def state_bytes(caches) -> int:
    return sum(t.numel() * t.element_size()
               for c in caches for t in c.values())


def count_step_launches(steps: list):
    """Wrap ``transformer.forward_decode`` so every model step appends the
    ksplit launches it made (read from the counters before and after);
    returns the function to restore."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    orig = T.forward_decode

    def forward_decode(*args, **kw):
        n0 = ops.launch_counts()["ksplit_gemm"]
        out = orig(*args, **kw)
        steps.append(ops.launch_counts()["ksplit_gemm"] - n0)
        return out

    T.forward_decode = forward_decode
    return lambda: setattr(T, "forward_decode", orig)


def decode_profile(cfg, params, kinds: dict, label: str,
                   step_launches: int) -> dict:
    """The decode step at batch 4 over a zeroed cache (the timing needs
    no history): median wall (host clock around synchronized steps)
    beside the byte bound (``decode_step_bytes``: the weights, embedding
    rows, each attention layer's visible KV, each row's recurrent state
    read and written once and the logits), ksplit launches read per step
    (each must be ``step_launches``), then steps under ``torch.profiler``
    (device busy, idle share, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    B = 4
    caches = T.init_cache(cfg, B, 2 + DECODE_STEPS + PROFILE_DECODE_STEPS,
                          DEVICE)
    tok = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (B, 1))).to(DEVICE)
    T.forward_decode(params, cfg, tok, caches, 0)
    sync()
    walls, launches = [], []
    for s in range(DECODE_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        T.forward_decode(params, cfg, tok, caches, 1 + s)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(ops.launch_counts()["ksplit_gemm"])
    wall_ms = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(PROFILE_DECODE_STEPS):
            T.forward_decode(params, cfg, tok, caches, 1 + DECODE_STEPS + s)
        sync()
    rows = [(e.key, e.self_device_time_total / PROFILE_DECODE_STEPS / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms in rows) or None
    ksplit_ms = sum(ms for name, ms in rows if "ksplit" in name)
    parts = decode_step_bytes(cfg, kinds, B, 1 + DECODE_STEPS)
    nbytes = sum(parts.values())
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    idle = (f"{1 - busy_ms / wall_ms:.1%}" if busy_ms
            else "not measured (the profiler saw no device time)")
    print(f"{label} decode step (batch {B}): median wall {wall_ms:.2f} "
          f"ms over {DECODE_STEPS} steps ({[round(w, 2) for w in walls]}); "
          f"byte bound {bound_ms:.2f} ms ({nbytes / 1e9:.2f} GB at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s: weights "
          f"{parts['weights'] / 1e9:.3f} GB, KV {parts['kv'] / 1e9:.4f} "
          f"GB, state read and written {parts['state'] / 1e9:.3f} GB); "
          f"ksplit launches per step {launches}")
    print(f"{label} decode profile ({PROFILE_DECODE_STEPS} steps): device "
          f"busy {busy_ms or 0:.2f} ms/step, idle share {idle}; ksplit "
          f"kernel {ksplit_ms:.2f} ms/step")
    for name, ms in rows[:8]:
        print(f"profile   {ms:8.3f} ms/step  {name[:90]}")
    check_counts(f"{label} decode", launches, step_launches)
    return {"wall_ms": wall_ms, "bound_ms": bound_ms, "busy_ms": busy_ms,
            "ksplit_ms": ksplit_ms, "launches_per_step": launches[0]}


def serve_xlstm(cfg, seed: int = 0) -> dict:
    """xLSTM-1.3B at full width (``XLSTM_LAYERS`` deep) through the
    engine's equal mode: four requests equal to their unbatched
    reference, one ksplit launch per layer and the lm_head's in every
    model step, no fresh resolution, every KSplit linear on the
    kernel; the first pattern period (1 sLSTM, 7 mLSTM layers) decoded
    through XLSTM_POSITIONS positions against the bulk forward; the decode
    step beside its byte bound."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import LayerList
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    row_state = state_bytes(T.init_cache(cfg, 1, 1, DEVICE))
    kinds_of = [m for m, _ in cfg.layer_kinds()]
    print(f"serve xlstm {cfg.name}: {cfg.n_layers} layers "
          f"({kinds_of.count('mlstm')} mLSTM, {kinds_of.count('slstm')} "
          f"sLSTM) d={cfg.d_model} heads={cfg.n_heads} vocab={cfg.vocab}; "
          f"weights {sum(kinds.values()) / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s; recurrent state "
          f"{row_state / 1e6:.2f} MB per row (fp32)")
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=max(XLSTM_LENS) + XLSTM_NEW))
    if eng.mode != "equal":
        fail(f"serve xlstm: engine mode {eng.mode!r}, not equal")
    eng.warmup()

    def stream():
        return family_stream(cfg.vocab, XLSTM_LENS, XLSTM_NEW, seed)

    reqs, wall_s, launches, st, steps = served_counted(
        eng, stream, xlstm_step_launches(cfg), "serve xlstm")
    t0 = time.perf_counter()
    refs = eng.generate_reference(stream())
    ref_s = time.perf_counter() - t0
    gen_toks = st["tokens"]["generated"]
    print(f"serve xlstm: {len(reqs)} requests (prompts {list(XLSTM_LENS)}, "
          f"{XLSTM_NEW} new), {gen_toks} tokens in {wall_s:.3f} s = "
          f"{gen_toks / wall_s:.2f} tokens/s; microbatches "
          f"{st['microbatches']['total']}, prefill steps "
          f"{st['prefill_steps']}, decode steps {st['decode_steps']}; "
          f"unbatched reference {ref_s:.1f} s; ksplit launches per model "
          f"step: {len(steps)} steps, all {sorted(set(steps))}")
    check_served("serve xlstm", cfg, reqs, refs, st, launches)
    period = cfg.pattern_period()
    cfg1 = dataclasses.replace(cfg, n_layers=period)
    params1 = dict(params, layers=LayerList(params["layers"][:period],
                                            period))
    t0 = time.perf_counter()
    order = decode_vs_bulk(cfg1, params1, XLSTM_POSITIONS, seed,
                           f"serve xlstm first period ({period} layers)")
    order_s = time.perf_counter() - t0
    prof = decode_profile(cfg, params, kinds, "serve xlstm",
                          xlstm_step_launches(cfg))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    rate = prof["bound_ms"] / prof["wall_ms"]
    print(f"serve xlstm: decode step {prof['wall_ms']:.2f} ms vs byte bound "
          f"{prof['bound_ms']:.2f} ms ({rate:.1%} of the bound's rate); "
          f"state {row_state / 1e6:.2f} MB per row; "
          f"peak memory {peak_gb:.2f} GB; decode vs bulk {order_s:.1f} s; "
          f"phase {phase_s:.1f} s")
    del eng, params, params1
    free_card()
    return {"launches": launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "order": order,
            "row_state_mb": row_state / 1e6, "peak_gb": peak_gb,
            "weights_gb": sum(kinds.values()) / 1e9, "phase_s": phase_s,
            **prof}


# ---------------------------------------------------------------------------
# phase 11: serving the Mamba-hybrid family
# ---------------------------------------------------------------------------

#: phase 11's depth: Jamba-v0.1's first pattern period (7 Mamba mixers,
#: attention at layer 4, MoE on odd layers), every published width; the
#: 32 layers (51.6e9 parameters) do not fit one card
JAMBA_LAYERS = 8
#: phase 11's stream: two 32-token and two 64-token prompts, 12 new tokens
JAMBA_LENS = (32, 32, 64, 64)
JAMBA_NEW = 12
#: ksplit launches in every model step of the period: 7 Mamba in_proj, 4
#: MLP up and gate (8), the attention layer's wq, wk, wv (3), the lm_head
JAMBA_STEP_LAUNCHES = 19
#: positions decoded against the bulk forward: two of the scan's 128-token
#: chunks, so the bulk crosses a chunk
JAMBA_POSITIONS = 256


def serve_jamba_period(cfg, seed: int = 0) -> dict:
    """Jamba-v0.1's first pattern period at published widths through the
    engine's equal mode: (b) at capacity factor 16 every request equals
    its unbatched reference, (a) at the published 1.25 the same stream
    twice gives the same tokens (drops printed), 19 ksplit launches in
    every model step of both, no fresh resolution, every KSplit linear
    on the kernel; then one row decoded through JAMBA_POSITIONS
    positions against the bulk forward under rule (c), and the decode
    step beside its byte bound."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    row_state = state_bytes([c for (m, _), c in zip(
        cfg.layer_kinds(), T.init_cache(cfg, 1, 1, "meta")) if m == "mamba"])
    mixers = [m for m, _ in cfg.layer_kinds()]
    print(f"serve jamba period {cfg.name}: {cfg.n_layers} layers "
          f"({mixers.count('mamba')} Mamba, {mixers.count('attn_full')} "
          f"attention; MoE on {sum(f == 'moe' for _, f in cfg.layer_kinds())}"
          f") d={cfg.d_model} d_ff={cfg.d_ff} E={cfg.n_experts} "
          f"top-{cfg.top_k} d_state={cfg.mamba_d_state} vocab={cfg.vocab}; "
          f"weights {sum(kinds.values()) / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s; Mamba state {row_state / 1e6:.2f} "
          f"MB per row (fp32)")
    sc = ServeConfig(max_batch=4, max_seq=max(JAMBA_LENS) + JAMBA_NEW)

    def stream():
        return family_stream(cfg.vocab, JAMBA_LENS, JAMBA_NEW, seed)

    def counted(eng):
        return served_counted(eng, stream, JAMBA_STEP_LAUNCHES,
                              "serve jamba")

    cfg16 = dataclasses.replace(cfg, capacity_factor=NO_DROP_CF)
    eng16 = Engine(cfg16, params, sc)
    if eng16.mode != "equal":
        fail(f"serve jamba: engine mode {eng16.mode!r}, not equal")
    eng16.warmup()
    got, wall_s, launches16, st16, steps16 = counted(eng16)
    t0 = time.perf_counter()
    refs16 = eng16.generate_reference(stream())
    ref_s = time.perf_counter() - t0
    gen_toks = st16["tokens"]["generated"]
    print(f"serve jamba (b) capacity {NO_DROP_CF}: {len(got)} requests "
          f"(prompts {list(JAMBA_LENS)}, {JAMBA_NEW} new), {gen_toks} tokens "
          f"in {wall_s:.3f} s = {gen_toks / wall_s:.2f} tokens/s; "
          f"microbatches {st16['microbatches']['total']}, prefill steps "
          f"{st16['prefill_steps']}, decode steps {st16['decode_steps']}; "
          f"unbatched reference {ref_s:.1f} s; dropped pairs per microbatch "
          f"{st16['moe']['dropped_per_microbatch']}; ksplit launches per "
          f"model step: {len(steps16)} steps, all {sorted(set(steps16))}")
    check_served("serve jamba (b)", cfg16, got, refs16, st16, launches16)
    if any(st16["moe"]["dropped_per_microbatch"]):
        fail("serve jamba (b): a pair dropped at C >= B")
    del eng16
    eng = Engine(cfg, params, sc)
    eng.warmup()
    run1, _, launches, st, steps = counted(eng)
    drops = list(st["moe"]["dropped_per_microbatch"])
    run2 = eng.generate(stream())
    drops2 = eng.stats()["moe"]["dropped_per_microbatch"][len(drops):]
    differ = [i for i, (r, f) in enumerate(zip(run1, refs16))
              if r.out_tokens != f.out_tokens]
    print(f"serve jamba (a) capacity {cfg.capacity_factor}: dropped (token, "
          f"expert) pairs per microbatch {drops} (replay {drops2}); requests "
          f"differing from the no-drop reference {differ} (not gated: the "
          f"reference's batched behaviour); ksplit launches per model step: "
          f"{len(steps)} steps, all {sorted(set(steps))}; post-warmup fresh "
          f"resolutions {st['plans']['post_warmup_fresh_resolutions']}")
    if [r.out_tokens for r in run1] != [r.out_tokens for r in run2]:
        fail("serve jamba (a): the same stream twice gave different tokens")
    if drops != drops2:
        fail(f"serve jamba (a): drops {drops} then {drops2}")
    if st["plans"]["post_warmup_fresh_resolutions"] != 0:
        fail(f"serve jamba (a): fresh resolutions ({st['plans']})")
    for r in run1:
        if len(r.out_tokens) != JAMBA_NEW or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            fail("serve jamba (a): malformed output tokens")
    del eng
    free_card()
    t0 = time.perf_counter()
    order = decode_vs_bulk(cfg16, params, JAMBA_POSITIONS, seed,
                           f"serve jamba period ({cfg.n_layers} layers)")
    order_s = time.perf_counter() - t0
    prof = moe_decode_profile(cfg, params, kinds, "serve jamba",
                              JAMBA_STEP_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase_s = time.perf_counter() - t_phase
    rate = prof["bound_ms"] / prof["wall_ms"]
    idle = (f"{1 - prof['busy_ms'] / prof['wall_ms']:.1%}"
            if prof["busy_ms"] else "not measured")
    print(f"serve jamba ({smi_line()}): decode step {prof['wall_ms']:.2f} "
          f"ms vs byte bound {prof['bound_ms']:.2f} ms ({rate:.1%} of the "
          f"bound's rate), idle share {idle}; Mamba state "
          f"{row_state / 1e6:.2f} MB per row; peak memory {peak_gb:.2f} GB; "
          f"decode vs bulk {order_s:.1f} s; phase {phase_s:.1f} s")
    del params
    free_card()
    return {"launches": launches16["ksplit_gemm"] + launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "order": order,
            "drops": drops, "row_state_mb": row_state / 1e6,
            "peak_gb": peak_gb, "weights_gb": sum(kinds.values()) / 1e9,
            "phase_s": phase_s, **prof}


# ---------------------------------------------------------------------------
# phase 12: the frontends and the large configs
# ---------------------------------------------------------------------------

#: phase 12a: HuBERT-XLarge's batch (4 clips of 512 frames at 50 Hz,
#: 10.24 s of audio each) and its AdamW steps on that batch, repeated
HUBERT_SEQ, HUBERT_BATCH = 512, 4
HUBERT_STEPS = 4
#: its peak learning rate: at 1e-3 (phase 7's) the 48 random-init
#: layers overshoot at the third step (losses 6.727, 6.689, 8.777, 6.586
#: on one H100)
HUBERT_LR = 3e-4
#: phase 12b: LLaVA-NeXT-34B's depth on the card (its 60 layers take ~108
#: GB at ratio_high 0.5; every width as published) and the text after its
#: 2880 patch embeddings: S = 3072 (the reference's flash attention
#: needs S <= 1024 or S % 1024 == 0)
LLAVA_LAYERS = 8
LLAVA_TEXT = 192
#: phase 12c: Llama-3-405B's depth on the card (9.66 GB a layer)
LLAMA405_LAYERS = 2
#: phases 12b and 12c's stream: two 32-token and two 64-token text
#: prompts, 8 new tokens each, at max_batch 4
LARGE_LENS = (32, 32, 64, 64)
LARGE_NEW = 8
#: the floor of the kernel-against-plain allowance on logits: one bf16
#: rounding of the largest plain logit
BF16_ROUNDING = 2.0 ** -8


def ksplit_linears(cfg, frontend: bool) -> int:
    """The ksplit launches of one forward of an attention/MLP stack: wq,
    wk and wv of every layer, up (and gate where the MLP is gated), the
    lm_head, and with ``frontend`` the frontend's projection (a bulk
    forward embeds through it, a decode step embeds tokens only).  wo and
    down are NSplit."""
    n = 1 + (1 if frontend and cfg.frontend != "none" else 0)
    for mixer, ffn in cfg.layer_kinds():
        n += 3 if mixer.startswith("attn") else 0
        n += (2 if cfg.gated_mlp else 1) if ffn == "mlp" else 0
    return n


def check_counts(label: str, counts: list, want: int) -> None:
    """Every forward or model step of a run launched the ksplit kernel
    ``want`` times: ``counts`` are read per step, never multiplied out."""
    if not counts or any(n != want for n in counts):
        fail(f"{label}: ksplit launches per step {counts}, not {want} in "
             "each")


def three_orders(fn) -> list:
    """``fn()`` through the ksplit kernel, then with its plain version
    swapped in, then with the segments summed as one matmul (a second
    plain order); the swapped runs launch nothing."""
    from repro_torch.kernels import ksplit_gemm as K
    kernel_fn = K.ksplit_gemm_multi
    out = [fn()]
    try:
        for plain in (K.ksplit_gemm_plain, ksplit_one_matmul):
            K.ksplit_gemm_multi = plain
            out.append(fn())
    finally:
        K.ksplit_gemm_multi = kernel_fn
    sync()
    return out


def order_gate(label: str, kernel, plain, plain2) -> dict:
    """``kernel`` within twice the gap between the two plain orders of
    ``plain``, floored at one bf16 rounding of the largest plain value."""
    gap = float((kernel - plain).abs().max())
    orders = float((plain2 - plain).abs().max())
    floor = BF16_ROUNDING * float(plain.abs().max())
    allow = max(2.0 * orders, floor)
    print(f"{label}: max|kernel - plain| {gap:.4e}, two plain orders "
          f"{orders:.4e}; allowance {allow:.4e} (2x the orders' gap, floor "
          f"{floor:.4e}: one bf16 rounding of the largest)")
    if not (bool(kernel.isfinite().all()) and gap <= allow):
        fail(f"{label}: the kernel is off its plain version")
    return {"gap": gap, "orders": orders, "allowance": allow}


def encoder_attends_both_ways(params, cfg, batch, label: str) -> float:
    """Changing only the last frame must move position 0's per-token
    loss, in a run that is otherwise bit for bit repeatable; returns the
    move."""
    import torch
    moved = dict(batch, frames=batch["frames"].clone())
    moved["frames"][:, -1] = -moved["frames"][:, -1]
    first, again = (losses_of(all_logits(params, cfg, batch),
                              batch["labels"]) for _ in range(2))
    other = losses_of(all_logits(params, cfg, moved), batch["labels"])
    d0 = float((other[:, 0] - first[:, 0]).abs().max())
    print(f"{label}: the last frame negated moves position 0's loss by "
          f"{d0:.4e} (repeat bit for bit: "
          f"{bool(torch.equal(first, again))})")
    if not torch.equal(first, again):
        fail(f"{label}: the encoder pass does not repeat bit for bit")
    if not d0 > 0:
        fail(f"{label}: position 0 does not see the last frame: the "
             "encoder attends causally")
    return d0


def image_and_text_order(params, cfg, batch, logits, allowance: float,
                         label: str) -> float:
    """The prompt is [patches, text]: changing only the patch embeddings
    moves the last text position's logits by more than the kernel's
    allowance, and changing only the last text token leaves every
    earlier position's hidden state bit for bit as it was."""
    import torch
    from repro_torch.models import transformer as T
    moved = dict(batch, patch_embeds=-batch["patch_embeds"])
    with torch.no_grad():
        d = float((T.forward_prefill(params, cfg, moved)
                   - logits).abs().max())
        toks = batch["tokens"].clone()
        toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab
        a = T._run_layers(params, cfg, batch)[0]
        b = T._run_layers(params, cfg, dict(batch, tokens=toks))[0]
    earlier = bool(torch.equal(a[:, :-1], b[:, :-1]))
    last = not torch.equal(a[:, -1], b[:, -1])
    print(f"{label}: patches negated move the last text position's logits "
          f"by {d:.4e} (allowance {allowance:.4e}); the last token changed "
          f"leaves positions < S-1 bit for bit: {earlier}, moves S-1: {last}")
    if not d > allowance:
        fail(f"{label}: the last text position does not see the image")
    if not (earlier and last):
        fail(f"{label}: the text is not the prompt's last part")
    return d


def served_counted(eng, reqs_fn, want: int, label: str):
    """``eng.generate`` over ``reqs_fn()`` with the ksplit launches of
    every model step read apart; each must be ``want``.  Returns (served
    requests, wall s, launches, stats, per-step launches)."""
    from repro_torch.kernels import ops
    steps: list = []
    restore = count_step_launches(steps)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = eng.generate(reqs_fn())
        sync()
        wall_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        restore()
    st = eng.stats()
    check_counts(label, steps, want)
    if (len(steps) != st["prefill_steps"] + st["decode_steps"]
            or launches["ksplit_gemm"] != sum(steps)
            or st["linear_dispatch_since_warmup"].get("ksplit_cuda", 0)
            != sum(steps)):
        fail(f"{label}: {len(steps)} model steps counted, "
             f"{launches['ksplit_gemm']} launches "
             f"({st['linear_dispatch_since_warmup']})")
    return reqs, wall_s, launches, st, steps


def hubert_phase(cfg, seed: int = 0) -> dict:
    """HuBERT-XLarge at full width, all 48 layers: the encoder pass over
    4 x 512 frames through the ksplit kernel (194 launches) against its
    plain version; position 0 sees the last frame; then the step-0
    gradients against the plain version's, and HUBERT_STEPS AdamW steps
    with a falling loss and 194 launches in each."""
    import torch
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tune import dispatch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    tokens = HUBERT_SEQ * HUBERT_BATCH
    batch = DP.make_batch(cfg, HUBERT_SEQ, HUBERT_BATCH, kind="train",
                          seed=seed, device=DEVICE)
    pre = DP.make_batch(cfg, HUBERT_SEQ, HUBERT_BATCH, kind="prefill",
                        seed=seed, device=DEVICE)
    if not torch.equal(pre["frames"], batch["frames"]):
        fail("hubert: the train batch's frames are not the prefill batch's")
    want = ksplit_linears(cfg, frontend=True)
    print(f"hubert {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads={cfg.n_heads} d_ff={cfg.d_ff} (GELU) vocab={cfg.vocab}, "
          f"frames {tuple(pre['frames'].shape)} fp32 "
          f"({HUBERT_SEQ / 50:.2f} s of audio at 50 Hz each); weights "
          f"{sum(kinds.values()) / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s")
    dispatch.warm_registry()
    dispatch.tune_linear_params(params, m_hint=tokens)

    # the encoder pass: kernel (counted), plain, a second plain order
    lin0 = dispatch.dispatch_counts("linear")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = all_logits(params, cfg, pre)
    sync()
    enc_ms = (time.perf_counter() - t0) * 1e3
    n_enc = ops.launch_counts()["ksplit_gemm"]
    lin = {p: v - lin0.get(p, 0)
           for p, v in dispatch.dispatch_counts("linear").items()}
    print(f"hubert encoder pass: {enc_ms:.1f} ms (first call), ksplit "
          f"launches {n_enc} (want {want}: 4 per layer, frontend_proj, "
          f"lm_head), linear dispatch {lin}")
    check_counts("hubert encoder pass", [n_enc], want)
    if lin.get("ksplit_torch", 0):
        fail("hubert: a KSplit linear ran off the kernel")
    if tuple(logits.shape) != (HUBERT_BATCH, HUBERT_SEQ, cfg.vocab):
        fail(f"hubert: logits of shape {tuple(logits.shape)}")
    _, plain, plain2 = three_orders(lambda: all_logits(params, cfg, pre))
    enc = order_gate("hubert encoder logits", logits, plain, plain2)
    d0 = encoder_attends_both_ways(params, cfg, batch, "hubert encoder")
    tok = [losses_of(x, batch["labels"]) for x in (logits, plain, plain2)]
    tok_gap, tok_gap_a = rel_gap(tok[0], tok[1]), rel_gap(tok[2], tok[1])
    del logits, plain, plain2, tok
    t0 = time.perf_counter()
    all_logits(params, cfg, pre)
    sync()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"hubert encoder pass warm: {warm_ms:.1f} ms; gates done at "
          f"{time.perf_counter() - t_phase:.1f} s")

    # step 0: gradients through the kernel against the plain version's
    ops.reset_launch_counts()
    loss_k, _, g_k = loss_and_grads(params, cfg, batch)
    sync()
    n_step0 = ops.launch_counts()["ksplit_gemm"]
    check_counts("hubert step 0", [n_step0], want)
    kernel_fn = K.ksplit_gemm_multi
    try:
        K.ksplit_gemm_multi = K.ksplit_gemm_plain
        loss_p, _, g_p = loss_and_grads(params, cfg, batch)
        K.ksplit_gemm_multi = ksplit_one_matmul
        _, _, g_a = loss_and_grads(params, cfg, batch)
        sync()
    finally:
        K.ksplit_gemm_multi = kernel_fn
    frob, worst, where = leaf_gaps(g_k, g_p)
    frob_a, worst_a, _ = leaf_gaps(g_a, g_p)
    del g_k, g_p, g_a
    print(f"hubert step 0: loss kernel {float(loss_k):.6f} plain "
          f"{float(loss_p):.6f}; per-token losses ||d||/||l|| kernel vs "
          f"plain {tok_gap:.2e}, two plain orders {tok_gap_a:.2e}; "
          f"gradients worst ||d||/||g|| {frob:.2e} (orders {frob_a:.2e}), "
          f"worst max|d|/max|g| {worst:.2e} at {where} (orders "
          f"{worst_a:.2e}); allowance {TRAIN_ORDER_RATIO:g}x the orders")
    if not (np.isfinite(float(loss_k))
            and tok_gap <= TRAIN_ORDER_RATIO * tok_gap_a
            and frob <= TRAIN_ORDER_RATIO * frob_a):
        fail("hubert step 0: the kernel's loss or gradients are off the "
             "plain version's")
    print(f"hubert step 0 done at {time.perf_counter() - t_phase:.1f} s")

    # AdamW steps on the repeated batch, launches read per step
    ocfg = adamw.AdamWConfig(lr_peak=HUBERT_LR, warmup_steps=1,
                             total_steps=HUBERT_STEPS)
    opt = adamw.init(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, 1, tune_params=params,
                              tune_tokens=tokens)
    losses, step_ms, per_step = [], [], []
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    for _ in range(HUBERT_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        now = ops.launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    steady = float(np.median(step_ms[1:]))
    prof = profile_step(step_fn, params, opt, batch, steady)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    idle = (f"{1 - prof['busy_ms'] / steady:.1%}" if prof["busy_ms"]
            else "not measured")
    print(f"hubert train ({smi_line()}): losses "
          f"{[round(v, 4) for v in losses]}; step wall ms "
          f"{[round(v, 1) for v in step_ms]}, median of steps 1-"
          f"{HUBERT_STEPS - 1} {steady:.1f} ms = {tokens / steady * 1e3:.1f} "
          f"frames/s, idle share {idle}; ksplit launches per step "
          f"{[c['ksplit_gemm'] for c in per_step]}, convert "
          f"{[c['convert'] for c in per_step]}; peak memory {peak_gb:.2f} GB")
    check_counts("hubert train", [c["ksplit_gemm"] for c in per_step], want)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"hubert train: losses {losses} are not finite and falling")
    del params, opt, step_fn
    phase_s = time.perf_counter() - t_phase
    print(f"hubert: phase {phase_s:.1f} s")
    return {"launches": n_enc + n_step0 + sum(c["ksplit_gemm"]
                                              for c in per_step),
            "convert_launches": sum(c["convert"] for c in per_step),
            "encoder": enc, "position0_move": d0, "encoder_ms": warm_ms,
            "encoder_first_ms": enc_ms,
            "step_ms": steady, "losses": losses, "peak_gb": peak_gb,
            "weights_gb": sum(kinds.values()) / 1e9, "phase_s": phase_s,
            **prof}


def llava_phase(cfg, seed: int = 0) -> dict:
    """LLaVA-NeXT-34B's first LLAVA_LAYERS layers at every published
    width: one multimodal prefill (2880 patch embeddings, then
    LLAVA_TEXT tokens) through the ksplit kernel (42 launches) against
    its plain version, the image and text-order gates; then four text
    requests through the engine's equal mode, equal to their unbatched
    reference, 41 launches in every model step."""
    import torch
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tune import dispatch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    dims = T.dims_of(cfg)
    S = cfg.n_patches + LLAVA_TEXT
    batch = DP.make_batch(cfg, S, 1, kind="prefill", seed=seed,
                          device=DEVICE)
    print(f"llava {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads {dims.n_q} q ({dims.n_q_orig} published) / {dims.n_kv} kv "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab}; weights "
          f"{sum(kinds.values()) / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s; prompt {cfg.n_patches} patch "
          f"embeddings {tuple(batch['patch_embeds'].shape)} + "
          f"{LLAVA_TEXT} tokens = {S}")
    dispatch.warm_registry()
    dispatch.tune_linear_params(params, m_hint=S)
    want = ksplit_linears(cfg, frontend=True)

    def prefill():
        with torch.no_grad():
            return T.forward_prefill(params, cfg, batch)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill()
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n_pre = ops.launch_counts()["ksplit_gemm"]
    print(f"llava prefill: {prefill_ms:.1f} ms (first call), ksplit "
          f"launches {n_pre} (want {want}: 5 per layer, frontend_proj, "
          "lm_head)")
    check_counts("llava prefill", [n_pre], want)
    _, plain, plain2 = three_orders(prefill)
    pre = order_gate("llava prefill last-position logits", logits, plain,
                     plain2)
    img = image_and_text_order(params, cfg, batch, logits,
                               pre["allowance"], "llava prefill")
    del logits, plain, plain2
    t0 = time.perf_counter()
    prefill()
    sync()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"llava prefill warm: {warm_ms:.1f} ms")

    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=max(LARGE_LENS) + LARGE_NEW))
    if eng.mode != "equal":
        fail(f"llava: engine mode {eng.mode!r}, not equal")
    eng.warmup()

    def stream():
        return family_stream(cfg.vocab, LARGE_LENS, LARGE_NEW, seed)

    step_want = ksplit_linears(cfg, frontend=False)
    reqs, wall_s, launches, st, steps = served_counted(
        eng, stream, step_want, "llava serve")
    refs = eng.generate_reference(stream())
    gen_toks = st["tokens"]["generated"]
    print(f"llava serve (equal mode, text tokens only): {len(reqs)} "
          f"requests (prompts {list(LARGE_LENS)}, {LARGE_NEW} new), "
          f"{gen_toks} tokens in {wall_s:.3f} s = {gen_toks / wall_s:.2f} "
          f"tokens/s; ksplit launches per model step: {len(steps)} steps, "
          f"all {sorted(set(steps))} (want {step_want})")
    check_served("llava serve", cfg, reqs, refs, st, launches)
    del eng
    prof = decode_profile(cfg, params, kinds, "llava", step_want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    phase_s = time.perf_counter() - t_phase
    print(f"llava ({smi_line()}): prefill {warm_ms:.1f} ms warm "
          f"({prefill_ms:.1f} first) at S={S}; decode step "
          f"{prof['wall_ms']:.2f} ms vs byte bound {prof['bound_ms']:.2f} "
          f"ms; peak memory {peak_gb:.2f} GB; phase {phase_s:.1f} s")
    return {"launches": n_pre + launches["ksplit_gemm"], "prefill": pre,
            "image_move": img, "prefill_ms": warm_ms,
            "prefill_first_ms": prefill_ms,
            "tokens_per_s": gen_toks / wall_s, "peak_gb": peak_gb,
            "weights_gb": sum(kinds.values()) / 1e9, "phase_s": phase_s,
            **prof}


def llama405_phase(cfg, seed: int = 0) -> dict:
    """Llama-3-405B's first LLAMA405_LAYERS layers at published widths in
    masked mode (refill, prefix cache and chunking off, as phase 4):
    four requests equal to their unbatched reference, 11 launches in
    every model step; the batch-4 decode step beside its byte bound."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    init_s = time.perf_counter() - t_phase
    kinds = bytes_by_kind(params)
    dims = T.dims_of(cfg)
    print(f"llama405 {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads {dims.n_q} q / {dims.n_kv} kv ({dims.n_kv_orig} published) "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab}; weights "
          f"{sum(kinds.values()) / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f" GB), init {init_s:.1f} s; peak at init "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    eng = Engine(cfg, params, ServeConfig(
        max_batch=4, max_seq=128, refill=False, prefix_cache=False,
        chunked_prefill=False))
    if eng.mode != "masked":
        fail(f"llama405: engine mode {eng.mode!r}, not masked")
    eng.warmup()

    def stream():
        return family_stream(cfg.vocab, LARGE_LENS, LARGE_NEW, seed)

    want = ksplit_linears(cfg, frontend=False)
    reqs, wall_s, launches, st, steps = served_counted(
        eng, stream, want, "llama405 serve")
    refs = eng.generate_reference(stream())
    gen_toks = st["tokens"]["generated"]
    print(f"llama405 serve (masked mode): {len(reqs)} requests (prompts "
          f"{list(LARGE_LENS)}, {LARGE_NEW} new), {gen_toks} tokens in "
          f"{wall_s:.3f} s = {gen_toks / wall_s:.2f} tokens/s; microbatches "
          f"{st['microbatches']['total']}; ksplit launches per model step: "
          f"{len(steps)} steps, all {sorted(set(steps))} (want {want})")
    check_served("llama405 serve", cfg, reqs, refs, st, launches)
    del eng
    prof = decode_profile(cfg, params, kinds, "llama405", want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    phase_s = time.perf_counter() - t_phase
    print(f"llama405 ({smi_line()}): decode step {prof['wall_ms']:.2f} ms "
          f"vs byte bound {prof['bound_ms']:.2f} ms "
          f"({prof['bound_ms'] / prof['wall_ms']:.1%} of the bound's rate); "
          f"peak memory {peak_gb:.2f} GB (from_dense's fp32 temporaries "
          f"included); phase {phase_s:.1f} s")
    return {"launches": launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / wall_s, "peak_gb": peak_gb,
            "weights_gb": sum(kinds.values()) / 1e9, "phase_s": phase_s,
            **prof}


def frontends_phase(seed: int = 0) -> dict:
    """Phase 12: (a) HuBERT-XLarge encoded and trained at full width,
    (b) LLaVA-NeXT-34B's multimodal prefill and text serving, (c)
    Llama-3-405B's first layers served, the card emptied between."""
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    out = {"hubert": hubert_phase(get("hubert-xlarge"), seed)}
    free_card()
    out["llava"] = llava_phase(dataclasses.replace(
        get("llava-next-34b"), n_layers=LLAVA_LAYERS), seed)
    free_card()
    out["llama405"] = llama405_phase(dataclasses.replace(
        get("llama3-405b"), n_layers=LLAMA405_LAYERS), seed)
    free_card()
    out["launches"] = sum(v["launches"] for v in out.values())
    out["convert_launches"] = out["hubert"]["convert_launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve frontends: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: training the MoE, xLSTM and Mamba-hybrid families
# ---------------------------------------------------------------------------

#: phase 13's cells, every width as published and depth the only cut:
#: (config, layers, seq, batch).  Qwen1.5-MoE-A2.7B's first 2 of 24
#: layers (~1.76e9 parameters, ~30 GB with gradients and AdamW state);
#: xLSTM-1.3B's first 8 of 48 (one period; 16 until phase 15 took the
#: script past 900 s), as phase 10 serves it, at S = 512 (the
#: mLSTM bulk scan crosses its 256-position chunk); Jamba-v0.1's layer 0
#: alone (a Mamba mixer and its d_ff 14336 MLP) at S = 256 (the selective
#: scan crosses its 128-position chunk).  Jamba's layer 1, a 16-expert MoE,
#: is ~2.8e9 parameters: with layers 0-1 the state comes to ~66 GB before
#: activations, so that layer trains on the CPU only, reduced
FT_CELLS = (("qwen2-moe-a2.7b", 2, 128, 4), ("xlstm-1.3b", 8, 512, 2),
            ("jamba-v0.1-52b", 1, 256, 2))
#: gate (c): AdamW steps on one repeated batch, at phase 12's learning
#: rate
FT_STEPS, FT_LR = 4, 3e-4
#: the bulk scans' chunks (``mlstm_block`` and ``mamba_block``'s
#: defaults): gate (d) runs on every layer with one of these mixers
SCAN_CHUNK = {"mlstm": 256, "mamba": 128}
#: gate (e)'s probe: one row of this many tokens, whose top-k picks leave
#: most experts without a token
EXPERT_PROBE = 8
#: the MoE cell's requests on a fresh init after training: prompt lengths
#: (the odd ones on the int8 variant), new tokens, the engine's max_seq
FT_SERVE_LENS = (32, 32, 64, 64)
FT_SERVE_NEW = 8
FT_MAX_SEQ = 80
#: the aux term's weight in the MoE loss (the reference's)
AUX_WEIGHT = 0.01


def train_state_bytes(params) -> dict:
    """Parameters, and bytes of the weights, their gradients (each in its
    parameter's dtype) and AdamW's fp32 state (two moments and the
    master copy, 12 bytes a parameter)."""
    from repro_torch import tree as TR
    ts = TR.tensors(params)
    w = sum(t.numel() * t.element_size() for t in ts)
    n = sum(t.numel() for t in ts)
    return {"params": n, "weights": w, "grads": w, "adamw": 12 * n,
            "total": 2 * w + 12 * n}


def step_launches(params) -> dict:
    """One train step's reckoned launches.  ksplit: once per KSplit
    linear (its forward; the backward is cuBLAS).  convert: once per
    non-empty tensor stored below fp32 (AdamW re-quantizes it), and once
    per NSplit linear with an fp32 segment (the backward rounds the
    cotangent of its bf16 input through that segment's fp32 operand)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.core.layout import KSplitWeight, NSplitWeight
    from repro_torch.core.linear import MPLinear
    ksplit = nsplit = 0

    def visit(node):
        nonlocal ksplit, nsplit
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, MPLinear):
            if isinstance(node.w, KSplitWeight):
                ksplit += 1
            elif isinstance(node.w, NSplitWeight):
                nsplit += any(b.dtype == torch.float32 and b.numel()
                              for b in node.w.bufs)
    visit(params)
    low = sum(1 for t in TR.tensors(params)
              if t.dtype != torch.float32 and t.numel())
    return {"ksplit_gemm": ksplit, "convert": low + nsplit,
            "convert_backward": nsplit}


def check_step_launches(label: str, per_step: list, want: dict) -> None:
    """Gate (b): every step's launches of each kernel, read per step,
    equal the reckoning."""
    for key, n in want.items():
        got = [c[key] for c in per_step]
        if not got or any(g != n for g in got):
            fail(f"{label}: {key} launches per step {got}, not {n} in each")


def expert_grads_follow_kept(cfg, recorded: list, grads, label: str
                             ) -> dict:
    """Gate (e): in every MoE layer, the gradient of each expert's gate,
    up and down buffers is nonzero exactly where the routing kept a
    token for that expert.  ``recorded``: one forward's routing calls in
    layer order (``_record_routing``'s log).  Returns the experts with
    and without a kept token and the dropped pairs."""
    import torch
    layers = [i for i, (_, ffn) in enumerate(cfg.layer_kinds())
              if ffn == "moe"]
    if len(recorded) != len(layers):
        fail(f"{label}: {len(recorded)} routings for {len(layers)} MoE "
             "layers")
    with_tok = without = drops = 0
    for (*_, r), i in zip(recorded, layers):
        E = r.table.shape[0]
        kept = torch.bincount(r.flat_e[r.keep], minlength=E) > 0
        with_tok += int(kept.sum())
        without += int((~kept).sum())
        drops += int((~r.keep).sum())
        for name in ("gate", "up", "down"):
            w = grads["layers"][i]["moe"][name]
            nz = torch.zeros(E, dtype=torch.bool, device=kept.device)
            for t in (w.w_hi, w.w_lo):
                if t.numel():
                    nz |= t.reshape(E, -1).abs().amax(1) > 0
            if not torch.equal(nz, kept):
                bad = (nz != kept).nonzero().flatten().tolist()
                fail(f"{label}: layer {i} {name}: experts {bad} have a "
                     "gradient that does not follow their kept tokens")
    return {"experts_with_tokens": with_tok, "experts_without": without,
            "dropped_pairs": drops}


def aux_in_loss(params, cfg, batch, loss, metrics, label: str) -> dict:
    """Gate (e): the training loss minus the cross entropy of the same
    forward without grad equals AUX_WEIGHT times the aux loss (within the
    rounding of one fp32 addition at the loss's size), the aux is
    positive, and ``metrics["ce"]`` is the loss (the reference reports
    the sum under that name)."""
    import torch
    from repro_torch.models import common as C
    from repro_torch.models import transformer as T
    with torch.no_grad():
        x, aux = T._run_layers(params, cfg, batch)
        x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = C.cross_entropy(params["lm_head"](x), batch["labels"])
    loss, ce, aux = float(loss), float(ce), float(aux)
    term = AUX_WEIGHT * aux
    tol = float(np.finfo(np.float32).eps) * abs(loss)
    print(f"{label} (e): loss {loss:.7f} - ce without aux {ce:.7f} = "
          f"{loss - ce:.7e}; {AUX_WEIGHT} x aux {aux:.6f} = {term:.7e} "
          f"(within {tol:.2e}); metrics ce {float(metrics['ce']):.7f}")
    if not (aux > 0 and abs(loss - ce - term) <= tol and term > 100 * tol):
        fail(f"{label} (e): the loss is not ce + {AUX_WEIGHT} x aux")
    if float(metrics["ce"]) != loss or float(metrics["aux"]) != aux:
        fail(f"{label} (e): metrics ce/aux are not the loss and its aux")
    return {"ce": ce, "aux": aux, "loss": loss}


def cross_chunk_gate(params, cfg, x, label: str) -> dict:
    """Gate (d), for every layer whose mixer runs a chunked scan: with
    ``x`` [B, S, d] (the embedding output) as the layer's input, the
    mixer's output on the last chunk's positions alone must give a
    nonzero gradient at position 0, and on the first chunk's an exactly
    zero one at position S - 1.  Only the scan's carry joins positions a
    chunk apart (the causal conv spans 3)."""
    import torch
    from repro_torch.models import common as C
    from repro_torch.models import mamba as M
    from repro_torch.models import xlstm as X
    S = x.shape[1]
    moved, still, n = [], [], 0
    for i, (lp, (mixer, _)) in enumerate(zip(params["layers"],
                                             cfg.layer_kinds())):
        if mixer not in SCAN_CHUNK:
            continue
        chunk = SCAN_CHUNK[mixer]
        if S <= chunk:
            fail(f"{label} (d): S = {S} does not cross the {chunk}-position "
                 "chunk")

        def grad_at(sl, lp=lp, mixer=mixer):
            xx = x.detach().clone().requires_grad_(True)
            h = C.rms_norm(xx, lp["norm1"], cfg.norm_eps)
            out = (X.mlstm_block(lp["mlstm"], h, n_heads=cfg.n_heads)
                   if mixer == "mlstm" else M.mamba_block(lp["mamba"], h))
            (g,) = torch.autograd.grad(out[:, sl].float().square().mean(),
                                       [xx])
            return g

        first = float(grad_at(slice(S - chunk, S))[:, 0].float().abs().max())
        last = float(grad_at(slice(0, chunk))[:, -1].float().abs().max())
        moved.append(first)
        still.append(last)
        n += 1
        if not (first > 0 and last == 0):
            fail(f"{label} (d): layer {i} ({mixer}): the last chunk's loss "
                 f"moves position 0 by {first:.3e} (must be > 0), the "
                 f"first chunk's moves position {S - 1} by {last:.3e} "
                 "(must be 0)")
    if not n:
        fail(f"{label} (d): no layer runs a chunked scan")
    print(f"{label} (d): {n} scanned layers at S = {S}: the last chunk's "
          f"loss reaches position 0 with max|g| {min(moved):.3e} at least; "
          f"the first chunk's reaches position {S - 1} with max|g| "
          f"{max(still):g}")
    return {"layers": n, "min_moved": min(moved), "max_still": max(still)}


def family_train_cell(cfg, seq: int, nb: int, seed: int = 0) -> dict:
    """Train ``cfg`` (a config cut in depth only) on one card: gates (a) step 0 through the kernel against the plain version
    and a second plain order (an MoE's every run replays the kernel run's
    expert picks), (b) every forward KSplit linear on the kernel and each
    step's ksplit and convert launches equal to the reckoning with no
    fresh resolution, (c) FT_STEPS AdamW steps with a finite, falling
    loss, (d) the cross-chunk gradient of the scanned mixers, (e) an
    MoE's aux term in the loss and its experts' gradients; then the
    step's wall time, busy and idle share and peak memory."""
    import torch
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ksplit_gemm as K
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tune import dispatch
    t_cell = time.perf_counter()
    label = f"family train {cfg.name}"
    moe = any(ffn == "moe" for _, ffn in cfg.layer_kinds())
    scanned = any(mixer in SCAN_CHUNK for mixer, _ in cfg.layer_kinds())
    tokens = seq * nb
    free_card()
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    sync()
    sb = train_state_bytes(params)
    kinds = bytes_by_kind(params)
    want = step_launches(params)
    print(f"{label}: {cfg.n_layers} layers d="
          f"{cfg.d_model} vocab={cfg.vocab}, seq {seq} x batch {nb}; "
          f"{sb['params'] / 1e9:.3f}e9 parameters: weights "
          f"{sb['weights'] / 1e9:.3f} GB (" + ", ".join(
              f"{k} {v / 1e9:.3f}" for k, v in kinds.items())
          + f"), gradients {sb['grads'] / 1e9:.3f} GB, AdamW state "
          f"{sb['adamw'] / 1e9:.3f} GB: {sb['total'] / 1e9:.3f} GB before "
          f"activations; reckoned per step: {want}")
    batch = DP.make_batch(cfg, seq, nb, kind="train", seed=seed,
                          device=DEVICE)
    dispatch.warm_registry()
    dispatch.tune_linear_params(params, m_hint=tokens)
    fresh0 = dispatch.fresh_resolutions()

    # (a) and (b) at step 0: the kernel run, its routing recorded
    rec: list = []
    undo = _record_routing(rec) if moe else None
    lin0 = dispatch.dispatch_counts("linear")
    ops.reset_launch_counts()
    try:
        loss_k, m_k, g_k = loss_and_grads(params, cfg, batch)
        sync()
    finally:
        if undo:
            undo()
    step0 = ops.launch_counts()
    fresh_fwd = dispatch.fresh_resolutions() - fresh0
    lin = {p: v - lin0.get(p, 0)
           for p, v in dispatch.dispatch_counts("linear").items()}
    out: dict = {}
    if moe:
        out["aux"] = aux_in_loss(params, cfg, batch, loss_k, m_k, label)
        out["experts"] = expert_grads_follow_kept(cfg, rec, g_k,
                                                  f"{label} (e) full batch")
    flips: list = []
    kernel_fn = K.ksplit_gemm_multi
    undo = _replay_routing(rec, False, flips) if moe else None
    try:
        tok_k = token_losses(params, cfg, batch)
        K.ksplit_gemm_multi = K.ksplit_gemm_plain
        loss_p, _, g_p = loss_and_grads(params, cfg, batch)
        tok_p = token_losses(params, cfg, batch)
        K.ksplit_gemm_multi = ksplit_one_matmul
        _, _, g_a = loss_and_grads(params, cfg, batch)
        tok_a = token_losses(params, cfg, batch)
        sync()
    finally:
        K.ksplit_gemm_multi = kernel_fn
        if undo:
            undo()
    frob, worst, where = leaf_gaps(g_k, g_p)
    frob_a, worst_a, _ = leaf_gaps(g_a, g_p)
    tok_gap, tok_gap_a = rel_gap(tok_k, tok_p), rel_gap(tok_a, tok_p)
    del g_k, g_p, g_a, tok_k, tok_p, tok_a
    print(f"{label} (a) step 0: loss kernel {float(loss_k):.6f} plain "
          f"{float(loss_p):.6f}; per-token losses ||d||/||l|| kernel vs "
          f"plain {tok_gap:.2e}, two plain orders {tok_gap_a:.2e}; "
          f"gradients worst ||d||/||g|| {frob:.2e} (orders {frob_a:.2e}), "
          f"worst max|d|/max|g| {worst:.2e} at {where} (orders "
          f"{worst_a:.2e}); allowance {TRAIN_ORDER_RATIO:g}x the orders"
          + (f"; expert picks replayed from the kernel run, own picks "
             f"differing in {len(flips)} (token, layer) decisions"
             + (f" at top-k margins <= {max(flips):.3e}" if flips else "")
             if moe else ""))
    if not (np.isfinite(float(loss_k))
            and tok_gap <= TRAIN_ORDER_RATIO * tok_gap_a
            and frob <= TRAIN_ORDER_RATIO * frob_a):
        fail(f"{label} (a): step 0 through the kernel is off the plain "
             "version's")
    print(f"{label} (b) step 0: forward KSplit linears {lin}, launches "
          f"{step0}; fresh resolutions after setup {fresh_fwd}; gates (a) "
          f"done at {time.perf_counter() - t_cell:.1f} s")
    if (lin.get("ksplit_torch", 0)
            or lin.get("ksplit_cuda", 0) != want["ksplit_gemm"]
            or step0["ksplit_gemm"] != want["ksplit_gemm"]
            or step0["convert"] != want["convert_backward"] or fresh_fwd):
        fail(f"{label} (b): step 0 off its reckoning {want}")

    if moe:
        probe = {k: v[:1, :EXPERT_PROBE] for k, v in batch.items()}
        probe_rec: list = []
        undo = _record_routing(probe_rec)
        try:
            _, _, g = loss_and_grads(params, cfg, probe)
        finally:
            undo()
        out["probe"] = expert_grads_follow_kept(cfg, probe_rec, g,
                                                f"{label} (e) probe")
        del g
        print(f"{label} (e): full batch {out['experts']}; probe of "
              f"{EXPERT_PROBE} tokens {out['probe']}: every expert's "
              "gradient nonzero exactly where it kept a token")
    if scanned:
        x0, _ = T._embed_inputs(params, cfg, batch)
        out["cross_chunk"] = cross_chunk_gate(params, cfg, x0, label)
        del x0

    # (b) and (c): AdamW steps on the repeated batch, launches per step
    ocfg = adamw.AdamWConfig(lr_peak=FT_LR, warmup_steps=1,
                             total_steps=FT_STEPS)
    opt = adamw.init(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, 1, tune_params=params,
                              tune_tokens=tokens)
    fresh0 = dispatch.fresh_resolutions()
    losses, step_ms, per_step = [], [], []
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    for _ in range(FT_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        now = ops.launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    fresh = dispatch.fresh_resolutions() - fresh0
    steady = float(np.median(step_ms[1:]))
    t_prof = time.perf_counter()
    prof = profile_step(step_fn, params, opt, batch, steady)
    prof_s = time.perf_counter() - t_prof
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if DEVICE != "cpu"
               else 0.0)
    idle = (f"{1 - prof['busy_ms'] / steady:.1%}" if prof["busy_ms"]
            else "not measured")
    print(f"{label} (c) ({smi_line()}): losses "
          f"{[round(v, 4) for v in losses]}; step wall ms "
          f"{[round(v, 1) for v in step_ms]}, median of steps 1-"
          f"{FT_STEPS - 1} {steady:.1f} ms = {tokens / steady * 1e3:.1f} "
          f"tokens/s, idle share {idle}; ksplit launches per step "
          f"{[c['ksplit_gemm'] for c in per_step]}, convert "
          f"{[c['convert'] for c in per_step]}; fresh resolutions {fresh}; "
          f"peak memory {peak_gb:.2f} GB; the {PROFILE_STEPS} profiled "
          f"steps took {prof_s:.1f} s")
    check_step_launches(f"{label} (b)", per_step,
                        {k: want[k] for k in ("ksplit_gemm", "convert")})
    if fresh:
        fail(f"{label} (b): {fresh} fresh plan resolutions in the steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{label} (c): losses {losses} are not finite and falling")
    del params, opt, step_fn, batch
    free_card()
    cell_s = time.perf_counter() - t_cell
    print(f"{label}: {cell_s:.1f} s")
    return {"launches": step0["ksplit_gemm"] + sum(
                c["ksplit_gemm"] for c in per_step),
            "convert_launches": step0["convert"] + sum(
                c["convert"] for c in per_step),
            "per_step": want, "step_ms": steady,
            "tokens_per_s": tokens / steady * 1e3, "losses": losses,
            "peak_gb": peak_gb, "state_gb": sb["total"] / 1e9,
            "step0": {"tok_gap": tok_gap, "tok_gap_orders": tok_gap_a,
                      "frob": frob, "frob_orders": frob_a,
                      "flips": len(flips)},
            "cell_s": cell_s, **out, **prof}


def moe_variant_serve(cfg, seed: int = 0) -> dict:
    """Qwen1.5-MoE-A2.7B (``cfg``'s depth) on a fresh init: an
    ``int8_pt+fp32`` variant from ``quantize_params`` whose expert
    tensors are the default weights' own (same ``data_ptr``), and
    FT_SERVE_LENS requests through one equal-mode engine, the odd ones on
    the variant; each must equal ``generate_reference``."""
    import torch
    from repro_torch.core.formats import FormatSet, format_set
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant import ActStats, quantize_params
    from repro_torch.serve import Engine, Request, ServeConfig
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, L).astype(np.int64)
               for L in FT_SERVE_LENS]
    stats = ActStats()
    for p in prompts:
        stats.observe(params["embed"][torch.from_numpy(p).to(DEVICE)])
    fs = FormatSet.from_key(cfg.mp_formats)
    qset = format_set("int8_pt", fs.names[fs.high])
    tag = qset.key()
    qparams = quantize_params(params, stats, fset=qset,
                              ratio_high=QUANT_RATIO)
    shared = all(
        getattr(q["moe"][n], t).data_ptr() == getattr(d["moe"][n],
                                                      t).data_ptr()
        for q, d in zip(qparams["layers"], params["layers"])
        for n in ("gate", "up", "down") for t in ("w_hi", "w_lo"))
    eng = Engine(cfg, params, ServeConfig(max_batch=4, max_seq=FT_MAX_SEQ),
                 variants={tag: qparams})
    if eng.mode != "equal":
        fail(f"family serve {tag}: engine mode {eng.mode!r}, not equal")
    eng.warmup()

    def reqs():
        return [Request(p, max_new_tokens=FT_SERVE_NEW,
                        fset=("default", tag)[i % 2])
                for i, p in enumerate(prompts)]

    before = linear_counts_by_formats()
    ops.reset_launch_counts()
    got = eng.generate(reqs())
    sync()
    launches = ops.launch_counts()
    by_fmt = {f: {p: v - before.get(f, {}).get(p, 0) for p, v in c.items()
                  if v - before.get(f, {}).get(p, 0)}
              for f, c in linear_counts_by_formats().items()}
    st = eng.stats()
    refs = eng.generate_reference(reqs())
    bad = [i for i, (r, f) in enumerate(zip(got, refs))
           if not r.done or r.out_tokens != f.out_tokens
           or len(r.out_tokens) != FT_SERVE_NEW]
    buckets = {r.bucket.split("/", 1)[1] for r in got}
    fresh = st["plans"]["post_warmup_fresh_resolutions"]
    print(f"family serve {cfg.name} ({cfg.n_layers} layers): variant {tag} "
          f"shares every expert tensor with the default weights: {shared}; "
          f"{len(got)} requests (prompts {list(FT_SERVE_LENS)}, "
          f"{FT_SERVE_NEW} new, odd ones on {tag}) == unbatched reference "
          f"for {len(got) - len(bad)}; buckets {sorted(buckets)}; linear "
          f"dispatch by formats {by_fmt}; launches {launches}; dropped "
          f"pairs per microbatch {st['moe']['dropped_per_microbatch']}; "
          f"fresh resolutions {fresh}; {time.perf_counter() - t0:.1f} s")
    if not shared:
        fail(f"family serve {tag}: the variant copied expert tensors")
    if bad:
        fail(f"family serve {tag}: requests {bad} differ from their "
             "reference")
    if buckets != {"default", tag} or fresh:
        fail(f"family serve {tag}: buckets {buckets}, fresh {fresh}")
    if by_fmt.get(cfg.mp_formats, {}).get("ksplit_torch", 0) \
            or launches["ksplit_gemm"] < 1:
        fail(f"family serve {tag}: default-weight linears off the kernel")
    del eng, params, qparams
    free_card()
    return {"launches": launches["ksplit_gemm"], "requests": len(got)}


def family_train_phase(seed: int = 0) -> dict:
    """Phase 13: the three FT_CELLS trained on one card, then the MoE
    cell's depth served with its int8 variant."""
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    out = {name: family_train_cell(
        dataclasses.replace(get(name), n_layers=layers), seq, nb, seed)
        for name, layers, seq, nb in FT_CELLS}
    name, layers = FT_CELLS[0][:2]
    out["serve"] = moe_variant_serve(
        dataclasses.replace(get(name), n_layers=layers), seed)
    out["launches"] = sum(v["launches"] for v in out.values())
    out["convert_launches"] = sum(v.get("convert_launches", 0)
                                  for v in out.values()
                                  if isinstance(v, dict))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"family train: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: SUMMA on one card
# ---------------------------------------------------------------------------

#: SUMMA GEMM edge (M = N = K) and the grids of four ranks on the card
SUMMA_SIZE = 4096
SUMMA_GRIDS = ((2, 2), (1, 4), (4, 1))
#: A and B are sorted-balanced in 4 segments, which serves every grid
#: above and the 1x1 one; C is balanced in 4x4 groups
SUMMA_SEGMENTS = 4
#: the grid solves: phase 5's operator at n = 2048 (at phase 5's 8192 the
#: balanced ladder escalates 11 times, 12 replicated numpy factorizations
#: per solve: 121 / 128 / 169 s for the three solves, `summa_phase.py
#: 8192`; at 4096 15 / 15 / 35 s, cut to keep the run inside its time
#: limit), tile 128, balanced escalation, RHS padded to 256 columns, the
#: 2x2 grid's row extent as balance groups
SUMMA_SOLVE_N = 2048
SUMMA_NRHS_PAD = 256


def summa_parity(out, other, A, B, C, dense, beta=0.0) -> float:
    """Worst |out - other| over twice the registry-derived per-class
    bound times the fp64 error scale (the reference's ``_assert_parity``:
    each side carries its own rounding budget); ≤ 1 passes."""
    from repro_torch.core.accuracy import class_error_bounds, error_scale
    from repro_torch.core.layout import expand_map
    k = A.shape[1]
    bounds = class_error_bounds(A.cls, B.cls, C.cls, k, A.fset)
    scale = error_scale(*dense, beta)
    err = np.abs(out.to_dense().double().cpu().numpy()
                 - other.to_dense().double().cpu().numpy())
    sel = expand_map(C.cls, C.tile)
    worst = 0.0
    for cls, bound in bounds.items():
        m = sel == cls
        if m.any():
            worst = max(worst, float((err[m] / (2 * bound * scale[m]
                                                + 1e-6)).max()))
    return worst


def summa_operands(gen, size: int = SUMMA_SIZE):
    """A, B, C at ``size``, t = 128, the default format set, 50% D and
    25% Q: A and B sorted-balanced, C balanced; and their dense values."""
    import torch
    from repro_torch.core import schedule
    from repro_torch.core.formats import DEFAULT_FORMATS as FS
    from repro_torch.core.layout import MPMatrix
    from repro_torch.core.precision import Policy
    t, g = TILE, SUMMA_SEGMENTS
    mt = size // t
    pol = Policy(kind="ratio", ratio_high=0.5, ratio_low8=0.25, seed=8)
    maps = (schedule.sorted_balanced_map(mt, mt, pol, axis=0, groups=g,
                                         fset=FS),
            schedule.sorted_balanced_map(mt, mt, pol, axis=1, groups=g,
                                         fset=FS),
            schedule.balanced_ratio_map(mt, mt, pol, g, g, fset=FS))
    dense = [torch.randn((size, size), generator=gen, device=DEVICE)
             for _ in range(3)]
    mats = [MPMatrix.from_dense(d, p, t, FS) for d, p in zip(dense, maps)]
    return mats, [d.cpu().numpy() for d in dense]


def summa_panel(A, B, C, P, Q) -> dict:
    """The grouped kernel's accumulate-into launch at SUMMA's local shape
    on a PxQ grid: rank (0, 0)'s mloc x t x nloc update by k-panel 1,
    added to the fp32 sums of k-panel 0.  First the kernel is held
    against its plain version started from equal sums, within the fp32
    summation-order allowance 2·t·2^-24·(|A_panel|·|B_panel| + |sums|)
    (the outputs stay fp32: no storage rounding or quantization to allow
    for); then timed beside its plain version, torch.matmul bf16 and fp32
    (TF32 off) at that shape, and the bound (operations by C class;
    bytes: the panel's storage read once, the fp32 sums read and
    written)."""
    import torch
    from repro_torch.core.layout import CompactMPMatrix, fp32_matmul
    from repro_torch.core.precision import map_storage_bytes
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import mp_gemm_tile as MT
    t, fs = TILE, A.fset
    mloc, nloc = SUMMA_SIZE // P, SUMMA_SIZE // Q
    da, db = A.to_dense(), B.to_dense()

    def panel(k):
        cols = slice(k * t, (k + 1) * t)
        return (CompactMPMatrix.from_dense(
                    da[:mloc, cols], A.cls[:mloc // t, k:k + 1], t, fs),
                CompactMPMatrix.from_dense(
                    db[cols, :nloc], B.cls[k:k + 1, :nloc // t], t, fs))

    pc = np.ascontiguousarray(C.cls[:mloc // t, :nloc // t])
    counts = np.bincount(pc.reshape(-1), minlength=len(fs))
    sums = tuple(torch.zeros((int(n), t, t), device=DEVICE) for n in counts)
    GG.grouped_gemm_plain(*panel(0), pc, sums)
    ap, bp = panel(1)
    got, want = (tuple(x.clone() for x in sums) for _ in range(2))
    GG.grouped_mp_gemm(ap, bp, pc, acc=got)
    GG.grouped_gemm_plain(ap, bp, pc, want)
    sync()

    def dense(tiles):
        return CompactMPMatrix(tiles, pc, CompactMPMatrix.make_slots(pc),
                               t, (mloc, nloc), fs).padded_dense()

    allow = 2.0 * t * 2.0 ** -24 * (
        fp32_matmul(ap.padded_dense().abs(), bp.padded_dense().abs())
        + dense(sums).abs())
    err, ratio = MT.within(dense(got), dense(want), allow)
    shape = f"{mloc}x{t}x{nloc}"
    print(f"grouped SUMMA panel {P}x{Q} {shape} accumulate-into, kernel vs "
          f"plain from equal fp32 sums: max|kernel-plain| {err:.3e}, "
          f"worst/allowance {ratio:.3e} (2*t*2^-24*(|A||B| + |sums|))")
    if not ratio <= 1.0:
        fail(f"the grouped kernel's accumulate-into form at the {P}x{Q} "
             f"SUMMA panel {shape} is outside the fp32 order allowance")
    acc = got
    ms = time_ms(lambda: GG.grouped_mp_gemm(ap, bp, pc, acc=acc), iters=20)
    plain_ms = time_ms(lambda: GG.grouped_gemm_plain(ap, bp, pc, acc),
                       iters=5, hold=False)
    a32 = da[:mloc, t:2 * t].contiguous()
    b32 = db[t:2 * t, :nloc].contiguous()
    a16, b16 = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    lib16 = time_ms(lambda: torch.matmul(a16, b16), iters=20)
    lib32 = time_ms(lambda: torch.matmul(a32, b32), iters=20)
    nbytes = (map_storage_bytes(ap.cls, t, fs)
              + map_storage_bytes(bp.cls, t, fs) + 2 * mloc * nloc * 4)
    bound_ms, by = _bound(nbytes, _ops_bound_s(pc, t, t, fs))
    print(f"time grouped SUMMA panel {P}x{Q} {shape} (accumulate-into): "
          f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}, "
          f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, torch.matmul "
          f"bf16 {lib16:.4f} ms, fp32 (TF32 off) {lib32:.4f} ms "
          "(yardsticks: C mixes fp32 and bf16 compute classes)")
    return {"shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "matmul_bf16_ms": lib16, "matmul_fp32_ms": lib32}


def summa_phase(gen) -> dict:
    """SUMMA on one card: a 1x1 grid over nccl in this process (over gloo
    on the CPU), beside it four ranks spawned on the same card over gloo;
    :func:`summa_gemms`, then :func:`summa_solves`."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.grid import Grid
    t_phase = time.perf_counter()
    card, backend = ((DEVICE + ":0", "nccl") if DEVICE == "cuda"
                     else ("cpu", "gloo"))
    if DEVICE == "cuda":   # the ranks share the card with this process
        import torch
        torch.cuda.empty_cache()
    rdv = tempfile.mkdtemp(prefix="chip-smoke-rdv-")
    dist.init_process_group(backend, init_method=f"file://{rdv}/rdv",
                            world_size=1, rank=0)
    try:
        grid = Grid(1, 1, device=card, backend=backend)
        out = summa_gemms(gen, grid, card)
        sol = summa_solves(grid, card)
    finally:
        dist.destroy_process_group()
        for f in os.listdir(rdv):
            os.remove(os.path.join(rdv, f))
        os.rmdir(rdv)
    out["launches"] += sol.pop("launches")
    out.update(sol, phase_s=time.perf_counter() - t_phase)
    print(f"summa phase: {out['phase_s']:.1f} s")
    return out


def summa_gemms(gen, grid, card: str) -> dict:
    """(1) The 1x1 ``grid``: the grouped local path at SUMMA_SIZE³
    against the ref path and single-device mp_matmul (within twice the
    per-class bound), K/t grouped launches, and bit for bit the
    single-device grouped path, whose kernel is held to its plain
    version on these operands at the fp32 order allowance; (2) four ranks
    spawned on ``card`` over gloo run the 2x2, 1x4 and 4x1 grids on the
    same operands: each output equals the 1x1 output bit for bit, every
    rank launches the grouped kernel K/t times and moves
    summa_collective_bytes / 4 bytes (counted per slab in each rank and
    gathered); then the grouped kernel's
    accumulate-into launch at SUMMA's local shapes, checked against its
    plain version and timed (:func:`summa_panel`)."""
    import torch
    from repro_torch.core.summa import (summa_collective_bytes,
                                        summa_mp_gemm, summa_with_stats)
    from repro_torch.kernels import ops
    from repro_torch.launch.grid import call_all, run_on_grid
    from repro_torch.tune import dispatch as D
    from repro_torch.tune.costmodel import GemmPlan
    t, kt = TILE, SUMMA_SIZE // TILE
    grouped = GemmPlan(path="grouped", bm=t, bn=t, bk=t)
    ref = GemmPlan(path="ref", bm=t, bn=t, bk=t)
    (A, B, C), dense = summa_operands(gen)
    out = {"launches": 0}
    secs = []
    for _ in range(2):   # the first call also sets up the communicators
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        g11 = summa_mp_gemm(A, B, C, grid=grid, plan=grouped)
        sync()
        secs.append(time.perf_counter() - t0)
        n11 = ops.launch_counts()["grouped_gemm"]
        out["launches"] += n11
    r11 = summa_mp_gemm(A, B, C, grid=grid, plan=ref)
    single = D.mp_matmul(A, B, C)
    solo = D.execute_plan(grouped, A, B, zero_c(C))
    sync()
    vs_ref = summa_parity(g11, r11, A, B, C, dense)
    vs_single = summa_parity(g11, single, A, B, C, dense)
    same_solo = all(torch.equal(x, y) for x, y in zip(g11.bufs, solo.bufs))
    print(f"summa 1x1 {grid.backend} {SUMMA_SIZE}^3 t={t} (A, B "
          f"sorted-balanced in {SUMMA_SEGMENTS} segments, C balanced; "
          f"50D25S25Q): grouped {secs[0]:.3f} s first, {secs[1]:.3f} s "
          f"warm, {n11} grouped launches "
          f"(K/t = {kt}); worst |grouped - ref| / 2·bound {vs_ref:.3e}, vs "
          f"mp_matmul {vs_single:.3e}; bit for bit the single-device "
          f"grouped path: {same_solo}")
    if n11 != kt:
        fail(f"the 1x1 SUMMA launched the grouped kernel {n11} times, not "
             f"K/t = {kt}")
    if not (vs_ref <= 1.0 and vs_single <= 1.0):
        fail("the 1x1 SUMMA is outside twice the per-class bound")
    if not same_solo:
        fail("the 1x1 SUMMA (accumulate-into launches) differs from the "
             "single-device grouped path")
    err, ratio = kernel_vs_plain("grouped", A, B, zero_c(C))
    print(f"grouped {SUMMA_SIZE}^3 t={t} on the SUMMA operands (store "
          f"form): max|kernel-plain| {err:.3e}, worst/allowance "
          f"{ratio:.3e} (2*K*2^-24*|A||B| + one output rounding)")
    if not ratio <= 1.0:
        fail("the grouped kernel on the SUMMA operands is outside "
             "tolerance of its plain version")
    cpu = [dataclasses.replace(m, bufs=tuple(b.cpu() for b in m.bufs))
           for m in (A, B, C)]
    hi = float((A.cls == A.fset.high).mean())
    q8 = float((A.cls == A.fset.low8).mean())
    t0 = time.perf_counter()
    rows = run_on_grid(
        2, 2, call_all, [(summa_with_stats, cpu, {"plan": grouped}, s)
                         for s in SUMMA_GRIDS],
        device=card, backend="gloo")
    spawn_s = time.perf_counter() - t0
    for (P, Q), row in zip(SUMMA_GRIDS, rows):
        model = summa_collective_bytes(SUMMA_SIZE, SUMMA_SIZE, SUMMA_SIZE,
                                       t, P, Q, hi, q8, A.fset)
        per_rank = model["total_bytes"] / (P * Q)
        equal = all(torch.equal(x.cpu(), y.cpu()) for x, y in
                    zip(row["out"].bufs, g11.bufs))
        out["launches"] += sum(row["launches"])
        print(f"summa {row['grid']} gloo on one card: per rank launches "
              f"{row['launches']} (sum {sum(row['launches'])}), bytes "
              f"{row['bytes']} (model {per_rank:.0f} each), broadcasts "
              f"{row['broadcasts']}, seconds "
              f"{[round(v, 3) for v in row['seconds']]} of which broadcast "
              f"{[round(v, 3) for v in row['broadcast_seconds']]}; equal "
              f"to the 1x1 output bit for bit: {equal}")
        if not equal:
            fail(f"the {row['grid']} SUMMA differs from the 1x1 output")
        if any(n != kt for n in row["launches"]):
            fail(f"{row['grid']}: a rank launched the grouped kernel "
                 f"{row['launches']} times, not K/t = {kt} each")
        if any(b != per_rank for b in row["bytes"]):
            fail(f"{row['grid']}: wire bytes {row['bytes']} != the model's "
                 f"{per_rank} per rank")
    print(f"summa grids: {len(SUMMA_GRIDS)} grids in one spawn of 4 ranks, "
          f"{spawn_s:.1f} s")
    out["panel"] = {f"{P}x{Q}": summa_panel(A, B, C, P, Q)
                    for P, Q in ((1, 1), (2, 2))}
    return out


def summa_solves(grid, card: str) -> dict:
    """(3) Phase 5's operator (n = SUMMA_SOLVE_N, t = 128, tol
    SOLVE_TOL) with balanced escalation: single-device with the grouped
    residual path, on the 1x1 ``grid``, and on a 2x2 grid of ranks
    spawned on ``card`` over gloo (grouped local path).  Each converges
    within FORWARD_TOL with 0 fresh resolutions and 0 table rebuilds; the
    2x2 solve equals the 1x1-grid solve (invariant b) and the
    single-device grouped solve (invariant c) bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    a = graded_spd(SUMMA_SOLVE_N, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, nrhs=1, seed=1)
    common = dict(tile=TILE, ratio_high=0.0, ratio_low8=0.0, tol=SOLVE_TOL,
                  escalation="balanced", balance_groups=2,
                  nrhs_pad=SUMMA_NRHS_PAD)
    reps, walls = {}, {}
    t0 = time.perf_counter()
    reps["single"] = solve(a, b, SolveConfig(residual_path="grouped",
                                             **common), device=DEVICE)
    walls["single"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reps["1x1"] = solve(a, b, SolveConfig(summa_grid=(1, 1),
                                          local_path="grouped", **common),
                        device=DEVICE, grid=grid)
    walls["1x1"] = time.perf_counter() - t0
    launches = ops.launch_counts()["grouped_gemm"]
    t0 = time.perf_counter()
    reps["2x2"] = solve(a, b, SolveConfig(summa_grid=(2, 2),
                                          local_path="grouped", **common),
                        device=card, backend="gloo")
    walls["2x2"] = time.perf_counter() - t0
    for label, rep in reps.items():
        err = forward_error(rep.x, xt)
        share = rep.broadcast_seconds / max(rep.total_seconds, 1e-12)
        print(f"summa solve {label}: n={SUMMA_SOLVE_N} converged="
              f"{rep.converged} sweeps {rep.sweeps} escalations "
              f"{rep.escalations} factorizations {rep.factorizations} map "
              f"{' -> '.join(rep.ratio_history)}; forward err {err:.3g}; "
              f"wall {walls[label]:.2f} s (solve {rep.total_seconds:.2f} s, "
              f"GEMM {rep.gemm_seconds:.2f} s, factorizations "
              f"{rep.factor_seconds:.2f} s); broadcasts "
              f"{rep.broadcast_seconds:.3f} s = {share:.1%} of the solve, "
              f"{rep.broadcast_bytes} B (rank 0); fresh resolutions "
              f"{rep.fresh_resolutions}, table rebuilds "
              f"{rep.summa_recompiles}")
        if not (rep.converged and err <= FORWARD_TOL):
            fail(f"summa solve {label}: not converged within "
                 f"{FORWARD_TOL} ({rep.metric_history}, err {err:.3g})")
        if rep.fresh_resolutions or rep.summa_recompiles:
            fail(f"summa solve {label}: {rep.fresh_resolutions} fresh "
                 f"resolutions, {rep.summa_recompiles} table rebuilds")
    d, s1, one = reps["2x2"], reps["single"], reps["1x1"]
    same_b = (np.array_equal(d.x, one.x)
              and np.array_equal(d.final_map, one.final_map)
              and d.metric_history == one.metric_history)
    same_c = (np.array_equal(d.x, s1.x)
              and np.array_equal(d.final_map, s1.final_map)
              and d.metric_history == s1.metric_history)
    print(f"summa solve invariants: 2x2 == 1x1 grid bit for bit: {same_b}; "
          f"2x2 == single-device grouped bit for bit: {same_c} "
          f"(max|dx| / max|x| {forward_error(d.x, s1.x):.3g})")
    if not same_b:
        fail("the 2x2 solve differs from the 1x1-grid solve")
    if not same_c:
        fail("the 2x2 solve differs from the single-device grouped solve")
    return {"launches": launches, "walls": walls,
            "broadcast_share": d.broadcast_seconds / d.total_seconds}


# ---------------------------------------------------------------------------
# phase 14: the replica cluster, tracing and the measured autotuner
# ---------------------------------------------------------------------------

#: phase 14's cluster: replicas, new tokens, and the requests that sample
#: (temperature CLUSTER_TEMP; the rest are greedy) — a replica with
#: another rng_seed then changes tokens
CLUSTER_REPLICAS = 2
CLUSTER_NEW = 16
CLUSTER_SAMPLED = (1, 2, 5, 6)
CLUSTER_TEMP = 0.8
#: distinct span names a traced run must hold (the hygiene floor)
MIN_SPAN_TYPES = 4
#: the traced solve: phase 5's operator at this size (it escalates once)
TRACE_SOLVE_N = 2048
#: the traced SUMMA GEMM's size, on a 1x1 grid
TRACE_SUMMA_SIZE = 1024
#: the autotuned GEMMs at t = 128: (label, size, format set, D share);
#: the first has ref, tile and grouped candidates, the second ref and
#: split (its C holds split2 tiles)
AUTOTUNE_CASES = (("0D100S", 4096, "fp8_e4m3+bf16+fp32", 0.0),
                  ("split2 50D50S", 4096, "fp8_e4m3+bf16+split2_fp16", 0.5))
#: the decode batch the measured linear search tunes at
AUTOTUNE_M = 4


def cluster_requests(vocab: int, seed: int = 0) -> list:
    """Phase 4's eight prompt lengths, CLUSTER_NEW tokens each; the
    CLUSTER_SAMPLED ones sample under their own seeds."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = np.linspace(8, 96, 8).astype(int)
    prompts = [rng.integers(0, vocab, L).astype(np.int64) for L in lens]
    return [Request(p, max_new_tokens=CLUSTER_NEW,
                    temperature=CLUSTER_TEMP if i in CLUSTER_SAMPLED else 0.0,
                    seed=i)
            for i, p in enumerate(prompts)]


def served_run(server, reqs) -> tuple[float, dict]:
    """Warm ``server`` (an Engine or a Cluster), then serve ``reqs``
    counted from zero; returns (host seconds until every token is on the
    host, launch counts)."""
    from repro_torch.kernels import ops
    server.warmup()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    server.generate(reqs)
    sync()
    return time.perf_counter() - t0, ops.launch_counts()


def cluster_gate(label: str, reqs, want, st: dict) -> None:
    """Every request served with the single engine's tokens, bit for bit;
    every replica healthy and serving; none rejected; no fresh plan
    resolution after warmup."""
    bad = [i for i, (r, w) in enumerate(zip(reqs, want))
           if r.error or not r.done or r.out_tokens != w]
    if bad:
        fail(f"{label}: requests {bad} differ from one engine's tokens")
    per = [p["requests"]["served"] for p in st["per_replica"]]
    if st["healthy"] != st["replicas"] or min(per) < 1:
        fail(f"{label}: {st['healthy']}/{st['replicas']} healthy, served "
             f"per replica {per}")
    if st["requests"]["rejected"]:
        fail(f"{label}: {st['requests']['rejected']} requests rejected")
    if st["post_warmup_fresh_resolutions"] != 0:
        fail(f"{label}: {st['post_warmup_fresh_resolutions']} fresh plan "
             "resolutions after warmup")


def trace_gate(label: str, path: str, replicas: int | None = None,
               min_span_types: int = MIN_SPAN_TYPES) -> list:
    """The JSONL passes ``repro_torch.obs.hygiene`` with the span floor,
    its Chrome export parses back to the same events, and (for a cluster)
    ``serve.route`` names every replica.  Returns the events."""
    from repro_torch.obs import hygiene
    from repro_torch.obs.trace import export_chrome, read_events
    problems = hygiene.validate_trace(path, min_span_types=min_span_types)
    if problems:
        fail(f"{label}: trace fails hygiene: {problems[:5]}")
    events = read_events(path)
    with open(export_chrome(path)) as f:
        if json.load(f)["traceEvents"] != events:
            fail(f"{label}: the Chrome export differs from the JSONL")
    if replicas is not None:
        routed = {e["args"]["replica"] for e in events
                  if e["name"] == "serve.route"}
        if routed != set(range(replicas)):
            fail(f"{label}: serve.route names replicas {sorted(routed)}, "
                 f"not all {replicas}")
    return events


def span_summary(events) -> dict:
    """{span name: [count, summed host ms]} of a trace's complete spans."""
    out: dict = {}
    for e in events:
        if e["ph"] == "X":
            row = out.setdefault(e["name"], [0, 0.0])
            row[0] += 1
            row[1] = round(row[1] + e["dur"] / 1e3, 3)
    return dict(sorted(out.items()))


def cluster_phase_serve(cfg, seed: int, tmp: str) -> dict:
    """(a) one Engine and a Cluster of CLUSTER_REPLICAS on the same
    weights and requests; (b) the same cluster run traced."""
    import torch
    import repro_torch
    from repro_torch.models import transformer as T
    from repro_torch.serve import Cluster, Engine, ServeConfig
    from repro_torch.tune import dispatch as D
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = T.init_model(gen, cfg)
    one = Engine(cfg, params, ServeConfig())
    single = cluster_requests(cfg.vocab, seed)
    one_s, _ = served_run(one, single)
    want = [r.out_tokens for r in single]
    if any(r.error or not r.done for r in single):
        fail("cluster: the single engine did not serve every request")
    sc = ServeConfig(replicas=CLUSTER_REPLICAS)
    cl = Cluster(cfg, params, sc)
    reqs = cluster_requests(cfg.vocab, seed)
    lin0 = D.dispatch_counts("linear")
    cl_s, launches = served_run(cl, reqs)
    lin = {p: n - lin0.get(p, 0)
           for p, n in D.dispatch_counts("linear").items()}
    st = cl.stats()
    gen_toks = st["tokens"]["generated"]
    print(f"cluster {cfg.name}: {cfg.n_layers} layers, "
          f"{CLUSTER_REPLICAS} replicas sharing one parameter tree "
          f"({param_bytes(params) / 1e9:.3f} GB), ServeConfig defaults; "
          f"placement {[r.replica for r in reqs]}; served per replica "
          f"{[p['requests']['served'] for p in st['per_replica']]}; "
          f"decode steps per replica "
          f"{[p['decode_steps'] for p in st['per_replica']]}")
    print(f"cluster: {gen_toks} tokens in {cl_s:.3f} s = "
          f"{gen_toks / cl_s:.2f} tokens/s vs one engine "
          f"{sum(len(w) for w in want) / one_s:.2f} tokens/s "
          f"({one_s:.3f} s) on {smi_line()}; kernel launches {launches}; "
          f"linear dispatch {lin}")
    cluster_gate("cluster", reqs, want, st)
    if launches["ksplit_gemm"] < 1 or lin.get("ksplit_torch", 0):
        fail(f"cluster: KSplit linears off the kernel ({lin}, launches "
             f"{launches})")
    # (b) the same run traced
    path = os.path.join(tmp, "cluster.jsonl")
    traced = cluster_requests(cfg.vocab, seed)
    repro_torch.configure(obs_trace=path)
    try:
        tr_s, _ = served_run(Cluster(cfg, params, sc), traced)
    finally:
        repro_torch.configure(obs_trace=None)
    if [r.out_tokens for r in traced] != want:
        fail("cluster traced: tokens differ from the untraced run")
    events = trace_gate("cluster traced", path, CLUSTER_REPLICAS)
    print(f"cluster traced: wall {tr_s:.3f} s vs untraced {cl_s:.3f} s; "
          f"{len(events)} events; spans [count, host ms] "
          f"{span_summary(events)}")
    return {"launches": launches["ksplit_gemm"],
            "tokens_per_s": gen_toks / cl_s,
            "engine_tokens_per_s": sum(len(w) for w in want) / one_s,
            "traced_s": tr_s, "untraced_s": cl_s}


def cluster_phase_solve_summa(gen, tmp: str) -> dict:
    """(c) phase 5's operator at TRACE_SOLVE_N solved untraced and
    traced (equal reports), and one SUMMA GEMM traced on a 1x1 grid."""
    import tempfile

    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.core.summa import summa_mp_gemm
    from repro_torch.launch.grid import Grid
    from repro_torch.obs.trace import read_events
    from repro_torch.solve import (SolveConfig, graded_spd,
                                   rhs_for_solution, solve)
    a = graded_spd(TRACE_SOLVE_N, cond=1e4, rho=0.9, seed=0)
    xt, b = rhs_for_solution(a, nrhs=1, seed=1)
    cfg = SolveConfig(tile=TILE, ratio_high=0.0, ratio_low8=0.0,
                      tol=SOLVE_TOL)
    plain = solve(a, b, cfg, device=DEVICE)
    path = os.path.join(tmp, "solve.jsonl")
    obs.configure(enabled=True, trace_path=path)
    try:
        rep = solve(a, b, cfg, device=DEVICE)
    finally:
        obs.configure(enabled=False)
    same = ((rep.sweeps, rep.escalations, rep.promotions,
             forward_error(rep.x, xt))
            == (plain.sweeps, plain.escalations, plain.promotions,
                forward_error(plain.x, xt)))
    events = trace_gate("traced solve", path)
    names = {e["name"] for e in events}
    print(f"traced solve n={TRACE_SOLVE_N}: sweeps {rep.sweeps}, "
          f"escalations {rep.escalations}, forward err "
          f"{forward_error(rep.x, xt):.3g}, report equal to the untraced "
          f"run: {same}; {len(events)} events, spans [count, host ms] "
          f"{span_summary(events)}")
    if not same:
        fail("traced solve: its report differs from the untraced solve's")
    need = {"solve.run", "solve.factor", "solve.sweep", "solve.escalate"}
    if not need <= names:
        fail(f"traced solve: the trace lacks {sorted(need - names)}")
    # one SUMMA GEMM on a 1x1 grid in this process
    card, backend = ((DEVICE + ":0", "nccl") if DEVICE == "cuda"
                     else ("cpu", "gloo"))
    (A, B, C), _ = summa_operands(gen, TRACE_SUMMA_SIZE)
    rdv = tempfile.mkdtemp(prefix="chip-smoke-rdv-", dir=tmp)
    spath = os.path.join(tmp, "summa.jsonl")
    dist.init_process_group(backend, init_method=f"file://{rdv}/rdv",
                            world_size=1, rank=0)
    try:
        grid = Grid(1, 1, device=card, backend=backend)
        obs.configure(enabled=True, trace_path=spath)
        try:
            summa_mp_gemm(A, B, C, grid=grid)
            sync()
        finally:
            obs.configure(enabled=False)
    finally:
        dist.destroy_process_group()
    sev = read_events(spath)
    gemms = [e for e in sev if e["name"] == "summa.gemm"]
    panels = [e["args"]["step"] for e in sev if e["name"] == "summa.panel"]
    print(f"traced summa 1x1 at {TRACE_SUMMA_SIZE}^3: {len(gemms)} "
          f"summa.gemm span(s) ({gemms[0]['dur'] / 1e3 if gemms else 0:.3f} "
          f"host ms), {len(panels)} summa.panel events")
    if len(gemms) != 1 or panels != list(range(TRACE_SUMMA_SIZE // TILE)):
        fail(f"traced summa: {len(gemms)} summa.gemm spans, panel steps "
             f"{panels}")
    return {"solve_events": len(events)}


def cache_only_gate(label: str, fn):
    """Run ``fn()`` with a spy on ``tune.search.measure``; fail if any
    measurement happened.  Returns ``fn``'s result."""
    from repro_torch.tune import search as S
    calls = []
    real = S.measure

    def spy(f, **kw):
        calls.append(kw)
        return real(f, **kw)

    S.measure = spy
    try:
        out = fn()
    finally:
        S.measure = real
    if calls:
        fail(f"{label}: cache-only mode measured {len(calls)} time(s)")
    return out


def autotune_operands(gen, size, fkey, hi):
    """A, B, C at ``size``³, t = TILE, under ratio maps (``hi`` D, the
    rest the set's LOW); for a split set C's HIGH tiles are split."""
    return gemm_case(size, size, size, TILE, fkey, hi, 0.0, gen, seed0=41)


def cluster_phase_autotune(cfg, seed: int, tmp: str) -> dict:
    """(d) the measured search, in a child process whose
    REPRO_TORCH_TUNE_CACHE names a file of its own: the plans it measures
    and registers end with it, so no later phase routes by them.  The
    child (:func:`autotune_child`) prints its table and gates, and leaves
    its launches and rows in a JSON file read here."""
    out = os.path.join(tmp, "autotune_result.json")
    env = dict(os.environ)
    env["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    env.pop("REPRO_TORCH_TUNE_CACHE_ONLY", None)
    env.pop("REPRO_TORCH_OBS_TRACE", None)
    code = ("import sys, chip_smoke; chip_smoke.autotune_child("
            f"{DEVICE!r}, {cfg.name!r}, {cfg.n_layers}, {seed}, {out!r})")
    sys.stdout.flush()
    run = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                         timeout=600)
    if run.returncode != 0:
        fail(f"autotune: the measuring process exited {run.returncode}")
    with open(out) as f:
        return json.load(f)


def autotune_child(device: str, arch: str, n_layers: int, seed: int,
                   out: str) -> None:
    """Phase 14 (d) inside its own process: every KSplit signature of
    ``arch`` at ``n_layers`` (phase 14's weights, from ``seed``) at m =
    AUTOTUNE_M, and AUTOTUNE_CASES, measured into the process cache;
    every winner measured and the file clean under ``tune.hygiene``; then
    cache-only mode reads a copy of the file and resolves the same plans
    from it without one measurement.  Writes the launches and the
    candidate rows to ``out``."""
    global DEVICE
    DEVICE = device
    sys.path.insert(0, os.path.join(HERE, "src"))
    import shutil

    import torch
    import repro_torch
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tune import dispatch as D
    from repro_torch.tune import hygiene
    from repro_torch.tune import search as S
    from repro_torch.tune.device import detect_device
    cache_file = S.cache_path()
    cfg = dataclasses.replace(get(arch), n_layers=n_layers)
    params = T.init_model(torch.Generator(device=DEVICE).manual_seed(seed),
                          cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(1414)
    dev = detect_device(torch.device(DEVICE))
    cases = [(label, *autotune_operands(gen, size, fkey, hi))
             for label, size, fkey, hi in AUTOTUNE_CASES]
    # every problem's report, for the candidate table (this process only)
    reports = []
    real = S.autotune_problem

    def recording(prob, run_plan, **kw):
        plan, rep = real(prob, run_plan, **kw)
        reports.append((prob, kw.get("paths", D.PATHS), plan, rep))
        return plan, rep

    S.autotune_problem = recording
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    linear = D.tune_linear_params(params, m_hint=AUTOTUNE_M, measure=True)
    gemms = {label: S.autotune(*mats) for label, _fs, mats, _m in cases}
    sync()
    measured_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    S.autotune_problem = real
    rows = []
    for prob, _paths, plan, rep in reports:
        for c in rep.get("candidates", []):
            rows.append({"key": S.plan_key(dev, prob),
                         "path": c["plan"].split(":")[0],
                         "measured_us": c.get("measured_us"),
                         "predicted_us": c.get("predicted_us"),
                         "error": c.get("error"),
                         "won": c["plan"] == plan.key()})
    bad = [S.plan_key(dev, p) for p, _, _, r in reports
           if r["source"] != "measured"]
    print(f"autotune: {len(reports)} problems measured in "
          f"{measured_s:.2f} s ({len(linear)} linear signatures at "
          f"m={AUTOTUNE_M}, GEMMs {list(gemms)}); kernel launches "
          f"{launches}; on {smi_line()}")
    for r in rows:
        print(f"autotune row: {r['key']} path {r['path']}: measured "
              f"{r['measured_us']} us, predicted {r['predicted_us']} "
              f"us{' (winner)' if r['won'] else ''}"
              f"{' ERROR ' + r['error'] if r['error'] else ''}")
    if bad or len(reports) != len(linear) + len(cases):
        fail(f"autotune: winners not measured for {bad} "
             f"({len(reports)} problems)")
    problems = hygiene.validate_cache(cache_file)
    if problems:
        fail(f"autotune: the cache fails hygiene: {problems[:5]}")
    # cache-only: the same plans from a copy of the file, nothing measured
    copy = cache_file + ".copy.json"
    shutil.copy(cache_file, copy)
    repro_torch.configure(tune_cache=copy, tune_cache_only=True)
    D.clear_registry()
    again = cache_only_gate("autotune cache-only", lambda: (
        D.tune_linear_params(params, m_hint=AUTOTUNE_M, measure=True),
        {label: S.autotune(*mats) for label, _fs, mats, _m in cases}))
    D.clear_registry()
    sources = {S.plan_key(dev, prob): D.resolve_plan(prob, dev, paths)
               for prob, paths, _plan, _rep in reports}
    wrong = {k: src for k, (plan, src) in sources.items() if src != "cache"}
    if again != (linear, gemms) or wrong or any(
            sources[S.plan_key(dev, p)][0] != plan
            for p, _, plan, _ in reports):
        fail(f"autotune cache-only: plans or sources differ ({wrong})")
    print(f"autotune cache-only: {len(sources)} plans resolved from "
          f"the cache, 0 measurements; winners "
          f"{sorted({p.path for p in linear.values()})} (linear), "
          f"{ {k: v.path for k, v in gemms.items()} }")
    with open(out, "w") as f:
        json.dump({"launches": launches, "rows": rows,
                   "measured_s": measured_s}, f)
    sys.stdout.flush()


def cluster_phase_launchers(tmp: str) -> None:
    """(e) the serve and solve launchers as subprocesses, traced."""
    from repro_torch.obs import hygiene
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    runs = {
        "serve": ["repro_torch.launch.serve", "--smoke", "--replicas",
                  str(CLUSTER_REPLICAS)],
        "solve": ["repro_torch.launch.solve", "--n", "1024", "--tile",
                  str(TILE), "--tol", str(SOLVE_TOL)],
    }
    for label, argv in runs.items():
        path = os.path.join(tmp, f"launch_{label}.jsonl")
        cmd = [sys.executable, "-m", *argv, "--trace", path]
        if DEVICE != "cuda":
            cmd += ["--device", DEVICE]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
        tail = out.stdout.strip().splitlines()[-2:]
        print(f"launcher {label}: exit {out.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; {tail}")
        if out.returncode != 0:
            fail(f"launcher {label} exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        problems = hygiene.validate_trace(path,
                                          min_span_types=MIN_SPAN_TYPES)
        if problems:
            fail(f"launcher {label}: trace fails hygiene: {problems[:5]}")


def cluster_phase(cfg, seed: int = 0) -> dict:
    """Phase 14: (a) InternLM2-1.8B at published widths, ``cfg``'s depth,
    served by a Cluster of CLUSTER_REPLICAS and by one Engine: the same
    tokens; (b) the cluster traced; (c) a traced solve and SUMMA GEMM;
    (d) the measured search; (e) the launchers traced."""
    import shutil
    import tempfile

    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    gen = torch.Generator(device=DEVICE).manual_seed(1414)
    try:
        out = cluster_phase_serve(cfg, seed, tmp)
        out.update(cluster_phase_solve_summa(gen, tmp))
        free_card()
        out["autotune"] = cluster_phase_autotune(cfg, seed, tmp)
        cluster_phase_launchers(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


#: phase 15's mesh: a miniature of make_production_mesh(multi_pod=True)
MESH_SHAPE = (2, 1, 2)
MESH_AXES = ("pod", "data", "model")
#: Qwen1.5-MoE-A2.7B's depth under the mesh, and the tokens per pod
MESH_QWEN_LAYERS = 2
MESH_SEQ = 256
#: Phi-3.5-MoE's block alone: tokens per pod
MESH_PHI_TOKENS = 256
#: InternLM2-1.8B's depth for the gradient tree and the re-mesh
MESH_ILM_LAYERS = 2
#: the meshed forward's allowance: this many times the gap one extra bf16
#: rounding of each MoE layer's expert sum makes (the sharded sum rounds
#: three times at tp = 2 where that variant rounds once)
MESH_ROUNDINGS = 3.0


def mesh_phase(seed: int = 0) -> dict:
    """Phase 15: one spawn of four ranks on the card over gloo, the mesh
    (pod=2, data=1, model=2); every call in that spawn
    (``launch.mesh_checks``; every gate raises here):

    (a) Qwen1.5-MoE-A2.7B at published widths, MESH_QWEN_LAYERS deep,
    the prefill (``forward_prefill``'s one pass of the layers, keeping the
    hidden states) of one seeded MESH_SEQ-token sequence per pod under
    ``hints_enabled(mesh)`` (60 % 2 experts: the non-EP, d_ff-sharded
    path) against the unmeshed forward of that pod's sequence on the same
    card: layer 0's kept (token, expert) pairs equal exactly, the
    last-position logits and the final hidden states within
    MESH_ROUNDINGS times the gap of one extra bf16 rounding per MoE layer
    (floored at one bf16 rounding of the largest value), the ksplit
    kernel launched for every KSplit linear of the meshed prefill in every
    rank; Phi-3.5-MoE's MoE block alone (16 experts: the EP path) against
    ``moe_block`` on the same tokens within the elementwise rounding
    allowance; the gloo collectives' ms and bytes per MoE block printed.
    (b) ``cross_pod_mean`` over "pod" on InternLM2-1.8B's gradient tree at
    published widths, MESH_ILM_LAYERS deep plus embed and lm_head, drawn
    per pod: every rank's result bit for bit the mean over pods of the
    compressed trees computed on the rank, and its err bit for bit
    ``compress``'s residual; the all-reduce's seconds and GB printed.
    (c) the same tree's parameters sharded by ``param_specs`` on the mesh
    and saved collectively: the manifest hash and leaves equal a
    single-process save's; restored onto (data=4, model=1) by one
    Shard(0) sharding and onto ``shrink_mesh_shape``'s (2, 1) on ranks
    0-1: every local shard bit for bit its slice of the logical array."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get
    from repro_torch.launch import mesh_checks as MC
    from repro_torch.launch.grid import call_all
    from repro_torch.launch.mesh import run_on_mesh
    t_phase = time.perf_counter()
    card = DEVICE + ":0" if DEVICE == "cuda" else "cpu"
    if DEVICE == "cuda":   # the ranks share the card with this process
        torch.cuda.empty_cache()
    qwen = dataclasses.replace(get("qwen2-moe-a2.7b"),
                               n_layers=MESH_QWEN_LAYERS)
    phi = get("phi3.5-moe-42b-a6.6b")
    ilm = dataclasses.replace(get("internlm2-1.8b"), n_layers=MESH_ILM_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-remesh-")
    try:
        pre, blk, cpm, rem = run_on_mesh(
            MESH_SHAPE, MESH_AXES, call_all, [
                (MC.prefill_mesh_check, (qwen, seed, MESH_SEQ), {}),
                (MC.moe_block_check, (phi, seed, MESH_PHI_TOKENS), {}),
                (MC.cross_pod_check, (ilm, seed), {}),
                (MC.remesh_check, (ilm, seed, tmp), {})],
            device=card, backend="gloo")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spawn_s = time.perf_counter() - t_phase
    # (a) the sharded MoE inside Qwen's prefill
    want = ksplit_linears(qwen, False) + sum(
        (2 if qwen.gated_mlp else 1) for _, f in qwen.layer_kinds()
        if f == "moe" and qwen.n_shared)
    per_block = {}
    for r in pre:
        c, n = r["comm"], r["moe_layers"]
        per_block[r["rank"]] = (
            1e3 * sum(c["seconds"].values()) / n,
            sum(c["bytes"].values()) / n)
        allow = max(MESH_ROUNDINGS * r["logits_gap_extra"],
                    2.0 ** -8 * r["logits_max"])
        allow_h = max(MESH_ROUNDINGS * r["hidden_gap_extra"],
                      2.0 ** -8 * r["hidden_max"])
        print(f"mesh (a) rank {r['rank']}: layer 0 kept pairs equal "
              f"{r['layer0_kept_equal']} ({r['layer0_kept']} kept, "
              f"{r['layer0_dropped']} dropped), logits gap "
              f"{r['logits_gap']:.4e} (one extra rounding "
              f"{r['logits_gap_extra']:.4e}, allowance {allow:.4e}), hidden "
              f"gap {r['hidden_gap']:.4e} (extra {r['hidden_gap_extra']:.4e},"
              f" allowance {allow_h:.4e}), later-layer picks replayed that "
              f"would differ {r['replayed_flips']}, ksplit launches "
              f"{r['launches']} (want {want}), meshed prefill "
              f"{r['seconds']:.3f} s, gloo per MoE block "
              f"{per_block[r['rank']][0]:.2f} ms "
              f"{per_block[r['rank']][1] / 1e6:.2f} MB "
              f"({json.dumps(c['calls'])})")
        if not (r["layer0_kept_equal"] and r["finite"]
                and r["shape"] == [1, 1, qwen.vocab]):
            fail(f"mesh (a) rank {r['rank']}: layer 0's kept pairs differ "
                 "or the logits are not finite of the expected shape")
        if not (r["logits_gap"] <= allow and r["hidden_gap"] <= allow_h):
            fail(f"mesh (a) rank {r['rank']}: the meshed prefill is outside "
                 "its allowance of the unmeshed one")
        if r["launches"] != want:
            fail(f"mesh (a) rank {r['rank']}: {r['launches']} ksplit "
                 f"launches in the meshed prefill, not {want}")
    for r in blk:
        c = r["comm"]
        print(f"mesh (a) phi3.5 EP block rank {r['rank']}: max err "
              f"{r['max_err']:.4e}, worst / allowance {r['worst_ratio']:.4f}"
              f", bit equal {r['bit_equal']}, {r['seconds'] * 1e3:.2f} ms, "
              f"gloo {1e3 * sum(c['seconds'].values()):.2f} ms "
              f"{sum(c['bytes'].values()) / 1e6:.2f} MB")
        if not r["worst_ratio"] <= 1.0:
            fail(f"mesh (a) rank {r['rank']}: the EP block is outside its "
                 "rounding allowance of moe_block")
    # (b) cross_pod_mean
    for r in cpm:
        c = r["comm"]
        print(f"mesh (b) rank {r['rank']} pod {r['pod']}: equal "
              f"{r['equal']}, err equal {r['err_equal']}, {r['tensors']} "
              f"tensors, {r['seconds']:.3f} s, all-reduced "
              f"{c['bytes'].get('cross_pod', 0) / 1e9:.3f} GB (fp32) in "
              f"{c['seconds'].get('cross_pod', 0.0):.3f} s")
        if not (r["equal"] and r["err_equal"]):
            fail(f"mesh (b) rank {r['rank']}: cross_pod_mean differs from "
                 "the mean of the compressed trees, or err from compress's")
    # (c) elastic re-mesh
    if not (rem[0].get("hash_equal") and rem[0].get("leaves_equal")):
        fail("mesh (c): the sharded save's manifest differs from a "
             "single-process save's")
    for r in rem:
        print(f"mesh (c) rank {r['rank']}: save {r['save_s']:.2f} s "
              f"({r['sharded_leaves']} sharded tensors, received "
              f"{r['comm']['bytes'].get('gather', 0) / 1e6:.1f} MB), remesh "
              f"{r['remesh']}, shrink {r['shrink']}")
        if not r["remesh"]["equal"]:
            fail(f"mesh (c) rank {r['rank']}: a restored shard differs")
        if (r["shrink"] is not None) != (r["rank"] < 2) or (
                r["shrink"] is not None and not r["shrink"]["equal"]):
            fail(f"mesh (c) rank {r['rank']}: the shrunk restore is wrong")
    out = {"launches": sum(r["launches"] for r in pre),
           "per_block_ms": max(v[0] for v in per_block.values()),
           "per_block_mb": max(v[1] for v in per_block.values()) / 1e6,
           "cross_pod_s": max(r["comm"]["seconds"].get("cross_pod", 0.0)
                              for r in cpm),
           "cross_pod_gb": cpm[0]["comm"]["bytes"].get("cross_pod", 0)
           / 1e9, "spawn_s": spawn_s,
           "phase_s": time.perf_counter() - t_phase}
    print(f"mesh phase: one spawn of 4 ranks {spawn_s:.1f} s")
    return out


def ptxas_rows(log: str) -> list[str]:
    """One 'kernel<t>: registers, spill stores/loads' line per entry
    function of a ptxas -v report."""
    import re
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # a template kernel's mangled name: ...<length><name>ILi<t>E
            name, spill = m.group(1)[:60], ""
            k = re.search(r"ILi(\d+)E", m.group(1))
            head = m.group(1)[:k.start()] if k else ""
            for n in range(1, len(head)):
                if head[:-n].endswith(str(n)) and not head[-n].isdigit():
                    name = f"{head[-n:]}<{k.group(1)}>"
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return rows


def check_sass(libs: dict) -> dict:
    """The tile, grouped and split libraries must hold wgmma: HGMMA
    instructions in their SASS (``cuobjdump -sass``).  Returns name ->
    count."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    for name in ("mp_gemm_tile", "grouped_gemm", "split_gemm"):
        sass = subprocess.run([tool, "-sass", libs[name]],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts[name] = sass.count("HGMMA")
        print(f"sass {name}: {counts[name]} HGMMA instructions")
        if not counts[name]:
            fail(f"the {name} library has no HGMMA (wgmma) instruction")
    return counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.core.precision import Policy
    except ImportError as e:
        fail(f"the repro_torch package is not next to this script ({e})")
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    from repro_torch.tune.device import detect_device
    spec = detect_device(torch.device(DEVICE)).kind
    print(f"device spec: {spec} (compute capability "
          f"{torch.cuda.get_device_capability(0)})")
    if spec != "gpu-h100":
        fail(f"dispatch resolved the spec {spec!r}, not 'gpu-h100': the "
             "kernels would not run")

    secs = {}

    def run(label, fn, *args):
        """``fn(*args)``, its seconds printed and kept by ``label``."""
        t = time.perf_counter()
        out = fn(*args)
        secs[label] = round(time.perf_counter() - t, 1)
        print(f"phase {label}: {secs[label]:.1f} s")
        return out

    libs = run("1 build", ops.ensure_built)
    for name, info in _build.BUILD_INFO.items():
        print(f"build {name}: " + " | ".join(ptxas_rows(info["log"])))
    check_sass(libs)

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    policy = Policy(kind="ratio", ratio_high=0.5)   # InternLM2's default
    t0 = time.perf_counter()
    ks_err = check_ksplit(gen, policy)
    tile_err = check_tile(gen)
    gr_err = check_grouped(gen)
    edge_err = check_edges(gen)
    split_err = check_split(gen)
    check_split_order(gen)
    cv_err = check_convert(gen)
    da_err = check_decode_attention()
    secs["2 kernels vs plain"] = round(time.perf_counter() - t0, 1)
    print(f"phase 2 kernels vs plain: {secs['2 kernels vs plain']:.1f} s")
    run("3 mp_matmul", lambda: (check_mp_matmul(gen),
                                check_mp_matmul_split(gen)))
    from repro_torch.configs import get
    cfg = get("internlm2-1.8b")
    sv = run("4 serve", serve, cfg)
    ss = run("4b serve state", serve_state,
             dataclasses.replace(cfg, n_layers=STATE_LAYERS))
    sq = run("4c serve quant", serve_quant,
             dataclasses.replace(cfg, n_layers=QUANT_LAYERS))
    sm9 = run("9a serve moe", serve_moe, dataclasses.replace(
        get("qwen2-moe-a2.7b"), n_layers=MOE_LAYERS))
    sw9 = run("9b serve gemma3", serve_windowed, dataclasses.replace(
        get("gemma3-4b"), n_layers=GEMMA_LAYERS))
    sx10 = run("10 serve xlstm", serve_xlstm, dataclasses.replace(
        get("xlstm-1.3b"), n_layers=XLSTM_LAYERS))
    sj11 = run("11 serve jamba period", serve_jamba_period,
               dataclasses.replace(get("jamba-v0.1-52b"),
                                   n_layers=JAMBA_LAYERS))
    sf12 = run("12 frontends", frontends_phase)
    sf13 = run("13 family train", family_train_phase)
    sol = run("5 solve", solve_phase)
    run("5 parity", parity_phase)
    tr = run("7 train", train_phase,
             dataclasses.replace(cfg, n_layers=TRAIN_LAYERS))
    sm = run("8 summa", summa_phase,
             torch.Generator(device=DEVICE).manual_seed(88))
    ms15 = run("15 mesh", mesh_phase)
    cl14 = run("14 cluster, trace, autotune", cluster_phase,
               dataclasses.replace(cfg, n_layers=STATE_LAYERS))
    at14 = cl14["autotune"]["launches"]
    t0 = time.perf_counter()
    ks_rows = time_ksplit(gen, policy)
    tg = time_tile_grouped(gen)
    sp = time_split(gen)
    cv = time_convert(gen)
    da = time_decode_attention()
    secs["6 timings"] = round(time.perf_counter() - t0, 1)
    print(f"phase 6 timings: {secs['6 timings']:.1f} s")

    main_row = next(r for r in ks_rows if (r["m"], r["n"]) == (4, 8192))
    kernels = [
        {"name": "ksplit_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/ksplit_gemm.cu",
         "replaces": "src/repro/kernels/ksplit_gemm.py:97",
         "launches": (sv["launches"] + ss["launches"] + sq["launches"]
                      + tr["launches"] + sm9["launches"]
                      + sm9["launches16"] + sw9["launches"]
                      + sx10["launches"] + sj11["launches"]
                      + sf12["launches"] + sf13["launches"]
                      + cl14["launches"] + at14["ksplit_gemm"]
                      + ms15["launches"]),
         "launches_by_phase": {"serve": sv["launches"],
                               "serve_state": ss["launches"],
                               "serve_quant": sq["launches"],
                               "train": tr["launches"],
                               "serve_moe": sm9["launches"],
                               "serve_moe_cf16": sm9["launches16"],
                               "serve_gemma3": sw9["launches"],
                               "serve_xlstm": sx10["launches"],
                               "serve_jamba_period": sj11["launches"],
                               "serve_frontends": sf12["launches"],
                               "family_train": sf13["launches"],
                               "cluster": cl14["launches"],
                               "autotune": at14["ksplit_gemm"],
                               "mesh": ms15["launches"]},
         "max_abs_err": max(ks_err.values()),
         **{key: main_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
         # phase 12's shapes: the 405B up/gate at decode, the bulk
         # LLaVA up/gate and HuBERT up
         "phase12_rows": [
             {key: r[key] for key in ("m", "k", "n", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
             for r in ks_rows if (r["m"], r["k"], r["n"]) in KSPLIT_TIMED]},
        {"name": "mp_gemm_tile", "route": "cuda",
         "source": "src/repro_torch/csrc/mp_gemm_tile.cu",
         "replaces": "src/repro/kernels/mp_gemm_tile.py:121",
         "launches": sol["store"]["launches"] + at14["mp_gemm_tile"],
         "launches_by_phase": {"solve": sol["store"]["launches"],
                               "autotune": at14["mp_gemm_tile"]},
         "max_abs_err": max(*tile_err.values(), *(
             v for (path, _, _), v in edge_err.items() if path == "tile")),
         **tg[("tile", "4096^3", "0D100S")]},
        {"name": "split_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/split_gemm.cu",
         "replaces": "src/repro/kernels/split_gemm.py:117",
         "launches": sol["split"]["launches"] + at14["split_gemm"],
         "launches_by_phase": {"solve": sol["split"]["launches"],
                               "autotune": at14["split_gemm"]},
         "max_abs_err": max(v for key, v in split_err.items()
                            if key[0] != "slices"),
         **sp[SPLIT_TIMES[0][0]]},
        # the split kernel's slice pass, run before each GEMM at t >= 64
        {"name": "split_slices", "route": "cuda",
         "source": "src/repro_torch/csrc/split_gemm.cu",
         "replaces": "src/repro/kernels/split_gemm.py:117",
         "launches": sol["split"]["prep_launches"],
         "max_abs_err": max(v for key, v in split_err.items()
                            if key[0] == "slices"),
         **sp["slice pass"]},
        # launches: the grouped solve's, and phase 8's SUMMA local
        # updates (the 1x1 GEMM, each rank of the three 4-rank grids, the
        # 1x1-grid solve); summa_panel: one accumulate-into launch at
        # SUMMA's local shape
        {"name": "grouped_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_gemm.cu",
         "replaces": "src/repro/kernels/grouped_gemm.py:119",
         "launches": (sol["grouped"]["launches"] + sm["launches"]
                      + at14["grouped_gemm"]),
         "launches_by_phase": {"solve": sol["grouped"]["launches"],
                               "summa": sm["launches"],
                               "autotune": at14["grouped_gemm"]},
         "summa_panel": sm["panel"],
         "max_abs_err": max(*gr_err.values(), *(
             v for (path, _, _), v in edge_err.items() if path == "grouped")),
         **tg[("grouped", "4096^3", "0D100S")]},
        # the layouts' storage casts on the card: every solve's operands
        # (the class-map form) and the grouped path's compact tiles (the
        # plain form); ms etc. are the plain form's 8192² -> bf16, the
        # "class_map ..." rows the class-map form's
        {"name": "convert", "route": "cuda",
         "source": "src/repro_torch/csrc/convert.cu",
         "replaces": "src/repro/kernels/convert.py:23",
         "launches": (sum(v["convert_launches"] + v["class_launches"]
                          for v in sol.values())
                      + sq["convert_launches"] + tr["convert_launches"]
                      + sf12["convert_launches"]
                      + sf13["convert_launches"] + at14["convert"]),
         "launches_by_form": {
             "convert": sum(v["convert_launches"] for v in sol.values()),
             "convert_by_class": sum(v["class_launches"]
                                     for v in sol.values())},
         "launches_by_phase": {
             "solve": sum(v["convert_launches"] + v["class_launches"]
                          for v in sol.values()),
             "serve_quant": sq["convert_launches"],
             "train": tr["convert_launches"],
             "serve_frontends": sf12["convert_launches"],
             "family_train": sf13["convert_launches"],
             "autotune": at14["convert"]},
         "max_abs_err": max(cv_err.values()), **cv},
        # replaces no Pallas kernel (the reference's decode attention is
        # plain jnp); timed at .chat's step with every row at position 511
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": None,
         "launches": sv["attn_launches"],
         "launches_by_phase": {"serve": sv["attn_launches"]},
         "max_abs_err_over_max_v": max(da_err.values()),
         **da[DECODE_ATTN_POSITIONS[-1]]},
    ]
    train_row = next(r for r in ks_rows
                     if (r["m"], r["n"]) == (TRAIN_SEQ * TRAIN_BATCH, 8192))
    hb, lv, ll = sf12["hubert"], sf12["llava"], sf12["llama405"]
    print(f"serve tokens/s {sv['tokens_per_s']:.2f}; ksplit launches per "
          f"model step {sv['launches_per_step']:.1f}; serve state tokens/s "
          f"{ss['tokens_per_s']:.2f} (phase {ss['phase_s']:.1f} s); serve "
          f"quant tokens/s {sq['tokens_per_s']:.2f}, bytes_vs_fp32 "
          f"{sq['bytes_vs_fp32']:.4f} (phase {sq['phase_s']:.1f} s); train "
          f"step {tr['step_ms']:.1f} ms = {tr['tokens_per_s']:.1f} tokens/s, "
          f"peak {tr['peak_gb']:.2f} GB (phase {tr['phase_s']:.1f} s); "
          f"ksplit at m={train_row['m']} N=8192 {train_row['ms']:.4f} ms "
          f"(bound {train_row['bound_ms']:.4f}, torch.matmul "
          f"{train_row['library_ms']:.4f}); summa phase {sm['phase_s']:.1f} "
          f"s, grid solves {[round(v, 2) for v in sm['walls'].values()]} s "
          f"(single, 1x1, 2x2), 2x2 broadcast share "
          f"{sm['broadcast_share']:.1%}; serve moe {sm9['tokens_per_s']:.2f} "
          f"tokens/s, decode step {sm9['wall_ms']:.2f} ms (byte bound "
          f"{sm9['bound_ms']:.2f} ms), peak {sm9['peak_gb']:.2f} GB (phase "
          f"{sm9['phase_s']:.1f} s); serve gemma3 {sw9['tokens_per_s']:.2f} "
          f"tokens/s (phase {sw9['phase_s']:.1f} s); serve xlstm "
          f"{sx10['tokens_per_s']:.2f} tokens/s, decode step "
          f"{sx10['wall_ms']:.2f} ms (byte bound {sx10['bound_ms']:.2f} ms), "
          f"peak {sx10['peak_gb']:.2f} GB (phase {sx10['phase_s']:.1f} s); "
          f"serve jamba period {sj11['tokens_per_s']:.2f} tokens/s, decode "
          f"step {sj11['wall_ms']:.2f} ms (byte bound {sj11['bound_ms']:.2f} "
          f"ms), peak {sj11['peak_gb']:.2f} GB (phase {sj11['phase_s']:.1f} "
          f"s); hubert encoder pass {hb['encoder_ms']:.1f} ms, train step "
          f"{hb['step_ms']:.1f} ms, peak {hb['peak_gb']:.2f} GB; llava "
          f"prefill {lv['prefill_ms']:.1f} ms, serve "
          f"{lv['tokens_per_s']:.2f} tokens/s, decode step "
          f"{lv['wall_ms']:.2f} ms (byte bound {lv['bound_ms']:.2f} ms), "
          f"peak {lv['peak_gb']:.2f} GB; "
          f"llama405 decode step {ll['wall_ms']:.2f} ms (byte bound "
          f"{ll['bound_ms']:.2f} ms), {ll['tokens_per_s']:.2f} tokens/s, "
          f"peak {ll['peak_gb']:.2f} GB (phase 12 {sf12['phase_s']:.1f} s); "
          + "; ".join(
              f"{name} train step {sf13[name]['step_ms']:.1f} ms, peak "
              f"{sf13[name]['peak_gb']:.2f} GB" for name, *_ in FT_CELLS)
          + f" (phase 13 {sf13['phase_s']:.1f} s); cluster "
          f"{cl14['tokens_per_s']:.2f} tokens/s vs one engine "
          f"{cl14['engine_tokens_per_s']:.2f}, traced wall "
          f"{cl14['traced_s']:.2f} s vs {cl14['untraced_s']:.2f} s (phase 14 "
          f"{cl14['phase_s']:.1f} s); mesh gloo per MoE block "
          f"{ms15['per_block_ms']:.2f} ms {ms15['per_block_mb']:.2f} MB, "
          f"cross_pod_mean {ms15['cross_pod_gb']:.3f} GB in "
          f"{ms15['cross_pod_s']:.3f} s (phase 15 {ms15['phase_s']:.1f} s); "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(f"phase seconds: {json.dumps(secs)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
