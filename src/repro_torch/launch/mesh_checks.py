"""Rank-side checks of the mesh layer (``launch.mesh``, ``launch.sharding``,
``models.moe.moe_block_sharded``, ``optim.grad_compress.cross_pod_mean``,
``checkpoint.ckpt``'s re-meshing restore).

Each function runs on every rank of a spawned mesh
(``launch.mesh.run_on_mesh`` + ``launch.grid.call_all``, as ``fn(...,
mesh=mesh)``), draws or slices its own inputs, and returns what every
rank saw (gathered to all ranks with ``all_gather_object``), so the
caller reads every rank's numbers from rank 0's result.  ``chip_smoke.py``
(phase 15) runs them at published widths on one card and applies its
gates to what they return; the CPU tests run them at reduced size and
hold the results to the JAX package.

Bounds (returned, gated by the caller):

* the sharded MoE rounds each rank's fp32 partial to bf16 and their sum
  to bf16 before the shared expert is added, where ``moe_block`` rounds
  once.  :func:`moe_block_check` returns the elementwise allowance
  ``2^-8·(2·A + |y_sharded| + |y|)`` (A: the sum of the magnitudes of
  the token's weighted expert contributions, which bounds every partial
  and their sum), plus the fp32 summation-order term of the expert
  products, ``2^-22·A``;
* a whole forward compares with the gap one extra bf16 rounding of each
  MoE layer's expert sum (before the shared expert) makes in the unmeshed
  forward (:func:`prefill_mesh_check`): the sharded sum rounds three
  times at tp = 2 (two partials and their sum) where that variant
  rounds once.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from repro_torch import tree as TR
from repro_torch.launch import mesh as MS


def _all(obj) -> list:
    """``obj`` of every rank of the default group, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _data_ways(mesh) -> tuple[int, int]:
    """(data shards, this rank's shard index) over the data axes, in mesh
    order."""
    n, i = 1, 0
    for a in MS.data_axes(mesh):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
    return n, i


def _data_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's data shard of the logical batch ``x`` (B over the
    data axes when it divides, else whole, as the reference)."""
    axes = MS.data_axes(mesh)
    if not axes or x.shape[0] % _data_ways(mesh)[0]:
        return x
    spec = (axes if len(axes) > 1 else axes[0],) + (None,) * (x.dim() - 1)
    return MS.local_slice(x, spec, mesh)


def _data_gather(y: torch.Tensor, B: int, mesh) -> torch.Tensor:
    axes = MS.data_axes(mesh)
    if not axes or B % _data_ways(mesh)[0]:
        return y
    for a in reversed(axes):
        y = torch.cat(MS.all_gather(mesh, y.contiguous(), a, "data_gather"),
                      0)
    return y


def moe_on_mesh(params, x: torch.Tensor, *, mesh, top_k: int, ep: bool,
                capacity_factor: float = 1.25) -> dict:
    """``moe_block_sharded`` driven from logical inputs: the whole block's
    ``params`` and batch ``x`` [B, S, d] on every rank; each rank takes
    its data shard and its expert slices, and the outputs of the data
    shards are gathered back.  Returns ``{"y": [B, S, d] bf16 (CPU),
    "aux", "drops": this rank's dropped pairs}``."""
    from repro_torch.models import moe as MOE
    dev = mesh.device
    local = MOE.shard_experts(TR.map_tensors(lambda t: t.to(dev), params),
                              mesh, ep)
    drops: list = []
    y, aux = MOE.moe_block_sharded(
        local, _data_slice(x, mesh).to(dev), top_k=top_k, mesh=mesh, ep=ep,
        capacity_factor=capacity_factor, drops=drops)
    y = _data_gather(y, x.shape[0], mesh)
    return {"y": y.cpu(), "aux": float(aux), "drops": int(sum(
        int(d) for d in drops))}


def _contributions(params, x: torch.Tensor, top_k: int,
                   capacity_factor: float) -> torch.Tensor:
    """A [T, d]: per token and element, the sum of the magnitudes of its
    weighted expert contributions (``moe_block``'s pieces)."""
    from repro_torch.models import moe as MOE
    T = x.shape[0] * x.shape[1]
    d = x.shape[-1]
    xf = x.reshape(T, d)
    r = MOE._dispatch_tables(xf, params["router"], top_k, capacity_factor)
    E, C = r.table.shape
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xe = xpad[r.table.reshape(-1)].reshape(E, C, d)
    h = torch.nn.functional.silu(params["gate"](xe)) * params["up"](xe)
    ye = params["down"](h.to(MOE.ACT_DTYPE))
    rows = torch.cat([(ye * r.gate_table[..., None]).reshape(E * C, d).abs(),
                      ye.new_zeros((1, d))], 0)
    a = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        a = a + rows[r.slot.reshape(T, top_k)[:, j]]
    return a


def moe_block_check(cfg, seed: int, tokens: int, *, mesh) -> list:
    """One MoE block of ``cfg`` (its first MoE layer's shapes, weights from
    ``seed``) on ``tokens`` tokens per data shard: the sharded block
    against ``moe_block`` on the same tokens on this rank, under the
    elementwise allowance of the module docstring.  Returns every rank's
    report."""
    from repro_torch.models import moe as MOE
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                          cfg.top_k, cfg.mp_policy, n_shared=cfg.n_shared,
                          shared_d_ff=cfg.shared_d_ff or None,
                          tile=cfg.mp_tile, ep=cfg.moe_ep)
    xg = torch.Generator(device=dev).manual_seed(
        seed + 1 + _data_ways(mesh)[1])
    x = torch.randn((1, tokens, cfg.d_model), generator=xg, device=dev
                    ).to(MOE.ACT_DTYPE)
    with torch.no_grad():
        y_ref = MOE.moe_block(params, x, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor)
        a = _contributions(params, x, cfg.top_k, cfg.capacity_factor)
        local = MOE.shard_experts(params, mesh, cfg.moe_ep)
        del params
        _sync(dev)
        MS.comm_stats().reset()
        t0 = time.perf_counter()
        y, _ = MOE.moe_block_sharded(
            local, x, top_k=cfg.top_k, mesh=mesh, ep=cfg.moe_ep,
            capacity_factor=cfg.capacity_factor)
        _sync(dev)
        secs = time.perf_counter() - t0
    comm = MS.comm_stats().snapshot()
    yf, rf = y.float().reshape(a.shape), y_ref.float().reshape(a.shape)
    allow = (2.0 ** -8 * (2 * a + yf.abs() + rf.abs())
             + 2.0 ** -22 * a)
    err = (yf - rf).abs()
    return _all({"rank": mesh.rank, "max_err": float(err.max()),
                 "worst_ratio": float((err / allow.clamp_min(1e-30)).max()),
                 "bit_equal": bool(torch.equal(y, y_ref)),
                 "seconds": secs, "comm": comm})


def cross_pod_check(cfg, seed: int, *, mesh, axis: str = "pod",
                    equal_pods: bool = False,
                    return_trees: bool = False) -> list:
    """``cross_pod_mean`` over ``axis`` on a gradient tree shaped like
    ``cfg``'s parameters, each tensor drawn per pod from a seeded
    generator (every pod the same draw with ``equal_pods``), with an fp32
    residual of 2^-10 normals: each rank's result against ``mean over
    pods of compress(g_p, e_p)`` computed on the rank, tensor by tensor,
    and its ``err`` against ``compress``'s residual, both bit for bit.
    Returns every rank's report (with ``return_trees``, this rank's trees
    too)."""
    from repro_torch.launch.sharding import param_shapes
    from repro_torch.optim import grad_compress as GC
    dev = mesh.device
    shapes = param_shapes(cfg)
    like = TR.tensors(shapes)
    npods = mesh.shape[axis]
    me = mesh.index(axis)

    def draw(pod: int, i: int):
        s = seed + 7919 * i + (0 if equal_pods else 1_000_003 * (pod + 1))
        gen = torch.Generator(device=dev).manual_seed(s)
        t = like[i]
        g = torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)
        e = torch.randn(t.shape, generator=gen, device=dev) * 2.0 ** -10
        return g, e

    drawn = {id(t): draw(me, i) for i, t in enumerate(like)}
    g = TR.replace_tensors(shapes, {k: v[0] for k, v in drawn.items()})
    e = TR.replace_tensors(shapes, {k: v[1] for k, v in drawn.items()})
    del drawn
    _sync(dev)
    MS.comm_stats().reset()
    t0 = time.perf_counter()
    gc, err = GC.cross_pod_mean(g, e, mesh, axis)
    _sync(dev)
    secs = time.perf_counter() - t0
    comm = MS.comm_stats().snapshot()
    # the expected mean, tensor by tensor over the pods' compressed draws
    equal = err_ok = True
    for i, (got, got_err) in enumerate(zip(TR.tensors(gc),
                                           TR.tensors(err))):
        total = None
        for pod in range(npods):
            gp, ep = draw(pod, i)
            cp, rp = GC.compress(gp, ep)
            if pod == me:
                err_ok = err_ok and torch.equal(got_err, rp)
            total = cp.float() if total is None else total + cp.float()
        equal = equal and torch.equal(got, (total / npods).to(
            torch.bfloat16))
    out = _all({"rank": mesh.rank, "pod": me, "equal": equal,
                "err_equal": err_ok, "seconds": secs, "comm": comm,
                "tensors": len(like)})
    if return_trees:
        cpu = lambda t: t.cpu()   # noqa: E731
        out[mesh.rank]["trees"] = {"grads": TR.map_tensors(cpu, g),
                                   "err_in": TR.map_tensors(cpu, e),
                                   "gc": TR.map_tensors(cpu, gc),
                                   "err": TR.map_tensors(cpu, err)}
    return out


def remesh_check(cfg, seed: int, workdir: str, *, mesh) -> list:
    """Elastic re-mesh of ``cfg``'s parameters (from ``seed``, whole on
    every rank), sharded by ``param_specs`` on ``mesh``
    (:func:`remesh_tree_check`)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    params = T.init_model(torch.Generator(device=mesh.device).manual_seed(
        seed), cfg)
    return remesh_tree_check(params, SH.param_specs(params, cfg, mesh),
                             workdir, mesh=mesh)


def remesh_tree_check(tree, specs: dict, workdir: str, *, mesh) -> list:
    """``tree`` (whole on every rank) sharded by ``specs`` ({leaf key:
    spec}) on ``mesh`` and saved collectively under ``workdir/sharded``;
    rank 0 also saves it unsharded under ``workdir/plain`` and compares
    the manifests' hash and leaves; then the checkpoint is restored onto
    a ("data", "model") mesh of all the ranks by one ``Shard(0)``
    sharding, and onto ``runtime.fault.shrink_mesh_shape``'s half of it
    on the first ranks: every local shard against its slice of the
    logical array, bit for bit.  Returns every rank's report."""
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.launch import sharding as SH
    from repro_torch.runtime.fault import shrink_mesh_shape
    tree = TR.map_tensors(lambda t: t.to(mesh.device), tree)
    sharded = SH.distribute_tree(tree, specs, mesh)
    t0 = time.perf_counter()
    MS.comm_stats().reset()
    man = CK.save(os.path.join(workdir, "sharded"), sharded, step=1)
    save_s = time.perf_counter() - t0
    comm = MS.comm_stats().snapshot()
    report = {"rank": mesh.rank, "save_s": save_s, "comm": comm,
              "hash": man["hash"],
              "sharded_leaves": sum(1 for t in TR.tensors(sharded)
                                    if SH.is_sharded(t))}
    if mesh.rank == 0:
        plain = CK.save(os.path.join(workdir, "plain"), tree, step=1)
        report["hash_equal"] = plain["hash"] == man["hash"]
        report["leaves_equal"] = plain["leaves"] == man["leaves"]
    MS.barrier(mesh)
    world = dist.get_world_size()
    flat = mesh.reshaped((world, 1), ("data", "model"))
    half = mesh.reshaped(shrink_mesh_shape((world, 1)), ("data", "model"))
    for label, m in (("remesh", flat), ("shrink", half)):
        if m.coordinate is None:
            report[label] = None
            continue
        t0 = time.perf_counter()
        got, _ = CK.restore(os.path.join(workdir, "sharded"), tree,
                            sharding_tree=SH.NamedSharding(m, SH.P("data")))
        secs = time.perf_counter() - t0
        ok = all(torch.equal(r.to_local(), MS.local_slice(w, SH.P("data"),
                                                          m))
                 for r, w in zip(TR.tensors(got), TR.tensors(tree)))
        report[label] = {"equal": ok, "seconds": secs,
                         "shape": dict(m.shape)}
    return _all(report)


def _routing_hook(log: list, replay: list | None, first_replay: int,
                  n_moe: int):
    """Wrap ``moe.route``: call i is MoE layer ``i % n_moe``; from layer
    ``first_replay`` on it takes ``replay``'s picks for that layer (the
    gates still from its own probabilities); every call's routing goes
    into ``log``.  Returns the function that restores ``route``."""
    from repro_torch.models import moe as MOE
    orig = MOE.route
    calls = [0]

    def route(probs, top_k, capacity_factor, picks=None):
        layer = calls[0] % n_moe
        calls[0] += 1
        if replay is not None and layer >= first_replay:
            picks = replay[layer].flat_e.reshape(-1, top_k)
        r = orig(probs, top_k, capacity_factor, picks)
        log.append(r)
        return r

    MOE.route = route
    return lambda: setattr(MOE, "route", orig)


def _extra_rounding(moe_block):
    """``moe_block`` with its expert sum rounded to bf16 before the shared
    expert is added in fp32 (one extra bf16 rounding): the routed experts
    alone through ``moe_block`` (whose output is that rounding), then the
    shared expert."""
    from repro_torch.models import moe as MOE

    def block(params, x, *, top_k, capacity_factor=1.25, return_aux=False,
              drops=None):
        routed = {k: v for k, v in params.items() if k != "shared"}
        out = moe_block(routed, x, top_k=top_k,
                        capacity_factor=capacity_factor,
                        return_aux=return_aux, drops=drops)
        y, aux = out if return_aux else (out, None)
        if "shared" in params:
            B, S, d = x.shape
            y = (y.float() + MOE.mlp_block(params["shared"], x.reshape(
                B * S, d)).float().reshape(B, S, d)).to(MOE.ACT_DTYPE)
        return (y, aux) if return_aux else y

    return block


def prefill_mesh_check(cfg, seed: int, seq: int, *, mesh) -> list:
    """The prefill of ``cfg`` (weights from ``seed``, whole on every rank)
    on one seeded ``seq``-token sequence per data shard, as
    ``forward_prefill`` computes it but keeping the final hidden states
    of its one pass of the layers, meshed (``hints_enabled(mesh)``: every
    MoE layer through ``moe_block_sharded`` on this rank's expert
    slices) against the
    unmeshed forward of the same sequence on this rank.  Layer 0 routes
    on its own, and its kept (token, expert) pairs must equal the
    unmeshed run's; later layers replay the unmeshed run's expert picks
    (a rounding difference flips picks at small router margins), and the
    picks they would have made otherwise are counted.  Returns every
    rank's report: the last-position logits' and the final hidden
    states' largest gaps, and the gaps of the one-extra-rounding variant
    (the allowance's base), the meshed prefill's ksplit launches, host
    seconds and collectives."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm
    from repro_torch.models.shard_hints import hints_enabled
    dev = mesh.device
    n_moe = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
    params = T.init_model(torch.Generator(device=dev).manual_seed(seed),
                          cfg)
    tokens = torch.randint(0, cfg.vocab, (_data_ways(mesh)[0], seq),
                           generator=torch.Generator().manual_seed(seed + 1),
                           dtype=torch.int32)
    mine = _data_slice(tokens, mesh).to(dev)

    def run(p):
        """One pass of the layers: (the last-position logits, as
        ``forward_prefill`` computes them, and the final hidden states)."""
        hidden, _ = T._run_layers(p, cfg, mine)
        logits = p["lm_head"](rms_norm(hidden[:, -1:], p["final_norm"],
                                       cfg.norm_eps))
        return logits.float(), hidden.float()

    with torch.no_grad():
        ref_log: list = []
        undo = _routing_hook(ref_log, None, n_moe, n_moe)
        try:
            logits_u, hidden_u = run(params)
        finally:
            undo()
        ref_log = ref_log[:n_moe]
        undo = _routing_hook([], ref_log, 0, n_moe)
        block = MOE.moe_block
        MOE.moe_block = _extra_rounding(block)
        try:
            logits_v, hidden_v = run(params)
        finally:
            MOE.moe_block = block
            undo()
        local = MOE.shard_model_experts(params, mesh, cfg.moe_ep)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        mesh_log: list = []
        undo = _routing_hook(mesh_log, ref_log, 1, n_moe)
        try:
            with hints_enabled(mesh):
                _sync(dev)
                ops.reset_launch_counts()
                MS.comm_stats().reset()
                t0 = time.perf_counter()
                logits_m, hidden_m = run(local)
                _sync(dev)
                secs = time.perf_counter() - t0
                launches = ops.launch_counts()["ksplit_gemm"]
                comm = MS.comm_stats().snapshot()
        finally:
            undo()
    r0, m0 = ref_log[0], mesh_log[0]
    kept0 = (torch.equal(r0.flat_e, m0.flat_e)
             and torch.equal(r0.keep, m0.keep))
    # picks the meshed later layers would have made on their own
    flips = 0
    for layer in range(1, n_moe):
        r = mesh_log[layer]
        own = torch.sort(r.probs, dim=-1, descending=True,
                         stable=True).indices[:, :cfg.top_k]
        want = ref_log[layer].flat_e.reshape(-1, cfg.top_k)
        flips += int((torch.sort(own, -1).values
                      != torch.sort(want, -1).values).any(-1).sum())
    gap = lambda a, b: float((a - b).abs().max())   # noqa: E731
    return _all({
        "rank": mesh.rank, "layer0_kept_equal": bool(kept0),
        "layer0_kept": int(r0.keep.sum()),
        "layer0_dropped": int((~r0.keep).sum()),
        "logits_gap": gap(logits_m, logits_u),
        "logits_gap_extra": gap(logits_v, logits_u),
        "hidden_gap": gap(hidden_m, hidden_u),
        "hidden_gap_extra": gap(hidden_v, hidden_u),
        "logits_max": float(logits_u.abs().max()),
        "hidden_max": float(hidden_u.abs().max()),
        "finite": bool(torch.isfinite(logits_m).all()),
        "shape": list(logits_m.shape), "replayed_flips": flips,
        "launches": launches, "seconds": secs, "comm": comm,
        "moe_layers": n_moe})
