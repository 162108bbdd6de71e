"""Mixture-of-Experts FFN with mixed-precision experts (twin of the
single-device part of ``repro.models.moe``).

Dispatch: top-k token-choice routing with a fixed per-expert capacity
``C = max(ceil(T·k/E·capacity_factor), 1)`` and gather/scatter index
dispatch (an ``[E, C]`` table of token ids, sentinel ``T`` → a zero row).
A (token, expert) pair past its expert's capacity is dropped: the token
gets nothing from that expert (the residual carries it).  Whether a pair
drops depends on the other tokens of the call, so a batched decode step
can drop what the same request alone keeps.

Expert weights are batched ``[E, K, N]`` in two segments, the default
format set's fp32 (HIGH) and bf16 (LOW): :class:`MoEKSplit` splits along
K (the *first* ``k_hi`` rows are fp32, whatever order ``k_cls`` marks),
:class:`MoENSplit` along N.  The expert products are plain PyTorch, each
segment an fp32 product with TF32 off (``layout.fp32_matmul``): the bf16
segment is upcast per call, so bf16·bf16 products are exact and summed
in fp32, as the reference's ``preferred_element_type=float32`` einsum.

Determinism on the card: routing takes a stable descending sort (ties
go to the lower expert index, as ``jax.lax.top_k``), and the combine sums
each token's kept contributions in ascending expert order (the order of
the reference's scatter-add), never through atomics.

Training: ``moe_block(return_aux=True)`` runs under autograd.  The
router's gradient comes through the gates written into ``gate_table``
(index writes that autograd carries; a dropped pick writes the cut-off
column and gets none) and through ``load_balance_aux``'s mean router
probability; the expert buffers' through the gathered rows, so an
expert without a kept token gets an exact zero, as in the reference.

``moe_block_sharded`` is the mesh path: on a ``launch.mesh.Mesh`` with
a "model" axis each rank holds its slice of the experts
(:func:`shard_experts`) and the partial outputs meet in one bf16 sum
over "model" (see its docstring).  It is forward-only: the port's
collectives carry no autograd rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.formats import DEFAULT_FORMATS
from repro_torch.core.layout import fp32_matmul
from repro_torch.core.linear import choose_tile, split_cls
from repro_torch.core.precision import Policy
from repro_torch.models.common import ACT_DTYPE, init_mlp, mlp_block


def _class_vector(nblocks: int, policy: Policy | None) -> np.ndarray:
    if policy is None or policy.kind == "uniform_low":
        return np.full(nblocks, DEFAULT_FORMATS.low, np.int8)
    return split_cls(nblocks, policy)


def _normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) / float(np.sqrt(fan_in))


def _lo_product(x: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """bf16 segment: bf16 operands, exact products, fp32 sums."""
    return fp32_matmul(x.to(torch.bfloat16).float(), w_lo.float())


@dataclasses.dataclass
class MoEKSplit:
    """Batched per-expert K-split weight: every expert shares the class
    boundary, so the buffers stack as [E, K_cls, N]."""

    w_hi: torch.Tensor   # f32[E, K_hi, N]
    w_lo: torch.Tensor   # bf16[E, K_lo, N]
    k_cls: np.ndarray
    tile: int
    shape: tuple[int, int, int]   # (E, K, N)

    @classmethod
    def init(cls, gen: torch.Generator, e: int, k: int, n: int,
             policy: Policy | None, tile: int | None = None
             ) -> "MoEKSplit":
        t = tile or choose_tile(k)
        kcls = _class_vector(k // t, policy)
        k_hi = int((kcls == DEFAULT_FORMATS.high).sum()) * t
        w = _normal(gen, (e, k, n), k)
        return cls(w[:, :k_hi].contiguous(), w[:, k_hi:].to(torch.bfloat16),
                   kcls, t, (e, k, n))

    def to_dense(self) -> torch.Tensor:
        return torch.cat([self.w_hi, self.w_lo.float()], dim=1)

    def storage_bytes(self) -> int:
        return self.w_hi.numel() * 4 + self.w_lo.numel() * 2

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [E, C, K] → [E, C, N] fp32, per-segment precision."""
        k_hi = self.w_hi.shape[1]
        y = None
        if k_hi:
            y = fp32_matmul(x[..., :k_hi].float(), self.w_hi)
        if self.w_lo.shape[1]:
            y_lo = _lo_product(x[..., k_hi:], self.w_lo)
            y = y_lo if y is None else y + y_lo
        return y


@dataclasses.dataclass
class MoENSplit:
    """Batched per-expert N-split weight [E, K, N_cls] (the down
    projection when the reference TP-shards the experts' d_ff)."""

    w_hi: torch.Tensor   # f32[E, K, N_hi]
    w_lo: torch.Tensor   # bf16[E, K, N_lo]
    n_cls: np.ndarray
    tile: int
    shape: tuple[int, int, int]

    @classmethod
    def init(cls, gen: torch.Generator, e: int, k: int, n: int,
             policy: Policy | None, tile: int | None = None
             ) -> "MoENSplit":
        t = tile or choose_tile(n)
        ncls = _class_vector(n // t, policy)
        n_hi = int((ncls == DEFAULT_FORMATS.high).sum()) * t
        w = _normal(gen, (e, k, n), k)
        return cls(w[:, :, :n_hi].contiguous(),
                   w[:, :, n_hi:].to(torch.bfloat16), ncls, t, (e, k, n))

    def to_dense(self) -> torch.Tensor:
        return torch.cat([self.w_hi, self.w_lo.float()], dim=2)

    def storage_bytes(self) -> int:
        return self.w_hi.numel() * 4 + self.w_lo.numel() * 2

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        parts = []
        if self.w_hi.shape[2]:
            parts.append(fp32_matmul(x.float(), self.w_hi))
        if self.w_lo.shape[2]:
            parts.append(_lo_product(x, self.w_lo))
        return torch.cat(parts, -1) if len(parts) > 1 else parts[0]


MOE_WEIGHTS = (MoEKSplit, MoENSplit)


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, policy: Policy | None, *, n_shared: int = 0,
             shared_d_ff: int | None = None, tile: int | None = None,
             ep: bool = True) -> dict:
    """``ep=True``: per-expert K-split down; ``ep=False``: N-split down
    (the reference's choice for experts replicated over its model axis).
    The shared expert is a gated MLP on the default format set."""
    down_cls = MoEKSplit if ep else MoENSplit
    params = {
        "router": torch.randn((d_model, n_experts), generator=gen,
                              device=gen.device, dtype=torch.float32) * 0.02,
        "gate": MoEKSplit.init(gen, n_experts, d_model, d_ff, policy, tile),
        "up": MoEKSplit.init(gen, n_experts, d_model, d_ff, policy, tile),
        "down": down_cls.init(gen, n_experts, d_ff, d_model, policy, tile),
    }
    if n_shared:
        params["shared"] = init_mlp(gen, d_model,
                                    shared_d_ff or d_ff * n_shared, policy,
                                    tile, device=gen.device)
    return params


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Routing:
    """One call's dispatch: ``table`` [E, C] token ids (sentinel T),
    ``gate_table`` [E, C] fp32, ``probs`` [T, E], ``flat_e`` [T·k] (the
    picks, token-major, by descending prob), ``keep`` [T·k], ``slot``
    [T·k] (row of the pick in ``table.reshape(-1)``; E·C when dropped)
    and the capacity ``C``."""

    table: torch.Tensor
    gate_table: torch.Tensor
    probs: torch.Tensor
    flat_e: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    capacity: int


def route(probs: torch.Tensor, top_k: int, capacity_factor: float,
          picks: torch.Tensor | None = None) -> Routing:
    """The integer part of dispatch from router probabilities [T, E].
    ``picks`` [T, top_k] replaces the top-k choice (gates still come from
    ``probs``): a replay of another run's expert picks."""
    T, E = probs.shape
    dev = probs.device
    expert_ids = picks if picks is not None else torch.sort(
        probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gate_vals = torch.gather(probs, 1, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # the reference's Python-float expression
    C = max(int(np.ceil(T * top_k / E * capacity_factor)), 1)
    flat_e = expert_ids.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot    # exclusive cumsum
    my_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = my_pos < C
    col = torch.where(keep, my_pos, torch.full_like(my_pos, C))
    tok_idx = torch.arange(T, device=dev).repeat_interleave(top_k)
    # column C takes the dropped picks and is cut off (the reference's
    # out-of-range write with mode="drop"); kept (expert, slot) pairs
    # are unique, so every kept write lands alone
    table = torch.full((E, C + 1), T, dtype=torch.int64, device=dev)
    table[flat_e, col] = tok_idx
    gate_table = torch.zeros((E, C + 1), dtype=torch.float32, device=dev)
    gate_table[flat_e, col] = gate_vals.reshape(-1).float()
    slot = torch.where(keep, flat_e * C + my_pos,
                       torch.full_like(my_pos, E * C))
    return Routing(table[:, :C].contiguous(),
                   gate_table[:, :C].contiguous(), probs, flat_e, keep,
                   slot, C)


def _dispatch_tables(xf: torch.Tensor, router: torch.Tensor, top_k: int,
                     capacity_factor: float) -> Routing:
    """Router logits ``xf @ router`` in fp32, softmax, then :func:`route`."""
    logits = fp32_matmul(xf.float(), router)
    return route(torch.softmax(logits, dim=-1), top_k, capacity_factor)


def load_balance_aux(r: Routing, top_k: int) -> torch.Tensor:
    """Switch-style load-balance loss ``E · Σ_e mean_prob_e ·
    kept_share_e``."""
    T, E = r.probs.shape
    me = r.probs.mean(0)
    ce = torch.bincount(r.flat_e[r.keep], minlength=E).float() / max(
        T * top_k, 1)
    return E * torch.sum(me * ce)


def moe_block(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, return_aux: bool = False,
              drops: list | None = None):
    """x: [B, S, d] → [B, S, d] bf16 (and the aux loss with
    ``return_aux``).  ``drops``, when given, gets this call's count of
    dropped (token, expert) pairs appended (a device scalar)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    r = _dispatch_tables(xf, params["router"], top_k, capacity_factor)
    if drops is not None:
        drops.append((~r.keep).sum())
    E, C = r.table.shape
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xe = xpad[r.table.reshape(-1)].reshape(E, C, d)
    h = F.silu(params["gate"](xe)) * params["up"](xe)
    ye = params["down"](h.to(ACT_DTYPE))                 # [E, C, d] fp32
    weighted = ye * r.gate_table[..., None]
    rows = torch.cat([weighted.reshape(E * C, d),
                      weighted.new_zeros((1, d))], 0)
    # each token's picks in ascending expert order, dropped ones last
    # (they index the zero row): a fixed summation order, no atomics
    slots = torch.sort(r.slot.reshape(T, top_k), dim=-1).values
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        out = out + rows[slots[:, j]]
    if "shared" in params:
        out = out + mlp_block(params["shared"], xf).float()
    out = out.reshape(B, S, d).to(ACT_DTYPE)
    if return_aux:
        return out, load_balance_aux(r, top_k)
    return out


# ---------------------------------------------------------------------------
# the mesh path
# ---------------------------------------------------------------------------

def _expert_dims(ep: bool) -> dict:
    """Which dim of each expert weight's buffers [E, K, N] is sharded over
    "model": E with expert parallelism; else gate/up's d_ff columns and
    down's d_ff rows (``launch.sharding``'s MoE rule)."""
    return ({"gate": 0, "up": 0, "down": 0} if ep
            else {"gate": 2, "up": 2, "down": 1})


def shard_experts(params: dict, mesh, ep: bool) -> dict:
    """``params`` (one MoE block's) with each expert weight cut to this
    rank's slice over "model"; the router and the shared expert stay
    whole.  The weights' ``shape`` keeps the logical (E, K, N)."""
    from repro_torch.launch.mesh import local_slice
    out = dict(params)
    for name, dim in _expert_dims(ep).items():
        w = params[name]
        spec = [None] * 3
        spec[dim] = "model"
        out[name] = dataclasses.replace(
            w, w_hi=local_slice(w.w_hi, spec, mesh),
            w_lo=local_slice(w.w_lo, spec, mesh))
    return out


def shard_model_experts(params: dict, mesh, ep: bool) -> dict:
    """A model tree whose every MoE layer holds this rank's expert slices
    (:func:`shard_experts`); every other tensor is shared with
    ``params``."""
    from repro_torch.tree import LayerList
    layers = LayerList(
        ({**lp, "moe": shard_experts(lp["moe"], mesh, ep)} if "moe" in lp
         else lp for lp in params["layers"]), params["layers"].period)
    return {**params, "layers": layers}


def _check_local(params: dict, E: int, tp: int, ep: bool) -> None:
    for name, dim in _expert_dims(ep).items():
        w = params[name]
        full = w.shape[dim]
        got = max(w.w_hi.shape[dim], w.w_lo.shape[dim])
        if got * tp != full:
            raise ValueError(
                f"moe_block_sharded: {name} holds {got} of {full} along "
                f"dim {dim}, not this rank's 1/{tp} slice "
                "(cut the weights with shard_experts)")


def moe_block_sharded(params, x: torch.Tensor, *, top_k: int, mesh,
                      ep: bool, capacity_factor: float = 1.25,
                      drops: list | None = None):
    """The mesh path of :func:`moe_block` (the reference's explicit
    ``shard_map`` MoE), step for step:

      * ``x`` [B, S, d] is this rank's data shard, the same on every rank
        of "model"; when S % tp == 0 the sequence is sharded over "model"
        (each rank keeps its S/tp rows) and all-gathered on entry in bf16;
      * routing and the [E, C] dispatch tables are computed per data shard
        (the capacity is per data shard);
      * EP (``ep``, E % tp == 0): each rank computes its E/tp experts;
      * non-EP: each rank computes every expert over its d_ff slice
        (gate/up columns, down rows: the down product is N-split);
      * each rank's fp32 partial is cast to bf16 and summed over "model"
        (``launch.mesh.psum``: one fp32 all-reduce, one rounding).  The
        reference reduce-scatters when the sequence is sharded; its
        partitioner then gathers the rows again for the next layer, which
        every rank here holds whole: the same values;
      * then the aux term (identical on every model rank, averaged over
        the data axes) and the shared expert, added in fp32 outside the
        sharded part, with one rounding to bf16.

    ``params`` holds this rank's expert slices (:func:`shard_experts`).
    Dropped (token, expert) pairs are counted into ``drops`` as
    :func:`moe_block` counts them.  Returns (y [B, S, d] bf16, aux).

    Forward only: the collectives move detached bytes, so a loss through
    this block would reach neither the router nor the experts.  With
    autograd on and ``x`` or a weight requiring grad it raises."""
    from repro_torch import tree as TR
    from repro_torch.launch import mesh as MS
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in TR.tensors(params))):
        raise RuntimeError(
            "moe_block_sharded is forward only: its collectives carry no "
            "gradient, so it refuses inputs or weights that require grad "
            "(run it under torch.no_grad(), or train without a mesh)")
    B, S, d = x.shape
    E = params["router"].shape[1]
    tp = mesh.shape["model"]
    _check_local(params, E, tp, ep)
    m = mesh.index("model")
    if S % tp == 0 and tp > 1:
        rows = S // tp
        piece = x[:, m * rows:(m + 1) * rows].to(ACT_DTYPE).contiguous()
        x = torch.cat(MS.all_gather(mesh, piece, "model", "x_gather"), 1)
    T = B * S
    xf = x.reshape(T, d)
    r = _dispatch_tables(xf, params["router"], top_k, capacity_factor)
    if drops is not None:
        drops.append((~r.keep).sum())
    _, C = r.table.shape
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xe = xpad[r.table.reshape(-1)].reshape(E, C, d)
    gt = r.gate_table
    lo, e_loc = 0, E
    if ep:
        e_loc = E // tp
        lo = m * e_loc
        xe, gt = xe[lo:lo + e_loc], gt[lo:lo + e_loc]
    h = F.silu(params["gate"](xe)) * params["up"](xe)
    ye = params["down"](h.to(ACT_DTYPE))                 # [e_loc, C, d]
    weighted = ye * gt[..., None]
    rows_ = torch.cat([weighted.reshape(e_loc * C, d),
                       weighted.new_zeros((1, d))], 0)
    # the token's picks in ascending expert order (moe_block's order);
    # a pick of another rank's expert, or a dropped one, reads zeros
    slots = torch.sort(r.slot.reshape(T, top_k), dim=-1).values - lo * C
    slots = torch.where((slots >= 0) & (slots < e_loc * C), slots,
                        torch.full_like(slots, e_loc * C))
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        out = out + rows_[slots[:, j]]
    y = MS.psum(mesh, out.to(torch.bfloat16), "model", "expert_psum")
    aux = load_balance_aux(r, top_k)
    for a in MS.data_axes(mesh):
        aux = MS.pmean(mesh, aux, a)
    if "shared" in params:
        y = y.float() + mlp_block(params["shared"], xf).float()
    return y.reshape(B, S, d).to(ACT_DTYPE), aux
