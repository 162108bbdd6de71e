"""What the reference computes for the comparison that decides
``correct``, for any family module that gives ``leaves``, ``dense``,
``stored``, ``logits`` and ``loss`` (``reference/<family>.py``).

* Serving: the reference runs once over each sampled prompt with the
  tokens the program served, and reads, at each served position, how far
  the served token's logit lies below the reference's best
  (:func:`served_gaps`).  The control (:func:`control_gaps`) is the same
  reference with every weight stored one precision lower, read at the
  token that it puts first.
* Training: the reference follows the program's first three steps from
  the same dense weights and batches (:func:`train_readings`).

Runs in blocks (a few requests, or one layer's recomputation, at a time)
so it fits beside nothing: the program's state is freed first.
"""
from __future__ import annotations

import torch

from portbench.reference.adamw import AdamW

#: requests the reference reads in one forward pass
SERVE_BLOCK = 8


def _padded(seqs: list, device) -> torch.Tensor:
    width = max(len(s) for s in seqs)
    out = torch.zeros((len(seqs), width), dtype=torch.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = torch.as_tensor(s, dtype=torch.int64)
    return out.to(device)


@torch.no_grad()
def _served_logits(ref, c, w: dict, reqs: list, device):
    """Yield (request, logits [n, V]) at the positions that produced its
    n served tokens (position L-1+t produced token t)."""
    for b in range(0, len(reqs), SERVE_BLOCK):
        block = reqs[b:b + SERVE_BLOCK]
        seqs = [list(r["prompt"]) + list(r["served"][:-1]) for r in block]
        lg = ref.logits(w.__getitem__, c, _padded(seqs, device))
        for i, r in enumerate(block):
            L, n = len(r["prompt"]), len(r["served"])
            yield r, lg[i, L - 1:L - 1 + n]


def served_gaps(ref, c: dict, seed: int, reqs: list, device) -> list:
    """Per request, the widest gap by which a judged token's logit lies
    below the reference's best.  ``reqs``: dicts with ``prompt`` and
    ``served`` token lists, the context the reference reads; the tokens
    judged at those positions are ``judged`` where given, else the
    served ones."""
    w = ref.weights(c, seed, device)
    out = []
    for r, lg in _served_logits(ref, c, w, reqs, device):
        tok = torch.as_tensor(r.get("judged", r["served"]),
                              device=device)[:, None]
        gap = lg.max(-1).values - lg.gather(-1, tok)[:, 0]
        out.append(float(gap.max()))
    return out


def control_tokens(ref, c: dict, seed: int, reqs: list, device) -> list:
    """The control put in the program's place: the same requests, with
    the token that the reference stored one precision lower puts first
    at each of their positions as the tokens judged (a served model's
    control reads the same prompts and served tokens, and need not
    decode)."""
    lo = ref.weights(c, seed, device, demote=True)
    out = [dict(r, judged=lg.argmax(-1).tolist())
           for r, lg in _served_logits(ref, c, lo, reqs, device)]
    del lo
    return out


def control_gaps(ref, c: dict, seed: int, reqs: list, device) -> list:
    """:func:`served_gaps` of the control's tokens."""
    return served_gaps(ref, c, seed,
                       control_tokens(ref, c, seed, reqs, device), device)


def train_readings(ref, c: dict, seed: int, opt: dict, batches: list,
                   device, demote: bool = False, half: bool = False
                   ) -> dict:
    """The reference's first ``len(batches)`` steps: each step's loss,
    each leaf's norm of the first clipped gradient, and each leaf's norm
    of its change over the steps.  ``batches``: (tokens, labels) pairs.

    ``demote`` is the control (every class stored one precision lower);
    ``half`` plants a fault: the loss is the mean over the first half of
    each batch's positions (with one sequence a step, half the batch is
    half its tokens)."""
    lvs = {lf.name: lf for lf in ref.leaves(c)}
    masters = {k: ref.stored(c, lf, ref.dense(seed, lf, device), demote)
               for k, lf in lvs.items()}
    for w in masters.values():
        w.requires_grad_(True)
    adam = AdamW(masters, opt)

    def get(name):
        w = masters[name]
        return w + (ref.stored(c, lvs[name], w.detach(), demote)
                    - w.detach())

    losses, grad1 = [], None
    for tokens, labels in batches:
        lg = ref.logits(get, c, tokens, remat=True)
        if half:
            n = tokens.shape[1] // 2
            lg, labels = lg[:, :n], labels[:, :n]
        lo = ref.loss(lg, labels)
        del lg
        grads = dict(zip(masters, torch.autograd.grad(
            lo, list(masters.values()))))
        losses.append(float(lo.detach()))
        with torch.no_grad():
            norms = adam.step(grads)
        del grads
        if grad1 is None:
            grad1 = {k: float(v) for k, v in norms.items()}
    change = {}
    with torch.no_grad():
        for k, lf in lvs.items():
            w0 = ref.stored(c, lf, ref.dense(seed, lf, device), demote)
            change[k] = float(torch.linalg.vector_norm(masters[k] - w0))
    return {"loss": losses, "grad1": grad1, "change": change}
