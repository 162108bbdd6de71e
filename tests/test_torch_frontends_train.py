"""Port parity of training the frontend configs, and the launchers:
reduced HuBERT-XLarge, LLaVA-NeXT-34B and Llama-3-405B on the JAX
package's own weights and batches (the pairs and tolerances of
``tests/test_torch_frontends.py``).

* ``forward_train``'s loss within ``LOSS_RTOL_EAGER`` (1e-5) of the
  reference run op by op, and every gradient leaf (in its own dtype,
  which must be the reference's) within ``GRAD_FROB`` (1.5e-2) on
  ‖Δ‖/‖g‖ and ``GRAD_MAX`` (3e-2) on max|Δ|/max|g| of ``jax.grad``:
  bf16 activation roundings flip with fp32 summation order and the
  backward carries the flips into every leaf.  A leaf the loss does not
  reach (HuBERT's token table) is zero in both;
* the train launcher trains reduced HuBERT and LLaVA from the pipeline's
  dict batches; the serve launcher refuses HuBERT with the reference's
  message.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import tree as TR
from repro_torch.train.train_step import loss_and_grads
from test_torch_frontends import ARCHS, _batches, _isolated, _pair  # noqa: F401
from test_torch_train import GRAD_FROB, GRAD_MAX, LOSS_RTOL_EAGER


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_gradients_match_reference(name):
    """``forward_train``'s loss and each gradient leaf against
    ``jax.grad`` of the reference run op by op."""
    jcfg, jp, pcfg, pp = _pair(name)
    jb, pb = _batches(name, "train", seed=2, step=3)
    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(
            lambda p: JT.forward_train(p, jcfg, jb)[0])(jp)
    loss, _, grads = loss_and_grads(pp, pcfg, pb)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL_EAGER)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    leaves = TR.walk(grads)
    assert [("/".join(str(k) for k in p)) for p, _ in flat] == \
        [leaf.name for leaf in leaves]
    for (_, jg), leaf in zip(flat, leaves):
        assert str(jg.dtype) == str(leaf.parts[0].dtype).replace(
            "torch.", ""), leaf.key
        a = np.asarray(jg, np.float32)
        t = torch.stack(leaf.parts) if leaf.stacked else leaf.parts[0]
        b = t.float().numpy()
        assert a.shape == b.shape, leaf.key
        if not a.size:
            continue
        if not np.abs(a).max():          # unused (hubert's token table)
            assert not np.abs(b).max(), leaf.key
            continue
        frob = np.linalg.norm(a - b) / np.linalg.norm(a)
        worst = np.abs(a - b).max() / np.abs(a).max()
        assert frob <= GRAD_FROB and worst <= GRAD_MAX, (leaf.key, frob,
                                                         worst)


def test_launchers(tmp_path, monkeypatch, capsys):
    """The train launcher trains reduced HuBERT and LLaVA from the
    pipeline's dict batches (exit 0); the serve launcher refuses HuBERT
    with the reference's message, as the reference's launcher does."""
    from repro_torch.launch import serve as PL
    from repro_torch.launch import train as TL
    for arch in ("hubert-xlarge", "llava-next-34b"):
        assert TL.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", str(tmp_path / arch)]) == 0
        assert "done: 3 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit) as port:
        PL.main(["--arch", "hubert-xlarge"])
    from repro.launch import serve as JL
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit) as ref:
        JL.main()
    assert port.value.code == ref.value.code \
        == "hubert-xlarge is encoder-only: no decode serving"
