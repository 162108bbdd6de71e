"""The decode-attention kernel's plain version and ``decode_attention`` on
the CPU (``repro_torch.kernels.decode_attention``,
``repro_torch.models.common``).

* The kernel module's plain version is the composition the model ran
  before the kernel, ``_attend(q, _repeat_kv(k), _repeat_kv(v), valid)``
  rounded to bf16, bit for bit, under every mask the engine builds.
* ``decode_attention`` on the JAX package's weights agrees with the
  reference's ops run one by one, over groups 1, 2, 4, 7 and 16 and head
  dims 16, 128 and 320, at a scalar and at per-row positions, through a
  ring buffer that has wrapped and with part of a row's cache hidden.
  The caches are written alike, each element within one bf16 ulp
  (``2^-7`` of it, or of ``2^-16`` of the cache's largest where a sum
  cancelled to near 0: the projections sum in another fp32 order, and
  RoPE's fp32 angles differ in the last bit at some positions, so a new
  key or value may round the other way).  Only fp32 summation order differs
  between the two, so the outputs (bf16 after ``wo``) agree to one bf16
  rounding of the largest output, ``2^-8 · max|out|`` (measured at most
  ``2.4e-3 · max|out|`` over these cases).
* A CPU tensor launches nothing and counts nothing.

The kernel itself runs only on a card:
``tests/test_torch_decode_attention_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core.linear import MPLinear
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import common as PC

GROUPS = (1, 2, 4, 7, 16)
HEAD_DIMS = (16, 128, 320)
MODES = ("scalar", "per_row", "ring", "hidden")
B, S_MAX, D_MODEL, N_KV = 3, 40, 32, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    ).to(torch.bfloat16)


def _masks(pos):
    """The engine's masks at per-row positions ``pos``: each row's prefix
    (masked mode), the same with a row's padding hidden, one row seeing
    every slot, and one seeing none (never built by the engine: the plain
    softmax's mean of V)."""
    kv = torch.arange(S_MAX)
    prefix = kv[None, :] <= torch.as_tensor(pos)[:, None]
    holes = prefix & ~((kv[None, :] >= 2) & (kv[None, :] < 9))
    edge = prefix.clone()
    edge[0] = True
    edge[1] = False
    return {"prefix": prefix, "holes": holes, "edge": edge,
            "equal": (kv <= 17)[None, :].expand(B, S_MAX)}


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("group", GROUPS)
def test_plain_is_the_models_composition(group, dh):
    rng = np.random.default_rng(group * 1000 + dh)
    q = _bf16(rng, (B, 1, N_KV * group, dh))
    k = _bf16(rng, (B, S_MAX, N_KV, dh))
    v = _bf16(rng, (B, S_MAX, N_KV, dh), 3.0)
    for name, valid in _masks([5, 17, 39]).items():
        want = PC._attend(q, PC._repeat_kv(k, group),
                          PC._repeat_kv(v, group),
                          valid[:, None, None, :]).to(torch.bfloat16)
        want = want.reshape(B, 1, -1)
        got = DA.decode_attention_plain(q, k, v, valid)
        assert got.dtype == torch.bfloat16, name
        assert torch.equal(got, want), name
        # the fp32 form is the same sums before the rounding
        f32 = DA.decode_attention(q, k, v, valid, out_dtype=torch.float32)
        assert torch.equal(f32.to(torch.bfloat16), got), name


def test_hidden_row_is_the_mean_of_v():
    rng = np.random.default_rng(7)
    q = _bf16(rng, (B, 1, 4, 16))
    k = _bf16(rng, (B, S_MAX, 2, 16))
    v = _bf16(rng, (B, S_MAX, 2, 16))
    valid = _masks([5, 17, 39])["edge"]
    out = DA.decode_attention(q, k, v, valid, out_dtype=torch.float32)
    mean = v[1].float().mean(0).repeat_interleave(2, 0).reshape(-1)
    assert torch.allclose(out[1, 0], mean, rtol=1e-6, atol=1e-6)


def _attention_pair(group, dh, seed):
    """The reference's attention parameters (dense bf16 linears) and the
    port's, with the same weights."""
    dims = JC.attn_dims(N_KV * group, N_KV, D_MODEL, 1, head_dim=dh)
    jp = JC.init_attention(jax.random.PRNGKey(seed), D_MODEL, dims, None)
    pp = {name: MPLinear(tensor_from_numpy(np.asarray(lin.w), "cpu"), None)
          for name, lin in jp.items()}
    return dims, jp, PC.AttnDims(dims.n_q, dims.n_kv, dh, dims.n_q_orig,
                                 dims.n_kv_orig), pp


def _case(mode, rng):
    """(position, slot, kv_valid, window) for the JAX and the torch call."""
    if mode == "scalar":
        return 17, None, None, None
    if mode == "ring":
        return 3 * S_MAX + 5, None, None, S_MAX
    pos = np.array([4, 17, 39])
    valid = _masks(pos)["holes" if mode == "hidden" else "prefix"].numpy()
    return pos, pos, valid, None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("group", GROUPS)
def test_decode_attention_matches_reference(group, dh, mode):
    seed = GROUPS.index(group) * 100 + HEAD_DIMS.index(dh) * 10 \
        + MODES.index(mode)
    rng = np.random.default_rng(seed)
    jdims, jp, pdims, pp = _attention_pair(group, dh, seed)
    x = rng.standard_normal((B, 1, D_MODEL)).astype(np.float32)
    ck = (rng.standard_normal((B, S_MAX, N_KV, dh))).astype(np.float32)
    cv = (rng.standard_normal((B, S_MAX, N_KV, dh)) * 2).astype(np.float32)
    position, slot, valid, window = _case(mode, rng)
    jck = jnp.asarray(ck, jnp.bfloat16)
    jcv = jnp.asarray(cv, jnp.bfloat16)
    pck = tensor_from_numpy(np.asarray(jck), "cpu")
    pcv = tensor_from_numpy(np.asarray(jcv), "cpu")
    with jax.disable_jit():
        jout, jck, jcv = JC.decode_attention(
            jp, jnp.asarray(x, jnp.bfloat16), jdims, jck, jcv,
            position=position if slot is None else jnp.asarray(position),
            window=window,
            slot=None if slot is None else jnp.asarray(slot),
            kv_valid=None if valid is None else jnp.asarray(valid))
    before = DA.launches
    pout = PC.decode_attention(
        pp, torch.from_numpy(x).to(torch.bfloat16), pdims, pck, pcv,
        position=position if slot is None else torch.from_numpy(position),
        window=window,
        slot=None if slot is None else torch.from_numpy(slot),
        kv_valid=None if valid is None else torch.from_numpy(valid))
    assert DA.launches == before
    for mine, ref in ((pck, jck), (pcv, jcv)):
        ref = np.asarray(ref, np.float32)
        floor = 2.0 ** -16 * np.abs(ref).max()
        assert np.all(np.abs(mine.float().numpy() - ref)
                      <= 2.0 ** -7 * np.maximum(np.abs(ref), floor))
    want = np.asarray(jout, np.float32)
    got = pout.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_cpu_tensors_launch_nothing():
    rng = np.random.default_rng(3)
    q = _bf16(rng, (B, 1, 4, 128))
    k = _bf16(rng, (B, S_MAX, 2, 128))
    valid = _masks([1, 2, 3])["prefix"]
    before = (DA.launches, DA.tiles_total)
    DA.decode_attention(q, k, k, valid)
    assert (DA.launches, DA.tiles_total) == before
    assert DA.stats() == {"kernel_calls": DA.launches, "tiles_read": 0,
                          "tiles_total": DA.tiles_total}
