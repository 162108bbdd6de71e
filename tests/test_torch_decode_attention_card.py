"""The decode-attention kernel (``csrc/decode_attention.cu``) against its
plain version on the card.  Every test is marked ``gpu`` and skips
without one.  This file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs alone, with pytest's
``--noconftest -m gpu`` (``tests/conftest.py`` imports JAX; the README
gives the command).

* At the decode shapes of the served configs (InternLM2 ``.chat``: B 128,
  S_max 512, 8 kv heads of 2 q heads, dh 128, rows at positions 0 … 511;
  Jamba: group 4; Llama-3-405B: group 16; LLaVA: group 7; gemma3: dh
  320 at 1024 slots; the reduced configs: dh 16) the kernel's
  fp32 output lies within ``2e-5 · max|V|`` of the plain version's: both
  sum the same fp32 products, in other orders, and the weights p sum to
  1.  Its bf16 output is that fp32 output rounded, bit for bit.
* A row alone gives the same bits as in a batch of 128.
* Tiles past every row's position are never read: the tile counter says
  so, and overwriting those slots changes no bit.
* A row that sees no key gets the mean of V, as the plain softmax gives.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as DA

#: fp32 agreement, a share of max|V|
TOL = 2e-5

#: (label, B, S_max, n_kv, group, dh)
SHAPES = [("internlm2.chat", 128, 512, 8, 2, 128),
          ("jamba", 32, 512, 8, 4, 128),
          ("llama405", 4, 1024, 8, 16, 128),
          ("llava", 4, 3072, 8, 7, 128),
          ("gemma3", 8, 1024, 4, 2, 320),
          ("reduced", 4, 80, 2, 2, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(B, S, nkv, group, dh, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 1, nkv * group, dh), generator=g).to(torch.bfloat16)
    k = torch.randn((B, S, nkv, dh), generator=g).to(torch.bfloat16)
    v = (torch.randn((B, S, nkv, dh), generator=g) * 3).to(torch.bfloat16)
    pos = torch.arange(B) * (S - 1) // max(B - 1, 1)
    valid = torch.arange(S)[None, :] <= pos[:, None]
    return [t.to(device) for t in (q, k, v, valid)] + [pos]


def _gap(got, want, v) -> float:
    return float((got - want).abs().max() / v.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain(cuda, shape):
    _, B, S, nkv, group, dh = shape
    q, k, v, valid, _ = _case(B, S, nkv, group, dh, 1, cuda)
    before = DA.launches
    got = DA.decode_attention(q, k, v, valid, out_dtype=torch.float32)
    got16 = DA.decode_attention(q, k, v, valid)
    assert DA.launches == before + 2
    want = DA.decode_attention_plain(q, k, v, valid, torch.float32)
    assert _gap(got, want, v) <= TOL
    assert torch.equal(got16, got.to(torch.bfloat16))
    # equal mode: one mask row for all, read through a stride-0 expand
    eq = (torch.arange(S, device=cuda) <= S // 3)[None, :].expand(B, S)
    got = DA.decode_attention(q, k, v, eq, out_dtype=torch.float32)
    want = DA.decode_attention_plain(q, k, v, eq, torch.float32)
    assert _gap(got, want, v) <= TOL


@pytest.mark.gpu
def test_row_alone_equals_row_in_batch(cuda):
    q, k, v, valid, _ = _case(128, 512, 8, 2, 128, 2, cuda)
    out = DA.decode_attention(q, k, v, valid)
    for i in (0, 37, 127):
        one = DA.decode_attention(q[i:i + 1], k[i:i + 1].contiguous(),
                                  v[i:i + 1].contiguous(), valid[i:i + 1])
        assert torch.equal(one[0], out[i])


@pytest.mark.gpu
def test_tiles_past_every_position_are_not_read(cuda):
    B, S = 16, 512
    q, k, v, _, _ = _case(B, S, 8, 2, 128, 3, cuda)
    pos = torch.arange(B, device=cuda) * 9 + 60          # 60 … 195
    valid = torch.arange(S, device=cuda)[None, :] <= pos[:, None]
    DA.reset_tiles()
    out = DA.decode_attention(q, k, v, valid)
    tiles = (pos // DA.TILE + 1) * 8                      # per row, kv heads
    assert DA.tiles_read() == int(tiles.sum())
    assert DA.tiles_total == B * 8 * S // DA.TILE
    k2, v2 = k.clone(), v.clone()
    k2[:, 256:] = 7.0
    v2[:, 256:] = -5.0
    assert torch.equal(DA.decode_attention(q, k2, v2, valid), out)


@pytest.mark.gpu
def test_row_without_a_visible_key_is_the_mean_of_v(cuda):
    q, k, v, valid, _ = _case(4, 200, 2, 4, 128, 4, cuda)
    valid[2] = False
    got = DA.decode_attention(q, k, v, valid, out_dtype=torch.float32)
    want = DA.decode_attention_plain(q, k, v, valid, torch.float32)
    assert _gap(got, want, v) <= TOL
    mean = v[2].float().mean(0).repeat_interleave(4, 0).reshape(-1)
    assert _gap(got[2, 0], mean, v) <= TOL
