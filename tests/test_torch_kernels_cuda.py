"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every case is marked ``cuda`` and skips without a GPU; on a
machine with one (and no JAX) run

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

The sweeps cover the shapes of tests/test_kernels.py and the port's
compiled variants: head_dim 32/64/128, GQA groups 1 to 16 (a group
over 8 query heads spans two blocks), page sizes 8/16/32, ragged fills and
starts, chunks that are not a whole q tile, and the four q/page dtype
pairs; for the dense-cache kernels (decode_attention, flash_attention)
fills of 1 and of the whole cache, per-row and scalar fills, and query
lengths that leave a ragged q tile (1, 127, 2049). fp32 q and pages hold
to 1e-4 (fp32 math in both, summed in another order); a bf16 output holds
to 2e-2, one bf16 rounding.
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, seed, q_shape, P, ps, Hkv, D, B, N, qdt, kvdt):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(*q_shape, generator=g, device=card).to(qdt)
    kp, vp = (torch.randn(P, ps, Hkv, D, generator=g, device=card).to(kvdt)
              for _ in range(2))
    bt = torch.randint(0, P, (B, N), generator=g, device=card,
                       dtype=torch.int32)
    return q, kp, vp, bt


def _close(got, want, qdt, kvdt):
    tol = 1e-4 if (qdt, kvdt) == (torch.float32, torch.float32) else 2e-2
    if qdt == torch.float32 and kvdt == torch.bfloat16:
        tol = 1e-4          # bf16 inputs, fp32 math and output
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,D,valids", [
    (2, 8, 2, 24, 16, 8, 64, (1, 128)),
    (1, 4, 1, 9, 8, 4, 32, (17,)),
    (3, 6, 6, 12, 16, 3, 64, (5, 31, 48)),
    (2, 16, 4, 40, 32, 6, 128, (100, 192)),
    (8, 9, 3, 64, 16, 128, 64, (1, 16, 17, 300, 1024, 1, 1600, 32)),
    (2, 32, 2, 20, 16, 5, 128, (33, 80)),
    (2, 8, 1, 10, 16, 4, 128, (7, 64)),
])
def test_paged_decode_kernel_matches_plain(card, B, H, Hkv, P, ps, N, D,
                                           valids, qdt, kvdt):
    q, kp, vp, bt = _inputs(card, B * 100 + N, (B, H, D), P, ps, Hkv, D,
                            B, N, qdt, kvdt)
    lens = torch.tensor(valids, dtype=torch.int32, device=card)
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt, lens)
    assert paged_decode_attention.launches == n0 + 1
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, lens, D ** -0.5),
           qdt, kvdt)


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,T,D,starts", [
    (1, 4, 2, 8, 16, 4, 16, 32, (16,)),
    (2, 8, 2, 12, 16, 6, 32, 32, (0, 48)),
    (1, 4, 4, 6, 8, 6, 16, 32, (24,)),
    (2, 16, 4, 16, 16, 8, 64, 64, (32, 0)),
    (4, 9, 3, 64, 16, 128, 64, 64, (0, 64, 1024, 0)),
    (2, 9, 3, 20, 16, 8, 24, 64, (8, 100)),
    (2, 32, 2, 20, 16, 6, 32, 128, (0, 48)),
    (1, 8, 1, 10, 16, 4, 32, 128, (16,)),
])
def test_chunked_prefill_kernel_matches_plain(card, B, H, Hkv, P, ps, N, T,
                                              D, starts, qdt, kvdt):
    q, kp, vp, bt = _inputs(card, B * 10 + T, (B, T, H, D), P, ps, Hkv, D,
                            B, N, qdt, kvdt)
    sp = torch.tensor(starts, dtype=torch.int32, device=card)
    n0 = chunked_prefill_attention.launches
    got = chunked_prefill_attention(q, kp, vp, bt, sp)
    assert chunked_prefill_attention.launches == n0 + 1
    _close(got, ref.chunked_prefill_attention(q, kp, vp, bt, sp, D ** -0.5),
           qdt, kvdt)


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,S,D,valids", [
    (2, 8, 2, 64, 64, (1, 64)),                  # fill 1 and fill S
    (1, 4, 4, 40, 32, (17,)),                    # G 1
    (3, 9, 3, 2048, 64, (1, 1600, 2048)),        # smollm-135m, stacked path
    (4, 32, 8, 300, 128, (33, 300, 1, 128)),     # qwen3-4b, G 4
    (2, 16, 2, 100, 128, (99, 7)),               # G 8
    (2, 32, 2, 96, 32, (50, 96)),                # G 16: two blocks a head
])
def test_decode_kernel_matches_plain(card, B, H, Hkv, S, D, valids, qdt,
                                     kvdt):
    g = torch.Generator(device=card).manual_seed(B * 1000 + S)
    q = torch.randn(B, H, D, generator=g, device=card).to(qdt)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=card).to(kvdt)
            for _ in range(2))
    lens = torch.tensor(valids, dtype=torch.int32, device=card)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, lens)
    assert decode_attention.launches == n0 + 1
    _close(got, ref.decode_attention(q, k, v, lens, D ** -0.5), qdt, kvdt)
    # a scalar fill is every row's fill
    _close(decode_attention(q, k, v, valids[0]),
           ref.decode_attention(q, k, v, valids[0], D ** -0.5), qdt, kvdt)


def test_decode_kernel_never_reads_past_the_fill(card):
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(2, 9, 64, generator=g, device=card)
    k, v = (torch.randn(2, 96, 3, 64, generator=g, device=card)
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([40, 1], dtype=torch.int32, device=card)
    o = decode_attention(q, k, v, lens)
    k[0, 40:], v[0, 40:], k[1, 1:], v[1, 1:] = 1e4, -1e4, 1e4, -1e4
    assert torch.equal(decode_attention(q, k, v, lens), o)


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", [
    (1, 1, 1, 4, 4, 32, True),                   # Sq 1, G 1
    (2, 127, 127, 9, 3, 64, True),               # ragged tiles, smollm
    (1, 2049, 2049, 8, 2, 32, True),             # one token past 2048
    (1, 300, 300, 32, 8, 128, True),             # qwen3-4b, G 4
    (2, 64, 64, 16, 2, 128, True),               # G 8
    (1, 80, 80, 32, 2, 64, True),                # G 16
    (2, 100, 37, 8, 2, 64, False),               # full, Sk != Sq
    (1, 70, 200, 6, 3, 64, True),                # Sk > Sq
    (1, 200, 70, 6, 3, 64, True),                # Sq > Sk
])
def test_flash_kernel_matches_plain(card, B, Sq, Sk, H, Hkv, D, causal, qdt,
                                    kvdt):
    g = torch.Generator(device=card).manual_seed(Sq * 7 + Sk)
    q = torch.randn(B, Sq, H, D, generator=g, device=card).to(qdt)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device=card).to(kvdt)
            for _ in range(2))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n0 + 1
    _close(got, ref.flash_attention(q, k, v, D ** -0.5, causal), qdt, kvdt)


def test_flash_kernel_never_reads_above_the_diagonal(card):
    """Keys strictly in every query's future are never read: poisoning
    them leaves the first 40 queries' outputs bit for bit as they were."""
    g = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(1, 96, 9, 64, generator=g, device=card)
    k, v = (torch.randn(1, 96, 3, 64, generator=g, device=card)
            for _ in range(2))
    o = flash_attention(q, k, v)
    k[:, 48:], v[:, 48:] = 1e4, -1e4
    assert torch.equal(flash_attention(q, k, v)[:, :40], o[:, :40])


def test_scratch_page_never_reaches_a_row(card):
    """Table entries past the fill / causal horizon point at page 0;
    poisoning it leaves every output bit as it was."""
    H, Hkv, D, P, ps = 9, 3, 64, 6, 16
    g = torch.Generator(device=card).manual_seed(2)
    kp, vp = (torch.randn(P, ps, Hkv, D, generator=g, device=card)
              .to(torch.bfloat16) for _ in range(2))
    q1 = torch.randn(1, H, D, generator=g, device=card)
    qc = torch.randn(1, ps, H, D, generator=g, device=card)
    bt = torch.tensor([[3, 4, 0, 0]], dtype=torch.int32, device=card)
    lens = torch.tensor([20], dtype=torch.int32, device=card)
    start = torch.tensor([ps], dtype=torch.int32, device=card)
    o1 = paged_decode_attention(q1, kp, vp, bt, lens)
    c1 = chunked_prefill_attention(qc, kp, vp, bt, start)
    kp[0], vp[0] = 1e4, -1e4
    assert torch.equal(paged_decode_attention(q1, kp, vp, bt, lens), o1)
    assert torch.equal(chunked_prefill_attention(qc, kp, vp, bt, start), c1)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 4, 48, device=card)
    kp = torch.zeros(2, 16, 2, 48, device=card, dtype=torch.bfloat16)
    bt = torch.zeros(1, 1, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, kp, kp, bt, lens)
    q = torch.zeros(1, 4, 256, device=card)       # no config the port runs
    kp = torch.zeros(2, 16, 2, 256, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, kp, kp, bt, lens)
    q = torch.zeros(1, 4, 64, device=card)
    kp = torch.zeros(2, 16, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kp, kp, bt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, kp.transpose(0, 1), kp.transpose(0, 1),
                               bt, lens)
    k = torch.zeros(1, 16, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(torch.zeros(1, 4, 48, device=card), k, k, 1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.zeros(1, 16, 4, 48, device=card), k, k)
    k = torch.zeros(1, 16, 3, 64, device=card)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(torch.zeros(1, 16, 4, 64, device=card), k, k)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(torch.zeros(1, 6, 64, device=card), k, k,
                         torch.ones(1, dtype=torch.int64, device=card))
