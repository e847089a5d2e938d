"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every case is marked ``cuda`` and skips without a GPU; on a
machine with one (and no JAX) run

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

The sweeps cover the shapes of tests/test_kernels.py and the port's
compiled variants: head_dim 32/64/128, GQA groups 1 to 16 (all of a
kv head's query heads are one tensor-core tile of a decode kernel), page
sizes 8/16/32, ragged fills and starts, chunks that are not a whole q tile,
and the four q/page dtype pairs; for the dense-cache kernels (decode_attention, flash_attention)
fills of 1 and of the whole cache, per-row and scalar fills, and query
lengths that leave a ragged q tile (1, 127, 2049). fp32 q and pages hold
to 1e-4 (fp32 math in both, summed in another order); a bf16 output holds
to 2e-2, one bf16 rounding. K3 and K4 also run at recurrentgemma-9b's
heads (head_dim 256, 16 query heads on one kv head), and K4 with a
local-attention window: windows of 1, smaller than a key tile, ragged
against the q tiles, the model's 2048 (which the wrapper drops, as it
masks nothing: the causal walk runs) and 2047 (the windowed walk).
The prefill kernels (K2, K4) share one tensor-core walk that packs q
tokens x the query heads of a kv head into 64-row tiles and splits a
short grid's key walks across blocks: further cases cover split ranges
that end mid-page (pages of 24 and 128 tokens) or lie wholly past a row's
causal horizon, a grid large enough that no split is taken, G 3's ragged
last packed tile, G 16 in one tile at head_dim 256 (causal, a window
under one key tile, 2047), and bit-equal repeated launches, the split
walk's fixed-order merge included. The decode kernels (K1, K3) share one
tensor-core walk too, split across blocks where rows x kv heads give the
card under two blocks an SM: further cases cover fills of 1, fills on a
range boundary, fills that leave ranges empty, G 1/3/4/16 at head_dim
32-256, one sequence of 1,600 tokens through K1 (the phone island's
decode), recurrentgemma-9b's heads at fills 1-2048, bit-equal repeated
launches, poison past every row's fill under the split, and the split
the wrappers plan from the walk's own grid (its ``*_attrs`` entry).

The RG-LRU scan (``rglru_scan``, K6) runs ragged S and C, with and
without h0, fp32 and bf16 inputs, at recurrentgemma-9b's prefill width
(C 4096), through both of its copy paths (16-byte chunks where C and the
pointers allow, a lane's own 4-byte word otherwise: odd C, C 100 in
bf16, an input that starts 2 bytes into its storage). Every case holds
to the claim of its source note: the kernel's explicit multiply-then-add
matches the plain version's two rounded ops bit for bit.

The SSD chunk kernel (``ssd_chunk``, K5) runs chunk lengths Q of 1, 37,
64, 65, 100, 130, 256 and 1024 (its longest), 1 to 6 chunks, 2 to 37
heads (33 and 37 are not a multiple of the 32 heads a cum block takes),
head_dim 16 to 128, state 16 to 128, at mamba2-370m's init (a = -1..-H,
dt = softplus(N(0,1) + dt_bias)) and with a strongly decaying head (a =
-32, dt ~ 1, so |cum| reaches ~8,000 by row 256). Each output holds to
``kernels.ssd.error_bound``: 1e-4 of the sum of its terms' magnitudes
(fp32 rounding of two products on both sides) widened by the relative
change e^(2 dc) - 1 that a gap dc between the two sides' ``cum`` makes in
every decay factor; ``cum`` itself is bit-equal to the plain version's
(both sum in order in fp32 on the card). A score scratch poisoned with
NaN changes no output bit, and repeated launches give the same bits.
"""
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.ssd import error_bound, ssd_chunk

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
    (2, 32, 2, 96, 32, (50, 96)),                # G 16: one tile a kv head
    (8, 16, 1, 2048, 256, (1, 16, 17, 300, 1024, 1, 1600, 2048)),
    # ^ recurrentgemma-9b: D 256, G 16 over one kv head, its 2048 ring
    (3, 16, 1, 64, 256, (64, 5, 33)),            # its .reduced() ring of 64
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
@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 2048, 16, 1, 256, 2048),                 # recurrentgemma-9b prefill
    (1, 2048, 16, 1, 256, 2047),                 # the windowed walk, bitten once
    (1, 2048, 16, 1, 256, 512),                  # a window that bites
    (2, 301, 16, 1, 256, 64),                    # ragged last tiles
    (1, 200, 16, 1, 256, 5),                     # window < a key tile
    (1, 130, 16, 1, 256, 1),                     # a token attends itself
    (1, 127, 9, 3, 64, 31),                      # other head dims too
    (2, 100, 4, 1, 32, 64),                      # .reduced() heads
    (1, 300, 32, 8, 128, 100),
])
def test_windowed_flash_kernel_matches_plain(card, B, S, H, Hkv, D, window,
                                             qdt, kvdt):
    g = torch.Generator(device=card).manual_seed(S * 3 + window)
    q = torch.randn(B, S, H, D, generator=g, device=card).to(qdt)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=card).to(kvdt)
            for _ in range(2))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == n0 + 1
    _close(got, ref.flash_attention(q, k, v, D ** -0.5, True, window), qdt,
           kvdt)


def test_windowed_flash_kernel_never_uses_keys_below_the_window(card):
    """Keys below every query's window contribute nothing: poisoning them
    leaves the last 64 queries' outputs bit for bit as they were (the key
    tiles the walk reads below a row's window give p = 0 exactly)."""
    g = torch.Generator(device=card).manual_seed(8)
    S, W = 400, 100
    q = torch.randn(1, S, 16, 256, generator=g, device=card)
    k, v = (torch.randn(1, S, 1, 256, generator=g, device=card)
            for _ in range(2))
    o = flash_attention(q, k, v, window=W)
    k[:, :S - 64 - W + 1], v[:, :S - 64 - W + 1] = 1e4, -1e4
    assert torch.equal(flash_attention(q, k, v, window=W)[:, -64:],
                       o[:, -64:])


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
    (1, 1025, 1025, 16, 1, 256, True),           # D 256: 4-token q tiles
    (2, 37, 90, 16, 1, 256, False),              # D 256, full
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
    q = torch.zeros(1, 4, 256, device=card)   # no paged config has D 256
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
    k = torch.zeros(1, 16, 2, 64, device=card)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(torch.zeros(1, 16, 4, 64, device=card), k, k,
                        causal=False, window=8)
    with pytest.raises(ValueError, match="window"):
        flash_attention(torch.zeros(1, 16, 4, 64, device=card), k, k,
                        window=0)
    # q one element into a buffer: contiguous, but not 16-byte aligned
    q = torch.zeros(1 + 16 * 4 * 64, device=card)[1:].view(1, 16, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, k)
    kp = torch.zeros(2, 16, 2, 64, device=card)
    bt = torch.ones(1, 1, dtype=torch.int32, device=card)
    sp = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        chunked_prefill_attention(q, kp, kp, bt, sp)


@pytest.mark.parametrize("name,B,T,H,Hkv,want", [
    ("chunked_prefill", 4, 64, 9, 3, (48, 21)),    # the main path's tick
    ("flash_attention", 1, 1024, 9, 3, (147, 21)),  # smollm-135m
    ("flash_attention", 1, 2048, 16, 1, (512, 4)),  # recurrentgemma-9b
    ("flash_attention", 2, 16, 4, 4, (8, 64)),      # G 1: 64 tokens a tile
])
def test_prefill_grid_is_the_launched_grid(card, name, B, T, H, Hkv, want):
    """The blocks of one key range and the tokens a block that the
    wrappers plan the split from: the launcher's grid."""
    assert _build.prefill_grid(name, B, T, H, Hkv) == want


def _paged_context(card, seed, starts, T, H, Hkv, D, ps, qdt, kvdt):
    """Rows of T fresh tokens at ``starts`` over private shuffled pages of
    a pool whose page 0 is the scratch page; a table as wide as the
    longest context plus one page."""
    g = torch.Generator(device=card).manual_seed(seed)
    B = len(starts)
    N = -(-(max(starts) + T) // ps) + 1
    P = 1 + B * N
    kp, vp = (torch.randn(P, ps, Hkv, D, generator=g, device=card).to(kvdt)
              for _ in range(2))
    bt = torch.zeros(B, N, dtype=torch.int32, device=card)
    for b, s in enumerate(starts):
        n = -(-(s + T) // ps)
        bt[b, :n] = 1 + b * N + torch.randperm(N, generator=g,
                                               device=card)[:n].int()
    q = torch.randn(B, T, H, D, generator=g, device=card).to(qdt)
    sp = torch.tensor(starts, dtype=torch.int32, device=card)
    return q, kp, vp, bt, sp


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("starts,T,H,Hkv,D,ps,split", [
    ((0, 64, 1024, 0), 64, 9, 3, 64, 16, True),   # the main path's tick
    ((0, 1500), 16, 9, 3, 64, 16, True),      # row 0: ranges past its horizon
    ((37, 700), 24, 9, 3, 64, 24, True),      # 64-key ranges end mid-page
    ((100, 900, 5), 32, 8, 2, 64, 128, True),  # pages of 128: mid-page too
    ((10, 400), 20, 16, 4, 128, 16, True),    # 32-key tiles at fp32 D 128
    ((0, 1, 100, 300, 513, 64, 7, 1000), 256, 9, 3, 64, 16, False),
    # ^ 8 rows of 256 tokens: enough blocks, no split
])
def test_chunked_prefill_split_walk_matches_plain(card, starts, T, H, Hkv, D,
                                                  ps, split, qdt, kvdt):
    q, kp, vp, bt, sp = _paged_context(card, T + len(starts), starts, T, H,
                                       Hkv, D, ps, qdt, kvdt)
    got = chunked_prefill_attention(q, kp, vp, bt, sp)
    assert (chunked_prefill_attention.last_split > 1) == split
    _close(got, ref.chunked_prefill_attention(q, kp, vp, bt, sp, D ** -0.5),
           qdt, kvdt)


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 100, 9, 3, 64, None),       # G 3: 21-token tiles, ragged last one
    (2, 43, 9, 3, 64, None),        # one full tile, a ragged one, split
    (1, 1024, 9, 3, 64, None),      # smollm-135m's prefill, split in two
    (1, 333, 16, 1, 256, None),     # G 16 in one tile: 4 tokens x 16 heads
    (1, 333, 16, 1, 256, 20),       # ... windowed, window < a key tile
    (1, 2048, 16, 1, 256, 2047),    # ... the model's window less one
    (3, 50, 32, 2, 128, None),      # G 16 at fp32 D 128 (32-key tiles)
])
def test_flash_kernel_packed_rows_match_plain(card, B, S, H, Hkv, D, window,
                                              qdt, kvdt):
    g = torch.Generator(device=card).manual_seed(S + H + D)
    q = torch.randn(B, S, H, D, generator=g, device=card).to(qdt)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=card).to(kvdt)
            for _ in range(2))
    got = flash_attention(q, k, v, window=window)
    _close(got, ref.flash_attention(q, k, v, D ** -0.5, True, window), qdt,
           kvdt)


def test_prefill_kernels_are_deterministic(card):
    """Two launches on the same inputs give the same bits, the split walk
    (merged in range order, no atomics) included."""
    q, kp, vp, bt, sp = _paged_context(card, 11, (0, 64, 1024, 0), 64, 9, 3,
                                       64, 16, torch.float32, torch.bfloat16)
    first = chunked_prefill_attention(q, kp, vp, bt, sp)
    assert chunked_prefill_attention.last_split > 1
    assert torch.equal(first, chunked_prefill_attention(q, kp, vp, bt, sp))
    g = torch.Generator(device=card).manual_seed(12)
    for S, H, Hkv, D in ((1024, 9, 3, 64), (2048, 16, 1, 256)):
        q = torch.randn(1, S, H, D, generator=g, device=card)
        k, v = (torch.randn(1, S, Hkv, D, generator=g, device=card)
                for _ in range(2))
        first = flash_attention(q, k, v)
        assert (flash_attention.last_split > 1) == (D == 64)
        assert torch.equal(first, flash_attention(q, k, v))


def _decode_split(card, kernel, seed, fills, H, Hkv, D, qdt, kvdt, cap,
                  ps=16):
    """K1 (``kernel`` "paged") over private shuffled pages of a pool whose
    page 0 is the scratch page, or K3 ("dense") over a (B, cap) cache:
    returns (wrapper, its inputs, the plain version's output)."""
    g = torch.Generator(device=card).manual_seed(seed)
    B = len(fills)
    q = torch.randn(B, H, D, generator=g, device=card).to(qdt)
    lens = torch.tensor(fills, dtype=torch.int32, device=card)
    if kernel == "dense":
        k, v = (torch.randn(B, cap, Hkv, D, generator=g, device=card)
                .to(kvdt) for _ in range(2))
        args = (q, k, v, lens)
        return decode_attention, args, ref.decode_attention(*args,
                                                            D ** -0.5)
    N = cap // ps
    P = 1 + B * N
    kp, vp = (torch.randn(P, ps, Hkv, D, generator=g, device=card).to(kvdt)
              for _ in range(2))
    bt = torch.zeros(B, N, dtype=torch.int32, device=card)
    for b, f in enumerate(fills):
        n = -(-f // ps)
        bt[b, :n] = 1 + b * N + torch.randperm(N, generator=g,
                                               device=card)[:n].int()
    args = (q, kp, vp, bt, lens)
    return paged_decode_attention, args, ref.paged_decode_attention(
        *args, D ** -0.5)


DECODE_SPLIT_CASES = [
    # kernel, fills, H, Hkv, D, cap
    ("paged", (1, 16, 17, 300, 1024, 1, 1600, 32), 9, 3, 64, 2048),
    ("paged", (1600,), 9, 3, 64, 2048),          # the phone island: B 1
    ("paged", (1, 1), 4, 4, 32, 256),             # fills of 1, G 1
    ("paged", (64, 128, 192), 12, 4, 128, 512),   # fills on tile edges, G 3
    ("paged", (33, 5), 32, 2, 128, 1024),         # ranges left empty, G 16
    ("dense", (1, 16, 17, 300, 1024, 1, 1600, 32), 9, 3, 64, 2048),
    ("dense", (1, 16, 17, 300, 1024, 1, 1600, 2048), 16, 1, 256, 2048),
    # ^ recurrentgemma-9b: G 16 at D 256, fills 1-2048
    ("dense", (33, 300, 1, 128), 32, 8, 128, 300),   # qwen3-4b, G 4
    ("dense", (200, 31, 129), 16, 1, 256, 256),   # a 256-slot ring
    ("dense", (7,), 8, 8, 32, 4096),              # one short row, G 1
]


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("kernel,fills,H,Hkv,D,cap", DECODE_SPLIT_CASES)
def test_decode_split_walk_matches_plain(card, kernel, fills, H, Hkv, D,
                                         cap, qdt, kvdt):
    """Every case's grid is short of two blocks an SM, so the walk is
    split; the split walk holds to the plain version."""
    wrapper, args, want = _decode_split(card, kernel, len(fills) + D, fills,
                                        H, Hkv, D, qdt, kvdt, cap)
    n0 = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == n0 + 1
    assert wrapper.last_split > 1
    _close(got, want, qdt, kvdt)


@pytest.mark.parametrize("kernel,fills,H,Hkv,D,cap", DECODE_SPLIT_CASES)
def test_decode_split_never_reads_past_the_fill(card, kernel, fills, H, Hkv,
                                                D, cap):
    """Poison past every row's fill (and the scratch page) under the
    split: every output bit stays as it was, and two launches on the same
    inputs give the same bits (the ranges merge in order, no atomics)."""
    wrapper, args, _ = _decode_split(card, kernel, 3 + D, fills, H, Hkv, D,
                                     torch.float32, torch.bfloat16, cap)
    first = wrapper(*args)
    assert wrapper.last_split > 1
    assert torch.equal(wrapper(*args), first)
    k, v = args[1], args[2]
    if kernel == "dense":
        for b, f in enumerate(fills):
            k[b, f:], v[b, f:] = 1e4, -1e4
    else:
        ps = k.shape[1]
        k[0], v[0] = 1e4, -1e4
        for b, f in enumerate(fills):
            if f % ps:
                page = args[3][b, f // ps].long()
                k[page, f % ps:], v[page, f % ps:] = 1e4, -1e4
    assert torch.equal(wrapper(*args), first)


def test_decode_kernels_are_deterministic(card):
    """Repeated launches of the split walk at the serving paths' shapes
    give the same bits."""
    for kernel, fills, H, Hkv, D, cap in DECODE_SPLIT_CASES[:2] + \
            DECODE_SPLIT_CASES[5:7]:
        wrapper, args, _ = _decode_split(card, kernel, 17, fills, H, Hkv, D,
                                         torch.float32, torch.bfloat16, cap)
        first = wrapper(*args)
        assert wrapper.last_split > 1
        for _ in range(3):
            assert torch.equal(wrapper(*args), first)


@pytest.mark.parametrize("kernel,B,H,Hkv,D,cap,want", [
    ("paged", 8, 9, 3, 64, 2048, 11),      # the main path's largest island
    ("paged", 1, 9, 3, 64, 2048, 16),      # the phone island
    ("dense", 8, 16, 1, 256, 2048, 16),    # recurrentgemma-9b, G 16
    ("dense", 8, 32, 8, 128, 2048, 5),     # qwen3-4b heads
    ("dense", 64, 9, 3, 64, 2048, 2),
    ("dense", 96, 9, 3, 64, 2048, 1),      # 288 blocks: no split
])
def test_decode_split_plan_is_the_launched_split(card, kernel, B, H, Hkv, D,
                                                 cap, want):
    """The walk's ``*_attrs`` entry gives the blocks of one key range and
    the key tile; the split planned from them (132 SMs) is the one the
    wrapper launched, and one block reads each K/V tile for all of a kv
    head's query heads (G 16 is one block a range)."""
    import ctypes
    fills = [min(cap, 100 * (b + 1)) for b in range(B)]
    wrapper, args, _ = _decode_split(card, kernel, 5, fills, H, Hkv, D,
                                     torch.float32, torch.bfloat16, cap)
    wrapper(*args)
    lib, entry = (("paged_attention", "paged_decode_attention_attrs")
                  if kernel == "paged" else
                  ("decode_attention", "decode_attention_attrs"))
    out = (ctypes.c_int * 6)()
    fn = _build.load_entry(lib, entry, [ctypes.c_int] * 6
                           + [ctypes.POINTER(ctypes.c_int)])
    assert fn(0, 1, D, B, H, Hkv, out) == 0
    regs, smem, local, per_sm, tile, blocks = out
    assert blocks == B * Hkv and tile == 64    # bf16 K/V: 64-key tiles
    assert regs > 0 and smem > 0 and per_sm >= 1
    assert _build.prefill_split(blocks, cap, 132, tile) == want
    assert wrapper.last_split == _build.prefill_split(
        blocks, cap, _build.sm_count(0), tile)


def _ssd_inputs(card, seed, Bsz, nc, Q, H, P, N, strong=False):
    """Mamba-2's post-conv, post-softplus chunk inputs at its init: x, B
    and C are silu of unit normals, dt = softplus(N(0,1) + dt_bias) with
    dt_bias = softplus^-1(U[1e-3, 1e-1]) and a = -(1..H). ``strong``: the
    last head decays at a = -32 with dt ~ U[0.9, 1.1]."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=card)

    x = torch.nn.functional.silu(rn(Bsz, nc, Q, H, P))
    B_ = torch.nn.functional.silu(rn(Bsz, nc, Q, N))
    C_ = torch.nn.functional.silu(rn(Bsz, nc, Q, N))
    u = torch.rand(H, generator=g, device=card) * 0.099 + 1e-3
    dt = torch.nn.functional.softplus(rn(Bsz, nc, Q, H)
                                      + torch.log(torch.expm1(u)))
    a = -torch.arange(1, H + 1, dtype=torch.float32, device=card)
    if strong:
        a[-1] = -32.0
        dt[..., -1] = 0.9 + 0.2 * torch.rand(Bsz, nc, Q, generator=g,
                                             device=card)
    return x, dt, a, B_, C_


def _ssd_close(got, want, inputs):
    torch.cuda.synchronize()
    # both sides sum cum in order in fp32: torch.cumsum along a
    # non-innermost dimension of more than one row is a serial loop there
    assert torch.equal(got[3], want[3])
    bounds, dc = error_bound(*inputs, got[3], want[3])
    for name, g, w, b in zip(("y_intra", "state", "decay", "cum"), got,
                             want, bounds):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        excess = ((g - w).abs() - b).max().item()
        assert excess <= 0, (name, excess, dc.max().item())


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong", [
    (1, 1, 1, 2, 16, 16, False),          # one row
    (1, 1, 37, 32, 64, 128, False),       # a ragged single chunk, full width
    (2, 6, 64, 2, 16, 128, True),         # one whole tile, strong decay
    (1, 6, 256, 32, 64, 128, False),      # mamba2-370m's prefill shape
    (1, 6, 256, 32, 64, 128, True),       # ... with a = -32, dt ~ 1
    (2, 2, 256, 2, 64, 16, True),
    (1, 3, 16, 32, 16, 16, False),        # mamba2-370m .reduced()
    (2, 1, 100, 32, 16, 128, False),      # two tiles, the second ragged
    (1, 2, 65, 32, 64, 128, False),       # one row past a whole tile
    (1, 1, 1024, 4, 64, 128, True),       # QMAX: 136 score tiles a chunk
    (1, 2, 130, 33, 128, 32, True),       # H 33: a cum block of one head
    (2, 1, 200, 37, 32, 64, False),       # H 37, head_dim 32, state 64
])
def test_ssd_chunk_kernel_matches_plain(card, Bsz, nc, Q, H, P, N, strong):
    inputs = _ssd_inputs(card, Q * 10 + H + nc, Bsz, nc, Q, H, P, N,
                         strong)
    n0 = ssd_chunk.launches
    got = ssd_chunk(*inputs)
    assert ssd_chunk.launches == n0 + 1
    _ssd_close(got, ref.ssd_chunk(*inputs), inputs)


def test_ssd_chunk_poisoned_scratch_changes_nothing(card, monkeypatch):
    """The score pass writes every entry of every tile the head pass
    reads, and the head pass masks a pair before it uses the score: a
    scratch full of NaN gives the same bits as a fresh one."""
    inputs = _ssd_inputs(card, 11, 1, 3, 200, 32, 64, 128, True)
    clean = ssd_chunk(*inputs)
    monkeypatch.setattr(ssd_mod, "_scratch", lambda shape, device: torch.full(
        shape, float("nan"), device=device))
    poisoned = ssd_chunk(*inputs)
    torch.cuda.synchronize()
    for g, w in zip(poisoned, clean):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_ssd_chunk_repeated_launches_are_bit_equal(card):
    inputs = _ssd_inputs(card, 12, 1, 6, 256, 32, 64, 128, True)
    first = ssd_chunk(*inputs)
    for _ in range(3):
        for g, w in zip(ssd_chunk(*inputs), first):
            assert torch.equal(g, w)


def test_ssd_chunk_padding_steps_change_nothing(card):
    """dt = 0 rows with zero x, B and C (the padding ``ssd_chunked`` adds)
    leave the state, the decay and the real rows' y and cum bit for bit
    as the unpadded chunk gives them."""
    x, dt, a, B_, C_ = _ssd_inputs(card, 3, 1, 2, 200, 32, 64, 128, True)
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, 56))
              for t in (x, dt, B_, C_)]
    got = ssd_chunk(x, dt, a, B_, C_)
    pad = ssd_chunk(padded[0], padded[1], a, padded[2], padded[3])
    assert torch.equal(pad[0][:, :, :200], got[0])
    assert torch.equal(pad[1], got[1]) and torch.equal(pad[2], got[2])
    assert torch.equal(pad[3][:, :, :200], got[3])
    assert (pad[0][:, :, 200:] == 0).all()


def test_ssd_chunk_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, dt, a, B_, C_ = _ssd_inputs(card, 4, 1, 1, 8, 2, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunk(x.double(), dt, a, B_, C_)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_chunk(torch.zeros(1, 1, 8, 2, 24, device=card), dt, a, B_, C_)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x, dt, a, B_.transpose(2, 3).contiguous().transpose(2, 3),
                  C_)
    with pytest.raises(ValueError, match="rows"):
        big = _ssd_inputs(card, 5, 1, 1, 1025, 2, 16, 16)
        ssd_chunk(*big)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,with_h0", [
    (1, 1500, 4096, False),               # recurrentgemma-9b's prefill
    (1, 37, 4096, True),                  # a short query, seeded state
    (3, 1, 100, True),                    # one step, ragged channels
    (2, 33, 31, False),                   # S and C both ragged
    (2, 300, 256, True),                  # .reduced() width
    (2, 257, 4096, True),                 # a ring stage past a whole one
])
def test_rglru_scan_kernel_matches_plain(card, B, S, C, with_h0, dt):
    """a = sigmoid of normals (as the gates make it, < 1), b normal; the
    kernel's h equals the plain version's bit for bit."""
    g = torch.Generator(device=card).manual_seed(S + C)
    a = torch.sigmoid(torch.randn(B, S, C, generator=g, device=card)).to(dt)
    b = torch.randn(B, S, C, generator=g, device=card).to(dt)
    h0 = (torch.randn(B, C, generator=g, device=card) if with_h0 else None)
    n0 = rglru_scan.launches
    got = rglru_scan(a, b, h0)
    assert rglru_scan.launches == n0 + 1
    want = ref.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_is_bit_exact_with_plain(card, dt):
    """Inputs that start one element into their storage: for bf16 the
    pointers are not 4-byte aligned, so every lane copies the word that
    holds its element, and odd rows start in a word's upper half."""
    g = torch.Generator(device=card).manual_seed(9)
    a = torch.rand(2 * 257 * 4096 + 1, generator=g, device=card).to(dt)
    b = torch.randn(2 * 257 * 4096 + 1, generator=g, device=card).to(dt)
    a, b = (t[1:].view(2, 257, 4096) for t in (a, b))
    h0 = torch.randn(2, 4096, generator=g, device=card)
    assert torch.equal(rglru_scan(a, b, h0), ref.rglru_scan(a, b, h0))


def test_rglru_scan_wrapper_refuses_what_the_kernel_does_not_take(card):
    a = torch.rand(1, 8, 64, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="h0"):
        rglru_scan(a, a, torch.zeros(1, 8, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a)
    assert rglru_scan(a[:, :0].contiguous(), a[:, :0].contiguous()).shape \
        == (1, 0, 64)


# ------------------------------------------------ migration and sampling

# a thawed request's next logits against the undisturbed slot's: the same
# kernels on the same K/V bits, where only the batch around the row (and
# with it the key-walk split and cuBLAS's choice of algorithm) differs
THAW_LOGIT_TOL = 1e-4


def test_page_export_then_import_is_bit_equal_on_the_card(card):
    """A card pool's pages, exported (one gather a leaf, one host copy)
    and imported into another card pool (one host copy, one scatter a
    leaf), hold exactly the exported bits."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.kvpool import (PagePool, export_request,
                                            import_request)
    model = get_model(get_config("smollm-135m").reduced())
    src, dst = (PagePool(model, max_len=128, page_size=16, num_pages=12,
                         device=card) for _ in range(2))
    g = torch.Generator(device=card).manual_seed(5)
    for layer in src.pages:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g, device=card))
    pids = [src.alloc(1) for _ in range(5)]
    want = [[t[p].clone() for layer in src.pages for t in layer.values()]
            for p in pids]
    recs = export_request(src, pids, 70)
    got, copied, hits = import_request(dst, recs, 1)
    assert copied == 5 and hits == 0
    for pid, w in zip(got, want):
        have = [t[pid] for layer in dst.pages for t in layer.values()]
        for a, b in zip(have, w):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_thawed_request_decodes_like_the_undisturbed_slot(card):
    """A request frozen mid-decode on one card batcher and imported into
    another continues with next-token logits within ``THAW_LOGIT_TOL`` of
    the undisturbed run's (fused and stacked)."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.batcher import (ContinuousBatcher,
                                             PagedContinuousBatcher)
    cfg = get_config("smollm-135m").reduced()
    prompts = ["a somewhat longer request that spans multiple pages here",
               "short one"]
    for cls, kw in ((PagedContinuousBatcher, dict(page_size=16)),
                    (ContinuousBatcher, {})):
        def make(params=None):
            return cls(cfg, params=params, num_slots=2, max_len=96,
                       device=card, **kw)

        def logged(b):
            rows = {}
            forward = b.model.forward

            def fwd(*a, **k):
                out = forward(*a, **k)
                if k.get("mode") == "decode":
                    for si, s in enumerate(b.slots):
                        if s.active:
                            step = (len(s.carried) + len(s.generated)
                                    + getattr(s, "gen_dev", 0))
                            rows[(s.prompt, step)] = out[0][si, 0].float()
                return out

            b.model.forward = fwd
            return rows

        base = make()
        want = logged(base)
        for p in prompts:
            base.submit(p, max_new_tokens=6, trust_tier=2)
        base.run_until_done()
        a, b = make(base.params), make(base.params)
        rids = [a.submit(p, max_new_tokens=6, trust_tier=2)
                for p in prompts]
        for _ in range(4):
            a.tick()
        got = logged(b)
        for r in rids:
            b.submit_ticket(a.freeze_request(r))
        b.run_until_done()
        assert b.migration_stats["imports"] == len(rids)
        assert got, "the thawed requests decoded nothing"
        for key, row in got.items():
            err = (row - want[key]).abs().max().item()
            assert err <= THAW_LOGIT_TOL, (cls.__name__, key, err)


def test_counter_noise_is_equal_on_the_card_and_the_cpu(card):
    """The sampler's uniforms are bit-equal on the card and on the CPU
    (integer hash), and the Gumbel noise within one float32 rounding."""
    from repro_torch.serving import sampling
    seeds = torch.tensor([3, 2 ** 31 + 9, 77, 0], dtype=torch.int64)
    draws = torch.tensor([0, 5, 123, 2 ** 20], dtype=torch.int64)
    cpu = sampling.counter_bits(seeds, draws, 49152)
    dev = sampling.counter_bits(seeds.to(card), draws.to(card), 49152)
    assert torch.equal(dev.cpu(), cpu)
    gc = sampling.gumbel_noise(seeds, draws, 49152)
    gd = sampling.gumbel_noise(seeds.to(card), draws.to(card), 49152).cpu()
    assert torch.allclose(gd, gc, rtol=2 ** -23, atol=2 ** -23)


def test_profiler_waits_for_the_card(card):
    """``DispatchProfiler.tick_end`` synchronizes the device that holds
    its target: the work launched in the tick has finished when it
    returns, and the wait is charged to ``device_sync``."""
    from repro_torch.obs import DispatchProfiler
    prof = DispatchProfiler()
    a = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize()
    prof.tick_begin()
    for _ in range(8):
        a = a @ a / 64.0
    prof.tick_end([{"k": a}])
    assert torch.cuda.current_stream(card).query()
    assert prof.totals["device_sync"] > 0
    assert prof.report()["ticks"] == 1


def _record_splits(monkeypatch):
    """Record the key-walk split of every K1/K2 launch the model makes."""
    from repro_torch.models import attention
    seen = {"paged_decode_attention": [], "chunked_prefill_attention": []}
    for name in seen:
        fn = getattr(attention, name)

        def rec(*a, fn=fn, name=name, **k):
            out = fn(*a, **k)
            seen[name].append(fn.last_split)
            return out

        monkeypatch.setattr(attention, name, rec)
    return seen


def test_padded_prefill_rows_touch_only_the_scratch_page(card):
    """Under ``constant_shape`` every fused prefill carries ``num_slots``
    rows; the padded ones (no tokens, an all-zero table, ``dst`` the
    scratch page) change no pool page but the scratch page, and the real
    rows write only their own fresh pages."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.batcher import PagedContinuousBatcher
    cfg = get_config("smollm-135m").reduced()
    b = PagedContinuousBatcher(cfg, num_slots=6, max_len=128, device=card,
                               constant_shape=True)
    checked = []
    prefill = b._fused_prefill

    def watched(params, pages, toks, starts, bt, dst, *rest):
        before = [t.clone() for layer in pages for t in layer.values()]
        out = prefill(params, pages, toks, starts, bt, dst, *rest)
        written = {int(p) for p in dst.flatten().tolist()} - {0}
        after = [t for layer in out[2] for t in layer.values()]
        for was, now in zip(before, after):
            moved = {int(p) for p in
                     (was != now).flatten(1).any(1).nonzero().flatten()}
            assert moved <= written | {0}, (moved, written)
        checked.append(int((dst == 0).all(1).sum()))
        return out

    b._fused_prefill = watched
    for k, p in enumerate(["one short request", "a second request that is "
                           "somewhat longer than the first one by a page"]):
        b.submit(p, max_new_tokens=4, trust_tier=1 + k)
    b.run_until_done()
    assert checked and max(checked) >= 4      # padded rows were launched
    assert {s[1] for s in b.dispatch_shapes if s[0] == "prefill"} == {6}


def test_constant_shape_launches_one_split_per_kernel(card, monkeypatch):
    """Every K1 launch and every K2 launch of a constant-shape batcher
    takes one key-walk split, whatever the load."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.batcher import PagedContinuousBatcher
    cfg = get_config("smollm-135m").reduced()
    seen = _record_splits(monkeypatch)
    b = PagedContinuousBatcher(cfg, num_slots=8, max_len=256, device=card,
                               constant_shape=True)
    for k in range(5):
        b.submit(f"request {k} " + "pad " * (6 * k + 1), max_new_tokens=3 + k,
                 trust_tier=1)
    b.run_until_done()
    for name, splits in seen.items():
        assert splits and len(set(splits)) == 1, (name, sorted(set(splits)))
