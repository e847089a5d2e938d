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

P12a adds K1 and K2 at head_dim 256 (paligemma-3b's 8 query heads on one
kv head) and at G 1, 4, 8 and 16 (musicgen-large, qwen3-4b, paligemma,
glm4-9b), the main path's tick and the phone island's one slot included,
and K4 with a prefix-LM prefix of 0, 1, 33 (inside a key tile), 256 and
5,000 (past the prompt: all of it bidirectional) tokens, with and
without a window, split and unsplit, fp32 and bf16; keys past every
early query's causal end and the prefix are never used, and the prefix
walk repeats bit for bit.

K4's backward (``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``)
runs against ``ref.flash_attention_bwd`` on the same q, k, v, output,
log-sum-exp and output gradient: causal, full, windows of 1, 33, 100 and
512, prefixes of 33, 256 and 5,000 (past the prompt), a window with a
prefix, head_dim 32/64/128/256, G 1 to 16, Sq != Sk both ways and ragged
S (65, 127, 130, 257, 300, 1000); each gradient holds to 1e-4 of its
largest magnitude (fp32 FMA sums against the plain version's einsums),
and repeated launches give the same bits (no float atomics). Through
autograd (``FlashAttention``) the forward and the backward launch once
each; K4's forward with its ``lse`` output gives the same bits in ``out``
as without it, split or not, and an ``lse`` within 1e-5 of the plain
version's; K1-K3 raise under autograd on CUDA tensors rather than drop a
gradient.

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

K5's backward (``ssd_chunk_bwd``, ``csrc/ssd_chunk_bwd.cu``) runs against
``ref.ssd_chunk_bwd`` on the same inputs and saved ``cum`` at chunk
lengths 1, 37, 64, 65, 256 and 1024, head_dim and state across
``WIDTHS``, 2 to 33 heads, with a strongly decaying head, and with
upstream gradients left out (None: zeros); each gradient holds to
``kernels.ssd.bwd_error_bound`` (each output's longest chain of fp32
sums, twice, times the sum of its terms' magnitudes), and repeated
launches give the same bits (no float atomics). K6's backward
(``rglru_scan_bwd``, ``csrc/rglru_scan_bwd.cu``) equals
``ref.rglru_scan_bwd`` bit for bit at ragged S and C, with and without
h0, fp32 and bf16, through both copy paths, at S on the edges of its
consumer batches (15, 16, 17) and ring stages (63, 64, 65, 129), with B >
1 and h0; two launches give the same bits, and ``bwd_kernel_attrs``
reports its producer/consumer layout (stages, steps a stage and a batch,
shared bytes, no local memory). Through autograd
(``SsdChunk``, ``RglruScan``) every input that requires a gradient gets
one, and the forward and the backward launch once each.
"""
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels import rglru as rglru_mod
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.ssd import (bwd_error_bound, error_bound, ssd_chunk,
                                     ssd_chunk_bwd)
from test_torch_rglru_bwd_design import kernel_constants

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
    q = torch.zeros(1, 4, 512, device=card)   # no config has D 512
    kp = torch.zeros(2, 16, 2, 512, device=card, dtype=torch.bfloat16)
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
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention(torch.zeros(1, 16, 4, 64, device=card), k, k,
                        prefix_len=-1)
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


# K1 and K2 at the heads of the configs P12a serves on the paged main
# path: paligemma-3b (8 heads of 256 on one kv head, G 8), musicgen-large
# (32 heads of 64, G 1), qwen3-4b (32 of 128 on 8, G 4), glm4-9b (32 of
# 128 on 2, G 16), and D 256 at G 1, 4 and 16
P12A_DECODE = [
    (3, 8, 1, 40, 16, 16, 256, (1, 100, 256)),              # paligemma
    (8, 8, 1, 64, 16, 128, 256, (1, 16, 17, 300, 1024, 1, 1600, 32)),
    (1, 8, 1, 110, 16, 128, 256, (1600,)),       # the phone island: split
    (2, 2, 2, 30, 16, 8, 256, (33, 128)),                   # D 256, G 1
    (2, 4, 1, 30, 16, 8, 256, (64, 5)),                     # D 256, G 4
    (2, 16, 1, 30, 16, 12, 256, (17, 180)),                 # D 256, G 16
    (4, 32, 32, 64, 16, 12, 64, (1, 50, 190, 100)),         # musicgen
    (4, 32, 8, 64, 16, 24, 128, (7, 300, 1, 64)),           # qwen3-4b
    (8, 32, 2, 64, 16, 128, 128, (1, 16, 17, 300, 1024, 1, 1600, 32)),
    # ^ glm4-9b at the main path's largest island
]
P12A_PREFILL = [
    (4, 8, 1, 64, 16, 128, 64, 256, (0, 64, 1024, 0)),      # paligemma
    (2, 2, 2, 20, 16, 8, 32, 256, (0, 48)),                 # D 256, G 1
    (2, 4, 1, 20, 16, 8, 32, 256, (16, 80)),                # D 256, G 4
    (2, 16, 1, 20, 16, 8, 24, 256, (8, 100)),               # D 256, G 16
    (4, 32, 32, 64, 16, 128, 64, 64, (0, 64, 1024, 0)),     # musicgen
    (4, 32, 8, 64, 16, 128, 64, 128, (0, 64, 1024, 0)),     # qwen3-4b
    (4, 32, 2, 64, 16, 128, 64, 128, (0, 64, 1024, 0)),     # glm4-9b
]


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,D,valids", P12A_DECODE)
def test_paged_decode_kernel_at_p12a_heads(card, B, H, Hkv, P, ps, N, D,
                                           valids, qdt, kvdt):
    q, kp, vp, bt = _inputs(card, B * 31 + H + D, (B, H, D), P, ps, Hkv, D,
                            B, N, qdt, kvdt)
    lens = torch.tensor(valids, dtype=torch.int32, device=card)
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt, lens)
    assert paged_decode_attention.launches == n0 + 1
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, lens, D ** -0.5),
           qdt, kvdt)


@pytest.mark.parametrize("qdt,kvdt", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,P,ps,N,T,D,starts", P12A_PREFILL)
def test_chunked_prefill_kernel_at_p12a_heads(card, B, H, Hkv, P, ps, N, T,
                                              D, starts, qdt, kvdt):
    q, kp, vp, bt, sp = _paged_context(card, B * 7 + H + D, starts, T, H,
                                       Hkv, D, ps, qdt, kvdt)
    n0 = chunked_prefill_attention.launches
    got = chunked_prefill_attention(q, kp, vp, bt, sp)
    assert chunked_prefill_attention.launches == n0 + 1
    _close(got, ref.chunked_prefill_attention(q, kp, vp, bt, sp, D ** -0.5),
           qdt, kvdt)


def test_paged_kernels_at_d256_never_read_the_scratch_page(card):
    """paligemma's heads: table entries past every fill and causal horizon
    point at page 0, whose poison reaches no output bit."""
    q, kp, vp, bt, sp = _paged_context(card, 3, (0, 48), 32, 8, 1, 256, 16,
                                       torch.float32, torch.bfloat16)
    lens = sp + 32
    o1 = paged_decode_attention(q[:, -1].contiguous(), kp, vp, bt, lens)
    c1 = chunked_prefill_attention(q, kp, vp, bt, sp)
    kp[0], vp[0] = 1e4, -1e4
    assert torch.equal(
        paged_decode_attention(q[:, -1].contiguous(), kp, vp, bt, lens), o1)
    assert torch.equal(chunked_prefill_attention(q, kp, vp, bt, sp), c1)


# K4 with a prefix-LM prefix: (B, S, H, Hkv, D) x prefix_len x window; the
# short prompts split their walks (whose ranges must cover the extended
# end), S 1024 at paligemma's heads too
PREFIX_SHAPES = [(1, 1024, 8, 1, 256), (2, 300, 8, 1, 256),
                 (1, 97, 4, 2, 64), (1, 200, 32, 2, 128)]


@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("prefix", [0, 1, 33, 256, 5000])
@pytest.mark.parametrize("B,S,H,Hkv,D", PREFIX_SHAPES)
def test_prefix_flash_kernel_matches_plain(card, B, S, H, Hkv, D, prefix,
                                           window, qdt, kvdt):
    g = torch.Generator(device=card).manual_seed(S + prefix + D)
    q = torch.randn(B, S, H, D, generator=g, device=card).to(qdt)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=card).to(kvdt)
            for _ in range(2))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, window=window, prefix_len=prefix)
    assert flash_attention.launches == n0 + 1
    _close(got, ref.flash_attention(q, k, v, D ** -0.5, True,
                                    window if window and window < S
                                    else None, prefix), qdt, kvdt)


def test_prefix_split_walk_covers_the_extended_end(card):
    """A short prompt whose rows all see a prefix longer than their causal
    end: the wrapper splits the walk, and the ranges cover the prefix."""
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(1, 64, 4, 2 * 32, generator=g, device=card)
    k, v = (torch.randn(1, 256, 2, 64, generator=g, device=card)
            for _ in range(2))
    got = flash_attention(q, k, v, prefix_len=200)
    assert flash_attention.last_split > 1
    _close(got, ref.flash_attention(q, k, v, 64 ** -0.5, True, None, 200),
           torch.float32, torch.float32)


def test_prefix_flash_kernel_never_reads_past_the_prefix(card):
    """Keys past every early query's causal end and the prefix are never
    used: poisoning them leaves those queries' outputs bit for bit, and
    the keys below the prefix do reach them."""
    g = torch.Generator(device=card).manual_seed(9)
    q = torch.randn(1, 256, 8, 256, generator=g, device=card)
    k, v = (torch.randn(1, 256, 1, 256, generator=g, device=card)
            for _ in range(2))
    o = flash_attention(q, k, v, prefix_len=100)
    causal = flash_attention(q, k, v)
    assert not torch.equal(o[:, :40], causal[:, :40])
    k[:, 100:], v[:, 100:] = 1e4, -1e4
    assert torch.equal(flash_attention(q, k, v, prefix_len=100)[:, :90],
                       o[:, :90])


def test_prefix_flash_kernel_is_deterministic(card):
    g = torch.Generator(device=card).manual_seed(10)
    q = torch.randn(1, 2048, 8, 256, generator=g, device=card)
    k, v = (torch.randn(1, 2048, 1, 256, generator=g, device=card)
            for _ in range(2))
    first = flash_attention(q, k, v, prefix_len=256)
    assert torch.equal(first, flash_attention(q, k, v, prefix_len=256))


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


# MoE and MLA blocks (P12b): torch ops, no kernel of K1-K6. fp32 on both
# sides with TF32 off; the card sums the matmuls in other orders than the
# CPU (measured gaps on the CPU against the reference: <= 6e-6)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _block_params(arch, seed=0):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    cfg = get_config(arch).reduced()
    return cfg, get_model(cfg).init(seed=seed, device="cpu")


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("B,S", [(1, 1), (3, 16), (2, 300)])
def test_moe_apply_on_the_card_matches_the_cpu(card, arch, B, S):
    """``moe_apply`` (router, top-k, every expert on every token, shared
    experts, the aux loss) at ``.reduced()`` on card tensors against the
    same call on CPU tensors; the chosen experts agree where the k-th and
    (k+1)-th probabilities are apart."""
    from repro_torch.models import moe
    cfg, params = _block_params(arch)
    p = params["layers"][1]["moe"]
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(B * S))
    y, aux = moe.moe_apply(cfg, p, x)
    yd, auxd = moe.moe_apply(cfg, _to(p, card), x.to(card))
    assert yd.device.type == "cuda"
    torch.testing.assert_close(yd.cpu(), y, **BLOCK_TOL)
    torch.testing.assert_close(auxd.cpu(), aux, **BLOCK_TOL)
    x2 = x.reshape(-1, cfg.d_model)
    from repro_torch.models.layers import rms_norm
    h = rms_norm(x2, p["ln"])
    _, idx, probs = moe._route(torch.matmul(h, p["router"]).float(),
                               cfg.top_k)
    _, idxd, _ = moe._route(torch.matmul(h.to(card), p["router"].to(card))
                            .float(), cfg.top_k)
    srt = probs.sort(-1, descending=True).values
    apart = (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]) > 1e-5
    assert torch.equal(idxd.cpu()[apart], idx[apart])


@pytest.mark.parametrize("decode_mode", ["absorbed", "naive"])
def test_mla_apply_on_the_card_matches_the_cpu(card, decode_mode):
    """``mla_apply`` at ``.reduced()``: full mode into a bf16 latent cache
    (S 40), then two decode steps at (B,) positions, on card tensors
    against the same calls on CPU tensors; the latent caches within one
    bf16 ulp."""
    from repro_torch.models import mla
    cfg, params = _block_params("deepseek-v2-lite-16b")
    p = params["layers"][0]["mixer"]
    g = torch.Generator().manual_seed(7)
    B, S, W = 3, 40, 64
    x = torch.randn(B, S + 2, cfg.d_model, generator=g)
    width = cfg.kv_lora_rank + cfg.rope_head_dim
    outs = {}
    for dev in ("cpu", card):
        pd = _to(p, dev)
        cache = {"ckr": torch.zeros(B, W, 1, width, dtype=torch.bfloat16,
                                    device=dev)}
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        ys = [mla.mla_apply(cfg, pd, x[:, :S].to(dev), pos, mode="full",
                            cache=cache)[0]]
        for t in range(2):
            posb = torch.tensor([S + t, S + t - 3, 5 + t], dtype=torch.int32,
                                device=dev)
            ys.append(mla.mla_apply(cfg, pd, x[:, S + t:S + t + 1].to(dev),
                                    posb, mode="decode", cache=cache,
                                    decode_mode=decode_mode)[0])
        outs[str(dev)] = ([y.cpu() for y in ys], cache["ckr"].float().cpu())
    (ycpu, ccpu), (ycard, ccard) = outs["cpu"], outs[str(card)]
    for a, b in zip(ycard, ycpu):
        torch.testing.assert_close(a, b, **BLOCK_TOL)
    torch.testing.assert_close(ccard, ccpu, rtol=2 ** -7, atol=1e-4)


# ------------------------------------------------------------ K4 backward

# (B, Sq, Sk, H, Hkv, D, causal, window, prefix)
BWD_CASES = [
    (2, 127, 127, 9, 3, 64, True, None, 0),      # smollm heads, ragged
    (1, 2048, 2048, 9, 3, 64, True, None, 0),    # smollm's S 2048
    (1, 65, 65, 4, 4, 32, True, None, 0),        # D 32, G 1, one past a tile
    (1, 300, 300, 32, 8, 128, True, None, 0),    # qwen3-4b, G 4
    (1, 80, 80, 32, 2, 64, True, None, 0),       # G 16
    (2, 512, 512, 8, 1, 256, True, None, 256),   # paligemma-3b: prefix 256
    (1, 300, 300, 8, 1, 256, True, None, 33),    # a prefix inside a tile
    (1, 300, 300, 4, 2, 64, True, None, 5000),   # prefix past the prompt
    (1, 1000, 1000, 16, 1, 256, True, 512, 0),   # recurrentgemma, window
    (1, 2048, 2048, 16, 1, 256, True, 2048, 0),  # its train step: causal
    (1, 200, 200, 6, 3, 64, True, 1, 0),         # window of 1
    (1, 130, 130, 6, 3, 64, True, 33, 0),        # a ragged window
    (1, 257, 257, 8, 2, 128, True, 100, 40),     # window and prefix
    (2, 100, 37, 8, 2, 64, False, None, 0),      # full, Sk < Sq
    (1, 70, 200, 6, 3, 64, True, None, 0),       # causal, Sk > Sq
    (1, 200, 70, 6, 3, 64, True, None, 0),       # causal, Sq > Sk
    # the tile edges: 64 keys a dK/dV block and 64 query rows a dQ block;
    # steps of 32 query rows (dK/dV) and 32 keys (dQ) at D 64, 16 at D 256
    (1, 31, 31, 9, 3, 64, True, None, 0),        # one short of a step
    (1, 33, 33, 9, 3, 64, True, None, 0),        # one past a step
    (1, 63, 63, 9, 3, 64, True, None, 0),        # one short of a block
    (2, 65, 65, 16, 1, 64, True, None, 0),       # one past, G 16 on 1
    (1, 33, 65, 4, 2, 64, False, None, 0),       # full, both ragged
    (1, 15, 15, 8, 1, 256, True, None, 0),       # D 256: one short of a step
    (1, 17, 17, 16, 1, 256, True, None, 0),      # one past, G 16 on 1
    (1, 63, 63, 16, 1, 256, True, 20, 0),        # one short of a block
    (1, 65, 65, 8, 1, 256, True, None, 33),      # one past, a prefix
]


def _bwd_inputs(card, seed, B, Sq, Sk, H, Hkv, D, causal, window, prefix):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device=card)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device=card)
            for _ in range(2))
    do = torch.randn(B, Sq, H, D, generator=g, device=card)
    o, lse = ref.flash_attention(q, k, v, D ** -0.5, causal, window, prefix,
                                 return_lse=True)
    return q, k, v, o.contiguous(), lse.contiguous(), do


def _close_grad(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,prefix", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(card, B, Sq, Sk, H, Hkv, D, causal,
                                        window, prefix):
    args = _bwd_inputs(card, Sq + Sk + D, B, Sq, Sk, H, Hkv, D, causal,
                       window, prefix)
    mask = (D ** -0.5, causal, window, prefix)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, *mask)
    assert flash_attention_bwd.launches == n0 + 1
    want = ref.flash_attention_bwd(*args, *(mask[:2]),
                                   window if window and window < Sq
                                   else None, prefix)
    for a, b in zip(got, want):
        _close_grad(a, b)


def _bwd_fp64(q, k, v, o, do, scale, window):
    """dq and dk of causal attention with a window, from the backward's
    formulas in fp64 on the same (fp32) inputs."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg, dog, og = (t.double().reshape(B, S, Hkv, H // Hkv, D)
                   for t in (q, do, o))
    kd, vd = k.double(), v.double()
    t = torch.arange(S, device=q.device)
    ok = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd) * scale
    p = torch.softmax(torch.where(ok, s, torch.full_like(s, -1e300)), -1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vd)
    ds = p * (dp - (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kd) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return dq.reshape(q.shape), dk


def test_flash_bwd_window_one_is_within_fp32_noise(card):
    """A window of 1: each query attends only itself, P is 1 and the exact
    dQ and dK are 0. With D = sum_j softmax(S)_ij dP_ij, D is dP's own
    value on both sides and dS is exactly 0 (with rowsum(dO * O) it was
    fp32 rounding noise). The kernel's dQ and dK stay within twice the
    plain version's own distance from the fp64 values."""
    args = _bwd_inputs(card, 464, 1, 200, 200, 6, 3, 64, True, 1, 0)
    got = flash_attention_bwd(*args, 64 ** -0.5, True, 1, 0)
    want = ref.flash_attention_bwd(*args, 64 ** -0.5, True, 1, 0)
    exact = _bwd_fp64(*args[:4], args[5], 64 ** -0.5, 1)
    torch.cuda.synchronize()
    for g, w, e in zip(got[:2], want[:2], exact):
        kernel = (g.double() - e).abs().max().item()
        plain = (w.double() - e).abs().max().item()
        assert kernel <= 2 * plain, (kernel, plain)


def test_flash_bwd_kernel_is_deterministic(card):
    args = _bwd_inputs(card, 21, 2, 512, 512, 8, 1, 256, True, None, 256)
    first = flash_attention_bwd(*args, 256 ** -0.5, True, None, 256)
    again = flash_attention_bwd(*args, 256 ** -0.5, True, None, 256)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_launches_both_kernels(card, dt):
    """Through autograd K4 runs once forward (with its lse) and its
    backward once, and the gradients are the plain backward's."""
    q, k, v, _, _, do = _bwd_inputs(card, 22, 2, 300, 300, 9, 3, 64, True,
                                    None, 0)
    q, k, v = (t.to(dt).requires_grad_(True) for t in (q, k, v))
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do.to(dt))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        f0 + 1, b0 + 1)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    o, lse = ref.flash_attention(qf, kf, vf, 64 ** -0.5, True,
                                 return_lse=True)
    want = ref.flash_attention_bwd(qf, kf, vf, out.detach().float(), lse,
                                   do.to(dt).float(), 64 ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dt
        if dt == torch.float32:
            _close_grad(a, b)
        else:   # one bf16 rounding of each gradient
            err = (a.float() - b).abs().max().item()
            assert err <= 1e-2 * b.abs().max().item(), err


@pytest.mark.parametrize("B,S,H,Hkv,D,window,prefix", [
    (1, 64, 4, 2, 64, None, 0),         # a short prompt: split walk
    (8, 2048, 9, 3, 64, None, 0),       # smollm's train shape: unsplit
    (2, 512, 8, 1, 256, None, 256),     # paligemma's prefix
    (1, 1000, 16, 1, 256, 512, 0),      # a window
])
def test_flash_lse_output_changes_no_bit(card, B, S, H, Hkv, D, window,
                                         prefix):
    g = torch.Generator(device=card).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=g, device=card)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=card)
            for _ in range(2))
    plain = flash_attention(q, k, v, window=window, prefix_len=prefix)
    split = flash_attention.last_split
    out, lse = fa_mod._forward(q, k, v, D ** -0.5, True, window, prefix,
                               True)
    assert flash_attention.last_split == split
    assert torch.equal(out, plain)
    _, want = ref.flash_attention(q, k, v, D ** -0.5, True, window, prefix,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert (lse - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _refusing_calls(card):
    g = torch.Generator(device=card).manual_seed(23)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    pages = r(8, 16, 2, 64)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=card)
    lens = torch.full((2,), 5, dtype=torch.int32, device=card)
    return {
        "paged_decode_attention": lambda q: paged_decode_attention(
            q(2, 4, 64), pages, pages, bt, lens),
        "chunked_prefill_attention": lambda q: chunked_prefill_attention(
            q(2, 16, 4, 64), pages, pages, bt,
            torch.zeros(2, dtype=torch.int32, device=card)),
        "decode_attention": lambda q: decode_attention(
            q(2, 4, 64), r(2, 32, 2, 64), r(2, 32, 2, 64), lens),
    }


@pytest.mark.parametrize("name", ["paged_decode_attention",
                                  "chunked_prefill_attention",
                                  "decode_attention"])
def test_kernels_without_backward_refuse_autograd(card, name):
    """A CUDA launch fills its output through a raw pointer (no grad_fn):
    under autograd the wrapper raises instead of dropping the gradient,
    and under no_grad it launches as before."""
    call = _refusing_calls(card)[name]
    g = torch.Generator(device=card).manual_seed(24)
    leaf = lambda *s: torch.randn(*s, generator=g,
                                  device=card).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        call(leaf)
    with torch.no_grad():
        call(leaf)


def test_flash_bwd_head_split_matches_the_unsplit_walk(card, monkeypatch):
    """paligemma's one kv head leaves the dK/dV grid short of the card:
    its 8 query heads split across blocks, merged in group order, give the
    unsplit walk's gradients within 1e-4 of their largest (the heads sum in
    another grouping) and dQ bit for bit."""
    args = _bwd_inputs(card, 25, 2, 512, 512, 8, 1, 256, True, None, 256)
    split = flash_attention_bwd(*args, 256 ** -0.5, True, None, 256)
    assert flash_attention_bwd.last_split == 8
    monkeypatch.setattr(fa_mod, "bwd_split", lambda blocks, G, sms: 1)
    whole = flash_attention_bwd(*args, 256 ** -0.5, True, None, 256)
    assert flash_attention_bwd.last_split == 1
    assert torch.equal(split[0], whole[0])
    for a, b in zip(split[1:], whole[1:]):
        _close_grad(a, b)


# ------------------------------------------- K5's and K6's backward kernels

def _ssd_grads(card, seed, shapes, given=(1, 1, 1, 1)):
    """Upstream gradients of K5's four outputs (unit normals; None where
    ``given`` leaves one out)."""
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(*s, generator=g, device=card) if k else None
            for s, k in zip(shapes, given)]


def _ssd_bwd_case(card, seed, Bsz, nc, Q, H, P, N, strong=False,
                  given=(1, 1, 1, 1)):
    inputs = _ssd_inputs(card, seed, Bsz, nc, Q, H, P, N, strong)
    cum = ref.ssd_chunk(*inputs)[3]
    grads = _ssd_grads(card, seed + 1, [
        (Bsz, nc, Q, H, P), (Bsz, nc, H, P, N), (Bsz, nc, H),
        (Bsz, nc, Q, H)], given)
    return (*inputs, cum, *grads)


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong,given", [
    (1, 1, 1, 2, 16, 16, False, (1, 1, 1, 1)),      # one row
    (1, 1, 37, 32, 64, 128, False, (1, 1, 1, 1)),   # ragged, full width
    (2, 3, 64, 4, 16, 128, True, (1, 1, 1, 1)),     # one tile, a = -32
    (1, 2, 65, 33, 32, 32, False, (1, 1, 1, 1)),    # a tile and a row
    (1, 4, 256, 32, 64, 128, True, (1, 1, 1, 1)),   # mamba2-370m's chunk
    (2, 2, 256, 8, 128, 64, False, (1, 0, 1, 1)),   # no state gradient
    (1, 2, 200, 4, 32, 16, True, (0, 1, 0, 0)),     # the state's alone
    (1, 1, 1024, 4, 64, 128, True, (1, 1, 0, 1)),   # QMAX
    (2, 3, 16, 32, 16, 16, False, (1, 1, 1, 1)),    # mamba2 .reduced()
    # ragged chunks around the 64-row tiles of the mma passes
    (2, 1, 37, 4, 128, 32, True, (1, 1, 1, 1)),     # one ragged tile, P 128
    (1, 2, 255, 8, 64, 128, False, (1, 1, 1, 1)),   # one short of 4 tiles
    (1, 2, 257, 8, 64, 128, True, (1, 1, 1, 1)),    # one past
])
def test_ssd_chunk_bwd_kernel_matches_plain(card, Bsz, nc, Q, H, P, N,
                                            strong, given):
    args = _ssd_bwd_case(card, Q + H + P, Bsz, nc, Q, H, P, N, strong,
                         given)
    n0 = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(*args)
    assert ssd_chunk_bwd.launches == n0 + 1
    want = ref.ssd_chunk_bwd(*args)
    bounds = bwd_error_bound(*args)
    torch.cuda.synchronize()
    for name, g, w, b in zip(("gx", "gdt", "ga", "gB", "gC"), got, want,
                             bounds):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        excess = ((g - w).abs() - b).max().item()
        assert excess <= 0, (name, excess)


def test_ssd_chunk_bwd_kernel_is_deterministic(card):
    args = _ssd_bwd_case(card, 31, 2, 4, 256, 32, 64, 128, True)
    first = ssd_chunk_bwd(*args)
    for _ in range(2):
        for g, w in zip(ssd_chunk_bwd(*args), first):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,with_h0", [
    (1, 2048, 4096, False),               # recurrentgemma-9b's train shape
    (1, 37, 4096, True),
    (3, 1, 100, True),                    # one step, ragged channels
    (2, 33, 31, False),                   # S and C both ragged
    (2, 300, 256, True),                  # .reduced() width
    (2, 257, 4096, True),                 # a ring stage past a whole one
    (1, 15, 4096, False),                 # a consumer batch -1/0/+1
    (1, 16, 4096, True),
    (1, 17, 4096, False),
    (2, 63, 4096, False),                 # a ring stage -1/0/+1
    (2, 64, 4096, True),
    (2, 65, 4096, False),
    (1, 129, 4096, True),                 # two stages +1
    (3, 129, 4096, True),                 # B > 1 with h0
    (4, 2049, 256, True),
])
def test_rglru_scan_bwd_kernel_is_bit_equal_to_plain(card, B, S, C, with_h0,
                                                     dt):
    g = torch.Generator(device=card).manual_seed(S + C + 1)
    a = torch.sigmoid(torch.randn(B, S, C, generator=g, device=card)).to(dt)
    b = torch.randn(B, S, C, generator=g, device=card).to(dt)
    h0 = (torch.randn(B, C, generator=g, device=card) if with_h0 else None)
    h = rglru_scan(a, b, h0)
    gh = torch.randn(B, S, C, generator=g, device=card)
    n0 = rglru_scan_bwd.launches
    got = rglru_scan_bwd(a, h, h0, gh)
    assert rglru_scan_bwd.launches == n0 + 1
    want = ref.rglru_scan_bwd(a, h, h0, gh)
    torch.cuda.synchronize()
    assert got[0].dtype == dt and got[1].dtype == dt
    assert (got[2] is None) == (h0 is None)
    for x, y in zip(got, want):
        if y is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_kernel_takes_the_word_path_bit_equal(card, dt):
    """a one element into its storage (bf16: not 4-byte aligned) and gh at
    an odd offset: every lane copies the word holding its element."""
    g = torch.Generator(device=card).manual_seed(10)
    a = torch.rand(2 * 257 * 4096 + 1, generator=g, device=card).to(dt)
    a = a[1:].view(2, 257, 4096)
    h = torch.randn(2, 257, 4096, generator=g, device=card)
    gh = torch.randn(2 * 257 * 4096 + 1, generator=g, device=card)[1:].view(
        2, 257, 4096)
    h0 = torch.randn(2, 4096, generator=g, device=card)
    for x, y in zip(rglru_scan_bwd(a, h, h0, gh),
                    ref.rglru_scan_bwd(a, h, h0, gh)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("word", [False, True])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 129, 2049])
def test_rglru_scan_bwd_kernel_paths_at_the_walks_edges(card, S, word, dt):
    """Both copy paths at the batch and stage edges of the walk, two
    sequences with h0: 16-byte chunks where a, h and gh are aligned, the
    word path where a and gh start one element into their storage."""
    g = torch.Generator(device=card).manual_seed(S + 20)
    n = 2 * S * 4096
    a = torch.sigmoid(torch.randn(n + 1, generator=g, device=card)).to(dt)
    gh = torch.randn(n + 1, generator=g, device=card)
    a = (a[1:] if word else a[:n]).view(2, S, 4096)
    gh = (gh[1:] if word else gh[:n]).view(2, S, 4096)
    h = torch.randn(2, S, 4096, generator=g, device=card)
    h0 = torch.randn(2, 4096, generator=g, device=card)
    assert rglru_mod.bwd_kernel_attrs(a, h, gh)["chunks_16_bytes"] != word
    for x, y in zip(rglru_scan_bwd(a, h, h0, gh),
                    ref.rglru_scan_bwd(a, h, h0, gh)):
        assert torch.equal(x, y)


def test_rglru_scan_bwd_kernel_is_deterministic(card):
    g = torch.Generator(device=card).manual_seed(12)
    a = torch.sigmoid(torch.randn(2, 1000, 4096, generator=g, device=card))
    h, gh = (torch.randn(2, 1000, 4096, generator=g, device=card)
             for _ in range(2))
    h0 = torch.randn(2, 4096, generator=g, device=card)
    first = rglru_scan_bwd(a, h, h0, gh)
    for x, y in zip(rglru_scan_bwd(a, h, h0, gh), first):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_kernel_reports_its_layout(card, dt):
    """A consumer and a producer warp a block, the ring's stages and
    steps as the source sets them, its shared bytes (the ring and a full
    and an empty barrier a stage), and no local memory."""
    steps, stages, batch = kernel_constants()
    a = torch.rand(1, 2048, 4096, device=card).to(dt)
    h = torch.rand(1, 2048, 4096, device=card)
    attrs = rglru_mod.bwd_kernel_attrs(a, h, h)
    row = 32 * a.element_size() + 2 * 32 * 4
    assert attrs["chunks_16_bytes"] and attrs["threads"] == 64
    assert (attrs["consumer_warps"], attrs["producer_warps"]) == (1, 1)
    assert (attrs["steps_a_stage"], attrs["stages"],
            attrs["steps_a_batch"]) == (steps, stages, batch)
    assert attrs["smem_bytes"] == stages * steps * row + 2 * stages * 8
    assert attrs["local_bytes"] == 0 and attrs["blocks_per_sm"] >= 1
    assert attrs["grid"] == [128, 1]
    word = rglru_mod.bwd_kernel_attrs(a.flatten()[1:].view(1, 1, -1),
                                      h.flatten()[1:].view(1, 1, -1),
                                      h.flatten()[1:].view(1, 1, -1))
    assert not word["chunks_16_bytes"] and word["local_bytes"] == 0
    assert word["smem_bytes"] == stages * steps * 3 * 128 + 2 * stages * 8


def test_scan_kernels_train_under_autograd(card):
    """K5 and K6 under autograd on CUDA tensors: the forward and the
    backward kernel launch once each, every input that requires a
    gradient gets one, and it is the backward kernel's."""
    args = _ssd_inputs(card, 40, 1, 2, 64, 4, 16, 16, True)
    leaves = [t.clone().requires_grad_(True) for t in args]
    n0, b0 = ssd_chunk.launches, ssd_chunk_bwd.launches
    outs = ssd_chunk(*leaves)
    ups = _ssd_grads(card, 41, [o.shape for o in outs])
    grads = torch.autograd.grad(outs, leaves, ups)
    assert (ssd_chunk.launches, ssd_chunk_bwd.launches) == (n0 + 1, b0 + 1)
    want = ssd_chunk_bwd(*args, outs[3].detach(), *ups)
    for g, w in zip(grads, want):
        assert g is not None and torch.equal(g, w)

    gen = torch.Generator(device=card).manual_seed(42)
    a = torch.sigmoid(torch.randn(2, 50, 96, generator=gen, device=card))
    b = torch.randn(2, 50, 96, generator=gen, device=card)
    h0 = torch.randn(2, 96, generator=gen, device=card)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    n0, b0 = rglru_scan.launches, rglru_scan_bwd.launches
    h = rglru_scan(*leaves)
    gh = torch.randn(h.shape, generator=gen, device=card)
    grads = torch.autograd.grad(h, leaves, gh)
    assert (rglru_scan.launches, rglru_scan_bwd.launches) == (n0 + 1, b0 + 1)
    for g, w in zip(grads, ref.rglru_scan_bwd(a, h.detach(), h0, gh)):
        assert g is not None and torch.equal(g, w)
