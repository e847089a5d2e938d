"""The schedule of K6's backward on Hopper
(``src/repro_torch/csrc/rglru_scan_bwd.cu``), modelled in numpy so that the
CPU checks it against the port's plain version bit for bit.

The kernel walks the sequence from its end. Stage k of its shared-memory
ring holds the steps [k RB_STEPS, (k + 1) RB_STEPS) below S, so only the
first stage walked (the top of the sequence) is ragged. A producer fills
ring slot j % RB_STAGES with the walk's j-th stage once the consumer has
released what the slot held. The consumer takes the ragged stage's top
step (whose ga[t + 1] would be ga[S]: not written), then single steps up
to whole batches, then batches of RB_BATCH steps; every later stage is
RB_STEPS / RB_BATCH batches. A batch loads its steps' a, h and gh first,
then runs the dependent chain g = gh[t] + a[t + 1] g (a rounded multiply,
then a rounded add), then stores: gx[t] = g, and ga[t + 1] = g[t + 1] h[t]
once h[t] is read. After the walk ga[0] = g[0] h0 (zeros without h0) and
gh0 = a[0] g[0].

``model_rglru_scan_bwd`` runs that schedule at the kernel's constants
(read from its source) and at a small geometry that wraps the ring many
times, and must equal ``ref.rglru_scan_bwd`` bit for bit in fp32 and bf16,
with and without h0, at S of 1, a batch -1/0/+1, a stage -1/0/+1, two
stages +1 and 2,049, at ragged C. It also counts the reads and writes:
every step is read once from each input and every output written once.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"


def kernel_constants():
    """(RB_STEPS, RB_STAGES, RB_BATCH) as the kernel's source sets them."""
    text = (CSRC / "rglru_scan_bwd.cu").read_text()
    return tuple(
        int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
        for k in ("RB_STEPS", "RB_STAGES", "RB_BATCH"))


def model_rglru_scan_bwd(a, h, h0, gh, steps, stages, batch):
    """The kernel's walk on float32 numpy arrays a, h, gh (B, S, C) and h0
    (B, C) or None, every lane of a strip at once. Returns (ga, gx, gh0,
    reads (3, S): a, h, gh reads of each step, writes (2, S): ga, gx
    writes of each step)."""
    Bsz, S, C = a.shape
    ga = np.full((Bsz, S, C), np.nan, np.float32)
    gx = np.full((Bsz, S, C), np.nan, np.float32)
    reads = np.zeros((3, S), np.int64)
    writes = np.zeros((2, S), np.int64)
    nk = -(-S // steps)
    ring = [None] * stages

    def produce(j):
        slot, k = j % stages, nk - 1 - j
        assert ring[slot] is None, "a slot refilled before it was read"
        t0 = k * steps
        n = min(steps, S - t0)
        ring[slot] = (k, a[:, t0:t0 + n], h[:, t0:t0 + n], gh[:, t0:t0 + n])
        reads[:, t0:t0 + n] += 1

    g = np.zeros((Bsz, C), np.float32)
    a_next = np.zeros((Bsz, C), np.float32)

    def steps_down(t0, sa, sh, sg, r, n, ga_first):
        """n steps from ring row r down: loads, chain, stores."""
        nonlocal g, a_next
        hv = [sh[:, r - i] for i in range(n)]
        gv = [sg[:, r - i] for i in range(n)]
        av = [sa[:, r - i] for i in range(n)]
        go, xo = [], []
        for i in range(n):
            go.append(g * hv[i])                 # ga[t + 1] = g[t + 1] h[t]
            g = gv[i] + a_next * g
            xo.append(g)
            a_next = av[i]
        for i in range(n):
            t = t0 + r - i
            if i > 0 or ga_first:
                ga[:, t + 1] = go[i]
                writes[0, t + 1] += 1
            gx[:, t] = xo[i]
            writes[1, t] += 1

    for j in range(min(stages, nk)):
        produce(j)
    for j in range(nk):
        slot = j % stages
        k, sa, sh, sg = ring[slot]
        assert k == nk - 1 - j
        t0 = k * steps
        if j == 0:                               # the ragged stage
            r = sa.shape[1] - 1
            steps_down(t0, sa, sh, sg, r, 1, False)
            r -= 1
            for _ in range((r + 1) % batch):
                steps_down(t0, sa, sh, sg, r, 1, True)
                r -= 1
            while r >= 0:
                steps_down(t0, sa, sh, sg, r, batch, True)
                r -= batch
        else:
            assert sa.shape[1] == steps
            for r in range(steps - 1, -1, -batch):
                steps_down(t0, sa, sh, sg, r, batch, True)
        ring[slot] = None                        # the consumer releases it
        if j + stages < nk:
            produce(j + stages)
    hp = h0 if h0 is not None else np.zeros((Bsz, C), np.float32)
    ga[:, 0] = g * hp
    writes[0, 0] += 1
    gh0 = a_next * g if h0 is not None else None
    return ga, gx, gh0, reads, writes


def _inputs(seed, Bsz, S, C, dtype, with_h0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(
        1 / (1 + np.exp(-rng.standard_normal((Bsz, S, C))))).float().to(dtype)
    h = torch.from_numpy(rng.standard_normal((Bsz, S, C))).float()
    gh = torch.from_numpy(rng.standard_normal((Bsz, S, C))).float()
    h0 = (torch.from_numpy(rng.standard_normal((Bsz, C))).float()
          if with_h0 else None)
    return a, h, h0, gh


def _check(S, C, dtype, with_h0, steps, stages, batch, Bsz=2):
    a, h, h0, gh = _inputs(S * 7 + C, Bsz, S, C, dtype, with_h0)
    ga, gx, gh0, reads, writes = model_rglru_scan_bwd(
        a.float().numpy(), h.numpy(), None if h0 is None else h0.numpy(),
        gh.numpy(), steps, stages, batch)
    assert (reads == 1).all(), "a step not read exactly once"
    assert (writes == 1).all(), "an output not written exactly once"
    want = ref.rglru_scan_bwd(a, h, h0, gh)
    got = (torch.from_numpy(ga).to(dtype), torch.from_numpy(gx).to(dtype),
           None if gh0 is None else torch.from_numpy(gh0))
    for name, x, y in zip(("ga", "gx", "gh0"), got, want):
        assert (x is None) == (y is None), name
        if y is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


STEPS, STAGES, BATCH = kernel_constants()


def test_kernel_constants_make_whole_batches():
    assert STEPS % BATCH == 0 and STAGES >= 2 and BATCH >= 1


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [31, 100])
@pytest.mark.parametrize("S", [1, BATCH - 1, BATCH, BATCH + 1, STEPS - 1,
                               STEPS, STEPS + 1, 2 * STEPS + 1, 2049])
def test_walk_is_bit_equal_to_plain_at_the_kernels_constants(S, C, dtype,
                                                             with_h0):
    _check(S, C, dtype, with_h0, STEPS, STAGES, BATCH)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 3, 4, 5, 7, 8, 9, 17, 100])
def test_walk_is_bit_equal_when_the_ring_wraps_often(S, dtype):
    """Stages of 8 steps in 2 slots, batches of 4: every S above 16 wraps
    the ring, and the ragged stage covers each of its lengths."""
    _check(S, 5, dtype, True, 8, 2, 4, Bsz=3)
