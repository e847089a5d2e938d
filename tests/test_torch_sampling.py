"""The port's token sampler against the reference's, and stochastic
serving inside the port.

``jax.random`` streams cannot be reproduced (ROADMAP R2), so the draws
are held to the reference statistically, on fixed logits: 4,096 seeded
reference draws per case must fall inside the port's kept set (the
filters are deterministic), and their frequencies must match the port's
kept-set probabilities within a binomial bound. The port's own draws are
held to the same probabilities, which checks the counter hash's uniforms
and the Gumbel-max. Inside the port: the same key gives the same draws on
every call and in every row order, the same seed gives the same streams,
and fused equals unfused at ``temperature > 0``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.serving.sampling import sample as jsample
from repro_torch.configs.base import get_config
from repro_torch.serving import sampling
from repro_torch.serving.batcher import (ContinuousBatcher,
                                         PagedContinuousBatcher)

# one torch thread, and the reference's step functions shared by
# every batcher of a config (``_torch_parity.lean_cpu``)
pytestmark = pytest.mark.usefixtures("lean_cpu")

N_DRAWS = 4096
# a tie at the 5th largest logit (index 3 and 9 both hold 1.0) and at the
# 1st (index 0 and 6 hold 2.5), plus a long tail
LOGITS = np.array([2.5, 0.3, 1.7, 1.0, -0.5, 1.2, 2.5, -2.0, 0.1, 1.0,
                   -1.0, 0.6], np.float32)
CASES = [(t, k, p) for t in (0.7, 1.3) for k in (0, 1, 5)
         for p in (0.1, 0.9, 1.0)]


def _binomial_bound(p, n):
    """Five standard deviations of a frequency over n draws, plus one
    draw: a false alarm has probability ~6e-7 per token."""
    return 5.0 * np.sqrt(p * (1.0 - p) / n) + 1.0 / n


def _port_probs(logits, t, k, p):
    lg = sampling.filter_logits(torch.from_numpy(logits)[None], t, k, p)[0]
    kept = torch.isfinite(lg).numpy()
    probs = torch.softmax(lg.double(), -1).numpy()
    return kept, probs


def _reference_draws(logits, t, k, p, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), N_DRAWS)
    draw = jax.vmap(lambda key: jsample(jnp.asarray(logits)[None], key, t,
                                        k, p)[0])
    return np.asarray(draw(keys))


def _port_draws(logits, t, k, p, seed=0):
    rows = torch.from_numpy(np.repeat(logits[None], N_DRAWS, 0))
    keys = torch.stack([torch.full((N_DRAWS,), seed, dtype=torch.int64),
                        torch.arange(N_DRAWS, dtype=torch.int64)], 1)
    return sampling.sample(rows, keys, t, k, p).numpy()


@pytest.mark.parametrize("t,k,p", CASES)
def test_reference_draws_fall_in_the_ports_kept_set(t, k, p):
    """Every reference draw is a token the port's filters keep, and the
    reference's frequencies match the port's kept-set probabilities."""
    kept, probs = _port_probs(LOGITS, t, k, p)
    got = _reference_draws(LOGITS, t, k, p)
    assert kept[got].all(), sorted(set(got[~kept[got]].tolist()))
    freq = np.bincount(got, minlength=len(LOGITS)) / N_DRAWS
    for v in np.flatnonzero(kept):
        assert abs(freq[v] - probs[v]) <= _binomial_bound(probs[v],
                                                           N_DRAWS), v


@pytest.mark.parametrize("t,k,p", CASES)
def test_port_draws_follow_the_filtered_distribution(t, k, p):
    """The port's counter-based Gumbel-max draws never leave the kept set
    and their frequencies match the filtered softmax."""
    kept, probs = _port_probs(LOGITS, t, k, p)
    got = _port_draws(LOGITS, t, k, p, seed=3)
    assert kept[got].all()
    freq = np.bincount(got, minlength=len(LOGITS)) / N_DRAWS
    for v in range(len(LOGITS)):
        assert abs(freq[v] - probs[v]) <= _binomial_bound(probs[v],
                                                           N_DRAWS), v


def test_filters_keep_ties_and_match_the_reference_rule():
    """top-k keeps every logit tied with the k-th; top-k 1 keeps both
    tied maxima; top-p 0.1 keeps the top of the sorted list (and its
    ties); top-p 1.0 with top-k 0 keeps everything."""
    kept, _ = _port_probs(LOGITS, 1.0, 5, 1.0)
    assert sorted(np.flatnonzero(kept)) == [0, 2, 3, 5, 6, 9]
    kept, _ = _port_probs(LOGITS, 1.0, 1, 1.0)
    assert sorted(np.flatnonzero(kept)) == [0, 6]
    kept, _ = _port_probs(LOGITS, 1.0, 0, 0.1)
    assert sorted(np.flatnonzero(kept)) == [0, 6]
    kept, _ = _port_probs(LOGITS, 1.0, 0, 1.0)
    assert kept.all()


def test_greedy_is_the_first_maximal_index():
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    lg[2, 7] = lg[2, 30] = lg[2].max() + 1.0           # a tie: first wins
    want = torch.argmax(lg, -1).to(torch.int32)
    assert torch.equal(sampling.sample(lg), want)
    assert torch.equal(sampling.sample(lg, (1, 0), 0.0), want)
    assert int(sampling.sample(lg)[2]) == 7
    assert torch.equal(sampling.sample(lg), torch.from_numpy(
        np.array(jnp.argmax(jnp.asarray(lg.numpy()), -1))))


def test_same_key_same_draws_in_any_row_order():
    """The counter noise is a function of (seed, draw, vocab index) only:
    bit-equal across calls, and permuting the rows permutes the noise."""
    rng = np.random.default_rng(1)
    lg = torch.from_numpy(rng.standard_normal((8, 300)).astype(np.float32))
    keys = torch.tensor([[11, n] for n in range(4)]
                        + [[7 + n, 3] for n in range(4)], dtype=torch.int64)
    a = sampling.perturbed_scores(lg, keys, 0.8)
    b = sampling.perturbed_scores(lg, keys, 0.8)
    assert torch.equal(a, b)
    perm = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4])
    c = sampling.perturbed_scores(lg[perm], keys[perm], 0.8)
    assert torch.equal(c, a[perm])
    assert torch.equal(sampling.sample(lg, keys, 0.8),
                       sampling.sample(lg, keys, 0.8))
    # another draw index gives other noise
    other = keys.clone()
    other[:, 1] += 1
    assert not torch.equal(sampling.perturbed_scores(lg, other, 0.8), a)


def test_counter_uniforms_are_uniform():
    """The top 24 bits of the hash over 4 streams x 16 draws x 4,096
    vocab entries fill 16 equal bins within a binomial bound, and no two
    streams share their bits."""
    seeds = torch.tensor([0, 1, 2, 2 ** 31 + 5] * 16, dtype=torch.int64)
    draws = torch.arange(64, dtype=torch.int64) // 4
    bits = sampling.counter_bits(seeds, draws, 4096)
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    n = bits.numel()
    hist = np.bincount((bits >> 28).flatten().numpy(), minlength=16) / n
    assert np.abs(hist - 1 / 16).max() <= _binomial_bound(1 / 16, n)
    assert len({tuple(r[:8].tolist()) for r in bits}) == bits.shape[0]


def test_stream_keys_differ_by_seed_and_admission():
    keys = {sampling.stream_key(s, n) for s in (1, 2, 8) for n in range(50)}
    assert len(keys) == 150
    assert all(k[1] == 0 and 0 <= k[0] < 2 ** 32 for k in keys)


# ------------------------------------------------- stochastic serving

PROMPTS = ["a somewhat longer request that spans multiple pages here",
           "short one", "a third prompt for the sampler",
           "and a fourth, longer one to cross a page boundary"]


@pytest.fixture(scope="module")
def cfg_params():
    cfg = get_config("smollm-135m").reduced()
    b = ContinuousBatcher(cfg, num_slots=2, max_len=96, device="cpu")
    return cfg, b.params


def _serve(cfg, params, cls, **kw):
    b = cls(cfg, params=params, num_slots=2, max_len=96, device="cpu", **kw)
    rids = [b.submit(p, max_new_tokens=6, trust_tier=2) for p in PROMPTS]
    done = b.run_until_done()
    return [done[r] for r in rids]


@pytest.mark.parametrize("mode", ["fused", "unfused", "full", "stacked"])
def test_same_seed_same_streams(cfg_params, mode):
    """Temperature 0.8: two runs with one seed give the same streams,
    and another seed gives others."""
    cfg, params = cfg_params
    cls, kw = ((ContinuousBatcher, {}) if mode == "stacked" else
               (PagedContinuousBatcher,
                {"fused": dict(fused=True), "unfused": dict(fused=False),
                 "full": dict(prefill="full")}[mode]))
    a = _serve(cfg, params, cls, temperature=0.8, seed=7, **kw)
    b = _serve(cfg, params, cls, temperature=0.8, seed=7, **kw)
    c = _serve(cfg, params, cls, temperature=0.8, seed=8, **kw)
    assert a == b
    assert a != c
    greedy = _serve(cfg, params, cls, **kw)
    assert a != greedy


def test_fused_equals_unfused_and_stacked_when_sampling(cfg_params):
    """The fused tick samples on the host side at temperature > 0, from
    the same logits and keys as the unfused and stacked paths."""
    cfg, params = cfg_params
    kw = dict(temperature=0.8, seed=5)
    fused = _serve(cfg, params, PagedContinuousBatcher, fused=True, **kw)
    unfused = _serve(cfg, params, PagedContinuousBatcher, fused=False, **kw)
    stacked = _serve(cfg, params, ContinuousBatcher, **kw)
    assert fused == unfused == stacked


def test_first_token_is_greedy_at_any_temperature(cfg_params):
    """The reference takes each request's first token by argmax of its
    prompt's logits whatever the temperature (ROADMAP R7); the port
    reproduces it on every path."""
    cfg, params = cfg_params
    for cls, kw in ((PagedContinuousBatcher, {}),
                    (PagedContinuousBatcher, dict(fused=False)),
                    (ContinuousBatcher, {})):
        greedy = _serve(cfg, params, cls, **kw)
        hot = _serve(cfg, params, cls, temperature=5.0, seed=1, **kw)
        assert [g[0] for g in greedy] == [h[0] for h in hot]
        assert greedy != hot
