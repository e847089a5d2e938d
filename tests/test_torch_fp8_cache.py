"""The port's fp8 dense KV caches held to the reference's, on the CPU.

``Model.init_cache(dtype=float8)`` adds fp32 ``k_scale``/``v_scale``
leaves beside each attention layer's ``k``/``v``; K/V are quantized on
write with a per-token-per-head scale (``attention._fp8_quantize``), and
decode dequantizes the whole cache to fp32 before the decode kernel (its
plain version here).

* ``_fp8_quantize`` on the same fp32 inputs gives the reference's bytes
  and scales bit for bit, for ``float8_e4m3fn`` and ``float8_e5m2``,
  including a row that holds the amax far above the rest and an all-zero
  row (scale floored at 1e-12);
* ``init_cache`` lays out the reference's leaves (names, shapes, dtypes,
  ones for the scales);
* smollm-135m ``.reduced()`` (the reference test's B 2, S 16, 3 decode
  steps) and recurrentgemma-9b ``.reduced()`` (window 64: a 40-token
  prompt, and an 80-token one whose ring keeps the last 64 tokens and
  their scales): the port's decode logits with an fp8 cache against the
  reference's with the same cache, and the reference test's bounds for
  fp32 against fp8 on the port.

Tolerance, port against reference with the same fp8 cache: 1e-3 on the
logits. Both sides quantize their own K/V, which come from fp32 matmuls
summed in other orders (~1e-6 apart), so an element next to a rounding
boundary can land one fp8 step apart (measured <= 1.5e-5 on the logits).
fp32 against fp8 on the port, for ``float8_e4m3fn`` (the reference
test's dtype): its max abs gap < 0.5 and mean relative gap < 0.05.
``float8_e5m2`` keeps two mantissa bits, and its mean relative gap is
~0.1 here; the reference claims no bound for it, so only its parity
with the reference is held. The module runs under
``_torch_parity.lean_cpu`` (one torch thread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.configs.base import get_config as jget_config
from repro.models.attention import _fp8_quantize as j_fp8_quantize
from repro.models.model import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.models.attention import _fp8_quantize
from repro_torch.models.model import get_model

pytestmark = pytest.mark.usefixtures("lean_cpu")
CPU = "cpu"
DTYPES = {"e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
PORT_TOL = 1e-3
MAX_GAP, MEAN_REL = 0.5, 0.05       # tests/test_extensions.py's bounds


def _arch(name):
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    return (cfg, model, bridge.from_reference(cfg, jax.device_get(jparams)),
            jmodel, jparams)


@pytest.fixture(scope="module")
def smollm():
    return _arch("smollm-135m")


@pytest.fixture(scope="module")
def rgemma():
    return _arch("recurrentgemma-9b")


# ------------------------------------------------------------ quantizer

@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0, 1e4])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fp8_quantize_is_bit_equal_to_the_reference(dt, scale):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(int(scale * 1000) % 997)
    x = (rng.standard_normal((3, 17, 2, 64)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                      # zero row: the 1e-12 floor
    x[1, 2, 1, 7] = 200.0 * scale         # an amax far above its row
    x[2, 3, 0] = -x[2, 3, 0]
    q, s = _fp8_quantize(torch.from_numpy(x), tdt)
    jq, js = j_fp8_quantize(jnp.asarray(x), jdt)
    assert q.dtype == tdt and s.dtype == torch.float32
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert float(s[0, 0, 0]) == np.float32(1e-12)
    assert not q[0, 0, 0].float().any()
    assert float(q[1, 2, 1, 7].float()) == float(torch.finfo(tdt).max)


@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-9b"])
def test_init_cache_lays_out_the_reference_leaves(name):
    """Every attention layer gets fp32 ones ``k_scale``/``v_scale`` of
    (B, W, Hkv), as the reference's tree holds them (stacked there along
    a leading layer dim), and nothing else gets a scale."""
    cfg = get_config(name).reduced()
    jcfg = jget_config(name).reduced()
    got = get_model(cfg).init_cache(2, 96, dtype=torch.float8_e4m3fn,
                                    device=CPU)
    jtree = jget_model(jcfg).init_cache(2, 96, dtype=jnp.float8_e4m3fn)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        key = jax.tree_util.keystr(path)
        for n in ("k", "v", "k_scale", "v_scale"):
            if key.endswith(f"['{n}']"):
                w = want.setdefault(n, [0, set(), set()])
                w[0] += int(np.prod(leaf.shape))
                w[1].add(tuple(leaf.shape[-4 if len(n) == 1 else -3:]))
                w[2].add(str(leaf.dtype))
                if n.endswith("scale"):
                    assert bool((np.asarray(leaf) == 1).all())
    have = {}
    for layer in got:
        for n, leaf in layer.items():
            if n in ("k", "v", "k_scale", "v_scale"):
                h = have.setdefault(n, [0, set(), set()])
                h[0] += leaf.numel()
                h[1].add(tuple(leaf.shape))
                h[2].add(str(leaf.dtype).replace("torch.", ""))
                if n.endswith("scale"):
                    assert bool((leaf == 1).all())
                    assert leaf.shape == layer["k"].shape[:-1]
        if "k" not in layer:
            assert not any(n.endswith("_scale") for n in layer)
    assert have == want
    plain = get_model(cfg).init_cache(2, 96, dtype=torch.bfloat16,
                                      device=CPU)
    assert not any(n.endswith("_scale") for layer in plain for n in layer)


# -------------------------------------------------------------- decode

def _decode(model, params, B, S, T, max_len, dtype, toks, jax_side=False):
    """Prefill ``toks[:, :S]`` into a dense cache of ``dtype``, then ``T``
    decode steps; returns the stacked (T, B, vocab) logits."""
    if jax_side:
        cache = model.init_cache(B, max_len, dtype=dtype)
        _, cache, _ = model.forward(params, mode="full", cache=cache,
                                    tokens=jnp.asarray(toks[:, :S]))
        out = []
        for t in range(T):
            lg, cache, _ = model.forward(
                params, mode="decode", cache=cache, pos=jnp.int32(S + t),
                tokens=jnp.asarray(toks[:, S + t:S + t + 1]))
            out.append(np.asarray(lg, np.float32))
        return np.stack(out)
    cache = model.init_cache(B, max_len, dtype=dtype, device=CPU)
    _, cache = model.forward(params, mode="full", cache=cache,
                             tokens=torch.from_numpy(toks[:, :S]))
    out = []
    for t in range(T):
        lg, cache = model.forward(
            params, mode="decode", cache=cache, pos=S + t,
            tokens=torch.from_numpy(toks[:, S + t:S + t + 1]))
        out.append(lg.float().numpy())
    return np.stack(out)


def _hold(arch, B, S, T, max_len, dt):
    cfg, model, params, jmodel, jparams = arch
    tdt, jdt = DTYPES[dt]
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    fp8 = _decode(model, params, B, S, T, max_len, tdt, toks)
    ref8 = _decode(jmodel, jparams, B, S, T, max_len, jdt, toks,
                   jax_side=True)
    assert np.all(np.isfinite(fp8))
    np.testing.assert_allclose(fp8, ref8, rtol=0, atol=PORT_TOL)
    if dt != "e4m3fn":
        return               # the reference test's bounds are e4m3fn's
    f32 = _decode(model, params, B, S, T, max_len, torch.float32, toks)
    gap = np.abs(f32 - fp8)
    assert float(gap.max()) < MAX_GAP
    assert gap.mean() / (np.abs(f32).mean() + 1e-9) < MEAN_REL


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fp8_decode_matches_reference_smollm(smollm, dt):
    """The reference test's shapes: B 2, a 16-token prompt, 3 steps, a
    cache of exactly S + T slots."""
    _hold(smollm, 2, 16, 3, 19, dt)


@pytest.mark.parametrize("S", [40, 80])
def test_fp8_decode_matches_reference_windowed(rgemma, S):
    """recurrentgemma-9b ``.reduced()``: window 64, so the attention
    layer's cache is a 64-slot ring; an 80-token prompt keeps its last 64
    tokens and their scales, and decode writes at ``pos % 64``."""
    _hold(rgemma, 2, S, 4, 128, "e4m3fn")
