"""K5's and K6's backward on the CPU: the plain backward functions
(``kernels/ref.py``: ``ssd_chunk_bwd``, ``rglru_scan_bwd``) and the
autograd Functions around the two kernels (``kernels.ssd.SsdChunk``,
``kernels.rglru.RglruScan``, which take the plain versions on CPU
tensors), against autograd and the reference.

* The closed-form backward functions against ``torch.autograd.grad`` of
  the plain forwards (``ref.ssd_chunk``, ``ref.rglru_scan``) in float64,
  where the two differ only by float64 rounding (1e-12 of each gradient's
  largest magnitude): ragged chunk lengths, a single row, a strongly
  decaying head (a = -32, dt ~ 1), each upstream gradient left out (None)
  in turn, an h0 and none. With bf16 a/b the backward's gradients come
  back in bf16 and equal autograd's through the forward's fp32 upcast
  bit for bit: both take each step as one rounded multiply and one
  rounded add, and round once to bf16.
* The port's ``models.ssm.ssd_chunked`` and ``models.rglru.lru_scan``
  under autograd (through ``SsdChunk`` and ``RglruScan``, which the test
  sees call the plain backward) against ``jax.vjp`` of the reference's
  ``repro.models.ssm.ssd_chunked`` and ``repro.models.rglru.lru_scan``
  (an associative scan), on inputs drawn with numpy at the models' init,
  sequences that are not a multiple of the chunk included. Both sides are
  fp32 and differ in summation order only: each gradient holds to 1e-5 of
  its largest magnitude: the SSD sums run over at most Q + N + H P
  products (8.6e-6 of their magnitude in the worst case at these sizes),
  the scan's over the sequence (its associative tree against the port's
  serial walk); the gaps measured here are at most 7.7e-7.
* Why the plain forward sums ``cum`` in K5's order (``ref.prefix_sum``):
  one train step of mamba2-370m at every mixer width (two layers, a
  1,024-token vocabulary) with that serial fp32 sum, and again with
  ``torch.cumsum``, which on the CPU accumulates in fp64. The loss moves
  by under 1e-6, but the gradient leaves of the dt path (``dt_bias``,
  ``A_log``, ``wdt``: sums over every row with heavy cancellation) move
  by more than 1e-5 of their largest (6.2e-5 measured here, against at
  most ~2e-5 for any other leaf), the scale of ``chip_smoke.py``'s
  card-vs-CPU reading (``TRAIN_GRAD_TOL`` 5e-5), and more than any other
  leaf.

The module runs under ``_torch_parity.lean_cpu`` (one torch thread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.kernels import ref
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.ssd import ssd_chunk
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm

pytestmark = pytest.mark.usefixtures("lean_cpu")

GRAD_TOL = 1e-5        # port vs reference, fp32, of the largest magnitude
F64_TOL = 1e-12        # closed form vs autograd, float64


def _silu(a):
    return a / (1.0 + np.exp(-a))


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _ssd_draw(seed, lead, H, P, N, strong=False):
    """Mamba-2's post-conv chunk inputs at its init (x, B, C silu of unit
    normals, dt = softplus(N(0,1) + dt_bias), a = -(1..H)); ``strong``:
    the last head decays at a = -32 with dt ~ 1. float64 numpy."""
    rng = np.random.default_rng(seed)
    x = _silu(rng.standard_normal(lead + (H, P)))
    B_ = _silu(rng.standard_normal(lead + (N,)))
    C_ = _silu(rng.standard_normal(lead + (N,)))
    u = rng.uniform(1e-3, 1e-1, H)
    dt = _softplus(rng.standard_normal(lead + (H,)) + np.log(np.expm1(u)))
    a = -np.arange(1, H + 1, dtype=np.float64)
    if strong:
        a[-1] = -32.0
        dt[..., -1] = rng.uniform(0.9, 1.1, lead)
    return x, dt, a, B_, C_


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# (Bsz, nc, Q, H, P, N, strong, upstream gradients given: y, state,
# decay, cum)
SSD_F64 = [
    (2, 2, 37, 3, 16, 16, False, (1, 1, 1, 1)),   # ragged Q
    (1, 1, 1, 2, 16, 16, False, (1, 1, 1, 1)),    # one row
    (1, 3, 64, 4, 16, 16, True, (1, 1, 1, 1)),    # a whole tile, a = -32
    (2, 1, 20, 2, 16, 16, False, (1, 0, 1, 1)),   # no state gradient
    (1, 2, 20, 2, 16, 16, False, (0, 1, 0, 0)),   # the state's alone
    (1, 2, 20, 2, 16, 16, True, (0, 0, 1, 1)),    # decay and cum alone
]


@pytest.mark.parametrize("Bsz,nc,Q,H,P,N,strong,given", SSD_F64)
def test_ssd_chunk_bwd_is_autograd_of_the_forward(Bsz, nc, Q, H, P, N,
                                                  strong, given):
    x, dt, a, B_, C_ = (torch.from_numpy(t).requires_grad_(True) for t in
                        _ssd_draw(Q + H + nc, (Bsz, nc, Q), H, P, N, strong))
    outs = ref.ssd_chunk(x, dt, a, B_, C_)
    rng = np.random.default_rng(Q)
    gs = [torch.from_numpy(rng.standard_normal(o.shape)) if g else None
          for o, g in zip(outs, given)]
    loss = sum((o * g).sum() for o, g in zip(outs, gs) if g is not None)
    want = torch.autograd.grad(loss, (x, dt, a, B_, C_), allow_unused=True,
                               materialize_grads=True)
    got = ref.ssd_chunk_bwd(*(t.detach() for t in (x, dt, a, B_, C_)),
                            outs[3].detach(), *gs)
    for name, g, w in zip(("gx", "gdt", "ga", "gB", "gC"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        assert float((g - w).abs().max()) <= F64_TOL * max(
            float(w.abs().max()), 1.0), name


@pytest.mark.parametrize("B,S,C,with_h0", [
    (2, 23, 5, True), (1, 1, 3, True), (2, 17, 4, False)])
def test_rglru_scan_bwd_is_autograd_of_the_forward(B, S, C, with_h0):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, C))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((B, S, C))).requires_grad_()
    h0 = (torch.from_numpy(rng.standard_normal((B, C))).requires_grad_()
          if with_h0 else None)
    h = ref.rglru_scan(a, b, h0)
    gh = torch.from_numpy(rng.standard_normal((B, S, C)))
    leaves = (a, b, h0) if with_h0 else (a, b)
    want = torch.autograd.grad((h * gh).sum(), leaves)
    got = ref.rglru_scan_bwd(a.detach(), h.detach(),
                             h0.detach() if with_h0 else None, gh)
    assert (got[2] is None) == (not with_h0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= F64_TOL * float(w.abs().max())


def test_rglru_scan_bwd_in_bf16_is_autograd_bit_for_bit():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 40, 8)).astype(
        np.float32)).bfloat16().requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(
        np.float32)).bfloat16().requires_grad_()
    h0 = torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)).requires_grad_()
    h = ref.rglru_scan(a, b, h0)
    gh = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32))
    want = torch.autograd.grad((h * gh).sum(), (a, b, h0))
    got = ref.rglru_scan_bwd(a.detach(), h.detach(), h0.detach(), gh)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(ref, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    monkeypatch.setattr(ref, name, counted)
    return calls


# (Bsz, S, H, P, N, chunk, strong)
SSD_PORT = [
    (2, 100, 3, 16, 16, 32, False),   # S not a multiple of the chunk
    (1, 160, 4, 16, 16, 64, True),    # whole chunks, a = -32
    (2, 37, 2, 16, 16, 64, False),    # one ragged chunk (Q = S)
]


@pytest.mark.parametrize("Bsz,S,H,P,N,chunk,strong", SSD_PORT)
def test_ssd_chunked_gradients_match_the_reference(monkeypatch, Bsz, S, H,
                                                   P, N, chunk, strong):
    calls = _count_calls(monkeypatch, "ssd_chunk_bwd")
    ins = [t.astype(np.float32) for t in
           _ssd_draw(S + H, (Bsz, S), H, P, N, strong)]
    rng = np.random.default_rng(S)
    gy = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda *t: jssm.ssd_chunked(*t, chunk)),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, hf = tssm.ssd_chunked(*leaves, chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (hf * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert calls == [1]
    for name, g, w in zip(("x", "dt", "a", "B", "C"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= GRAD_TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("B,S,C,with_h0", [(2, 90, 16, True),
                                           (1, 33, 8, False)])
def test_lru_scan_gradients_match_the_reference(monkeypatch, B, S, C,
                                                with_h0):
    calls = _count_calls(monkeypatch, "rglru_scan_bwd")
    rng = np.random.default_rng(S)
    a = rng.uniform(0.8, 0.999, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32)
    gh = rng.standard_normal((B, S, C)).astype(np.float32)
    ins = (a, b, h0) if with_h0 else (a, b)
    _, vjp = jax.vjp(jax.jit(jrglru.lru_scan), *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(gh))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    h = trglru.lru_scan(*leaves)
    got = torch.autograd.grad((h * torch.from_numpy(gh)).sum(), leaves)
    assert calls == [1]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= GRAD_TOL


def test_functions_pass_no_gradient_for_an_unused_output(monkeypatch):
    """A loss on y_intra alone hands ``SsdChunk``'s backward None for the
    other three outputs (no zeros made), and the gradients equal the
    plain backward's with those left out; ``RglruScan`` gives a bf16 a/b
    bf16 gradients and an fp32 h0 an fp32 one."""
    seen = []
    fn = ref.ssd_chunk_bwd

    def spy(*args):
        seen.append(args[-3:])
        return fn(*args)
    monkeypatch.setattr(ref, "ssd_chunk_bwd", spy)
    ins = [torch.from_numpy(t.astype(np.float32)).requires_grad_(True)
           for t in _ssd_draw(3, (1, 2, 24), 2, 16, 16)]
    y = ssd_chunk(*ins)[0]
    gy = torch.ones_like(y)
    got = torch.autograd.grad(y.sum(), ins)
    assert seen == [(None, None, None)]
    want = fn(*(t.detach() for t in ins), ref.ssd_chunk(*ins)[3].detach(),
              gy, None, None, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a = torch.rand(1, 9, 4).bfloat16().requires_grad_()
    b = torch.randn(1, 9, 4).bfloat16().requires_grad_()
    h0 = torch.randn(1, 4, requires_grad=True)
    grads = torch.autograd.grad(rglru_scan(a, b, h0).sum(), (a, b, h0))
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]


DT_PATH = ("dt_bias", "A_log", "wdt")


def _leaf_names(tree, prefix=""):
    """The names of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def test_cum_order_moves_the_dt_path_gradients(monkeypatch):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import value_and_grad
    from repro_torch.training.optim import tree_leaves
    cfg = dataclasses.replace(get_config("mamba2-370m"), num_layers=2,
                              vocab_size=1024)
    model = get_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, 1, 512, seed=1).next_batch().items()}
    runs = []
    for cum in (ref.prefix_sum, lambda v: torch.cumsum(v, 2)):
        monkeypatch.setattr(ref, "prefix_sum", cum)
        loss, _, grads = value_and_grad(model, params, batch)
        runs.append((float(loss), tree_leaves(grads)))
    (l0, g0), (l1, g1) = runs
    assert abs(l0 - l1) <= 1e-6 * abs(l1)
    rel = {n: _rel(a.numpy(), b.numpy())
           for n, a, b in zip(_leaf_names(params), g0, g1)}
    on_path = [v for n, v in rel.items() if n.rsplit("/", 1)[1] in DT_PATH]
    off_path = [v for n, v in rel.items()
                if n.rsplit("/", 1)[1] not in DT_PATH]
    assert len(on_path) == 6 and len(rel) == len(g0)
    assert max(on_path) > 1e-5 and max(on_path) > max(off_path), rel
