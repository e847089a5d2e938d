"""The port's train step against the reference's, at ``.reduced()`` widths
on the reference's seeded weights (moved across with ``bridge``), on the
CPU.

* The loss (with its ``ce`` and ``aux`` parts) and every gradient leaf of
  ``models.steps.value_and_grad`` against the reference's
  ``jax.value_and_grad(loss_fn)``, for smollm-135m, qwen3-4b (qk_norm),
  paligemma-3b (a vision prefix with no loss on it, the prefix-LM mask),
  musicgen-large (audio embeddings), deepseek-v2-lite-16b (MLA, a dense
  head layer, MoE with its aux loss), mamba2-370m (SSD) and
  recurrentgemma-9b (RG-LRU, a local window that bites at S 80). Both
  sides are fp32 and differ in summation order: the loss holds to 1e-5
  relative, each gradient leaf to 1e-4 of its largest magnitude plus
  1e-7 (leaves a step reaches through more layers sum more terms; the
  measured gaps are ~1e-6 of the magnitude).
* The parameters after 3 AdamW steps of ``make_train_step`` (in place)
  against the reference's train step (its ``make_train_step`` is the
  jitted gradient above and ``apply_updates``; its ``shard`` of the batch
  is the identity without a mesh), with weight decay on the
  leaves the reference decays (a pattern group's 1-D leaves are rank 2
  in its stacked layout; the rule itself is held exactly by
  tests/test_torch_train_substrate.py): each leaf within 2e-3 of the
  learning rate. Adam moves an element by lr g / (|g| + eps) whatever the
  size of its gradient, so a gradient's summation-order noise (~3e-7 on
  smollm's tied embedding, ~1e-6 of its largest element, which is 1% of
  an element of 2e-5) moves the step by up to noise / eps of lr. Both
  sides take eps 1e-4, so that bound is 3e-3 lr; the measured gaps are
  at most 5.4e-4 lr (embeddings) and under 1e-4 lr elsewhere. At the
  default eps 1e-8 the same noise moves an element of eps's size by ~1%
  of lr.
* ``remat=True`` against ``remat=False``: the same loss and gradients,
  bit for bit (the CPU recomputes each group's forward identically).
* The AdamW state the reference's steps leave carries across with
  ``bridge.opt_state_from_reference`` and matches the port's.

The module runs under ``_torch_parity.lean_cpu`` (one torch thread).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import lean_cpu  # noqa: F401  (a fixture)
from repro.configs.base import get_config as jget_config
from repro.models.model import get_model as jget_model
from repro.models.steps import loss_fn as jloss_fn
from repro.training import optim as joptim
from repro_torch import bridge
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.steps import make_train_step, value_and_grad
from repro_torch.training import optim as toptim

pytestmark = pytest.mark.usefixtures("lean_cpu")

ARCHS = ["smollm-135m", "qwen3-4b", "paligemma-3b", "musicgen-large",
         "deepseek-v2-lite-16b", "mamba2-370m", "recurrentgemma-9b",
         "glm4-9b", "qwen3-32b", "kimi-k2-1t-a32b"]
SEQ = {"recurrentgemma-9b": 80}      # past its .reduced() window of 64
LR = 3e-3


def _batch(cfg, seed, B=2):
    S = SEQ.get(cfg.name.removesuffix("-smoke"), 32)
    rng = np.random.default_rng(seed)
    toks = lambda s: rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if cfg.frontend == "audio":
        return {"embeddings": rng.standard_normal((B, S, cfg.d_model),
                                                  np.float32),
                "labels": toks(S)}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        emb = rng.standard_normal((B, P, cfg.d_model), np.float32)
        t = toks(S - P)
        return {"embeddings": emb, "tokens": t, "labels": t}
    t = toks(S)
    return {"tokens": t, "labels": t}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Per config: both models, the reference's params (and a numpy copy),
    the port's, and the reference's jitted gradient."""
    name = request.param
    jcfg, tcfg = jget_config(name).reduced(), tget_config(name).reduced()
    jmodel, tmodel = jget_model(jcfg), tget_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), "float32")
    np_params = jax.tree.map(np.asarray, jparams)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jmodel, p, b), has_aux=True))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                tmodel=tmodel, jparams=jparams, np_params=np_params,
                grad=grad)


def _port_params(a):
    return bridge.from_reference(a["tcfg"], a["np_params"])


def _leaf_pairs(a, ref_tree, port_tree):
    """(path, reference leaf, port leaf) in the port's layout."""
    ref = bridge.from_reference(a["tcfg"], jax.tree.map(np.asarray,
                                                        ref_tree))
    return zip(_paths(port_tree), toptim.tree_leaves(ref),
               toptim.tree_leaves(port_tree))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def test_loss_and_every_gradient_leaf_match_the_reference(arch):
    a = arch
    batch = _batch(a["tcfg"], 1)
    (jloss, jparts), jgrads = a["grad"](a["jparams"], batch)
    loss, parts, grads = value_and_grad(a["tmodel"], _port_params(a),
                                        _torch_batch(batch))
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)) \
            + 1e-7, (a["name"], float(got), float(want))
    n = 0
    for path, want, got in _leaf_pairs(a, jgrads, grads):
        want, got = want.numpy(), got.numpy()
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()) + 1e-7, (
            a["name"], path, err, float(np.abs(want).max()))
        n += 1
    assert n == len(toptim.tree_leaves(grads))
    if a["tcfg"].num_experts:
        assert float(parts["aux"]) > 0


def test_three_adamw_steps_match_the_reference(arch):
    a = arch
    ocfg = joptim.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=1,
                              total_steps=10)
    tocfg = toptim.AdamWConfig(lr=LR, eps=1e-4, warmup_steps=1,
                               total_steps=10)
    # the reference's make_train_step is the gradient then apply_updates
    # (its shard of the batch is the identity without a mesh): the
    # module's jitted gradient and one jitted update stand for it
    jupdate = jax.jit(lambda p, g, s: joptim.apply_updates(ocfg, p, g, s))

    def jstep(p, s, batch):
        (loss, parts), g = a["grad"](p, batch)
        p, s, stats = jupdate(p, g, s)
        return p, s, {"loss": loss, **parts, **stats}

    jp, js = a["jparams"], joptim.init_state(ocfg, a["jparams"])
    tp = _port_params(a)
    ts = toptim.init_state(tocfg, tp)
    tstep = make_train_step(a["tmodel"], tocfg, remat=False)
    for i in range(3):
        batch = _batch(a["tcfg"], 10 + i)
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, _torch_batch(batch))
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])) + 1e-7, (a["name"], i, k)
    assert not any(t.requires_grad for t in toptim.tree_leaves(tp))
    for path, want, got in _leaf_pairs(a, jp, tp):
        err = float((got - want).abs().max())
        assert err <= 2e-3 * LR, (a["name"], path, err)
    # the reference's AdamW state carries across and matches the port's
    carried = bridge.opt_state_from_reference(
        a["tcfg"], jax.tree.map(np.asarray, js))
    assert int(carried["step"]) == int(ts["step"]) == 3
    for want, got in zip(toptim.tree_leaves(carried["mu"]),
                         toptim.tree_leaves(ts["mu"])):
        assert want.shape == got.shape
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()) + 1e-9


def test_remat_changes_no_bit(arch):
    a = arch
    params = _port_params(a)
    batch = _torch_batch(_batch(a["tcfg"], 2))
    loss0, parts0, g0 = value_and_grad(a["tmodel"], params, batch)
    loss1, parts1, g1 = value_and_grad(a["tmodel"], params, batch,
                                       remat=True)
    assert torch.equal(loss0, loss1) and torch.equal(parts0["aux"],
                                                     parts1["aux"])
    for x, y in zip(toptim.tree_leaves(g0), toptim.tree_leaves(g1)):
        assert torch.equal(x, y)


def test_grouped_layers_take_the_reference_weight_decay():
    """A norm weight of a layer inside the repeating groups is rank 2 in
    the reference's stacked layout and decays; the final norm does not."""
    from repro_torch.models.steps import reference_ranks
    cfg = tget_config("deepseek-v2-lite-16b").reduced()
    model = tget_model(cfg)
    params = model.init(seed=0, device="cpu")
    ranks = reference_ranks(model, params)
    assert ranks["final_norm"] == 1 and ranks["embed"] == 2
    assert model.layer_spans()[0] == (0, 1, False)       # the dense head
    assert ranks["layers"][0]["mlp"]["ln"] == 1
    assert ranks["layers"][1]["mixer"]["ln"] == 2         # grouped
    assert ranks["layers"][1]["moe"]["we_gate"] == 4


def test_factored_train_step_is_refused():
    """The refusal is gone: the factored second moment trains in the
    reference's stacked layout (held to the reference in
    ``test_torch_factored_moment.py``). The state keeps a grouped 1-D
    leaf's ``vr``/``vc`` once a group, and a step moves them. (The name
    is kept from when ``make_train_step`` refused ``factored=True``.)"""
    from repro_torch.models.steps import init_opt_state
    cfg = tget_config("smollm-135m").reduced()
    model = tget_model(cfg)
    ocfg = toptim.AdamWConfig(factored=True, warmup_steps=0)
    step = make_train_step(model, ocfg, remat=False)
    params = model.init(seed=0, device="cpu")
    state = init_opt_state(model, ocfg, params)
    assert "v" not in state["mu"]["layers"][0]["mixer"]["ln"]
    assert state["groups"][0]["mixer"]["ln"]["vr"].shape == (2,)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    _, state, metrics = step(params, state, {"tokens": toks,
                                             "labels": toks})
    assert torch.isfinite(metrics["loss"])
    assert float(state["groups"][0]["mixer"]["ln"]["vr"].abs().sum()) > 0
