"""The port's training substrate against the reference's, on the CPU.

* AdamW (``training.optim``) with a plain and a factored second moment:
  five ``apply_updates`` of the same seeded gradients on the same tree
  (dict and list nodes, 1-D, 2-D and 3-D leaves) in both packages. The
  update is elementwise fp32 in both; ``pow``, ``cos`` and ``sqrt`` may
  round their last bit differently, so parameters hold to 1e-6 absolute
  (a few ulps at unit scale) and each state leaf to 1e-5 of its largest
  magnitude.
  ``apply_updates_`` (in place) gives ``apply_updates``'s bits. ``ranks``
  decays a per-layer vector exactly as the reference decays the same
  vectors stacked into a matrix.
* ``cosine_lr`` over warm-up, decay and past the end, ``global_norm``,
  and clipping (the norm reported before clipping) against the
  reference's.
* Checkpoints written by one package and read by the other (fp32, bf16,
  int32 leaves, dict and list nodes), and ``latest_step``.
* The train launcher: a run checkpointed every 3 steps and resumed from
  step 3 ends on the uninterrupted run's loss, bit for bit.
* MIST's stage-2 classifier: ``train_classifier`` on the CPU against the
  reference's (zero init, 300 full-batch AdamW steps): the same train
  accuracy and the same class for every corpus text and for held-out
  probes (the reference's smallest top-2 probability margin over them is
  0.49), class probabilities within 1e-3 (measured 2.2e-4), and weights
  within 3e-2 of the reference's largest. After one step the weights
  agree to 3e-9; Adam divides each step by the gradient's own size, and
  a trigram shared by every class has a gradient that cancels to its
  summation noise, so from step 2 such weights take steps a few percent
  of lr apart, which add up to 1.0% of the largest weight by step 300
  (measured 0.029 of 2.82).
"""
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import mist_model as jmist
from repro.training import optim as joptim
from repro_torch import checkpoint as tckpt
from repro_torch.core import mist_model as tmist
from repro_torch.launch import train as tlaunch
from repro_torch.training import optim as toptim

SHAPES = {"w": (8, 16), "b": (16,), "stack": [{"u": (3, 4, 5)},
                                              {"s": ()}]}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale) for v in shapes]
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _flat(tree):
    """numpy leaves in the reference's flattening order (dict keys
    sorted, lists in order), of a port tree or a reference one."""
    leaves = toptim.tree_leaves(tree)
    if any(isinstance(x, torch.Tensor) for x in leaves):
        return [t.numpy() for t in leaves]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, atol=0.0, rel=0.0):
    """Each leaf within ``atol`` plus ``rel`` of its largest magnitude."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= atol + rel * float(np.abs(b).max(initial=0.0)), err


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_matches_the_reference(factored):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=0.05, factored=factored, warmup_steps=2, total_steps=8)
    jcfg, tcfg = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = joptim.init_state(jcfg, jp), toptim.init_state(tcfg, tp)
    _close(ts, js)
    for i in range(5):
        g = _tree(rng, scale=0.5 if i % 2 else 3.0)  # clipped every other
        jp, js, jstats = joptim.apply_updates(jcfg, jp, _to_jax(g), js)
        tp, ts, tstats = toptim.apply_updates(tcfg, tp, _to_torch(g), ts)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
    _close(tp, jp, atol=1e-6)
    _close(ts["mu"], js["mu"], rel=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 5


def test_in_place_updates_give_the_functional_bits():
    rng = np.random.default_rng(1)
    cfg = toptim.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=5)
    p1 = _to_torch(_tree(rng))
    p2 = toptim.tree_map(torch.clone, p1)
    s1, s2 = toptim.init_state(cfg, p1), toptim.init_state(cfg, p2)
    for _ in range(3):
        g = _to_torch(_tree(rng))
        p1, s1, st1 = toptim.apply_updates(cfg, p1, g, s1)
        out = toptim.apply_updates_(cfg, p2, g, s2)
        assert out[0] is p2 and out[1] is s2
        assert torch.equal(st1["grad_norm"], out[2]["grad_norm"])
    for a, b in zip(toptim.tree_leaves((p1, s1)), toptim.tree_leaves(
            (p2, s2))):
        assert torch.equal(a, b)


def test_ranks_decay_per_layer_vectors_as_the_reference_decays_a_stack():
    """The reference stacks a pattern group's norm weights into (G, d) and
    decays them (rank 2); the port's per-layer (d,) leaves with ranks 2
    get the same values, and with their own rank 1 they are not decayed."""
    rng = np.random.default_rng(2)
    cfg = dict(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=4)
    stack = rng.standard_normal((3, 6)).astype(np.float32)
    grads = [rng.standard_normal((3, 6)).astype(np.float32)
             for _ in range(3)]
    jcfg, tcfg = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
    jp = {"ln": jnp.asarray(stack)}
    js = joptim.init_state(jcfg, jp)
    tp = {"ln": [torch.from_numpy(r.copy()) for r in stack]}
    ts = toptim.init_state(tcfg, tp)
    plain, ps = toptim.tree_map(torch.clone, tp), toptim.init_state(tcfg, tp)
    ranks = {"ln": [2, 2, 2]}
    for g in grads:
        jp, js, _ = joptim.apply_updates(jcfg, jp, {"ln": jnp.asarray(g)},
                                         js)
        tg = {"ln": [torch.from_numpy(r.copy()) for r in g]}
        tp, ts, _ = toptim.apply_updates(tcfg, tp, tg, ts, ranks=ranks)
        plain, ps, _ = toptim.apply_updates(tcfg, plain, tg, ps)
    got = torch.stack(tp["ln"]).numpy()
    np.testing.assert_allclose(got, np.asarray(jp["ln"]), atol=1e-6)
    assert np.abs(torch.stack(plain["ln"]).numpy() - got).max() > 1e-3


def test_cosine_lr_global_norm_and_clipping():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg, tcfg = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(joptim.cosine_lr(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(toptim.cosine_lr(tcfg, torch.tensor(step,
                                                        dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1.0), step
    tree = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(float(toptim.global_norm(_to_torch(tree))),
                               float(joptim.global_norm(_to_jax(tree))),
                               rtol=1e-6)
    ccfg = toptim.AdamWConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    huge = {"w": torch.full((4,), 1e6)}
    _, _, stats = toptim.apply_updates(ccfg, params,
                                       huge, toptim.init_state(ccfg, params))
    assert float(stats["grad_norm"]) == pytest.approx(2e6)  # unclipped


def _ckpt_tree(rng):
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "h": rng.standard_normal((5,)).astype(
                           ml_dtypes.bfloat16),
                       "layers": [{"a": rng.standard_normal(2).astype(
                           np.float32)}, {"a": np.zeros(2, np.float32)}]},
            "state": {"step": np.asarray(7, np.int32)}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def test_checkpoints_cross_between_the_packages(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(4))
    port = _as_torch(tree)
    like_j = jax.tree.map(jnp.asarray, tree)
    # the port writes, the reference reads
    tckpt.save(tmp_path / "a", port, step=3)
    got = jckpt.restore(tmp_path / "a" / "step_00000003", like_j)
    for w, g in zip(jax.tree.leaves(like_j), jax.tree.leaves(got)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the reference writes, the port reads
    jckpt.save(tmp_path / "b", like_j, step=5)
    back = tckpt.restore(tmp_path / "b" / "step_00000005", port)
    for w, g in zip(toptim.tree_leaves(port), toptim.tree_leaves(back)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the same manifest
    ja = (tmp_path / "b" / "step_00000005" / "manifest.json").read_text()
    ta = (tmp_path / "a" / "step_00000003" / "manifest.json").read_text()
    assert ja == ta
    assert tckpt.latest_step(tmp_path / "b") == 5
    assert jckpt.latest_step(tmp_path / "a") == 3
    tckpt.save(tmp_path / "a", port, step=12)
    assert tckpt.latest_step(tmp_path / "a") == 12
    assert tckpt.latest_step(tmp_path / "none") is None


def test_launcher_resume_ends_on_the_uninterrupted_loss(tmp_path):
    args = ["--device", "cpu", "--smoke", "--steps", "6", "--log-every",
            "1", "--batch", "2", "--seq", "32"]
    whole = tlaunch.main(args)
    tlaunch.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert tckpt.latest_step(tmp_path) == 6
    shutil.rmtree(tmp_path / "step_00000006")      # cut after step 3
    resumed = tlaunch.main(args + ["--ckpt-dir", str(tmp_path),
                                   "--resume"])
    assert [h["step"] for h in resumed] == [4, 5, 6]
    assert resumed == whole[3:]


def test_classifier_trains_to_the_reference_classes():
    want = jmist.train_classifier(seed=0)
    got = tmist.train_classifier(seed=0, device="cpu")
    assert got.train_accuracy == want.train_accuracy
    for k in ("w", "b"):
        w = np.asarray(want.params[k])
        err = np.abs(got.params[k].numpy() - w).max()
        assert err <= 3e-2 * np.abs(w).max(), (k, err)
    texts = [t for t, _ in jmist.synth_corpus(200, 0)] + [
        "what is the weather in Paris", "our sprint retro notes",
        "the patient's MRI shows a lesion", "api key for the billing service"]
    assert [got.classify(t) for t in texts] == \
        [want.classify(t) for t in texts]
    for t in texts[::40] + texts[-4:]:
        np.testing.assert_allclose(got.probs(t).numpy(),
                                   np.asarray(want.probs(t)), atol=1e-3)
