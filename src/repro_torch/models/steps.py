"""Step functions: the train step and the serving paths' steps.

Port of ``repro/models/steps.py``. The reference jits each step and
donates the cache; here each step is a plain function that runs eagerly
on the device of its tensors and updates the cache (a dense cache or the
pool pages), ``last_tok`` and ``gen_buf`` in place.

Training (``cross_entropy``, ``loss_fn``, ``make_train_step``): the loss
of ``Model.forward(mode="full")`` differentiated by autograd, the
attention through K4 and its backward kernel (``kernels.flash_attention``),
Mamba-2's SSD through K5 and its backward (``kernels.ssd``) and the
RG-LRU recurrence through K6 and its backward (``kernels.rglru``), where
the reference's ``jax.value_and_grad`` differentiates XLA's ops. The train step updates the parameters and the AdamW state in
place (``training.optim.apply_updates_``): one copy of each, where the
reference returns new arrays.

Under a mesh (``sharding.axis_rules``) the train step takes the global
batch and splits it over the data axes ("pod" and "data", the
reference's ``shard`` of the batch, ``steps.py:53``) that divide it: as
``resolve_spec`` drops an axis that does not divide a dim, a batch that
no data axis divides is held whole by every rank, as the reference
replicates it. The model runs on the rank's rows, with its MoE blocks
expert-parallel over "model". Each rank's objective is its
cross-entropy weighted by its share of the labelled tokens that all the
data ranks hold (the global tokens times the ranks that hold each row)
plus the aux loss (global already, and differentiated only through the
rank's own statistics) over the ranks that hold each row, so an
all-reduce SUM of the gradients over the data axes gives the gradient
of the global-batch loss, each row counted once. The model runs
tensor-parallel over "model" (``sharding.LOCAL_RULES``): its blocks'
``column_in``/``row_out`` pairs make each rank's gradient of a
replicated leaf the single-device one, and of a split leaf (heads, ff,
vocab, ssm_heads, lru, experts) this rank's slice of it. With FSDP
(``sharding.axis_rules(mesh, fsdp=True)``) a leaf split over the data
axes has its gradient summed there already, by ``sharding.fsdp_gather``'s
backward, and the step sums only the others. The clip norm counts each
leaf's slices once (its squares summed over every mesh axis that splits
it) and each replicated leaf once, and AdamW updates each rank's local
leaves. Over a vocabulary split over "model" the cross-entropy never
gathers the (B, S, V) logits (``cross_entropy_split``).

The factored second moment (``AdamWConfig.factored``, which the
reference's dry-run sets for configs of 64 experts or more) factors
each leaf as the reference's stacked layout does
(``stacked_groups``, ``training.optim``); ``init_opt_state`` makes the
state to match.

Device-resident sampling state (``last_tok`` (num_slots + 1,),
``gen_buf`` (num_slots + 1, max_len)) carries ONE extra row at index
``num_slots``: rows the reference writes with ``mode="drop"`` (slot ==
num_slots: padding, idle, stalled or host-sampled rows) land there and
are never read, which drops them without a host sync or an out-of-range
index.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.serving.sampling import sample
from repro_torch.training import optim as _optim


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. labels (B,S); mask optional."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_split(logits, labels, mask=None):
    """``cross_entropy`` of this rank's vocab slice of the logits (V /
    model entries from ``sharding.model_offset``): the row max and the
    sum of exps over "model", the label's logit from the rank that holds
    it; never a gather of (B, S, V)."""
    logits = logits.float()
    V = logits.shape[-1]
    m = sharding.model_sum(logits.detach().amax(dim=-1),
                           op=dist.ReduceOp.MAX)
    se = sharding.row_out(torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(se)
    lab = labels.long() - sharding.model_offset(V)
    own = (lab >= 0) & (lab < V)
    ll = torch.gather(logits, -1, torch.clamp(lab, 0, V - 1)[..., None])
    ll = sharding.row_out(torch.where(own, ll[..., 0],
                                      torch.zeros_like(ll[..., 0])))
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(model, params, batch, remat=False):
    """(loss, {"ce", "aux"}) of a batch dict of tensors: ``tokens`` and
    ``labels`` (B, S); an audio frontend's ``embeddings`` (B, S, d) in
    place of the tokens, a vision frontend's (B, P, d) before them, with
    no loss on that prefix; an optional ``mask``. The loss is the
    next-token cross-entropy plus ``router_aux_coef`` times the summed
    MoE load-balance loss."""
    cfg = model.cfg
    kw = {}
    if cfg.frontend == "audio":
        kw["embeddings"] = batch["embeddings"]
    elif cfg.frontend == "vision":
        kw["embeddings"] = batch["embeddings"]
        kw["tokens"] = batch["tokens"]
    else:
        kw["tokens"] = batch["tokens"]
    logits, _, aux = model.forward(params, mode="full", remat=remat,
                                   triangular=False, return_aux=True,
                                   local_logits=True, **kw)
    labels = batch["labels"]
    P = logits.shape[1] - labels.shape[1]
    if P > 0:  # vlm: no loss on the image prefix
        logits = logits[:, P:]
    ce = (cross_entropy if logits.shape[-1] == cfg.vocab_size
          else cross_entropy_split)
    loss = ce(logits[:, :-1], labels[:, 1:], batch.get("mask"))
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce": loss, "aux": aux}


def value_and_grad(model, params, batch, remat=False, *, summed=None):
    """(loss, {"ce", "aux"}, grads): the loss of ``loss_fn`` and its
    gradient with respect to every parameter, a tree like ``params``
    (zeros for a parameter the loss does not read, as ``jax.grad``
    gives). ``params`` is not changed and needs no ``requires_grad``.
    Under a mesh ``batch`` is the global batch and the loss and gradients
    are the global batch's (see the module docstring); a split leaf's
    gradient is this rank's slice. ``summed``: ``fsdp_leaves(model)``,
    where the caller has made it once."""
    mesh = sharding.current_mesh()
    groups = sharding.batch_groups(mesh)
    if groups and summed is None:
        summed = fsdp_leaves(model)
    rows = next(iter(batch.values())).shape[0]
    if mesh is not None:
        batch = split_batch(batch)
    live = _optim.tree_map(lambda p: p.detach().requires_grad_(True),
                           params)
    leaves = _optim.tree_leaves(live)
    with torch.enable_grad(), sharding.global_batch(rows):
        loss, parts = loss_fn(model, live, batch, remat=remat)
        if groups:
            share = _token_share(batch, groups)
            copies = _row_copies(mesh)
            aux = parts["aux"] if copies == 1 else parts["aux"] / copies
            loss = share * parts["ce"] + model.cfg.router_aux_coef * aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    parts = {k: v.detach() for k, v in parts.items()}
    if groups:
        # a leaf split over the data axes was summed by its gather's
        # backward: summing it again would double its gradient
        rest = [k for k, done in enumerate(summed) if not done]
        for k, g in zip(rest, _all_reduce_flat([grads[k] for k in rest],
                                               groups)):
            grads[k] = g
        ce = (share * parts["ce"]).detach().clone()
        for group in groups:
            dist.all_reduce(ce, group=group)
        parts["ce"] = ce
        loss = ce + model.cfg.router_aux_coef * parts["aux"]
    return (loss.detach(), parts, _optim.tree_unflatten(live, grads))


def split_batch(batch):
    """This rank's rows of a global batch dict under the current mesh
    (the reference's ``shard(v, "batch", ...)``): split over the data
    axes that divide the batch (``resolve_spec``), the whole batch where
    none does."""
    return {k: sharding.local_slice(v, ("batch",) + (None,) * (v.dim() - 1))
            for k, v in batch.items()}


def _row_copies(mesh):
    """How many data ranks hold each row of the batch the model runs on:
    the batch axes' ranks over those that split it (1 where the data
    axes divide the batch)."""
    sizes = sharding.mesh_shape(mesh)
    split = sharding.batch_split_axes(mesh)
    return sharding.batch_ranks(mesh) // math.prod(sizes[a] for a in split)


def _token_share(batch, groups):
    """This rank's weight in the global mean cross-entropy: its labelled
    tokens over those of every data rank, summed over the data axes'
    ``groups`` (each row as many times as ranks hold it; a ``mask``
    counts its ones; the loss floors a denominator at 1)."""
    mask = batch.get("mask")
    if mask is None:
        n = torch.tensor(float(batch["labels"][:, 1:].numel()),
                         device=batch["labels"].device)
    else:
        n = mask.float().sum()
    total = n.clone()
    for group in groups:
        dist.all_reduce(total, group=group)
    return torch.clamp(n, min=1.0) / torch.clamp(total, min=1.0)


def _all_reduce_flat(tensors, groups):
    """All-reduce SUM a list of tensors over each of ``groups`` through
    one flat fp32 buffer; returns new tensors in the inputs' dtypes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    for group in groups:
        dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def grad_norm(model, grads, *, split=None):
    """The global norm of ``grads`` under the current mesh: replicated
    leaves once, a split leaf's squares summed over each mesh axis that
    splits it ("model", and with FSDP "pod" and "data"). ``split``:
    ``split_axes(model)``, where the caller has made it once."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _optim.global_norm(grads)
    leaves = _optim.tree_leaves(grads)
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    parts: dict = {}      # the mesh axes that split a leaf -> its squares
    for g, axes in zip(leaves, split or split_axes(model)):
        parts.setdefault(axes, []).append(torch.sum(torch.square(g.float())))
    total = sum(parts.pop((), []), zero)
    for axes, squares in parts.items():
        part = sum(squares, zero).clone()
        for ax in axes:
            dist.all_reduce(part, group=mesh.get_group(ax))
        total = total + part
    return torch.sqrt(total)


def _placed_leaves(model):
    """(abstract leaf, placed axes) of every parameter, in
    ``tree_leaves`` order."""
    return sharding._walk(model.abstract(), sharding.placed_axes(model))


def _split_spec(shape, axes) -> dict:
    """{dim: the mesh axes of more than one rank that split it} of a
    leaf under the current rules."""
    sizes = sharding.mesh_shape(sharding.current_mesh())
    out = {}
    for i, e in enumerate(sharding.resolve_spec(tuple(shape), axes)):
        split = tuple(a for a in sharding._entry_axes(e) if sizes[a] > 1)
        if split:
            out[i] = split
    return out


def split_axes(model) -> list:
    """For each parameter leaf (``tree_leaves`` order), the mesh axes of
    more than one rank that split it under the current placement, in
    dim order; () for a whole leaf."""
    return [tuple(ax for d in sorted(spec) for ax in spec[d])
            for spec in (_split_spec(s.shape, a)
                         for s, a in _placed_leaves(model))]


def fsdp_leaves(model) -> list:
    """For each parameter leaf, whether it is split over the data axes
    (its gradient summed by ``sharding.fsdp_gather``)."""
    return [sharding.fsdp_split(a) for _, a in _placed_leaves(model)]


def split_dims(model):
    """A tree like the params: for each leaf, ``{dim: mesh axes}`` of
    its dims split under the current mesh and placement (over "model",
    and with FSDP over "pod" and "data"), or None."""
    if sharding.current_mesh() is None:
        return None
    return _optim.tree_unflatten(model.abstract(), [
        _split_spec(s.shape, a) or None for s, a in _placed_leaves(model)])


def stacked_groups(model) -> list:
    """For each slot of the repeating pattern, the port's layers the
    reference stacks into one leaf (``blocks/slot{s}``), in depth
    order."""
    spans = [(lo, hi) for lo, hi, g in model.layer_spans() if g]
    return [tuple(lo + s for lo, _ in spans)
            for s in range(len(model.pattern))] if spans else []


def init_opt_state(model, opt_cfg: _optim.AdamWConfig, params):
    """``training.optim.init_state`` for ``model``'s params, with the
    reference's stacked groups (the factored moment's layout)."""
    return _optim.init_state(opt_cfg, params, stacked_groups(model))


def state_layout(model, opt_cfg: _optim.AdamWConfig, mesh=None):
    """(axes, global shapes) of the AdamW state beside the params as
    ``sharding.placed_axes`` places them under ``mesh`` (None: the
    current one): its ``mu`` and, with the factored moment, its
    ``groups`` (``step`` left out)."""
    groups = stacked_groups(model)
    ax = _optim.state_axes(opt_cfg, sharding.placed_axes(model, mesh),
                           groups)
    shapes = _optim.init_state(opt_cfg, model.abstract(), groups)
    return ({k: v for k, v in ax.items() if k != "step"},
            {k: v for k, v in shapes.items() if k != "step"})


def reference_ranks(model, params):
    """The rank each parameter has in the reference's layout, a tree like
    ``params``: a layer of a repeating pattern group is stacked there
    along a leading dim, one more than the port's per-layer tensor
    (``training.optim`` decays leaves of rank 2 or more)."""
    grouped = {i for lo, hi, g in model.layer_spans() if g
               for i in range(lo, hi)}
    out = {k: _optim.tree_map(lambda p: p.dim(), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [_optim.tree_map(lambda p, e=int(i in grouped):
                                     p.dim() + e, lp)
                     for i, lp in enumerate(params["layers"])]
    return out


def make_train_step(model, opt_cfg: _optim.AdamWConfig, remat=True):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): one AdamW step on the gradient of ``loss_fn``, written into
    ``params`` and ``opt_state`` in place (both returned; the parameters
    never require grad, so the serving paths can take them as they are).
    ``metrics``: ``loss``, ``ce``, ``aux``, ``lr`` and ``grad_norm``,
    0-d tensors on the parameters' device. ``opt_state`` comes from
    ``init_opt_state`` (with the factored second moment, its groups).
    Under a mesh (build the step under the mesh it runs on), the
    factored statistics of a leaf take their means over the mesh axes
    that split the dims they reduce; which leaves split where is read
    once, here."""
    groups = stacked_groups(model)
    split = split_dims(model) if opt_cfg.factored else None
    meshed = sharding.current_mesh() is not None
    summed = fsdp_leaves(model) if meshed else None
    norm_axes = split_axes(model) if meshed else None

    def train_step(params, opt_state, batch):
        loss, parts, grads = value_and_grad(model, params, batch, remat,
                                            summed=summed)
        params, opt_state, stats = _optim.apply_updates_(
            opt_cfg, params, grads, opt_state,
            ranks=reference_ranks(model, params),
            grad_norm=grad_norm(model, grads, split=norm_axes),
            groups=groups, split=split)
        return params, opt_state, {"loss": loss, **parts, **stats}

    return train_step


def make_prefill_step(model):
    """Full-prompt prefill: tokens (B, S) and/or a frontend's
    ``embeddings`` (B, P, d), placed before the tokens, at positions
    0..S-1 into a dense cache from ``model.init_cache`` (the reference's
    step takes the same inputs as a dict). Returns the last position's
    logits (B, V) and the cache; over a vocabulary split over "model"
    only that row is gathered."""
    def prefill_step(params, cache, tokens=None, embeddings=None):
        logits, cache = model.forward(params, mode="full", tokens=tokens,
                                      embeddings=embeddings, cache=cache,
                                      local_logits=True)
        last = logits[:, -1, :]
        if last.shape[-1] != model.cfg.vocab_size:   # gather one row only
            last = sharding.model_gather(last, -1)
        return last, cache

    return prefill_step


def make_serve_step(model):
    """One decode token against a dense cache: token (B, 1), ``pos`` a
    scalar or (B,) per-row absolute positions. Returns (logits (B, V),
    cache)."""
    def serve_step(params, cache, token, pos):
        logits, cache = model.forward(params, mode="decode", tokens=token,
                                      cache=cache, pos=pos)
        return logits[:, 0, :], cache

    return serve_step


def make_chunked_prefill_step(model):
    """One page-aligned prefill chunk against the paged KV pool: token
    (1, C*page_size) ids for C consecutive whole pages (zero-padded past
    the prompt), ``start`` (1,) absolute position of the chunk's first
    token, block_table (1, N) physical page ids covering every page the
    sequence occupies through this chunk, ``dst_page`` (C,) page ids the
    chunk's K/V lands on — an entry equal to the reserved scratch page
    masks the write. Returns the chunk's full logits (1, C*page_size, V)
    plus the pool cache."""
    def chunked_prefill_step(params, cache, token, start, block_table,
                             dst_page):
        logits, cache = model.forward(
            params, mode="chunk", tokens=token, cache=cache, pos=start,
            block_table=block_table, dst_page=dst_page)
        return logits, cache

    return chunked_prefill_step


def make_fused_prefill_step(model):
    """One fused dispatch for EVERY prefill chunk run of a batcher tick,
    with on-device first-token emission.

    Rows are independent chunk runs, possibly from different requests:
    token (R, C*page_size) zero-padded ids, ``start`` (R,) absolute
    positions of each run's first token, block_table (R, W), dst_page
    (R, C) pool page ids (scratch page == masked write). Runs whose request
    completes its prompt emit their boundary argmax token straight into
    the device-resident sampling state: ``emit_slot`` (R,) is the decode
    slot to write (num_slots = no emission: the dump row), ``emit_off``
    (R,) the boundary row inside the run, ``gen_idx`` (R,) the write index
    into ``gen_buf``. Returns (last_tok, gen_buf, cache) — no logits leave
    the device, so the host never syncs."""
    def fused_prefill_step(params, cache, token, start, block_table,
                           dst_page, emit_slot, emit_off, gen_idx,
                           last_tok, gen_buf):
        logits, cache = model.forward(
            params, mode="chunk", tokens=token, cache=cache, pos=start,
            block_table=block_table, dst_page=dst_page)
        rows = torch.arange(logits.shape[0], device=logits.device)
        bound = sample(logits[rows, emit_off.long()])
        slot = emit_slot.long()
        last_tok[slot] = bound
        gen_buf[slot, gen_idx.long()] = bound
        return last_tok, gen_buf, cache

    return fused_prefill_step


def make_paged_serve_step(model):
    """One decode step for ALL sequences of a paged KV pool: token (B,1),
    pos (B,) per-sequence absolute positions, block_table (B,N) physical
    page ids. ``cache`` is the pool's list of per-layer page dicts."""
    def paged_serve_step(params, cache, token, pos, block_table):
        logits, cache = model.forward(
            params, mode="decode", tokens=token, cache=cache, pos=pos,
            block_table=block_table)
        return logits[:, 0, :], cache

    return paged_serve_step


def make_fused_decode_step(model):
    """Paged decode over all slots against DEVICE-RESIDENT sampling state:
    each row's input token comes from ``host_tok`` where ``host_mask`` is
    set (admission-seeded or host-sampled tokens) and from ``last_tok``
    otherwise (tokens the device produced in earlier dispatches and the
    host never saw). Greedy next tokens are written back into ``last_tok``
    and logged at ``gen_buf[write_slot, gen_idx]`` — rows with write_slot
    == num_slots (idle or stalled slots) write the dump row. Returns
    (logits, last_tok, gen_buf, cache); greedy callers ignore the logits,
    so nothing forces a device sync."""
    def fused_decode_step(params, cache, last_tok, host_mask, host_tok,
                          pos, block_table, write_slot, gen_idx, gen_buf):
        B = host_tok.shape[0]
        tok = torch.where(host_mask, host_tok, last_tok[:B])[:, None]
        logits, cache = model.forward(
            params, mode="decode", tokens=tok, cache=cache, pos=pos,
            block_table=block_table)
        logits = logits[:, 0, :]
        nxt = sample(logits)
        slot = write_slot.long()
        last_tok[slot] = nxt
        gen_buf[slot, gen_idx.long()] = nxt
        return logits, last_tok, gen_buf, cache

    return fused_decode_step
