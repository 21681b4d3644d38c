"""The steps (``repro/launch/steps.py``): training, the federated round and
serving.

* ``make_train_step``: forward, backward, ``clip_by_global_norm`` and the
  optimizer update, optionally over microbatches.
* ``make_fl_round``: the Astraea synchronization round on a transformer.
  Each mediator trains its clients' token stream with sequential SGD from
  the round's start weights; Eq. 6 averages the mediators' fp32 deltas
  with weights ``n_m`` through the ``fedavg_agg`` kernel.  Full-delta, or
  over a LoRA adapter state (``models/lora.py``) with the backbone frozen.
* ``make_prefill_step`` / ``make_serve_step``: greedy next-token choice on
  top of the model's prefill and decode passes; they also return the
  logits.

On a ``(mediator, model)`` mesh (``launch/mesh.py::make_fl_mesh``) the
round runs as the reference's ``mediator_shard_map``: mediator row ``i``
trains its share of the mediators on its devices, tensor-parallel over its
``t`` model columns (``models/transformer.py::TensorParallel``; the
reference leaves that axis to its compiler), and Eq. 6 is the reference's
``psum_eq6``: each leaf (each shard) split into column blocks over the
mediator rows, one ``fedavg_agg`` launch a row, which is the whole leaf's
Eq. 6 bit for bit (the kernel reduces over M column by column).

The reference jits each step; here they run eagerly.  Parameters are flat
dicts keyed by the port's names (``transformer.train_params``).  The
training step updates its ``params`` and optimizer state in place, leaf by
leaf (the reference returns new trees): at qwen3-4b's width a second copy
of the weights and the AdamW moments would be 24 GB more on the card.  A
mediator row's mediators run one after another.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import lora
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, clip_by_global_norm

Params = dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def _loss_and_grads(loss_of, leaves: Params) -> tuple[torch.Tensor, Params]:
    """``loss_of(leaves)`` and its gradient in every leaf (fresh leaves that
    require grad, sharing the given tensors' storage)."""
    with torch.enable_grad():
        live = {k: t.detach().requires_grad_(True) for k, t in leaves.items()}
        loss = loss_of(live)
        grads = torch.autograd.grad(loss, list(live.values()), materialize_grads=True)
    return loss.detach(), dict(zip(live, grads))


def _update_leafwise(opt: Optimizer, grads: Params, state: dict, params: Params) -> dict:
    """``opt.update`` one leaf at a time, each update added into its
    parameter and its state leaves written back into ``state``: the same
    values as one update over the whole dict (every optimizer here is
    elementwise), with one leaf's temporaries at a time."""
    last = state
    for k in list(grads):
        sub = {key: ({k: val[k]} if isinstance(val, dict) else val)
               for key, val in state.items()}
        upd, last = opt.update({k: grads.pop(k)}, sub, {k: params[k]})
        with torch.no_grad():
            params[k].add_(upd[k])
        for key, val in last.items():
            if isinstance(val, dict):
                state[key][k] = val[k]
    for key, val in last.items():
        if not isinstance(val, dict):
            state[key] = val
    return state


def make_train_step(model: T.Transformer, opt: Optimizer, *, clip_norm: float = 1.0,
                    microbatches: int = 1, accum_dtype: torch.dtype = torch.float32):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``microbatches > 1`` splits the batch's leading axis into that many
    slices and accumulates their gradients in ``accum_dtype`` in slice
    order, then divides loss and gradients by the count, as the reference's
    scan does.  ``params`` and ``opt_state`` are updated in place and
    returned.  The step's two parts are its attributes, for the dry run
    to count apart: ``step.grad_of(params, batch) -> (loss, grads)`` of one
    microbatch, and ``step.finish(params, opt_state, grads) -> (params,
    opt_state)`` from the microbatches' summed gradients (divided by the
    count, clipped, the update), which empties ``grads`` once the clipped
    copy exists, so the unclipped gradients are not held through the
    update."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grad_of(params, batch):
        return _loss_and_grads(lambda p: T.forward_train(model, batch, p)[0], params)

    def finish(params: Params, opt_state: dict, grads: Params):
        if microbatches > 1:
            for k in grads:
                grads[k] = grads[k] / microbatches
        clipped = clip_by_global_norm(grads, clip_norm)
        grads.clear()
        return params, _update_leafwise(opt, clipped, opt_state, params)

    def train_step(params: Params, opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, grads = grad_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
            size = b // microbatches
            loss = None
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
                l, g = grad_of(params, mb)
                loss = l if loss is None else loss + l
                for k, gk in g.items():
                    grads[k].add_(gk)
            loss = loss / microbatches
        params, opt_state = finish(params, opt_state, grads)
        return params, opt_state, loss
    train_step.grad_of, train_step.finish = grad_of, finish
    return train_step


def suggest_microbatches(cfg, global_batch: int, seq_len: int, *, data_parallel: int = 1,
                         model_parallel: int = 1, budget_bytes: float = 4e9) -> int:
    """Napkin: saved residuals per device ~= L * (B/dp/m) * (S/tp) * d * 6
    bytes; the smallest power-of-two ``m`` that fits ``budget_bytes``.  The
    reference reads ``dp`` (its ``pod`` x ``data`` axes) and ``tp`` (its
    ``model`` axis) from a mesh; here they are given."""
    dp, tp = data_parallel, model_parallel
    seq_shards = tp if seq_len % tp == 0 else 1
    layers = cfg.n_layers + cfg.encoder_layers
    m = 1
    while m < global_batch // dp:
        saved = layers * (global_batch / dp / m) * (seq_len / seq_shards) * cfg.d_model * 6
        if saved <= budget_bytes:
            break
        m *= 2
    return m


# --------------------------------------------------------------------------
# Astraea federated round
# --------------------------------------------------------------------------

# the column blocks of Eq. 6 over the mediator rows start at multiples of
# this many columns: the CPU's plain reduction orders a column's terms by its
# place in a 64-column tile, so aligned blocks keep every column's sum the
# whole leaf's (the card's kernel reduces each column alone at any offset)
EQ6_BLOCK_ALIGN = 64


def eq6_blocks(n: int, rows: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` column blocks of an ``n``-column leaf over ``rows``
    mediator rows: equal blocks rounded up to ``EQ6_BLOCK_ALIGN`` columns,
    in order; a row whose block would start past the leaf gets none."""
    size = -(-(-(-n // rows)) // EQ6_BLOCK_ALIGN) * EQ6_BLOCK_ALIGN
    return [(i * size, min((i + 1) * size, n)) for i in range(rows) if i * size < n]


def psum_eq6(deltas: list[torch.Tensor], n_m: torch.Tensor, places: list[torch.device],
             home: torch.device) -> torch.Tensor:
    """Eq. 6 of one flat leaf over the mediator rows, the reference's
    ``psum_eq6`` (``repro/core/engine.py``) as a reduce-scatter and an
    all-gather: ``deltas[m]`` mediator ``m``'s fp32 delta ``(N,)`` on its
    row; row ``i`` takes column block ``i`` of every mediator's delta onto
    ``places[i]`` and runs one ``fedavg_agg`` over ``(M, block)``; the
    averaged blocks are gathered on ``home``.  No place ever holds the
    ``(M, N)`` stack, and each column is reduced as in one launch over it."""
    out = []
    for (lo, hi), place in zip(eq6_blocks(deltas[0].numel(), len(places)), places):
        block = torch.stack([d[lo:hi].to(place) for d in deltas])
        out.append(ops.fedavg_agg(block, n_m.to(place)).to(home))
    return out[0] if len(out) == 1 else torch.cat(out)


def make_fl_round(model: T.Transformer, n_mediators: int = 1, *,
                  learning_rate: float = 1e-3, local_steps: int = 4,
                  mediator_epochs: int = 1, lora_mapping: dict | None = None,
                  mesh=None):
    """One Astraea synchronization round over ``n_mediators`` mediators.

    Inputs: ``tokens, labels (n_mediators * local_batch, S)``, row block
    ``m`` mediator ``m``'s clients, client-major; ``weights (B,)`` per-row
    token counts (padding rows 0).  Each mediator runs ``mediator_epochs x
    local_steps`` SGD steps on microbatches of ``local_batch / local_steps``
    rows, from the same start, with the update ``(a - lr * g)`` in the
    weights' dtype.  Eq. 6 then averages the fp32 deltas with ``n_m = sum``
    of the mediator's row weights and adds the result to the start in
    fp32, cast back.

    Full-delta: ``round(params, tokens, labels, weights) -> params`` (a new
    dict).  Each mediator's final weights stay in the parameter dtype; the
    deltas are formed leaf by leaf at Eq. 6, one ``fedavg_agg`` launch per
    leaf (a mediator row), so no ``(M, N)`` fp32 buffer is ever held.

    With ``lora_mapping``: ``round(backbone, a_tree, state, tokens, labels,
    weights) -> state``.  The backbone and the frozen ``A`` stay fixed, the
    mediators train the adapter state through ``lora.merge_params`` inside
    the loss, and Eq. 6 averages the adapter deltas over the flat adapter
    tree, one ``fedavg_agg`` launch (a mediator row): the only thing that
    rides the WAN.

    With ``mesh`` (``make_fl_mesh``: ``n`` mediator rows of ``t`` model
    columns), as the reference's ``mediator_shard_map``: ``n_mediators``
    must be a multiple of ``n``, and mediator row ``i`` trains mediators
    ``i * k ... i * k + k - 1`` (``k = n_mediators / n``) in turn on its
    devices (``model_devices(mesh, i)``), from its copy of the start; the
    rows' steps are issued step by step (step ``s`` of every row before
    step ``s + 1``), so rows on distinct cards overlap.  Eq. 6 is the
    reference's ``psum_eq6`` (``psum_eq6`` here): each leaf -- each shard
    at ``t > 1``, the flat adapter tree under LoRA -- split into ``n``
    column blocks, row ``i`` reducing block ``i`` of every mediator's delta
    in one launch, the blocks gathered to the leaf's home; bit for bit the
    one-row round at the same ``t``.  At ``t > 1`` the rows train
    tensor-parallel over their columns, for every family the round trains:
    ``round(params, ...)`` splits ``params`` by the rule tables
    (``launch/sharding.py::placements``) onto each row's columns, trains
    each mediator's shards through ``forward_train``'s ``TensorParallel``
    hook and returns the new weights gathered whole on ``params``' device.
    Over a LoRA mapping the backbone is split the same way, the adapter
    state and the A bases stay whole on each row's home (what rides the
    WAN), each position's merged weights come from ``lora.merge_shards``
    (the same bits as ``merge_params``' slice).  A placement the
    tensor-parallel forward cannot serve raises (``transformer.check_tp``)."""
    if n_mediators < 1 or local_steps < 1 or mediator_epochs < 1:
        raise ValueError("n_mediators, local_steps and mediator_epochs must be >= 1")
    tp_size = 1 if mesh is None else mesh.shape.get("model", 1)
    n_rows = 1 if mesh is None else mesh.shape.get("mediator", 1)
    if n_mediators % n_rows:
        raise ValueError(f"{n_mediators} mediators do not split over {n_rows} mediator rows")
    per_row = n_mediators // n_rows
    dims = None
    if tp_size > 1:
        from repro_torch.launch import model_axis, sharding
        from repro_torch.launch.model_axis import shard_key
        dims = sharding.placements(T.param_specs(model.cfg, model.max_seq), mesh)
        T.check_tp(model.cfg, dims, tp_size)
        shard_col = {shard_key(k, j): j for k, d in dims.items() if d is not None
                     for j in range(tp_size)}

    def rows_of(home: torch.device) -> list[tuple]:
        """Each mediator row's devices: the mesh's rows, or ``home`` alone
        without a mesh of several positions."""
        if mesh is None or n_rows * tp_size == 1:
            return [(home,)]
        from repro_torch.launch.mesh import model_devices
        return [model_devices(mesh, i) for i in range(n_rows)]

    def place(key: str, devices: tuple) -> torch.device:
        """Where a row on ``devices`` keeps ``key``: a shard on its column."""
        return devices[shard_col.get(key, 0)] if dims is not None else devices[0]

    def on_row(tree: Params, devices: tuple) -> Params:
        return {k: v.to(place(k, devices)) for k, v in tree.items()}

    def split_params(params: Params, devices: tuple) -> tuple[Params, object]:
        """A row's copy of ``params``: at ``t > 1`` a tree of shards on its
        columns and the hook reading it, else the leaves on its home."""
        if dims is None:
            return on_row(params, devices), None
        tree = on_row(model_axis.split_tree(params, dims, devices), devices)
        return tree, T.TensorParallel(model, dims, devices, devices[0])

    def split(tokens, labels, weights):
        if tokens.shape[0] % (n_mediators * local_steps):
            raise ValueError(f"{tokens.shape[0]} rows do not split into {n_mediators} "
                             f"mediators x {local_steps} local steps")
        lb = tokens.shape[0] // n_mediators
        rows = [slice(m * lb, (m + 1) * lb) for m in range(n_mediators)]
        n_m = torch.stack([weights[r].sum() for r in rows]).to(torch.float32)
        return [(tokens[r], labels[r]) for r in rows], n_m

    def train_rows(starts: list[Params], streams, loss_ofs, rows) -> list[Params]:
        """Every mediator's sequential SGD, row ``i``'s mediators in turn
        from its start ``starts[i]``, the rows' steps interleaved step by
        step; the final weights in mediator order."""
        finals = []
        micro = streams[0][0].shape[0] // local_steps
        for q in range(per_row):
            ws = [{k: t.detach().clone() for k, t in start.items()} for start in starts]
            data = [tuple(a.to(devs[0]) for a in streams[i * per_row + q])
                    for i, devs in enumerate(rows)]
            if ws[0]:
                for _ in range(mediator_epochs):
                    for s in range(local_steps):
                        for w, (tokens, labels), loss_of in zip(ws, data, loss_ofs):
                            mb = {"tokens": tokens[s * micro:(s + 1) * micro],
                                  "labels": labels[s * micro:(s + 1) * micro]}
                            _, g = _loss_and_grads(lambda p: loss_of(p, mb), w)
                            with torch.no_grad():
                                for k in w:
                                    w[k].sub_(learning_rate * g.pop(k))
            finals.append(ws)
        return [finals[q][i] for i in range(len(rows)) for q in range(per_row)]

    def eq6(starts: list[Params], finals: list[Params], n_m: torch.Tensor, rows,
            flat: bool) -> Params:
        """Eq. 6 by ``psum_eq6`` leaf by leaf, each leaf's deltas formed
        (and the finals' leaves dropped) as it goes, or over the flat tree;
        the result on row 0's leaves' devices."""
        f32 = torch.float32
        home = starts[0]
        row_of = [m // per_row for m in range(n_mediators)]
        if flat:
            deltas = [torch.cat([(f[k].to(f32) - starts[row_of[m]][k].to(f32)).reshape(-1)
                                 for k in home]) for m, f in enumerate(finals)]
            dev = next(iter(home.values())).device
            avg = psum_eq6(deltas, n_m, [devs[0] for devs in rows], dev)
            out, at = {}, 0
            for k, s in home.items():
                out[k] = (s.to(f32) + avg[at:at + s.numel()].reshape(s.shape)).to(s.dtype)
                at += s.numel()
            return out
        out = {}
        for k, s in home.items():
            deltas = [(f.pop(k).to(f32) - starts[row_of[m]][k].to(f32)).reshape(-1)
                      for m, f in enumerate(finals)]
            avg = psum_eq6(deltas, n_m, [place(k, devs) for devs in rows], s.device)
            out[k] = (s.to(f32) + avg.reshape(s.shape)).to(s.dtype)
        return out

    if lora_mapping is not None:
        def fl_round_lora(backbone: Params, a_tree: Params, state: Params, tokens, labels,
                          weights) -> Params:
            rows = rows_of(next(iter(backbone.values())).device)
            loss_ofs = []
            for devs in rows:
                tree, tp = split_params(backbone, devs)
                a_row = on_row(a_tree, devs[:1])
                if tp is None:
                    def loss_of(st, mb, tree=tree, a_row=a_row):
                        merged = lora.merge_params(tree, a_row, st, lora_mapping)
                        return T.forward_train(model, mb, merged)[0]
                else:
                    def loss_of(st, mb, tree=tree, a_row=a_row, tp=tp):
                        merged = lora.merge_shards(tree, a_row, st, lora_mapping, dims,
                                                   tp_size)
                        return T.forward_train(model, mb, merged, par=tp)[0]
                loss_ofs.append(loss_of)
            streams, n_m = split(tokens, labels, weights)
            if not state:
                return {}
            starts = [on_row(state, devs[:1]) for devs in rows]
            finals = train_rows(starts, streams, loss_ofs, rows)
            return eq6(starts, finals, n_m, rows, flat=True)
        return fl_round_lora

    def fl_round(params: Params, tokens, labels, weights) -> Params:
        home = next(iter(params.values())).device
        rows = rows_of(home)
        starts, loss_ofs = [], []
        for devs in rows:
            start, tp = split_params(params, devs)
            starts.append(start)
            loss_ofs.append(lambda p, mb, tp=tp: T.forward_train(model, mb, p, par=tp)[0])
        streams, n_m = split(tokens, labels, weights)
        finals = train_rows(starts, streams, loss_ofs, rows)
        new = eq6(starts, finals, n_m, rows, flat=False)      # one launch a leaf a row
        del starts, finals
        if dims is None:
            return {k: new[k].to(home) for k in params}
        out = {}
        for k in params:
            if dims[k] is None:
                out[k] = new.pop(k).to(home)
            else:
                out[k] = model_axis.all_gather([new.pop(shard_key(k, j))
                                                for j in range(tp_size)], dims[k], home)
        return out
    return fl_round


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

def make_prefill_step(model: T.Transformer, pad_to: int | None = None):
    """``step(batch) -> (next tokens (b, 1), logits (b, 1, vocab), cache)``;
    ``batch`` holds ``tokens`` and, for a VLM or an audio model,
    ``vision_embeds`` or ``enc_feats``, all handed to ``forward_prefill``."""
    def prefill_step(batch):
        logits, cache = T.forward_prefill(model, batch, pad_to=pad_to)
        return logits.argmax(-1), logits, cache
    return prefill_step


def make_serve_step(model: T.Transformer):
    """One decode step: ``step(batch, cache) -> (next tokens (b, 1), logits
    (b, 1, vocab), cache)``; the cache is updated in place (an audio
    model's decode reads the encoder output its prefill stored there)."""
    def serve_step(batch, cache):
        logits, cache = T.forward_decode(model, batch, cache)
        return logits.argmax(-1), logits, cache
    return serve_step
