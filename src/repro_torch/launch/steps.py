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
round is tensor-parallel over the model axis (the reference leaves that
axis to its compiler): each mediator's local SGD runs Megatron-style over
the ``t`` positions (``models/transformer.py::TensorParallel``), and Eq. 6
runs per position on its slice of each leaf, one ``fedavg_agg`` a shard
(the reference's ``psum_eq6``), which is the whole leaf's Eq. 6 bit for bit
(the kernel reduces over M column by column).

The reference jits each step; here they run eagerly.  Parameters are flat
dicts keyed by the port's names (``transformer.train_params``).  The
training step updates its ``params`` and optimizer state in place, leaf by
leaf (the reference returns new trees): at qwen3-4b's width a second copy
of the weights and the AdamW moments would be 24 GB more on the card.  On
one card the mediators of a round run one after another.
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
    leaf, so no ``(M, N)`` fp32 buffer is ever held.

    With ``lora_mapping``: ``round(backbone, a_tree, state, tokens, labels,
    weights) -> state``.  The backbone and the frozen ``A`` stay fixed, the
    mediators train the adapter state through ``lora.merge_params`` inside
    the loss, and Eq. 6 averages the adapter deltas in one ``fedavg_agg``
    launch (``ops.fedavg_agg_tree``): the only thing that rides the WAN.

    With ``mesh`` (a ``make_fl_mesh`` with a model axis ``t > 1``) the
    round is tensor-parallel over the mesh's model columns (mediator row
    0's devices; the mediators still run in turn), for every family the
    round trains: ``round(params, ...)`` splits ``params`` by the rule
    tables (``launch/sharding.py::placements``), trains each mediator's
    shards through ``forward_train``'s ``TensorParallel`` hook, runs Eq. 6
    shard by shard and returns the new weights gathered whole on
    ``params``' device.  Over a LoRA mapping the backbone is split the same
    way, the adapter state and the A bases stay whole on their device (what
    rides the WAN), each position's merged weights come from
    ``lora.merge_shards`` (the same bits as ``merge_params``' slice) and
    Eq. 6 over the adapter tree is one launch, as at ``t = 1``.  A
    placement the tensor-parallel forward cannot serve raises
    (``transformer.check_tp``)."""
    if n_mediators < 1 or local_steps < 1 or mediator_epochs < 1:
        raise ValueError("n_mediators, local_steps and mediator_epochs must be >= 1")
    tp_size = 1 if mesh is None else mesh.shape.get("model", 1)
    if tp_size > 1:
        from repro_torch.launch import model_axis, sharding
        from repro_torch.launch.mesh import model_devices
        from repro_torch.launch.model_axis import shard_key
        dims = sharding.placements(T.param_specs(model.cfg, model.max_seq), mesh)
        devices = model_devices(mesh)
        T.check_tp(model.cfg, dims, tp_size)

        def split_params(params: Params) -> tuple[Params, T.TensorParallel]:
            """``params`` as a tree of shards, and the hook reading it."""
            home = next(iter(params.values())).device
            return model_axis.split_tree(params, dims, devices), \
                T.TensorParallel(model, dims, devices, home)

    def split(tokens, labels, weights):
        if tokens.shape[0] % (n_mediators * local_steps):
            raise ValueError(f"{tokens.shape[0]} rows do not split into {n_mediators} "
                             f"mediators x {local_steps} local steps")
        lb = tokens.shape[0] // n_mediators
        rows = [slice(m * lb, (m + 1) * lb) for m in range(n_mediators)]
        n_m = torch.stack([weights[r].sum() for r in rows]).to(torch.float32)
        return [(tokens[r], labels[r]) for r in rows], n_m

    def local_sgd(start: Params, tokens, labels, loss_of) -> Params:
        """The mediator's sequential SGD from a copy of ``start``."""
        w = {k: t.detach().clone() for k, t in start.items()}
        if not w:
            return w
        micro = tokens.shape[0] // local_steps
        for _ in range(mediator_epochs):
            for s in range(local_steps):
                mb = {"tokens": tokens[s * micro:(s + 1) * micro],
                      "labels": labels[s * micro:(s + 1) * micro]}
                _, g = _loss_and_grads(lambda p: loss_of(p, mb), w)
                with torch.no_grad():
                    for k in w:
                        w[k].sub_(learning_rate * g.pop(k))
        return w

    def eq6(start: Params, finals: list[Params], n_m: torch.Tensor, tree: bool) -> Params:
        f32 = torch.float32
        if tree:
            deltas = {k: torch.stack([f[k].to(f32) - start[k].to(f32) for f in finals])
                      for k in start}
            avg = ops.fedavg_agg_tree(deltas, n_m)
            return {k: (start[k].to(f32) + avg[k]).to(start[k].dtype) for k in start}
        out = {}
        for k, s in start.items():
            deltas = torch.stack([f.pop(k).to(f32) - s.to(f32) for f in finals])
            avg = ops.fedavg_agg(deltas.reshape(len(finals), -1),
                                 n_m.to(s.device)).reshape(s.shape)
            out[k] = (s.to(f32) + avg).to(s.dtype)
        return out

    if lora_mapping is not None:
        def fl_round_lora(backbone: Params, a_tree: Params, state: Params, tokens, labels,
                          weights) -> Params:
            if tp_size == 1:
                def loss_of(st, mb):
                    merged = lora.merge_params(backbone, a_tree, st, lora_mapping)
                    return T.forward_train(model, mb, merged)[0]
            else:
                tree, tp = split_params(backbone)

                def loss_of(st, mb):
                    merged = lora.merge_shards(tree, a_tree, st, lora_mapping, dims, tp_size)
                    return T.forward_train(model, mb, merged, par=tp)[0]
            streams, n_m = split(tokens, labels, weights)
            if not state:
                return {}
            finals = [local_sgd(state, t, l, loss_of) for t, l in streams]
            return eq6(state, finals, n_m, tree=True)
        return fl_round_lora

    def fl_round(params: Params, tokens, labels, weights) -> Params:
        def loss_of(p, mb):
            return T.forward_train(model, mb, p)[0]
        streams, n_m = split(tokens, labels, weights)
        finals = [local_sgd(params, t, l, loss_of) for t, l in streams]
        return eq6(params, finals, n_m, tree=False)
    if tp_size == 1:
        return fl_round

    def fl_round_tp(params: Params, tokens, labels, weights) -> Params:
        home = next(iter(params.values())).device
        start, tp = split_params(params)

        def loss_of(p, mb):
            return T.forward_train(model, mb, p, par=tp)[0]
        streams, n_m = split(tokens, labels, weights)
        finals = [local_sgd(start, t, l, loss_of) for t, l in streams]
        new = eq6(start, finals, n_m, tree=False)         # one launch a shard
        del start, finals
        out = {}
        for k in params:
            if dims[k] is None:
                out[k] = new.pop(k)
            else:
                out[k] = model_axis.all_gather([new.pop(shard_key(k, j))
                                                for j in range(len(devices))], dims[k], home)
        return out
    return fl_round_tp


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
