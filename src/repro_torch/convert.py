"""Parameter layout mapping between the reference's pytrees and the port.

The reference's CNN params are ``{"conv1": {"w": HWIO, "b"}, ...,
"dense1": {"w": (din, dout), "b"}, "out": {...}}``.  The port keys them like
``EmnistCNN.state_dict()``: conv weights OIHW, ``nn.Linear`` weights
``(dout, din)``.  The port flattens activations in NHWC order, as the
reference does, so ``dense1``'s rows need no permutation.

The reference's transformer params share the port's layouts (weights
``(d_in, d_out)``) and differ only in the stacked leading layer axis of
the ``layers`` and (audio) ``encoder`` stacks, which the port writes out as
one module per layer.  LoRA adapter trees
(``A`` and the adapter state) keep the reference's flat ``/``-joined keys,
stacked shapes and layouts in the port too (the CNN's dense entries as
HWIO / ``(din, dout)``), so they convert leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Reference params (nested dict of arrays, e.g. numpy) -> state dict.
    Array leaves become float32; tensor leaves (a checkpoint read by
    ``checkpoint.load_pytree``) keep their dtype, bf16 included."""
    out = {}
    for layer, leaves in tree.items():
        w, b = (_leaf(leaves[k]) for k in ("w", "b"))
        w = w.permute(3, 2, 0, 1) if w.dim() == 4 else w.T
        out[f"{layer}.weight"] = w.contiguous()
        out[f"{layer}.bias"] = b.clone()
    return out


def _leaf(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.array(a, np.float32))


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, dict[str, np.ndarray]]:
    """Inverse of ``params_from_jax``: state dict -> nested dict of numpy
    arrays, or of CPU tensors for dtypes numpy lacks (bf16, fp8), which
    ``checkpoint.save_pytree`` writes by name."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for name, t in state.items():
        layer, kind = name.rsplit(".", 1)
        t = t.detach().cpu()
        if kind == "weight":
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        t = t.contiguous().clone()
        native = t.dtype not in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
        out.setdefault(layer, {})["w" if kind == "weight" else "b"] = \
            t.numpy() if native else t
    return out


def _to_torch(a) -> torch.Tensor:
    """numpy (or array-like) -> tensor; bfloat16 arrays (``ml_dtypes``)
    pass through float32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# the reference's stacked layer trees
STACKS = ("layers", "encoder")


def transformer_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Reference transformer params (``repro.models.transformer.init_params``
    pytree, leaves as numpy) -> the port's ``Transformer`` state dict.
    Layouts are shared; only the stacked leading axis of ``layers`` and
    ``encoder`` is unstacked into ``layers.{i}.<path>`` /
    ``encoder.{i}.<path>``."""
    out = {}
    for name, leaf in _flatten(tree).items():
        t = _to_torch(leaf)
        stack, _, rest = name.partition(".")
        if stack in STACKS and rest:
            for i in range(t.shape[0]):
                out[f"{stack}.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out


def transformer_params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """Inverse of ``transformer_params_from_jax``: state dict -> nested
    numpy dict with stacked ``layers`` and ``encoder``.  bfloat16 tensors
    come back as float32 arrays of the same values (numpy has no
    bfloat16)."""
    stacks: dict[str, dict[int, np.ndarray]] = {}
    flat: dict[str, np.ndarray] = {}
    for name, t in state.items():
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        stack = name.split(".", 1)[0]
        if stack in STACKS and "." in name:
            _, idx, rest = name.split(".", 2)
            stacks.setdefault(f"{stack}.{rest}", {})[int(idx)] = a
        else:
            flat[name] = a
    for name, rows in stacks.items():
        flat[name] = np.stack([rows[i] for i in range(len(rows))])
    tree: dict = {}
    for name, a in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def adapter_tree_from_jax(tree) -> dict[str, torch.Tensor]:
    """A reference LoRA tree (``lora.init_adapter_A``'s ``{path: A}`` or an
    adapter state ``{path: B or dense value}``, leaves as numpy) -> the
    port's: the same flat ``/``-joined keys and stacked ``(L, ...)``
    shapes, as tensors (bfloat16 leaves stay bfloat16)."""
    return {path: _to_torch(leaf) for path, leaf in tree.items()}

