"""Parameter layout mapping between the reference's pytrees and the port.

The reference's CNN params are ``{"conv1": {"w": HWIO, "b"}, ...,
"dense1": {"w": (din, dout), "b"}, "out": {...}}``.  The port keys them like
``EmnistCNN.state_dict()``: conv weights OIHW, ``nn.Linear`` weights
``(dout, din)``.  The port flattens activations in NHWC order, as the
reference does, so ``dense1``'s rows need no permutation.

The reference's transformer params share the port's layouts (weights
``(d_in, d_out)``) and differ only in the stacked leading ``layers`` axis,
which the port writes out as one module per layer.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Reference params (nested dict of arrays, e.g. numpy) -> state dict."""
    out = {}
    for layer, leaves in tree.items():
        w = np.asarray(leaves["w"], np.float32)
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
        out[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{layer}.bias"] = torch.from_numpy(np.asarray(leaves["b"], np.float32).copy())
    return out


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, dict[str, np.ndarray]]:
    """Inverse of ``params_from_jax``: state dict -> nested numpy dict."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for name, t in state.items():
        layer, kind = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if kind == "weight":
            out.setdefault(layer, {})["w"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
        else:
            out.setdefault(layer, {})["b"] = a.copy()
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


def transformer_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Reference transformer params (``repro.models.transformer.init_params``
    pytree, leaves as numpy) -> the port's ``Transformer`` state dict.
    Layouts are shared; only the stacked leading axis of ``layers`` is
    unstacked into ``layers.{i}.<path>``."""
    out = {}
    for name, leaf in _flatten(tree).items():
        t = _to_torch(leaf)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(t.shape[0]):
                out[f"layers.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out


def transformer_params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """Inverse of ``transformer_params_from_jax``: state dict -> nested
    numpy dict with stacked layers.  bfloat16 tensors come back as float32
    arrays of the same values (numpy has no bfloat16)."""
    stacks: dict[str, dict[int, np.ndarray]] = {}
    flat: dict[str, np.ndarray] = {}
    for name, t in state.items():
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            stacks.setdefault(f"layers.{rest}", {})[int(idx)] = a
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
