"""Parameter layout mapping between the reference's pytree and the port.

The reference's CNN params are ``{"conv1": {"w": HWIO, "b"}, ...,
"dense1": {"w": (din, dout), "b"}, "out": {...}}``.  The port keys them like
``EmnistCNN.state_dict()``: conv weights OIHW, ``nn.Linear`` weights
``(dout, din)``.  The port flattens activations in NHWC order, as the
reference does, so ``dense1``'s rows need no permutation.
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
