"""The paper's EMNIST CNN (Section II-B) in PyTorch.

Three VALID-padded convolutions (12ch 5x5/s2, 18ch 3x3/s2, 24ch 2x2/s1),
dropout 0.5 after the first two, dense 150 ReLU and a linear head: 68,873
parameters at 47 classes and 28x28 inputs, as in ``repro/models/cnn.py``.

The public layout is the reference's NHWC ``(B, H, W, C)``.  Inside, the
input is permuted to NCHW for ``F.conv2d`` and permuted back to NHWC before
the flatten, so ``dense1``'s input rows keep the reference's order.

Training code calls the model functionally, ``model.apply(params, x,
keep=...)`` with ``params`` a dict keyed like ``state_dict()``.  Dropout
takes its keep-masks from the caller as ``(B, H, W, C)`` booleans, one per
dropout site (``dropout_shapes``), so the draws can be injected.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

Params = dict[str, torch.Tensor]

DROPOUT_RATE = 0.5


def _shapes(h: int) -> tuple[int, int, int]:
    h1 = (h - 5) // 2 + 1          # conv1 5x5 s2 VALID
    h2 = (h1 - 3) // 2 + 1         # conv2 3x3 s2 VALID
    h3 = h2 - 2 + 1                # conv3 2x2 s1 VALID
    return h1, h2, h3


def _dropout(x_nchw: torch.Tensor, keep_nhwc: torch.Tensor) -> torch.Tensor:
    keep = keep_nhwc.permute(0, 3, 1, 2)
    return torch.where(keep, x_nchw / (1.0 - DROPOUT_RATE),
                       torch.zeros((), device=x_nchw.device))


class EmnistCNN(nn.Module):
    def __init__(self, num_classes: int = 47, image_size: int = 28):
        super().__init__()
        h1, h2, h3 = _shapes(image_size)
        self.num_classes = num_classes
        self.input_shape = (image_size, image_size, 1)
        self._act_hw = (h1, h2)
        self.conv1 = nn.Conv2d(1, 12, 5, stride=2)
        self.conv2 = nn.Conv2d(12, 18, 3, stride=2)
        self.conv3 = nn.Conv2d(18, 24, 2, stride=1)
        self.dense1 = nn.Linear(h3 * h3 * 24, 150)
        self.out = nn.Linear(150, num_classes)

    def dropout_shapes(self, batch: int) -> list[tuple[int, ...]]:
        """NHWC shapes of the two dropout sites' keep-masks."""
        h1, h2 = self._act_hw
        return [(batch, h1, h1, 12), (batch, h2, h2, 18)]

    @staticmethod
    def apply(params: Params, x: torch.Tensor,
              keep: list[torch.Tensor] | None = None) -> torch.Tensor:
        """Logits of NHWC images ``x``; ``keep`` = dropout keep-masks
        (training), ``None`` = inference."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, params["conv1.weight"], params["conv1.bias"],
                            stride=2))
        if keep is not None:
            x = _dropout(x, keep[0])
        x = F.relu(F.conv2d(x, params["conv2.weight"], params["conv2.bias"],
                            stride=2))
        if keep is not None:
            x = _dropout(x, keep[1])
        x = F.relu(F.conv2d(x, params["conv3.weight"], params["conv3.bias"]))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(F.linear(x, params["dense1.weight"], params["dense1.bias"]))
        return F.linear(x, params["out.weight"], params["out.bias"])

    def forward(self, x: torch.Tensor,
                keep: list[torch.Tensor] | None = None) -> torch.Tensor:
        return self.apply(dict(self.named_parameters()), x, keep)


def emnist_cnn(num_classes: int = 47, image_size: int = 28) -> EmnistCNN:
    return EmnistCNN(num_classes, image_size)


def init_params(model: nn.Module, seed: int = 0,
                device: torch.device | str = "cpu") -> Params:
    """He-normal weights and zero biases, the reference's init law, drawn
    from a ``torch.Generator`` seeded with ``seed`` (the values differ from
    ``jax.random``'s; tests convert the reference's params instead)."""
    gen = torch.Generator().manual_seed(seed)
    out: Params = {}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            out[name] = torch.zeros(p.shape, dtype=torch.float32)
        else:
            fan_in = math.prod(p.shape[1:])
            out[name] = torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / fan_in)
    return {k: v.to(device) for k, v in out.items()}


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in params.values())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL; with ``mask``, ``sum(nll * mask) / max(sum(mask), 1e-6)``
    so all-padding batches give exactly zero loss and zero gradients."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1e-6)
    return nll.mean()
