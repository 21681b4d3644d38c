"""The paper's CNN classifiers in PyTorch.

* ``emnist_cnn`` (Section II-B): three VALID-padded convolutions (12ch
  5x5/s2, 18ch 3x3/s2, 24ch 2x2/s1), dropout 0.5 after the first two,
  dense 150 ReLU and a linear head: 68,873 parameters at 47 classes and
  28x28 inputs.
* ``cinic_cnn`` (the Keras CIFAR-10 example the paper cites for CINIC-10):
  two blocks of two SAME-padded 3x3 convolutions and a 2x2 max-pool, at
  ``width`` and ``2 * width`` channels, each block followed by dropout
  0.25, then dense ``512 * width // 32`` ReLU, dropout 0.5 and a linear
  head: 2,168,362 parameters at 10 classes, 32x32x3 and width 32.

Both mirror ``repro/models/cnn.py``.  The public layout is the reference's
NHWC ``(B, H, W, C)``.  Inside, the input is copied to contiguous NCHW
for ``F.conv2d`` (on the card a view with NHWC strides made cuDNN
transpose around every grouped convolution of the lockstep rows) and
permuted back to NHWC before the flatten, so ``dense1``'s input rows keep
the reference's order.

``param_specs()`` gives each parameter as the reference declares it --
its ``/``-joined path (``conv1/w``), shape and logical axes in the
reference's layout (conv ``(kh, kw, cin, cout)``, dense ``(din, dout)``)
-- with the port's name and the permutation from one layout to the other,
for the LoRA mapping table (``models/lora.py``).

Training code calls the model functionally, ``model.apply(params, x,
keep=...)`` with ``params`` a dict keyed like ``state_dict()``.  Each
convolution and dense layer goes through ``layers`` (``PLAIN``: the whole
weights); ``TensorParallel`` runs them over a model axis's shards
(the FL engine's ``tp_rows``).  Dropout
takes its keep-masks from the caller, one boolean mask per dropout site in
the site's NHWC (or ``(B, features)``) shape; ``dropout_sites(batch)``
lists each site's ``(shape, rate)``, so the draws can be injected.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.launch import model_axis

Params = dict[str, torch.Tensor]
Site = tuple[tuple[int, ...], float]


@dataclass(frozen=True)
class ParamSpec:
    """One parameter as the reference declares it: ``shape`` and logical
    ``axes`` in the reference's layout, the port's parameter ``names`` it
    covers (one), and ``perm``, the permutation taking the reference
    layout to the port's (``None``: the same layout)."""
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    names: tuple[str, ...]
    perm: tuple[int, ...] | None = None


def _conv_specs(name: str, kh: int, kw: int, cin: int, cout: int) -> dict:
    """A conv layer: HWIO ``w`` is the port's OIHW ``.weight``."""
    return {f"{name}/w": ParamSpec((kh, kw, cin, cout), ("conv", "conv", "conv_in", "mlp"),
                                   (f"{name}.weight",), (3, 2, 0, 1)),
            f"{name}/b": ParamSpec((cout,), ("mlp",), (f"{name}.bias",))}


def _dense_specs(name: str, din: int, dout: int, out_axis: str = "mlp") -> dict:
    """A dense layer: ``(din, dout)`` ``w`` is the transpose of the port's
    ``nn.Linear`` ``.weight``."""
    return {f"{name}/w": ParamSpec((din, dout), ("embed", out_axis), (f"{name}.weight",),
                                   (1, 0)),
            f"{name}/b": ParamSpec((dout,), (out_axis,), (f"{name}.bias",))}


class Layers:
    """The convolution and dense layers ``apply`` calls, over the whole
    weights ``params[f"{name}.weight"]`` / ``.bias``."""

    def conv(self, params: Params, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        return F.conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"], **kw)

    def linear(self, params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])


PLAIN = Layers()


class TensorParallel(Layers):
    """The layers over a model axis of ``len(devices)`` positions (the
    reference's TP rows, ``repro/core/engine.py`` §8): a layer whose weight
    the rules split (``dims[f"{name}.weight"]`` not None: output channels
    or features, port dimension 0, never a contraction dimension) reads
    its shards ``params[model_axis.shard_key(f"{name}.weight", j)]`` (and
    the bias's); position ``j`` computes its output-channel slice from the
    whole input
    (``to_positions``: the input gradient all-reduced in the backward) and
    the slices are all-gathered on ``home`` (the gradient's slice back to
    each position in the backward).  A replicated layer runs whole on
    ``home``.  ``apply``/``dropout_sites`` make it a model for the round
    programs: ``apply(tree, x, keep)`` is ``model.apply`` through these
    layers."""

    def __init__(self, model, dims: dict[str, int | None], devices, home):
        self.model, self.dims = model, dims
        self.devices = tuple(torch.device(d) for d in devices)
        self.home = torch.device(home)
        for k, d in dims.items():
            if d not in (None, 0):
                raise ValueError(f"{k}: TP rows split output channels (port dim 0), "
                                 f"not dim {d}")

    def dropout_sites(self, batch: int):
        return self.model.dropout_sites(batch)

    def apply(self, tree: Params, x: torch.Tensor, keep=None) -> torch.Tensor:
        return self.model.apply(tree, x, keep, layers=self)

    def _split(self, params, name, x, fn):
        if self.dims.get(f"{name}.weight") is None:
            return fn(x, params[f"{name}.weight"], params[f"{name}.bias"])
        xs = model_axis.to_positions(x, self.devices)
        key = model_axis.shard_key
        ys = [fn(xj, params[key(f"{name}.weight", j)], params[key(f"{name}.bias", j)])
              for j, xj in enumerate(xs)]
        return model_axis.gather_from_positions(ys, 1, self.home)

    def conv(self, params, name, x, **kw):
        return self._split(params, name, x, lambda a, w, b: F.conv2d(a, w, b, **kw))

    def linear(self, params, name, x):
        return self._split(params, name, x, F.linear)


def _shapes(h: int) -> tuple[int, int, int]:
    h1 = (h - 5) // 2 + 1          # conv1 5x5 s2 VALID
    h2 = (h1 - 3) // 2 + 1         # conv2 3x3 s2 VALID
    h3 = h2 - 2 + 1                # conv3 2x2 s1 VALID
    return h1, h2, h3


def _dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` (NCHW or ``(B, F)``) with a keep-mask in
    the public layout (NHWC or ``(B, F)``): kept values over ``1 - rate``."""
    if keep.dim() == 4:
        keep = keep.permute(0, 3, 1, 2)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


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

    def param_specs(self) -> dict[str, ParamSpec]:
        """The reference's ``emnist_cnn(...).param_specs()``, flat by path."""
        flat = self.dense1.in_features
        return {**_conv_specs("conv1", 5, 5, 1, 12), **_conv_specs("conv2", 3, 3, 12, 18),
                **_conv_specs("conv3", 2, 2, 18, 24), **_dense_specs("dense1", flat, 150),
                **_dense_specs("out", 150, self.num_classes, out_axis="vocab")}

    DROPOUT_RATES = (0.5, 0.5)

    def dropout_sites(self, batch: int) -> list[Site]:
        """NHWC keep-mask shape and rate of each dropout site."""
        h1, h2 = self._act_hw
        return list(zip([(batch, h1, h1, 12), (batch, h2, h2, 18)],
                        self.DROPOUT_RATES))

    @staticmethod
    def apply(params: Params, x: torch.Tensor,
              keep: list[torch.Tensor] | None = None,
              layers: Layers = PLAIN) -> torch.Tensor:
        """Logits of NHWC images ``x``; ``keep`` = dropout keep-masks
        (training), ``None`` = inference."""
        rates = EmnistCNN.DROPOUT_RATES
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.relu(layers.conv(params, "conv1", x, stride=2))
        if keep is not None:
            x = _dropout(x, keep[0], rates[0])
        x = F.relu(layers.conv(params, "conv2", x, stride=2))
        if keep is not None:
            x = _dropout(x, keep[1], rates[1])
        x = F.relu(layers.conv(params, "conv3", x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(layers.linear(params, "dense1", x))
        return layers.linear(params, "out", x)

    def forward(self, x: torch.Tensor,
                keep: list[torch.Tensor] | None = None) -> torch.Tensor:
        return self.apply(dict(self.named_parameters()), x, keep)


def emnist_cnn(num_classes: int = 47, image_size: int = 28) -> EmnistCNN:
    return EmnistCNN(num_classes, image_size)


class CinicCNN(nn.Module):
    def __init__(self, num_classes: int = 10, image_size: int = 32,
                 channels: int = 3, width: int = 32):
        super().__init__()
        w1, w2, hidden = width, 2 * width, 512 * width // 32
        self.num_classes = num_classes
        self.input_shape = (image_size, image_size, channels)
        self._pooled = (image_size // 2, image_size // 4)
        self._widths = (w1, w2, hidden)
        self.conv1a = nn.Conv2d(channels, w1, 3, padding=1)
        self.conv1b = nn.Conv2d(w1, w1, 3, padding=1)
        self.conv2a = nn.Conv2d(w1, w2, 3, padding=1)
        self.conv2b = nn.Conv2d(w2, w2, 3, padding=1)
        self.dense1 = nn.Linear(self._pooled[1] ** 2 * w2, hidden)
        self.out = nn.Linear(hidden, num_classes)

    def param_specs(self) -> dict[str, ParamSpec]:
        """The reference's ``cinic_cnn(...).param_specs()``, flat by path."""
        (w1, w2, hidden), cin = self._widths, self.conv1a.in_channels
        return {**_conv_specs("conv1a", 3, 3, cin, w1), **_conv_specs("conv1b", 3, 3, w1, w1),
                **_conv_specs("conv2a", 3, 3, w1, w2), **_conv_specs("conv2b", 3, 3, w2, w2),
                **_dense_specs("dense1", self.dense1.in_features, hidden),
                **_dense_specs("out", hidden, self.num_classes, out_axis="vocab")}

    DROPOUT_RATES = (0.25, 0.25, 0.5)

    def dropout_sites(self, batch: int) -> list[Site]:
        """Keep-mask shape and rate of each dropout site: after each pooled
        block (NHWC) and after ``dense1`` (``(B, hidden)``)."""
        (h1, h2), (w1, w2, hidden) = self._pooled, self._widths
        return list(zip([(batch, h1, h1, w1), (batch, h2, h2, w2), (batch, hidden)],
                        self.DROPOUT_RATES))

    @staticmethod
    def apply(params: Params, x: torch.Tensor,
              keep: list[torch.Tensor] | None = None,
              layers: Layers = PLAIN) -> torch.Tensor:
        """Logits of NHWC images ``x``; ``keep`` = dropout keep-masks
        (training), ``None`` = inference."""
        def conv(x, name):
            return F.relu(layers.conv(params, name, x, padding=1))
        rates = CinicCNN.DROPOUT_RATES
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.max_pool2d(conv(conv(x, "conv1a"), "conv1b"), 2)
        if keep is not None:
            x = _dropout(x, keep[0], rates[0])
        x = F.max_pool2d(conv(conv(x, "conv2a"), "conv2b"), 2)
        if keep is not None:
            x = _dropout(x, keep[1], rates[1])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(layers.linear(params, "dense1", x))
        if keep is not None:
            x = _dropout(x, keep[2], rates[2])
        return layers.linear(params, "out", x)

    def forward(self, x: torch.Tensor,
                keep: list[torch.Tensor] | None = None) -> torch.Tensor:
        return self.apply(dict(self.named_parameters()), x, keep)


def cinic_cnn(num_classes: int = 10, image_size: int = 32, channels: int = 3,
              width: int = 32) -> CinicCNN:
    """``width`` scales the channel counts (32 = the paper's model)."""
    return CinicCNN(num_classes, image_size, channels, width)


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
