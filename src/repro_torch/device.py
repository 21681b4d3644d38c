"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless the caller asks for the CPU with
``device="cpu"`` (the tests do).  Without a usable CUDA device and without
that explicit request, ``resolve_device`` raises: a run never drifts onto
the CPU by itself.

fp32 means fp32: both TF32 switches are turned off whenever a device is
resolved, so convolutions (cuDNN) and matrix products keep full float32
mantissas on the card, as the float32 reference computes them.
"""
from __future__ import annotations

import numpy as np
import torch


def set_fp32_precision() -> None:
    """Turn off TF32 for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises if there is
    none); ``"cpu"`` -> the CPU; any other string is parsed by torch."""
    set_fp32_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array (an index, a mask) as a tensor on ``device``.  On
    the card it goes through pinned memory with ``non_blocking=True``: the
    copy queues behind the work already on the stream instead of making the
    host wait for it, as a copy from pageable memory would."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
