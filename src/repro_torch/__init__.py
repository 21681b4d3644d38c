"""PyTorch/CUDA port of the Astraea reproduction.

The package mirrors ``repro``'s layout (``data``, ``core``, ``models``,
``optim``, ``kernels``, ``configs``, ``launch``) in PyTorch idiom.  It
imports torch and numpy only.  Its hand-written CUDA kernels
(``kernels/csrc``) carry the FL main path and the model zoo's serving path
on an NVIDIA Hopper card; on CPU tensors the ``kernels.ops`` wrappers run
the plain PyTorch versions in ``kernels/ref.py``.
"""
from repro_torch.device import resolve_device, set_fp32_precision

__all__ = ["resolve_device", "set_fp32_precision"]
