"""Architecture configs of the port's model zoo.

``ArchConfig`` keeps every field of the reference's config, so a family
that joins the port later adds registry entries, not a new class.
``get(arch_id)`` resolves the architectures the port runs; any other id
raises ``KeyError``, as the reference does for an unknown id.
``reduced(cfg)`` is the CPU smoke variant of the same family;
``InputShape`` and ``make_batch`` give a family's training inputs.
"""
from repro_torch.configs.base import ArchConfig, InputShape, make_batch, reduced
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B

_REGISTRY = {
    "hymba-1.5b": HYMBA_1_5B,
    "gemma-2b": GEMMA_2B,
    "qwen3-4b": QWEN3_4B,
    "h2o-danube-1.8b": H2O_DANUBE_1_8B,
    "mamba2-370m": MAMBA2_370M,
}

ARCH_IDS = list(_REGISTRY)


def get(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs: {ARCH_IDS}")
    return _REGISTRY[arch_id]


__all__ = ["ARCH_IDS", "ArchConfig", "InputShape", "get", "make_batch", "reduced"]
