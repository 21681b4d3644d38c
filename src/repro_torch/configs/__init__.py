"""Architecture configs of the port's model zoo.

``ArchConfig`` keeps every field of the reference's config.  ``get(arch_id)``
resolves any of the ten architectures (in the reference's order); any other
id raises ``KeyError``, as the reference does for an unknown id.
``reduced(cfg)`` is the CPU smoke variant of the same family;
``InputShape`` and ``make_batch`` give a family's training inputs,
``token_split`` a VLM's text and vision spans; ``INPUT_SHAPES``,
``input_specs`` (meta tensors) and ``skip_reason`` the dry run's.
"""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape, input_specs,
                                     make_batch, reduced, skip_reason, token_split)
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1_314B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN1_5_110B
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

_REGISTRY = {
    "grok-1-314b": GROK_1_314B,
    "internvl2-1b": INTERNVL2_1B,
    "qwen1.5-110b": QWEN1_5_110B,
    "mamba2-370m": MAMBA2_370M,
    "gemma-2b": GEMMA_2B,
    "h2o-danube-1.8b": H2O_DANUBE_1_8B,
    "whisper-base": WHISPER_BASE,
    "hymba-1.5b": HYMBA_1_5B,
    "granite-moe-3b-a800m": GRANITE_MOE_3B_A800M,
    "qwen3-4b": QWEN3_4B,
}

ARCH_IDS = list(_REGISTRY)


def get(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _REGISTRY[arch_id]


__all__ = ["ARCH_IDS", "ArchConfig", "InputShape", "get", "make_batch", "reduced",
           "token_split"]
