"""Astraea core in PyTorch: the paper's contribution as composable modules."""
from repro_torch.core import augmentation, comm, distribution, fl, scheduling
from repro_torch.core.astraea import AstraeaTrainer
from repro_torch.core.engine import EngineConfig, FLRoundEngine
from repro_torch.core.fedavg import FedAvgTrainer
from repro_torch.core.fl import LocalSpec

__all__ = ["augmentation", "comm", "distribution", "fl", "scheduling",
           "AstraeaTrainer", "EngineConfig", "FLRoundEngine", "FedAvgTrainer",
           "LocalSpec"]
