"""Astraea core in PyTorch: the paper's contribution as composable modules."""
from repro_torch.checkpoint import load_pytree, load_trainer, save_pytree, save_trainer
from repro_torch.core import augmentation, comm, distribution, fl, scheduling
from repro_torch.core.astraea import AstraeaTrainer
from repro_torch.core.async_engine import AsyncRoundEngine, AsyncSpec
from repro_torch.core.engine import EngineConfig, FLRoundEngine
from repro_torch.core.fedavg import FedAvgTrainer
from repro_torch.core.fl import LocalSpec
from repro_torch.core.staleness import AdaptiveStalenessSpec, StragglerSpec

__all__ = ["augmentation", "comm", "distribution", "fl", "scheduling",
           "AdaptiveStalenessSpec", "AstraeaTrainer", "AsyncRoundEngine",
           "AsyncSpec", "EngineConfig", "FLRoundEngine", "FedAvgTrainer",
           "LocalSpec", "StragglerSpec", "load_pytree", "load_trainer",
           "save_pytree", "save_trainer"]
