from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (Optimizer, adam, adamw, apply_updates,
                                          clip_by_global_norm, sgd)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "clip_by_global_norm",
           "schedules", "sgd"]
