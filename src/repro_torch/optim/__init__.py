from repro_torch.optim.optimizers import Optimizer, adam, apply_updates, sgd

__all__ = ["Optimizer", "adam", "apply_updates", "sgd"]
