"""Trainer and pytree checkpoints in the JAX package's file format."""
from repro_torch.checkpoint.msgpack_ckpt import (load_pytree, load_trainer,
                                                 save_pytree, save_trainer)

__all__ = ["save_pytree", "load_pytree", "save_trainer", "load_trainer"]
