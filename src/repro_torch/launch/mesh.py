"""Meshes as axis names and sizes (``repro/launch/mesh.py``), with no
device and no process group.

The reference's production target is a pod of TPU chips:

  single pod: (data=16, model=16)            -- 256 devices
  multi pod:  (pod=2, data=16, model=16)     -- 512 devices

Here a mesh is an ``AbstractMesh``: what the sharding rules
(``launch/sharding.py``) and the dry run (``launch/dryrun.py``) read --
axis names, their sizes, the device count.  Mapping it onto a live
``torch.distributed`` ``DeviceMesh`` is the distributed runtime's work,
which the port does not have yet: ``init_distributed``,
``process_local_mesh``, ``ProcessWaveDispatcher`` and ``make_fl_mesh``
with ``model > 1`` raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

_RUNTIME = ("the port's distributed runtime (torch.distributed over several cards) "
            "is not ported yet")


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names in order and their sizes."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(s < 1 for s in self.sizes):
            raise ValueError(f"bad mesh {self.axis_names} {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh() -> AbstractMesh:
    """The degenerate one-device mesh: one card, or the CPU."""
    return AbstractMesh(("data", "model"), (1, 1))


def make_fl_mesh(*, mediator: int = 1, model: int = 1) -> AbstractMesh:
    """The FL round engine's ``(mediator, model)`` mesh.  Only ``model ==
    1`` exists in the port: every mediator row holds its whole model."""
    if model != 1:
        raise NotImplementedError(f"make_fl_mesh(model={model}): {_RUNTIME}")
    return AbstractMesh(("mediator", "model"), (int(mediator), 1))


def model_axis_size(mesh: AbstractMesh) -> int:
    """Size of the tensor-parallel ``model`` axis (1 without one)."""
    return mesh.shape.get("model", 1)


def data_axes(mesh: AbstractMesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch: ("pod", "data") or ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def ring_permutation(n: int, step: int) -> list[tuple[int, int]]:
    """The step-``s`` rotation over an ``n``-device axis as ``(source,
    dest)`` pairs: at hop ``s`` shard ``o`` sends to ``(o + s) % n``, so
    every hop is a full permutation (the ragged client-store exchange's
    decomposition of its all-to-all)."""
    if not 0 < step < n:
        raise ValueError(f"ring step must be in (0, {n}), got {step}")
    return [(o, (o + step) % n) for o in range(n)]


def init_distributed(*args, **kwargs):
    raise NotImplementedError(f"init_distributed: {_RUNTIME}")


def process_local_mesh(*args, **kwargs):
    raise NotImplementedError(f"process_local_mesh: {_RUNTIME}")


class ProcessWaveDispatcher:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ProcessWaveDispatcher: {_RUNTIME}")
