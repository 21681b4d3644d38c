"""Synthetic, genuinely-learnable image classification data.

The container is offline (no EMNIST/CINIC-10), so we synthesize a family of
classification tasks with the same *structure*: each class has a smooth
random prototype image; a sample is its prototype under a random affine
distortion plus pixel noise. A small CNN reaches >90% on the balanced
variant, leaving headroom for imbalance effects to be measured -- which is
all the paper's experiments need.

Generation is numpy (cheap, done once); training consumes torch tensors.
A byte-for-byte copy of the JAX package's ``data/synthetic.py`` (numpy only),
so both packages build identical federations from the same seed.

Million-client scale: ``federation_counts`` draws a K-client federation's
per-client label histograms in one vectorized pass (Dirichlet skew +
batched multinomial -- no sample is ever materialized), and
``StreamingFederation`` wraps them as a lazy *row source* for the
streaming client stores: a client's padded ``(pad, ...)`` x/y/mask rows
are synthesized deterministically on demand from a per-client seed
sequence, so the same client id always yields byte-identical rows no
matter when -- or on which thread -- it is streamed (the spill store's
prefetch-correctness anchor), and total footprint is histograms
(K x C ints) plus the <= c clients in flight, never K x samples.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticSpec:
    num_classes: int = 20
    image_size: int = 28
    channels: int = 1
    noise: float = 0.25          # pixel noise std
    distort: float = 0.15        # affine distortion strength
    prototype_freqs: int = 3     # low-frequency components per prototype


def _prototypes(spec: SyntheticSpec, rng: np.random.Generator) -> np.ndarray:
    """Smooth per-class prototypes: random low-frequency Fourier mixtures."""
    h = spec.image_size
    yy, xx = np.mgrid[0:h, 0:h] / h
    protos = np.zeros((spec.num_classes, h, h, spec.channels), np.float32)
    for c in range(spec.num_classes):
        for ch in range(spec.channels):
            img = np.zeros((h, h))
            for _ in range(spec.prototype_freqs):
                fy, fx = rng.integers(1, 4, 2)
                phase_y, phase_x = rng.uniform(0, 2 * np.pi, 2)
                amp = rng.uniform(0.5, 1.0)
                img += amp * np.sin(2 * np.pi * fy * yy + phase_y) * np.cos(2 * np.pi * fx * xx + phase_x)
            protos[c, :, :, ch] = img / np.abs(img).max()
    return protos


def _random_affine_np(rng: np.random.Generator, img: np.ndarray, strength: float) -> np.ndarray:
    """Cheap affine distortion: small rotation + shift via index remap."""
    h = img.shape[0]
    theta = rng.uniform(-strength, strength)
    tx, ty = rng.uniform(-strength * h * 0.2, strength * h * 0.2, 2)
    c, s = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:h, 0:h].astype(np.float32)
    cy = cx = (h - 1) / 2
    src_y = c * (yy - cy) - s * (xx - cx) + cy + ty
    src_x = s * (yy - cy) + c * (xx - cx) + cx + tx
    iy = np.clip(np.rint(src_y).astype(int), 0, h - 1)
    ix = np.clip(np.rint(src_x).astype(int), 0, h - 1)
    return img[iy, ix]


class SyntheticTask:
    """Holds the class prototypes; generates arbitrarily many fresh samples."""

    def __init__(self, spec: SyntheticSpec, seed: int = 0):
        self.spec = spec
        self._proto_rng = np.random.default_rng(seed)
        self.prototypes = _prototypes(spec, self._proto_rng)

    def sample(self, cls: int, n: int, rng: np.random.Generator) -> np.ndarray:
        proto = self.prototypes[cls]
        out = np.empty((n,) + proto.shape, np.float32)
        for i in range(n):
            img = _random_affine_np(rng, proto, self.spec.distort)
            out[i] = img + rng.normal(0, self.spec.noise, proto.shape)
        return out

    def sample_counts(self, counts: np.ndarray, rng: np.random.Generator
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Generate ``counts[c]`` samples per class, shuffled."""
        xs, ys = [], []
        for c, n in enumerate(np.asarray(counts, int)):
            if n <= 0:
                continue
            xs.append(self.sample(c, int(n), rng))
            ys.append(np.full(int(n), c, np.int32))
        x = np.concatenate(xs) if xs else np.empty((0,) + self.prototypes.shape[1:], np.float32)
        y = np.concatenate(ys) if ys else np.empty((0,), np.int32)
        perm = rng.permutation(x.shape[0])
        return x[perm], y[perm]


def make_classification_data(spec: SyntheticSpec, counts: np.ndarray, seed: int = 0
                             ) -> tuple[np.ndarray, np.ndarray]:
    task = SyntheticTask(spec, seed)
    rng = np.random.default_rng(seed + 1)
    return task.sample_counts(counts, rng)


def federation_counts(num_clients: int, num_classes: int, *,
                      min_samples: int = 24, max_samples: int = 48,
                      skew: float = 0.3, seed: int = 0) -> np.ndarray:
    """``(K, C)`` per-client label histograms, no samples materialized.

    One vectorized pass: per-client totals are uniform ints, per-client
    class mixes are Dirichlet draws (small ``skew`` = non-IID clients
    concentrated on a few classes, the paper's BAL2-style local
    imbalance), and the histograms are a single batched multinomial.
    K=1e6 takes a couple of seconds and ~K * C * 4 bytes -- this is the
    ONLY per-federation state the streaming pipeline keeps.
    """
    rng = np.random.default_rng(seed)
    totals = rng.integers(min_samples, max_samples + 1, num_clients)
    mixes = rng.dirichlet(np.full(num_classes, skew), size=num_clients)
    return rng.multinomial(totals, mixes).astype(np.int32)


# per-client seed-sequence salt, so client streams never collide with the
# federation-level rngs above
_CLIENT_SALT = 0x5F


class StreamingFederation:
    """Lazy K-client federation: histograms up front, samples on demand.

    Implements both surfaces the streaming engine path needs:

    * the *dataset* surface (``num_clients`` / ``num_classes`` /
      ``client_counts()`` / ``pad`` / ``test_images`` / ``test_labels``)
      consumed by ``FLRoundEngine`` for scheduling and eval;
    * the *row source* protocol (``row_specs`` / ``nbytes_per_client`` /
      ``rows(ids)``) consumed by the host/spilled client stores: a
      client's padded x/y/mask rows, synthesized from
      ``SeedSequence([seed, salt, client_id])`` -- deterministic per id,
      independent of streaming order and thread.

    Only the small balanced test set is ever materialized.
    """

    def __init__(self, spec: SyntheticSpec, counts: np.ndarray, *,
                 batch_size: int = 10, seed: int = 0,
                 test_per_class: int = 8, name: str = "stream"):
        self.spec, self.name = spec, name
        self.task = SyntheticTask(spec, seed)
        self._counts = np.asarray(counts)
        self.num_clients, self.num_classes = self._counts.shape
        if self.num_classes != spec.num_classes:
            raise ValueError(f"counts have {self.num_classes} classes, "
                             f"spec has {spec.num_classes}")
        sizes = self._counts.sum(axis=1)
        if sizes.min(initial=1) < 1:
            raise ValueError("every client needs at least one sample")
        # same padding rule as the engine applies to packed federations,
        # so a materialized copy of this federation packs byte-identically
        self.pad = int(-(-int(sizes.max()) // batch_size) * batch_size)
        self._seed = seed
        h = spec.image_size
        self._img_shape = (h, h, spec.channels)
        rng = np.random.default_rng(seed + 1)
        self.test_images, self.test_labels = self.task.sample_counts(
            np.full(self.num_classes, test_per_class), rng)

    def client_counts(self) -> np.ndarray:
        return self._counts

    # ---- row source protocol (core/client_store.py) ----
    @property
    def row_specs(self) -> tuple:
        return (((self.pad,) + self._img_shape, np.dtype(np.float32)),
                ((self.pad,), np.dtype(np.int32)),
                ((self.pad,), np.dtype(np.float32)))

    @property
    def nbytes_per_client(self) -> int:
        return sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in self.row_specs)

    def _client_rows(self, k: int) -> tuple:
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, _CLIENT_SALT, int(k)]))
        x, y = self.task.sample_counts(self._counts[k], rng)
        n = x.shape[0]
        xs = np.zeros((self.pad,) + self._img_shape, np.float32)
        ys = np.zeros((self.pad,), np.int32)
        ms = np.zeros((self.pad,), np.float32)
        xs[:n], ys[:n], ms[:n] = x, y, 1.0
        return xs, ys, ms

    def rows(self, ids: np.ndarray) -> tuple:
        ids = np.asarray(ids)
        out = tuple(np.empty((ids.size,) + shape, dtype)
                    for shape, dtype in self.row_specs)
        for i, k in enumerate(ids):
            for buf, row in zip(out, self._client_rows(int(k))):
                buf[i] = row
        return out

    # ---- equivalence helper (tests / small-K benches) ----
    def materialize(self):
        """Realize the whole federation as a packed ``FederatedDataset``
        -- identical samples to what streaming yields per client, so an
        engine over the materialized copy (any store policy) is bitwise
        identical to the streaming engine. Small K only, obviously."""
        from repro_torch.data.federated import FederatedDataset
        xs, ys = [], []
        for k in range(self.num_clients):
            x, y, m = self._client_rows(k)
            n = int(m.sum())
            xs.append(x[:n].copy())
            ys.append(y[:n].copy())
        return FederatedDataset(client_images=xs, client_labels=ys,
                                test_images=self.test_images,
                                test_labels=self.test_labels,
                                num_classes=self.num_classes,
                                name=self.name + "-materialized")
