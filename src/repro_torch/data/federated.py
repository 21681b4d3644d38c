"""Federated partitioners reproducing the paper's TABLE I settings.

Three orthogonal imbalance knobs (Section II-B):

* **Scalar (size)**: per-client dataset sizes -- ``even`` or ``instagram``
  (the cited Instagram-uploads dynamics are heavy-tailed; we use a log-normal
  size law, the standard fit for user-upload counts).
* **Global**: union class distribution -- ``balanced``, ``letterfreq``
  (English letter frequency, the paper's LTRF), or ``normal`` (standard
  normal pdf over class index, the paper's imbalanced CINIC-10).
* **Local**: per-client class distribution -- ``matched`` (each client
  mirrors the global distribution; BAL1) or ``random`` (Dirichlet around the
  global distribution; BAL2/INS/LTRF -- non-IID).

The five TABLE I datasets are then:

    BAL1  = (even,      balanced,   matched)
    BAL2  = (even,      balanced,   random)
    INS   = (instagram, balanced,   random)
    LTRF1 = (instagram, letterfreq, random)
    LTRF2 = LTRF1 with 2x total training data

Clients never share samples (every sample is freshly generated) and the test
set is always balanced -- both paper invariants.

A copy of the JAX package's ``data/federated.py`` (numpy only): the same
seed gives byte-identical arrays in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.synthetic import SyntheticSpec, SyntheticTask

# English letter relative frequencies (Wikipedia corpus order a..z), the
# paper's LTRF global law. Truncated + renormalized to num_classes.
_LETTER_FREQ = np.array([
    8.167, 1.492, 2.782, 4.253, 12.702, 2.228, 2.015, 6.094, 6.966, 0.153,
    0.772, 4.025, 2.406, 6.749, 7.507, 1.929, 0.095, 5.987, 6.327, 9.056,
    2.758, 0.978, 2.360, 0.150, 1.974, 0.074])


def letter_frequency_probs(num_classes: int) -> np.ndarray:
    """LTRF global class distribution (sorted descending like Zipf-ish data)."""
    freqs = _LETTER_FREQ
    if num_classes <= len(freqs):
        p = np.sort(freqs)[::-1][:num_classes]
    else:  # extend with a Zipf tail for >26 classes (e.g. 47-class EMNIST)
        tail = freqs.min() / np.arange(2, num_classes - len(freqs) + 2)
        p = np.concatenate([np.sort(freqs)[::-1], tail])[:num_classes]
    return p / p.sum()


def normal_pdf_probs(num_classes: int) -> np.ndarray:
    """Imbalanced CINIC-10: class counts follow the standard normal pdf."""
    z = np.linspace(-2.0, 2.0, num_classes)
    p = np.exp(-0.5 * z * z)
    return p / p.sum()


def instagram_sizes(num_clients: int, rng: np.random.Generator,
                    sigma: float = 1.0) -> np.ndarray:
    """Heavy-tailed per-client size weights (log-normal upload law)."""
    w = rng.lognormal(mean=0.0, sigma=sigma, size=num_clients)
    return w / w.sum()


@dataclass
class FederatedDataset:
    """Per-client padded arrays + masks, ready for the round engine."""
    client_images: list[np.ndarray]
    client_labels: list[np.ndarray]
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int
    name: str = "fed"

    @property
    def num_clients(self) -> int:
        return len(self.client_images)

    def client_counts(self) -> np.ndarray:
        out = np.zeros((self.num_clients, self.num_classes))
        for k, y in enumerate(self.client_labels):
            out[k] = np.bincount(y, minlength=self.num_classes)
        return out

    def padded(self, pad_to: int | None = None):
        """Stack clients into (K, pad, ...) arrays + (K, pad) masks.

        Raises ``ValueError`` if ``pad_to`` is smaller than the largest
        client -- silently truncating samples would corrupt the federation
        (the old behavior dropped the tail without warning).
        """
        sizes = [x.shape[0] for x in self.client_images]
        pad = pad_to or max(sizes)
        if pad < max(sizes):
            raise ValueError(
                f"pad_to={pad} would truncate clients: the largest client "
                f"holds {max(sizes)} samples; pass pad_to >= {max(sizes)}")
        sample_shape = self.client_images[0].shape[1:]
        xs = np.zeros((self.num_clients, pad) + sample_shape, np.float32)
        ys = np.zeros((self.num_clients, pad), np.int32)
        mask = np.zeros((self.num_clients, pad), np.float32)
        for k, (x, y) in enumerate(zip(self.client_images, self.client_labels)):
            n = x.shape[0]
            xs[k, :n] = x
            ys[k, :n] = y
            mask[k, :n] = 1.0
        return xs, ys, mask


# dataset presets (scaled-down analogues)
EMNIST_LIKE = SyntheticSpec(num_classes=20, image_size=28, channels=1)
CINIC_LIKE = SyntheticSpec(num_classes=10, image_size=32, channels=3)


def _client_class_counts(rng: np.random.Generator, num_clients: int,
                         total_samples: int, global_probs: np.ndarray,
                         size_weights: np.ndarray, local: str,
                         dirichlet_conc: float = 2.0) -> np.ndarray:
    """Integer (K, C) per-client class counts realizing all three knobs."""
    num_classes = global_probs.shape[0]
    sizes = np.maximum(np.rint(size_weights * total_samples).astype(int), 2)
    counts = np.zeros((num_clients, num_classes), int)
    for k in range(num_clients):
        if local == "matched":
            q = global_probs
        elif local == "random":
            q = rng.dirichlet(dirichlet_conc * num_classes * global_probs)
        else:
            raise ValueError(f"unknown local distribution {local!r}")
        counts[k] = rng.multinomial(sizes[k], q)
    return counts


def partition(spec: SyntheticSpec, *, num_clients: int, total_samples: int,
              test_samples: int, sizes: str = "even", global_dist: str = "balanced",
              local: str = "random", seed: int = 0, name: str = "fed",
              dirichlet_conc: float = 2.0) -> FederatedDataset:
    """Build one of the TABLE I-style federated datasets."""
    rng = np.random.default_rng(seed)
    task = SyntheticTask(spec, seed=seed)

    if global_dist == "balanced":
        gp = np.full(spec.num_classes, 1.0 / spec.num_classes)
    elif global_dist == "letterfreq":
        gp = letter_frequency_probs(spec.num_classes)
    elif global_dist == "normal":
        gp = normal_pdf_probs(spec.num_classes)
    else:
        raise ValueError(f"unknown global distribution {global_dist!r}")

    if sizes == "even":
        sw = np.full(num_clients, 1.0 / num_clients)
    elif sizes == "instagram":
        sw = instagram_sizes(num_clients, rng)
    else:
        raise ValueError(f"unknown size law {sizes!r}")

    counts = _client_class_counts(rng, num_clients, total_samples, gp, sw, local,
                                  dirichlet_conc)
    client_x, client_y = [], []
    for k in range(num_clients):
        x, y = task.sample_counts(counts[k], rng)
        client_x.append(x)
        client_y.append(y)

    # balanced test set (paper invariant)
    per_class = test_samples // spec.num_classes
    tx, ty = task.sample_counts(np.full(spec.num_classes, per_class), rng)
    return FederatedDataset(client_x, client_y, tx, ty, spec.num_classes, name)


def table1(spec: SyntheticSpec = EMNIST_LIKE, *, num_clients: int = 60,
           total_samples: int = 6000, test_samples: int = 2000, seed: int = 0
           ) -> dict[str, FederatedDataset]:
    """All five TABLE I datasets at the scaled-down size."""
    mk = lambda name, sizes, gd, local, total: partition(
        spec, num_clients=num_clients, total_samples=total,
        test_samples=test_samples, sizes=sizes, global_dist=gd, local=local,
        seed=seed, name=name)
    return {
        "BAL1": mk("BAL1", "even", "balanced", "matched", total_samples),
        "BAL2": mk("BAL2", "even", "balanced", "random", total_samples),
        "INS": mk("INS", "instagram", "balanced", "random", total_samples),
        "LTRF1": mk("LTRF1", "instagram", "letterfreq", "random", total_samples),
        "LTRF2": mk("LTRF2", "instagram", "letterfreq", "random", total_samples * 2),
    }
