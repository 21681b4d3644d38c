"""Port parity of the numpy-only parts: federations, the Alg. 2 plan and the
WAN ledger must equal the reference exactly; plus device resolution and the
port's own seeded draws."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import augmentation as jaug                       # noqa: E402
from repro.core.comm import CommMeter as JCommMeter               # noqa: E402
from repro.data import federated as jfed                          # noqa: E402

from repro_torch import device as port_device                    # noqa: E402
from repro_torch.core import augmentation as aug                  # noqa: E402
from repro_torch.core.comm import CommMeter                       # noqa: E402
from repro_torch.core.draws import SeededDraws                    # noqa: E402
from repro_torch.data import federated as fed                     # noqa: E402

SETTINGS = [
    dict(sizes="instagram", global_dist="letterfreq", local="random"),
    dict(sizes="even", global_dist="balanced", local="matched"),
    dict(sizes="instagram", global_dist="normal", local="random"),
]


@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_partition_is_byte_identical(setting):
    kw = dict(num_clients=9, total_samples=200, test_samples=60, seed=setting,
              **SETTINGS[setting])
    spec_j = dataclasses.replace(jfed.EMNIST_LIKE, num_classes=12, image_size=12)
    spec_t = dataclasses.replace(fed.EMNIST_LIKE, num_classes=12, image_size=12)
    a, b = jfed.partition(spec_j, **kw), fed.partition(spec_t, **kw)
    for x, y in zip(a.client_images + a.client_labels, b.client_images + b.client_labels):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.test_images.tobytes() == b.test_images.tobytes()
    assert a.test_labels.tobytes() == b.test_labels.tobytes()
    np.testing.assert_array_equal(a.client_counts(), b.client_counts())
    pad = max(x.shape[0] for x in a.client_images) + 3
    for pa, pb in zip(a.padded(pad), b.padded(pad)):
        assert pa.dtype == pb.dtype and pa.tobytes() == pb.tobytes()
    with pytest.raises(ValueError):
        b.padded(1)


def test_paper_width_federation_is_byte_identical():
    """The chip configuration's federation: 47 classes, 64 clients (cut to
    640 samples here)."""
    kw = dict(num_clients=64, total_samples=640, test_samples=94,
              sizes="instagram", global_dist="letterfreq", local="random", seed=0)
    a = jfed.partition(dataclasses.replace(jfed.EMNIST_LIKE, num_classes=47), **kw)
    b = fed.partition(dataclasses.replace(fed.EMNIST_LIKE, num_classes=47), **kw)
    for pa, pb in zip(a.padded(), b.padded()):
        assert pa.tobytes() == pb.tobytes()


@pytest.mark.parametrize("alpha", [0.0, 0.67, 2.0])
def test_augmentation_plan_matches_reference(alpha):
    counts = np.array([0, 3, 10, 40, 7, 100, 55, 1], float)
    np.testing.assert_array_equal(aug.augmentation_plan(counts, alpha),
                                  jaug.augmentation_plan(counts, alpha))
    np.testing.assert_array_equal(aug.planned_counts(counts, alpha),
                                  jaug.planned_counts(counts, alpha))
    np.testing.assert_array_equal(aug.online_mixture(counts, alpha),
                                  jaug.online_mixture(counts, alpha))


def test_comm_ledger_matches_reference():
    a, b = JCommMeter(68_873), CommMeter(68_873)
    for m in (a, b):
        m.plan_broadcast(47, 64)
        for r in range(3):
            m.fedavg_round(16) if r % 2 else m.astraea_round(16, 4, 2)
            m.end_round()
    assert a.total_bytes == b.total_bytes
    assert a.round_log == b.round_log
    assert a.ledger_totals() == b.ledger_totals()
    assert b.total_bytes == 47 * 4 * 64 + 4 * 68_873 * (
        2 * (2 * 16 * 2 + 2 * 4) + 2 * 16)


def test_resolve_device():
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_device.resolve_device()
        with pytest.raises(RuntimeError):
            port_device.resolve_device("cuda")


def test_seeded_draws_are_reproducible_and_address_keyed():
    d1, d2 = SeededDraws(3), SeededDraws(3)
    assert torch.equal(d1.client(0, 1, 0, 2).permutation(0, 30),
                       d2.client(0, 1, 0, 2).permutation(0, 30))
    assert not torch.equal(d1.client(0, 1, 0, 2).permutation(0, 30),
                           d1.client(0, 1, 0, 3).permutation(0, 30))
    sites = [((2, 3, 3, 4), 0.5), ((2, 6), 0.25)]
    keep = d1.client(1, 0, 0, 0).epoch_keep_masks(0, 5, sites)
    assert keep[0].dtype == torch.bool and keep[0].shape == (5, 2, 3, 3, 4)
    assert keep[1].shape == (5, 2, 6)
    assert all(torch.equal(a, b) for a, b in
               zip(keep, d2.client(1, 0, 0, 0).epoch_keep_masks(0, 5, sites)))
    w = torch.tensor([0.0, 2.0, 1.0, 0.0])
    idx, u, mats, trans = d1.augment(0, 0, 1, w)
    assert set(idx.tolist()) <= {1, 2} and u.shape == (4,)
    assert mats.shape == (4, 2, 2) and trans.shape == (4, 2)
    idx0, *_ = d1.augment(0, 0, 1, torch.zeros(4))
    assert idx0.tolist() == [0, 0, 0, 0]
    for a, b in zip(d1.augment(0, 0, 1, w), d2.augment(0, 0, 1, w)):
        assert torch.equal(a, b)


def test_affine_from_uniform_matches_reference_formula():
    """Same uniforms -> the reference's rotation/shear/zoom/shift maps."""
    import jax.numpy as jnp
    u = np.random.default_rng(0).random((5, 6)).astype(np.float32)
    mats, trans = aug.affine_from_uniform(torch.from_numpy(u))
    lo = np.array([-0.3, -0.2, -0.15, -0.15, -3.0, -3.0], np.float32)
    v = u * (-2 * lo) + lo
    cos, sin = jnp.cos(v[:, 0]), jnp.sin(v[:, 0])
    zx, zy = 1.0 + v[:, 2], 1.0 + v[:, 3]
    expect = np.stack([np.stack([cos / zx, (sin + v[:, 1]) / zx], -1),
                       np.stack([-sin / zy, cos / zy], -1)], -2)
    np.testing.assert_allclose(mats.numpy(), expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), v[:, 4:], rtol=1e-6, atol=1e-6)
