"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch and the port only (no JAX), so it runs on a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips: the kernels have no CPU mode.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import scheduling                           # noqa: E402
from repro_torch.kernels import ops, ref                          # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("n", [68_873, 1 << 16])
def test_fedavg_agg_kernel(dev, dtype, rtol, n):
    """Odd N takes the one-column path, aligned N the vector path."""
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.randn(16, n, generator=g, device=dev).to(dtype)
    w = torch.rand(16, generator=g, device=dev)
    before = ops.LAUNCHES["fedavg_agg"]
    out = ops.fedavg_agg(d, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fedavg_agg"] == before + 1
    torch.testing.assert_close(out.double(), ref.fedavg_agg(d, w).double(),
                               rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_fedavg_agg_tree_fused_equals_per_leaf_on_card(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    tree = {"a": torch.randn(4, 3, 5, generator=g, device=dev),
            "b": torch.randn(4, 17, generator=g, device=dev)}
    w = torch.rand(4, generator=g, device=dev)
    fused = ops.fedavg_agg_tree(tree, w)
    for k, leaf in tree.items():
        assert torch.equal(fused[k], ops.fedavg_agg(leaf.reshape(4, -1), w)
                           .reshape(leaf.shape[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("k,tied", [(16, False), (300, False), (64, True)])
def test_kld_greedy_kernel(dev, k, tied):
    rng = np.random.default_rng(k)
    counts = np.tile(rng.integers(1, 9, (1, 47)), (k, 1)) if tied \
        else rng.integers(0, 60, (k, 47))
    t = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    kp = ops.kld_greedy_picks(t, 4).cpu().numpy()
    pp = ref.kld_greedy_picks(t, 4).cpu().numpy()
    div = scheduling.first_divergence(counts, 4, pp, kp)
    assert div is None or div["tie"], div
    if tied:
        np.testing.assert_array_equal(kp, np.arange(k))


@pytest.mark.cuda
def test_affine_warp_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    imgs = torch.randn(64, 28, 28, 3, generator=g, device=dev)
    mats = torch.randn(64, 2, 2, generator=g, device=dev)
    trans = 3 * torch.randn(64, 2, generator=g, device=dev)
    torch.testing.assert_close(ops.affine_warp(imgs, mats, trans),
                               ref.affine_warp(imgs, mats, trans), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_wrappers_refuse_non_contiguous_cuda_input(dev):
    d = torch.randn(8, 4, device=dev).t()
    with pytest.raises(ValueError):
        ops.fedavg_agg(d, torch.ones(4, device=dev))
