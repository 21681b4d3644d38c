"""Class-distribution statistics and Kullback-Leibler divergence.

Astraea's two strategies both operate on *label distributions*: Alg. 2
needs the global per-class counts and their mean; Alg. 3 greedily
minimizes ``D_KL(P_m + P_k || P_u)``.  Every function computes in float32
with the op order of the JAX reference (``repro/core/distribution.py``),
so scores over integer counts agree with it to the last few ulps of
``log``.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def class_histogram(labels: torch.Tensor, num_classes: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-class sample counts of an integer label vector ``(n,)``; ``mask``
    zeros (padding) are excluded.  Returns float32 ``(num_classes,)``."""
    weights = torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device) if mask is None \
        else mask.to(torch.float32)
    out = torch.zeros(num_classes, dtype=torch.float32, device=labels.device)
    return out.index_add_(0, labels.long(), weights)


def normalize(counts: torch.Tensor) -> torch.Tensor:
    """Counts -> probability distribution (safe for all-zero rows)."""
    total = counts.sum(dim=-1, keepdim=True)
    return counts / total.clamp_min(_EPS)


def uniform(num_classes: int, device=None) -> torch.Tensor:
    return torch.full((num_classes,), 1.0 / num_classes, dtype=torch.float32,
                      device=device)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """D_KL(p || q) over the last axis, with 0·log(0/q) = 0."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    ratio = torch.log(p.clamp_min(_EPS)) - torch.log(q.clamp_min(_EPS))
    return torch.where(p > 0, p * ratio, torch.zeros((), device=p.device)
                       ).sum(dim=-1)


def kld_to_uniform(counts: torch.Tensor) -> torch.Tensor:
    """D_KL(normalize(counts) || U); accepts leading batch axes."""
    counts = counts.to(torch.float32)
    return kl_divergence(normalize(counts),
                         uniform(counts.shape[-1], counts.device))


def merged_kld_scores(mediator_counts: torch.Tensor,
                      client_counts: torch.Tensor) -> torch.Tensor:
    """Alg. 3 inner loop: ``D_KL(normalize(P_m + P_k) || U)`` for every
    candidate row of ``client_counts (K, C)`` against ``mediator_counts
    (C,)``.  Returns ``(K,)`` float32."""
    merged = mediator_counts.to(torch.float32)[None, :] \
        + client_counts.to(torch.float32)
    return kld_to_uniform(merged)


def global_histogram(client_counts: torch.Tensor) -> torch.Tensor:
    """Union distribution over all clients: the sum of per-client counts."""
    return torch.as_tensor(client_counts, dtype=torch.float32).sum(dim=0)


def imbalance_summary(client_counts) -> dict[str, torch.Tensor]:
    """The three imbalance types of ``(K, C)`` client counts: ``size_cv``
    (scalar: std / mean of the client sizes), ``local_kld_mean`` (local:
    the mean client KLD to uniform) and ``global_kld`` (global: the KLD of
    the union histogram to uniform)."""
    counts = torch.as_tensor(client_counts, dtype=torch.float32)
    sizes = counts.sum(dim=-1)
    return {
        "size_cv": sizes.std(correction=0) / sizes.mean().clamp_min(_EPS),
        "local_kld_mean": kld_to_uniform(counts).mean(),
        "global_kld": kld_to_uniform(global_histogram(counts)),
    }
