"""Three-term roofline, the useful-FLOP references and the kernels'
analytic costs (``repro/roofline/model.py`` and the ``cost_estimate``s of
``repro/kernels/``).

``HW`` holds one NVIDIA H100 SXM5's data-sheet peaks (dense rates, no
sparsity, at the 700 W limit); none is a measurement.  Terms, in seconds
a step on one device:

  compute    = FLOPs / peak_flops
  memory     = bytes / hbm_bw
  collective = collective bytes / link_bw (None where nothing counted them)

``model_flops`` is the 6*N*D (dense) / 6*N_active*D (MoE) useful-compute
reference; ``useful_ratio`` = model / counted catches recomputation and
redundancy.

The kernel costs are the reference's analytic counts, one function per
``pallas_call`` (the same formulas, fields named as ``pl.CostEstimate``'s),
and for the two backwards the reference leaves to XLA the counts
``examples/kernel_times.py`` bounds them by.  ``roofline/counts.py``
charges each kernel launch of a counted step with them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, NamedTuple

import numpy as np

if TYPE_CHECKING:       # this module imports nothing of the package at its top:
    # examples/kernel_times.py loads it by path, beside another tree's package
    from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM5 data-sheet peaks (dense, no sparsity, 700 W)."""
    peak_flops: float = 989e12          # bf16 / fp16 on the tensor cores
    peak_flops_tf32: float = 495e12     # TF32 on the tensor cores
    peak_flops_fp32: float = 67e12      # fp32 outside the tensor cores
    hbm_bw: float = 3.35e12             # HBM3, B/s
    link_bw: float = 450e9              # NVLink 4, B/s a direction


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float | None
    flops: float
    bytes_accessed: float
    collective_bytes: float | None
    model_flops: float
    useful_ratio: float

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Naive no-overlap bound: the largest term counted."""
        return max(self._terms().values())

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
        }


def roofline_from_costs(flops: float, bytes_accessed: float,
                        collective_bytes: float | None, model_flops_total: float,
                        hw: HW = HW()) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / hw.peak_flops,
        memory_s=bytes_accessed / hw.hbm_bw,
        collective_s=None if collective_bytes is None else collective_bytes / hw.link_bw,
        flops=flops, bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
        model_flops=model_flops_total,
        useful_ratio=model_flops_total / max(flops, 1.0),
    )


def kernel_roofline(flops: float, bytes_accessed: float, hw: HW = HW()) -> dict:
    """Two-term (compute / HBM) bound of one kernel launch from its
    analytic cost: the no-overlap least time, which wall it sits against,
    and its intensity against the ridge point (FLOP/byte), at
    ``hw.peak_flops``."""
    compute_s = flops / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    return {
        "flops": float(flops),
        "bytes": float(bytes_accessed),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "roofline_s": max(compute_s, memory_s),
        "bound": "compute" if compute_s >= memory_s else "memory",
        "intensity": float(flops) / max(float(bytes_accessed), 1.0),
        "ridge_intensity": hw.peak_flops / hw.hbm_bw,
    }


def achieved_fraction(measured_s: float, roofline_s: float) -> float:
    """Fraction of the roofline bound achieved: bound / measured."""
    return float(roofline_s) / max(float(measured_s), 1e-12)


def model_flops(cfg: ArchConfig, tokens: int, kind: str) -> float:
    """6*N*D useful FLOPs for ``tokens`` tokens.  train: 6*N*D (forward
    and backward); prefill and decode: 2*N*D.  MoE counts active params."""
    from repro_torch.models.transformer import active_param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_param_count(cfg) * tokens


def analytic_flops_per_token(cfg: ArchConfig, seq_len: int, kind: str) -> float:
    """Finer-grained forward FLOPs a token, the attention O(s) term
    included (times 3, or 4 under remat, for training)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = 0.0
    if cfg.has_attention:
        per_layer += 2 * d * hd * (2 * H + 2 * KV)            # qkvo projections
        kv_span = min(cfg.sliding_window or seq_len, seq_len)
        per_layer += 2 * 2 * H * hd * (kv_span / 2 if kind != "decode" else kv_span)
    if cfg.has_ssm:
        di, n, h, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        per_layer += 2 * d * (2 * di + 2 * n + h) + 2 * di * d
        Lc = cfg.ssm_chunk
        per_layer += 2 * Lc * n + 2 * Lc * h * p + 4 * h * p * n
    if cfg.is_moe:
        per_layer += 2 * 3 * d * f * cfg.top_k * cfg.capacity_factor + 2 * d * cfg.n_experts
    elif cfg.d_ff:
        nmat = 2 if cfg.norm == "ln" else 3
        per_layer += 2 * nmat * d * f
    total = per_layer * cfg.n_layers + 2 * d * cfg.vocab      # lm head
    if kind == "train":
        total *= 3 + (1 if cfg.remat else 0)                   # bwd + remat fwd
    return total


# --------------------------------------------------------------------------
# The kernels' analytic costs
# --------------------------------------------------------------------------

class Cost(NamedTuple):
    """One launch's analytic cost (``pl.CostEstimate``'s fields)."""
    flops: float
    transcendentals: float
    bytes_accessed: float


def fedavg_agg_cost(m: int, n: int, delta_bytes: int, out_bytes: int) -> Cost:
    """Eq. 6 over ``(m, n)`` deltas (``kernels/fedavg_agg.py:57``)."""
    return Cost(2 * m * n, 0, m * n * delta_bytes + n * out_bytes + m * 4)


def score_cost(m: int, k: int, c: int) -> Cost:
    """An ``(m, k, c)`` scoring sweep (``kernels/kld_score.py:60``):
    ``kld_score`` is m = 1, ``kld_score_matrix`` any m."""
    return Cost(6 * m * k * c, m * k * c, (m * c + k * c) * 4 + m * k * 4)


def greedy_cost(k: int, c: int) -> Cost:
    """The whole Alg. 3 pass: K absorption steps, each a full ``(K, C)``
    sweep (``kernels/kld_score.py:204``)."""
    sweep = score_cost(1, k, c)
    return Cost(k * sweep.flops + 4 * k * k, k * sweep.transcendentals,
                k * k * c * 4 + k * 4)


def affine_warp_cost(b: int, h: int, w: int, c: int, img_bytes: int = 4) -> Cost:
    """One warp launch (``kernels/affine_warp.py:33``)."""
    hw = h * w
    return Cost(b * (2 * hw * hw * c + 12 * hw * hw), 0,
                b * (2 * hw * c * img_bytes + 4 * 4 + 2 * 4))


def flash_attention_cost(b: int, h: int, sq: int, skv: int, d: int,
                         io_bytes: int = 4) -> Cost:
    """One attention launch (``kernels/flash_attention.py:29``): the full
    ``sq x skv`` square whatever the mask, K and V counted per query head."""
    return Cost(4 * b * h * sq * skv * d, b * h * sq * skv,
                io_bytes * (2 * b * h * sq * d + 2 * b * h * skv * d))


def ssd_chunk_cost(b: int, nc: int, L: int, h: int, p: int, n: int,
                   io_bytes: int = 4) -> Cost:
    """One SSD intra-chunk launch (``kernels/ssd_chunk.py:31``)."""
    tiles = b * nc * h
    return Cost(tiles * (2 * L * L * (n + p) + 2 * L * n * p + 3 * L * L),
                tiles * (L * L + L + 1),
                tiles * (2 * L * p * io_bytes + L * io_bytes + 4
                         + 2 * L * n * io_bytes + n * p * 4 + 4))


def visible_pairs(sq: int, skv: int, causal: bool, window: int | None,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the causal and window masks keep
    (``kernels/ref.py::attention_mask``'s ones)."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_bwd_cost(b: int, h: int, kv: int, sq: int, skv: int, d: int,
                             io_bytes: int, causal: bool = True, window: int | None = None,
                             q_offset: int = 0) -> Cost:
    """The attention backward (``examples/kernel_times.py::
    flash_bwd_bound``): five d-long products a visible pair (S and dO V^T
    recomputed, dV, dK, dQ), 2d operations each; one exp a visible pair;
    q, out, dout and dq (b, sq, H, d), k, v, dk and dv (b, skv, KV, d)
    each moved once."""
    pairs = visible_pairs(sq, skv, causal, window, q_offset) * b * h
    return Cost(10 * d * pairs, pairs, io_bytes * (4 * b * sq * h * d + 4 * b * skv * kv * d))


def ssd_chunk_bwd_cost(b: int, nc: int, L: int, h: int, p: int, n: int) -> Cost:
    """The SSD backward in fp32 (``examples/kernel_times.py::
    ssd_bwd_bound``): per (batch, chunk, head) dx's P^T dy and dM' on the
    lower triangle and B dS, x dS^T; per (batch, chunk) C B^T, dC and dB on
    the triangle; the forward's exps recomputed; every input read and
    every gradient written once."""
    tiles, tri = b * nc * h, L * (L + 1) // 2
    x_elems, bc_elems = b * nc * L * h * p, b * nc * L * n
    return Cost(tiles * (4 * tri * p + 4 * L * n * p) + b * nc * 6 * tri * n,
                tiles * (L * L + L + 1),
                4 * (3 * x_elems + 2 * b * nc * L * h + 4 * bc_elems + b * nc * h * n * p
                     + b * nc * h + 2 * h))
