#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the eight CUDA sources (nine kernels) with ``nvcc`` for sm_90a,
   one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at a large one, with CUDA-event times of the
   kernel, the plain version and a one-call PyTorch yardstick, beside the
   least time the card could take (H100 SXM peaks), and the device kernels
   per call (Eq. 6 and the warp must be one); the warp also at H != W, the
   greedy pass also past what one CTA's shared memory holds (K = 16,385;
   C = 1,100), with its cluster launch plan, and the scoring kernels past
   their former class limits (``kld_score`` at C = 60,000, the matrix at
   C = 2,000); the matrix also at Path A's 256 x 1,024, each matrix row
   with its launch plan and its first, middle and last rows bit for bit
   ``kld_score``'s;
4. agreement: small Astraea runs on the card against the same runs on the
   CPU (plain versions), same params and draws: EMNIST (8 classes, 16 px)
   and a reduced CINIC (16 px, width 8), 2 rounds each;
5. main path: FedAvg then Astraea at the paper's EMNIST width (68,873
   parameters), 3 rounds each, the mediator rows in lockstep
   (``row_exec="vmap"``) and each round's local training one CUDA graph
   (``num_round_traces`` must be 1), with every kernel launch count reset
   just before and read just after; the WAN ledger must equal the
   CommMeter formula and accuracy must be finite.  Then, per trainer, one
   more round profiled (seconds, host launches, device kernels, device
   busy and idle), and one ``row_exec="map"`` round (rows one by one,
   eagerly) from the same seed, held to the first lockstep round
   (``row_exec_check``) and timed;
6. Path A, Alg. 3 step by step: ``reschedule(impl="loop")`` on the card
   over 1,024 integer histograms (one ``kld_score`` launch per pick) and
   the (mediator x client) score sweep of its schedule (one
   ``kld_score_matrix`` launch), counts reset before and read after; the
   picks must equal the one-launch greedy kernel's, and on the CINIC
   cohort's post-augmentation counts the CPU loop's up to float ties;
7. Path B, the CINIC-10 arm at the paper's width (``cinic_cnn``, 2,168,362
   parameters, 32x32x3): FedAvg and Astraea, 3 rounds each as in phase
   5, counts reset before and read after; WAN ledger exactly 794.078 /
   992.600 MiB; the same ``"map"`` rounds and profiles; then one
   materialized-Alg. 2 Astraea round (its warp launches and extra
   storage);
8. serving agreement: a reduced Hymba (GQA 4:2), a reduced gemma at its
   full head dim of 256, and the reduced granite-moe-3b-a800m (MoE),
   whisper-base (audio; LayerNorm scales set to 1) and internvl2-1b (VLM)
   with their weights at the standard fan-in (f32 weights from one seed;
   stub vision or frame embeddings from another) prefilled and decoded on
   the card against the same runs on the CPU;
9. serving paths: ``repro_torch.launch.serve.serve`` at full width (bf16,
   weights from seed 0), one model at a time, with the launch counts reset
   just before each and read just after (``SERVE_RUNS``): hymba-1.5b
   (1,393,625,120 parameters; 32 flash-attention and 32 SSD launches per
   prefill) and gemma-2b (2,506,172,416; 18 flash launches at head dim
   256), batch 4, a 2,048-token prompt and 16 new tokens; qwen3-4b
   (4,022,468,096; 36 flash at 128), h2o-danube-1.8b (1,831,201,280; 24
   flash at 80, window 4096) and mamba2-370m (368,338,432; 48 SSD at state
   128), batch 1, a 512-token prompt and 4 new tokens; granite-moe-3b-a800m
   (3,298,793,472; 32 flash, 40 experts top 8) at batch 4 x 2,048 + 16,
   internvl2-1b (493,780,992; 24 flash at GQA 14:2) at batch 4 x (256 stub
   vision tokens + 1,792 text) + 16, whisper-base (73,542,144; 18 flash: 6
   encoder, non-causal over 1,536 stub frames, 6 decoder and 6
   cross-attention; its LayerNorm scales set to 1 after init, as the
   reference's init zeroes them and with them every output) at batch 4 x
   256 + 16.  No kernel launches in decode but whisper's 6 cross-attention
   flash launches a step; every logit must be finite.  Each model is built
   once; after its run it serves one warm prefill and 4 decode steps under
   ``torch.profiler``: device busy time, idle share, flash attention's and
   SSD's share of the prefill and the top kernels of each.  No backward
   kernel launches.  Every kernel signature (shape, dtype, mask) the run
   called and phase 3 did not hold (``recorded_kernel_calls``) is then held
   against its plain version.  A table of the runs follows.

10. async rounds, client stores and checkpoints, at phase 5's EMNIST arm
    (Astraea, 3 rounds a run, launch counts reset before each run and read
    after; runs held to each other bit for bit use cuDNN's deterministic
    algorithms, as its default ones are not): S=0 with a wave per mediator
    behind a 4x straggler -- masked dispatch bitwise the sync ``"vmap"``
    run, overlapped under ``"map"`` bitwise the sync ``"map"`` run, one
    Eq. 6 launch per commit and one warp per round; S=2 in turns (blocking
    baseline, overlapped): seconds per round, ``overlap_frac``,
    graphs built and their bytes, ``sim_speedup``, the staleness
    histogram, the WAN ledger equal to ``2|w|(c E_m + ceil(c/gamma))`` per
    round plus the plan; the graphs of an async CINIC-10 engine and their
    bytes; replicated, host and spilled stores bitwise equal; a spilled
    ``StreamingFederation`` of 1,000,000 clients at prefetch depth 1 and 2
    (device bytes ``U_cap`` x bytes per client, as over 1,000 clients); a
    checkpoint after round 2 restored on the card, its round 3 bitwise the
    uninterrupted one's.
11. training qwen3-4b at full width (bf16, weights from seed 0; 4,022,468,096
    parameters), each run's launch counts reset before it and read after;
    a full config checkpoints each layer of a training step
    (``ArchConfig.remat``), so its backward runs each layer's forward
    kernels again: two forward launches of a layer's flash (SSD) kernel a
    step, one backward.  Two AdamW steps of ``make_train_step`` at batch 4
    x 128 (72 forward and 36 backward flash launches a step), a LoRA
    rank-16 round and a
    full-delta round of ``make_fl_round`` over the 2 mediators Alg. 3 makes
    of 8 synthetic clients (one ``kld_greedy_picks``; one ``fedavg_agg`` for
    the LoRA round, one a leaf for the full-delta one), with seconds, peak
    memory, the WAN ledger (the LoRA leg's 35,863,552 bytes, the reference
    mapping's) and a profiled step of each; then the SSD families at full
    width (bf16, seed 0): hymba-1.5b (1,393,625,120 parameters) two AdamW
    steps at 4 x 128 (64 flash, 32 flash backward, 64 SSD and 32 SSD
    backward launches a step) and a LoRA rank-16 round over the same 2
    mediators, and mamba2-370m (368,338,432) two AdamW steps at 4 x 512
    (eight chunks; 96 SSD and 48 SSD backward launches a step, no flash)
    and a full-delta round over the same 2 mediators (one Eq. 6 launch a
    leaf), each with seconds, peak memory, finite losses and a moved
    update; then
    the MoE, audio and VLM families at full width (bf16, seed 0) at 4 x
    128: granite-moe-3b-a800m (3,298,793,472 parameters; 64 flash and 32
    flash backward launches a step, 40 experts top 8 through the MoE's
    deterministic backward) two AdamW steps and a LoRA rank-16 round over
    the same 2 mediators (its adapters batched over the layers and the
    experts; the leg's 109,341,696 bytes, the reference mapping's; its
    layer matrices at the standard fan-in, ``to_fan_in``: at the
    reference's init the round's plain SGD diverges), whisper-base
    (73,542,144; its LayerNorm scales set to 1; 36 flash and 18 flash
    backward launches a step: 6 encoder layers, non-causal over
    1,536 stub frames, 6 decoder and 6 cross-attention) and internvl2-1b
    (493,780,992; 64 stub vision tokens and 64 text tokens a row; 48 and 24)
    two AdamW steps each (no third, profiled step: the script's time
    limit; qwen3-4b's stays); then the training
    launchers at their reduced configs (qwen3-4b, mamba2-370m,
    granite-moe-3b-a800m, whisper-base, internvl2-1b; ``LAUNCHER_STEPS``
    steps each, the script's time limit) and ``fl_train`` (2 rounds);
    every kernel signature these runs called that phase 3 did not hold --
    the flash backward's too -- held against its plain version after.
12. the CNN engine's LoRA adapter exchange and the round telemetry, under
    cuDNN's deterministic algorithms, each run's launch counts reset
    before it and read after: ``fedavg_agg`` against its plain version at
    the adapter widths (M = 16 and 4 at EMNIST's 753 columns, M = 4 at
    CINIC's 2,142); at phase 5's EMNIST arm, per trainer in turns, a
    full-delta, a rank-2 and a full-rank (150) run of 3 rounds
    (one Eq. 6 launch a round over the adapter rows, one capture, the WAN
    ledger at 3,012 B a rank-2 leg; full rank's merged weights bitwise
    the full-delta run's), their seconds per round; an async
    S=0 rank-2 run bitwise its sync run; one rank-2 Astraea round at
    CINIC-10's width; a rank-2 Astraea run with ``Telemetry(profile=True)``
    and a device trace over its rounds 2 and 3: bitwise the untraced run,
    one capture, the four artifacts valid, the spans in the device trace,
    a live ``/metrics`` scrape equal to ``to_prometheus()``.
13. the measurement layer (``roofline/``, ``launch/dryrun.py``): (a) inside
    phase 11, on its qwen3-4b model, one AdamW step at 4 x 128 counted on
    the card by ``roofline.step_costs`` (launch counts reset before and read
    after) against the dry run's count of the same step on meta: equal
    FLOPs and kernel charges (the launches are the charges), the byte
    proxy's differing aten ops printed, the dry run's per-device bytes
    within 25 % of the step's ``max_memory_allocated`` (less the bytes
    earlier phases left on the card), and an uncounted step's seconds and
    share of the 989 TFLOP/s bf16 peak by ``model_flops`` and by the
    counted FLOPs; (b) the quickstart twin (``examples/quickstart.py``) at
    its full config, counts reset before and read after: each of
    ``fedavg_agg``, ``kld_greedy_picks`` and ``affine_warp`` launched, the
    WAN MiB of every evaluated round equal to the closed forms; (c) the dry
    run on meta of grok-1-314b and qwen1.5-110b ``train_4k`` on the
    single-pod production mesh (the multi-pod one is left to the CPU's
    ``dryrun --all`` for the script's time limit): each device's state
    bytes and the 80 GB cards the replicated and the sharded layouts need.
14. the mediator axis (``phase14``), every line with the card's name and
    power limit (logical shards and processes on one card measure device
    and host copies, not NVLink or NCCL): (a) four logical shards on the
    card at phase 5's EMNIST arm, three Astraea rounds with a reschedule
    each, under cuDNN's deterministic algorithms: the replicated store and
    the sharded store (``scheduling.place_mediators``) under the ragged
    and the all-gather exchange bit for bit equal, each shard a quarter of
    the replicated store's bytes, exchange bytes a round (ragged <= gather,
    both > 0), the placement's fetch counts, seconds a round and launches;
    (b) two child
    processes on the card (``examples/distributed_waves.py``, the library
    phase 2 built loaded, never rebuilt), joined through a ``TCPStore``
    this process hosts: two overlapped async rounds of (a)'s arm over a
    ``ProcessWaveDispatcher``, their params bit for bit each other's and a
    single-process run's, their per-key ledgers equal; a child that fails
    or hangs fails the phase.  (a) runs on the 4 x 1 ``(mediator, model)``
    mesh (``make_fl_mesh(mediator=4, model=1)``: the 1-D mesh's program).
15. the model axis (``phase15a``, ``tp_round_check``, phase 14 (b) and
    ``tp_family_round``),
    every line with the card's name and power limit (logical positions on
    one card measure device copies, not NVLink): (a) after phase 14 (a), at
    its EMNIST arm under cuDNN's deterministic algorithms, a 2 x 2 mesh of
    four logical positions on the card: three Astraea rounds under the
    gather oracle over the replicated and the sharded store, each bit for
    bit the sharded store's run on a 2 x 1 mesh (a lockstep program's bits
    follow its width), one capture a mediator row, the split leaves' bytes a
    position halved, WAN ledgers phase 14 (a)'s, model-axis bytes on the intra-pod
    ledger at 2 x 2 only; async S=0 over the sharded store bitwise its sync
    run; TP rows (``"auto"``
    on the card) after two rounds within 1e-5 relative and 1e-6 absolute of
    the oracle's at the reference's tiny config, and within
    ``P15_ARM_BOUND`` in L2 at the EMNIST arm; seconds a round of each; (b)
    inside phase 11, after its full-delta round, the same round of qwen3-4b
    tensor-parallel over two logical positions (``make_fl_round(mesh=...)``:
    Megatron's layout, flash at 16:4 heads a position) from the same start
    and inputs: its update within ``P15_DELTA_BOUND`` of the t=1 round's in
    L2, and the first microbatch's gradient at the start within
    ``P15_GRAD_BOUND`` of the whole model's,
    1,152 forward and 576 backward flash launches at 16:4 heads (2
    positions x 2 mediators x 4 steps x 36 layers, the forward twice under
    remat; the t=1 round's 576 + 288), 651 Eq. 6 launches (one a shard of
    the 253 split leaves and one for each of the 145 whole ones; each held
    to its plain version; per-shard Eq. 6 bit for bit the whole leaf's),
    seconds and peak GB, and every new flash signature held to its plain
    version; (c) phase 14 (b)'s two children run one more
    pair of rounds on ``process_local_mesh(model=2)`` (TP rows), bit for
    bit this process's run of the same; (d)-(f) inside phase 11, after each
    family's t=1 round (``tp_family_round``), that round again over two
    logical positions from the same start and inputs -- (d)
    granite-moe-3b-a800m's LoRA round (expert-parallel, 20 experts and
    12:4 heads a position), (e) mamba2-370m's full-delta round (16 SSD heads
    a position), (f) hymba-1.5b's LoRA round (whole KV groups, 15:3 and
    10:2 heads; the scan once a layer at 25 heads) -- in bf16 (finite, a
    moved update), then as a t=1 / t=2 pair on the weights cast to fp32
    with the TP round's update within ``P15_DELTA_BOUND_F32`` of the t=1
    round's in L2 (the t=1 round with its gradient negated reads above
    it; a bf16 round's update there is below its rounding noise), launch
    counts of every run predicted from the placements and held exactly
    (flash and SSD once a position where their heads split; Eq. 6 one
    launch a shard of each split leaf and one a whole leaf, or one for the
    adapter tree, each held to its plain version), the first microbatch's
    fp32 gradient through
    ``P15_GRAD_LAYERS`` full-width layers TP against the whole model within
    ``P15_GRAD_BOUND`` (one position's partial dropped from every
    all-reduce reads above it), seconds and peak GB; every new kernel
    signature held to its plain version with phase 11's.
16. the mediator axis as compute (``phase16a``, phase 15 (a),
    ``mediator_rows_round_check``), every line with the card's name and
    power limit (logical positions on one card: device copies, no overlap
    across cards): each mediator row of a mesh trains its own schedule rows
    on its own position, its own round program and CUDA graph, the sharded
    store's exchange run between the positions.  Phases 14 (a) and 15 (a)
    hold one graph and one warp launch a mediator row a round.  (a) after
    phase 15 (a), at phase 5's EMNIST arm on the 4 x 1 mesh under cuDNN's
    deterministic algorithms, three rounds over the sharded store:
    ``"map"`` bit for bit the run with every row on the engine's device;
    ``"vmap"`` within ``P16_VMAP_BOUND`` of ``"map"``; the exchange bytes
    counted where they move equal to the ledger's (phase 14 (a)'s ragged
    and gather runs); seconds a round and a profiled round's device busy
    and idle beside the engine-device run's; (b) phase 15 (a)'s TP rows,
    each mediator row on its own two columns; (c) inside phase 11 after
    15 (b), qwen3-4b's full-delta round on a 2 x 1 mesh (one mediator a
    row) from phase 11 (c)'s start and inputs: bit for bit its t=1 round,
    flash launches as at t=1, Eq. 6 one launch a row a leaf (the
    reference's ``psum_eq6``), seconds and peak GB.

Phase 3 also holds the flash-attention and SSD kernels against their plain
versions at the serve shapes (bf16 and f32), with a no-window, a
``q_offset`` and a GQA 1:1 attention row, rows at head dims 80 and 128
in bf16 and f32, gemma's layer (MQA 8:1, head dim 256) in bf16 and
f32, and granite's (GQA 24:8) and internvl2's (14:2) prefill layers in
bf16, and
times ``F.scaled_dot_product_attention`` with an explicit mask as
attention's one-call yardstick (the port never calls it).  It holds the
attention backward kernel against its plain version at qwen3-4b's training
layer, the reduced configs' layer, danube's head under a window with a
query offset, and gemma's layer, in bf16 and f32, by the direct call and
with the forward's log-sum-exp (the training path), beside SDPA's
backward (its bf16 error against the same exact gradients printed beside
the kernel's; bf16 gradients within 2^-7 of their largest magnitude), and
times the bf16 forward with and without writing that log-sum-exp, and
Hymba's training attention layer (GQA 5:1 at head dim 64) in bf16, and
phase 11's MoE, audio and VLM training layers at head dim 64: whisper's
encoder (4 x 1,536 frames, non-causal) in bf16 and f32, its
cross-attention (128 queries over the 1,536 frames, non-causal),
granite's GQA 24:8 and internvl2's 14:2 layers at 4 x 128 in bf16.  It
holds the SSD backward kernel against its plain version at Hymba's
training layer, mamba2-370m's, Hymba's serve-length shape and a reduced
config's, each also bit for bit across two runs.  A bf16
attention row is held per element too: against the plain version in fp32
on the same inputs, within 2^-8 (|exact| + sum p|v| / l), one bf16
rounding of the output and of every probability weight.

Prints the kernels' JSON summary, then as the last line
``{"ok": true, "device": {...}}``.  Full results go to
``build/chip_smoke.json``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the least time the card could take (H100 SXM peaks), shared with the
# kernel-times script
from repro_torch.examples.kernel_times import (bound, flash_bound,  # noqa: E402
                                               flash_bwd_bound, greedy_bound,
                                               score_bound, sdpa_backward, sdpa_mask,
                                               ssd_bound, ssd_bwd_bound,
                                               ssd_bwd_inputs, ssd_bwd_split_bound,
                                               ssd_inputs)

FED_KW = dict(num_clients=64, total_samples=6400, test_samples=2350,
              sizes="instagram", global_dist="letterfreq", local="random",
              seed=0)
CINIC_FED_KW = dict(num_clients=64, total_samples=6400, test_samples=1000,
                    sizes="instagram", global_dist="normal", local="random",
                    seed=0)
CLIENTS, GAMMA, ROUNDS, ALPHA = 16, 4, 3, 0.67
FL_KERNELS = ("fedavg_agg", "kld_greedy_picks", "affine_warp")
CINIC_PARAMS = 2_168_362


def log(*a):
    print(*a, flush=True)


def timed(row: dict, **fns) -> dict:
    """Add ``<name>`` (CUDA-event ms per call, host dispatch included) and
    ``<name>_device`` (profiler device ms) for each callable, and the
    device kernels per call of the kernel's own wrapper (``ms``)."""
    from repro_torch.examples.kernel_times import device_profile, time_ms
    for name, (fn, min_ms) in fns.items():
        row[name] = time_ms(fn, min_ms=min_ms)
        row[name.replace("ms", "device_ms")], kernels = device_profile(fn, row[name])
        if name == "ms":
            row["kernels_per_call"] = kernels
    return row


# ---------------------------------------------------------------- phase 3

def one_kernel_per_call(row: dict, fn, what: str) -> None:
    """Hold a wrapper to one device kernel per call, counted in a CUDA
    graph of one call (``kernel_times.graph_kernel_count``: every launch is
    a node, so none can be dropped, as the profiler's records were)."""
    from repro_torch.examples.kernel_times import graph_kernel_count
    row["kernels_per_call"] = graph_kernel_count(fn)
    if row["kernels_per_call"] != 1:
        raise AssertionError(f"{what}: {row['kernels_per_call']} device kernels per call, "
                             "expected 1")


def check_fedavg(dev, m, n, dtype, gen, *, dummy=True):
    """``fedavg_agg`` on random ``(m, n)`` deltas against its plain version;
    with ``dummy`` the last row weighs 0 (a padded mediator row)."""
    from repro_torch.kernels import ops, ref
    d = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    w = torch.rand(m, generator=gen, device=dev) * 100 + 1
    if dummy:
        w[-1] = 0.0
    out, plain = ops.fedavg_agg(d, w), ref.fedavg_agg(d, w)
    err = float((out.double() - plain.double()).abs().max())
    scale = float(plain.double().abs().max())
    # fp32: sums in another order, |err| <= 1e-5 of the output's scale;
    # bf16: the two fp32 sums may round to neighbouring bf16 values (2^-7)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(scale, 1.0)
    if not err <= tol:
        raise AssertionError(f"fedavg_agg M={m} N={n} {dtype}: err {err} > {tol}")
    wn = ref.normalized_weights(w).to(dtype)
    esize = d.element_size()
    b_ms, by = bound(m * n * esize + m * 4 + n * esize, 2 * m * n)
    row = timed({"shape": f"M={m} N={n} {str(dtype).split('.')[-1]}",
                 "max_abs_err": err, "tol": tol, "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.fedavg_agg(d, w), 50.0),
                plain_ms=(lambda: ref.fedavg_agg(d, w), 50.0),
                library_ms=(lambda: wn @ d, 50.0))
    # one launch from the raw weights: no normalizing op before the kernel
    one_kernel_per_call(row, lambda: ops.fedavg_agg(d, w), f"fedavg_agg M={m} N={n}")
    return row


# relative gap of two float64 scores that float32 cannot order: the plain
# version sums a row's classes in another order than the kernel, so each
# f32 score carries ~C/2 roundings of 2^-24
F32_NEAR_TIE = 2.0 ** -20


def check_greedy(dev, counts_np, gamma, *, loop_exact=False):
    """The one-launch pass against its plain version: picks equal, or
    diverging first where the two candidates' float64 scores tie (to 1e-9
    relative).  With ``loop_exact`` (the rows past what one CTA's shared
    memory holds, where a K-step pass meets near-ties often) the picks must
    equal the card's per-step loop exactly (``reschedule(impl="loop")``,
    one ``kld_score`` launch per pick through the same scorer), and may
    leave the plain version's only at a float32 near-tie (F32_NEAR_TIE)."""
    from repro_torch.core import scheduling
    from repro_torch.kernels import ops, ref
    counts = torch.as_tensor(counts_np, dtype=torch.float32, device=dev)
    kp = ops.kld_greedy_picks(counts, gamma).cpu().numpy()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pp = ref.kld_greedy_picks(counts, gamma)
    end.record()
    torch.cuda.synchronize()
    pp = pp.cpu().numpy()
    if sorted(kp.tolist()) != list(range(len(kp))):
        raise AssertionError("kld_greedy_picks is not a permutation")
    div = scheduling.first_divergence(counts_np, gamma, pp, kp)
    if div is not None and not div["tie"]:
        gap = abs(div["score_a"] - div["score_b"]) / max(abs(div["score_a"]),
                                                         abs(div["score_b"]), 1e-300)
        if not (loop_exact and gap <= F32_NEAR_TIE):
            raise AssertionError(f"kld_greedy_picks disagrees: {div}")
    if loop_exact:
        loop = scheduling.picks_of(scheduling.reschedule(counts_np, gamma, impl="loop",
                                                         device=dev))
        if loop.tolist() != kp.tolist():
            raise AssertionError("kld_greedy_picks differs from the card loop: "
                                 f"{scheduling.first_divergence(counts_np, gamma, loop, kp)}")
    k, c = counts_np.shape
    err = 0.0 if div is None else abs(div["score_a"] - div["score_b"])
    b_ms, by = greedy_bound(k, c, gamma)
    fns = {"ms": (lambda: ops.kld_greedy_picks(counts, gamma), 50.0)}
    if k <= 1024:
        fns["plain_ms"] = (lambda: ref.kld_greedy_picks(counts, gamma), 1.0)
    row = timed({"shape": f"K={k} C={c} gamma={gamma}", "max_abs_err": err,
                 "first_divergence": div, "bound_ms": b_ms, "bound_by": by,
                 "plan": ops.kld_greedy_plan(k, c)}, **fns)
    if k > 1024:
        # the plain version's K-step host loop (seconds), timed once by
        # events: its checked call above; a profile of its ~10 K launches
        # costs tens of seconds and stops the profiler recording later
        # windows, so its device time is not measured
        row["plain_ms"], row["plain_device_ms"] = start.elapsed_time(end), None
    row["library_ms"] = row["library_device_ms"] = None
    row["us_per_step"] = 1e3 * row["ms"] / k
    return row


def check_score(dev, med, cand):
    """``kld_score`` on ``med (C,)``, ``cand (K, C)`` against its plain
    version: within 1e-6 absolute (sums in another order)."""
    from repro_torch.kernels import ops, ref
    med = torch.as_tensor(med, dtype=torch.float32, device=dev).contiguous()
    cand = torch.as_tensor(cand, dtype=torch.float32, device=dev).contiguous()
    out, plain = ops.kld_score(med, cand), ref.kld_score(med, cand)
    err = float((out.double() - plain.double()).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"kld_score K={cand.shape[0]}: err {err} > 1e-6")
    k, c = cand.shape
    b_ms, by = score_bound(1, k, c)
    row = timed({"shape": f"K={k} C={c}", "max_abs_err": err, "tol": 1e-6,
                 "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.kld_score(med, cand), 50.0),
                plain_ms=(lambda: ref.kld_score(med, cand), 50.0))
    row["library_ms"] = row["library_device_ms"] = None
    return row


def check_score_matrix(dev, meds, cand):
    """``kld_score_matrix`` against its plain version (1e-6 absolute); the
    first, a middle and the last row must equal the single-mediator
    kernel's bit for bit (one device function)."""
    from repro_torch.kernels import ops, ref
    meds = torch.as_tensor(meds, dtype=torch.float32, device=dev).contiguous()
    cand = torch.as_tensor(cand, dtype=torch.float32, device=dev).contiguous()
    out, plain = ops.kld_score_matrix(meds, cand), ref.kld_score_matrix(meds, cand)
    err = float((out.double() - plain.double()).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"kld_score_matrix M={meds.shape[0]}: err {err} > 1e-6")
    (m, c), k = meds.shape, cand.shape[0]
    for i in (0, m // 2, m - 1):
        if not torch.equal(out[i], ops.kld_score(meds[i].contiguous(), cand)):
            raise AssertionError(f"kld_score_matrix M={m} K={k} C={c}: row {i} differs "
                                 "from kld_score's bits")
    b_ms, by = score_bound(m, k, c)
    row = timed({"shape": f"M={m} K={k} C={c}", "max_abs_err": err, "tol": 1e-6,
                 "bound_ms": b_ms, "bound_by": by,
                 "plan": ops.kld_score_matrix_plan(m, k, c, meds, cand)},
                ms=(lambda: ops.kld_score_matrix(meds, cand), 50.0),
                plain_ms=(lambda: ref.kld_score_matrix(meds, cand), 50.0))
    row["library_ms"] = row["library_device_ms"] = None
    return row


def check_warp(dev, b, h, w, c, gen):
    from repro_torch.examples.kernel_times import grid_sample, warp_inputs
    from repro_torch.kernels import ops, ref
    # yardstick: grid_sample on the same inverse map
    imgs, mats, trans, nchw, grid = warp_inputs(b, h, w, c, gen, dev)
    out, plain = ops.affine_warp(imgs, mats, trans), ref.affine_warp(imgs, mats, trans)
    err = float((out - plain).abs().max())
    if not err <= 1e-5:          # same op order, no FMA: ulp-level only
        raise AssertionError(f"affine_warp B={b} {h}x{w}x{c}: err {err} > 1e-5")
    gs = grid_sample(nchw, grid).permute(0, 2, 3, 1)
    pix = b * h * w
    b_ms, by = bound(2 * pix * c * 4 + b * 6 * 4, pix * (20 + 8 * c))
    row = timed({"shape": f"B={b} {h}x{w}x{c}", "max_abs_err": err,
                 "grid_sample_err": float((gs - plain).abs().max()),
                 "stages": ops.affine_warp_stages(imgs, out),
                 "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.affine_warp(imgs, mats, trans), 50.0),
                plain_ms=(lambda: ref.affine_warp(imgs, mats, trans), 50.0),
                library_ms=(lambda: grid_sample(nchw, grid), 50.0))
    one_kernel_per_call(row, lambda: ops.affine_warp(imgs, mats, trans),
                        f"affine_warp B={b} {h}x{w}x{c}")
    return row


def _fmt(x):
    return "n/a" if x is None else f"{x:.4f}"


def _dname(dtype):
    return str(dtype).split(".")[-1]


# the kernel signatures phase 3 (and phases 9 and 11, for the serving and
# training paths' own) has held against the plain versions:
# ("flash_attention", q shape, k shape, dtype, causal, window, q_offset),
# the same for "flash_attention_bwd", ("ssd_chunk", x shape, n, dtype) and
# ("ssd_chunk_bwd", x shape, n)
CHECKED: set[tuple] = set()


def flash_key(q, k, causal, window, q_offset):
    return ("flash_attention", tuple(q.shape), tuple(k.shape), q.dtype, causal, window,
            q_offset)


def flash_bwd_key(q, k, causal, window, q_offset):
    return ("flash_attention_bwd",) + flash_key(q, k, causal, window, q_offset)[1:]


def ssd_key(x, B):
    if B.dtype != x.dtype:
        raise AssertionError(f"ssd_chunk called with x {x.dtype} and B {B.dtype}; the "
                             f"check draws both in one dtype")
    return ("ssd_chunk", tuple(x.shape), B.shape[-1], x.dtype)


def ssd_bwd_key(x, B):
    return ("ssd_chunk_bwd", tuple(x.shape), B.shape[-1])


def check_flash(dev, gen, *, b, sq, skv, h, kv, d, dtype, window, q_offset=0,
                causal=True):
    from repro_torch.kernels import ops, ref
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, plain = ops.flash_attention(q, k, v, **kw), ref.flash_attention(q, k, v, **kw)
    err = float((out.double() - plain.double()).abs().max())
    scale = float(plain.double().abs().max())
    # fp32: online softmax vs the whole-row plain version, sums in other
    # orders; bf16: the two fp32 results may round to neighbouring values
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * max(scale, 1.0)
    if not err <= tol:
        raise AssertionError(f"flash_attention {tuple(q.shape)} {dtype} {kw}: "
                             f"err {err} > {tol}")
    extra = {}
    if dtype == torch.bfloat16:
        # and per element, against the plain version in fp32 on the same
        # bf16 inputs: one bf16 rounding of the output (2^-8 of |exact|) and
        # one of every probability weight p (2^-9 of sum p|v| / l, doubled
        # for the fp32 sums' order), so a late row that drops or misweights
        # a 64-key tile fails where the scale's 2^-7 would not see it
        qf, kf, vf = q.float(), k.float(), v.float()
        exact = ref.flash_attention(qf, kf, vf, **kw)
        bound = 2 ** -8 * (exact.abs() + ref.flash_attention(qf, kf, vf.abs(), **kw))
        gap = (out.float() - exact).abs()
        worst = float((gap / bound.clamp_min(1e-30)).max())
        if not bool((gap <= bound).all()):
            raise AssertionError(f"flash_attention {tuple(q.shape)} bf16 {kw}: an element "
                                 f"is {worst:.3f} x its bound 2^-8 (|exact| + sum p|v| / l)")
        extra = {"per_element_worst_over_bound": worst}
        del qf, kf, vf, exact, bound, gap
    CHECKED.add(flash_key(q, k, causal, window, q_offset))
    mask = ref.attention_mask(sq, skv, device=dev, **kw)
    pairs = int(mask.sum()) * b * h                  # visible (query, key) pairs
    b_ms, by = flash_bound(q, k, mask)
    # yardstick: SDPA in its (b, H, s, d) layout with the same boolean mask
    # (none where every key is seen) and the KV heads repeated, prepared
    # outside the timed call
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    lib_mask = sdpa_mask(mask)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask).transpose(1, 2)
    row = timed({"shape": f"b={b} sq={sq} skv={skv} H={h} KV={kv} d={d} "
                          f"W={window} off={q_offset}" + ("" if causal else " non-causal")
                          + f" {_dname(dtype)}",
                 "max_abs_err": err, "tol": tol, **extra, "pairs": pairs,
                 "sdpa_err": float((sdpa.double() - plain.double()).abs().max()),
                 "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.flash_attention(q, k, v, **kw), 50.0),
                plain_ms=(lambda: ref.flash_attention(q, k, v, **kw), 50.0),
                library_ms=(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=lib_mask), 50.0))
    if dtype == torch.bfloat16:
        # what writing the backward's lse costs (the training path asks for
        # it; serving does not)
        timed(row, lse_ms=(lambda: ops._flash_forward(q, k, v, causal, window, q_offset,
                                                      with_lse=True), 50.0))
    return row


def _sdpa_bwd_grads(q, k, v, dout, mask):
    """SDPA's backward in q's dtype on the same inputs and mask (the KV
    heads repeated outside the graph, their gradients summed in fp32), in
    the model layout."""
    h, kv = q.shape[2], k.shape[2]
    gq, gk, gv = sdpa_backward(q, k, v, dout, mask)()
    b, _, skv, d = gk.shape

    def fold(g):                                    # (b, H, skv, d) -> (b, skv, KV, d)
        return g.float().reshape(b, kv, h // kv, skv, d).sum(2).transpose(1, 2)
    return gq.float().transpose(1, 2), fold(gk), fold(gv)


def check_flash_bwd(dev, gen, *, b, sq, skv, h, kv, d, dtype, window, q_offset=0,
                    causal=True):
    """The attention backward kernel at ``out`` from the forward kernel, by
    the direct call (the wrapper runs the forward kernel for lse) and by the
    training path's call (the forward's lse): fp32 within 1e-5 of each
    gradient's scale of ``ref.flash_attention_bwd`` (sums in other
    orders); bf16 within 2^-7 of each gradient's largest magnitude of the
    plain version in fp32 on the same bf16 inputs (the tensor cores round P
    and dS to bf16), beside SDPA's bf16 backward against the same exact
    gradients.  Timed (``ms``: the training path's call) beside the direct
    call, the plain version and SDPA's backward."""
    from repro_torch.kernels import ops, ref
    q, dout = (torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, kv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops._flash_forward(q, k, v, causal, window, q_offset, with_lse=True)
    direct = ops.flash_attention_bwd(q, k, v, out, dout, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    mask = ref.attention_mask(sq, skv, device=dev, **kw)
    extra = {}
    if dtype == torch.float32:
        want = ref.flash_attention_bwd(q, k, v, out, dout, **kw)
        rel = 1e-5
    else:
        want = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, out, dout)), **kw)
        rel = 2 ** -7
        sdpa = _sdpa_bwd_grads(q, k, v, dout, mask)
        extra["sdpa_errs_dq_dk_dv"] = [float((g - w).abs().max()) for g, w in zip(sdpa, want)]
        extra["sdpa_worst_over_bound"] = max(
            e / (rel * max(float(w.abs().max()), 1e-30))
            for e, w in zip(extra["sdpa_errs_dq_dk_dv"], want))
        del sdpa
    tols = [rel * max(float(w.double().abs().max()), 1e-30) for w in want]
    errs = [max(float((g.double() - w.double()).abs().max()) for g in (a, c))
            for a, c, w in zip(got, direct, want)]
    worst = max(e / t for e, t in zip(errs, tols))
    del want
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention_bwd {tuple(q.shape)} {dtype} {kw}: errors "
                             f"{errs} reach {worst:.3f} of their bound")
    b_ms, by = flash_bwd_bound(q, k, mask)
    pairs = int(mask.sum()) * b * h
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    lib = sdpa_backward(q, k, v, dout, mask)
    CHECKED.add(flash_bwd_key(q, k, causal, window, q_offset))
    row = timed({"shape": f"b={b} sq={sq} skv={skv} H={h} KV={kv} d={d} "
                          f"W={window} off={q_offset}" + ("" if causal else " non-causal")
                          + f" {_dname(dtype)}",
                 "max_abs_err": max(errs), "errs_dq_dk_dv": errs, "tols": tols,
                 "worst_over_bound": worst, **extra, "bound_ms": b_ms, "bound_by": by,
                 # dq in a pass of its own recomputes S and dO V^T: 7 products
                 # a pair against the bound's 5
                 "ops_7_of_5_ms": 14.0 * d * pairs / peak * 1e3,
                 "split": ops.flash_bwd_split(b, sq, skv, kv, h // kv,
                                              ops._sm_count(dev.index), d=d, dtype=dtype,
                                              **kw)},
                ms=(lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw), 50.0),
                direct_ms=(lambda: ops.flash_attention_bwd(q, k, v, out, dout, **kw), 50.0),
                plain_ms=(lambda: ref.flash_attention_bwd(q, k, v, out, dout, **kw), 50.0),
                library_ms=(lib, 50.0))
    return row


def check_ssd(dev, gen, *, b, nc, L, h, p, n, dtype):
    from repro_torch.kernels import ops, ref
    x, dt, A, B, C = ssd_inputs(b, nc, L, h, p, n, dtype, gen, dev)
    got, want = ops.ssd_chunk(x, dt, A, B, C), ref.ssd_chunk(x, dt, A, B, C)
    errs = []
    for i, (o, w) in enumerate(zip(got, want)):
        err = float((o.double() - w.double()).abs().max())
        scale = max(float(w.double().abs().max()), 1.0)
        # fp32 sums in another order: 1e-5 of the scale; y_diag in bf16:
        # one bf16 ulp
        tol = (2 ** -7 if (i == 0 and dtype == torch.bfloat16) else 1e-5) * scale
        if not err <= tol:
            raise AssertionError(f"ssd_chunk output {i} {dtype}: err {err} > {tol}")
        errs.append(err)
    CHECKED.add(ssd_key(x, B))
    b_ms, by = ssd_bound(b, nc, L, h, p, n, dtype)
    row = timed({"shape": f"b={b} nc={nc} L={L} h={h} p={p} n={n} {_dname(dtype)}",
                 "max_abs_err": max(errs), "errs_y_S_g": errs,
                 "bound_ms": b_ms, "bound_by": by},
                ms=(lambda: ops.ssd_chunk(x, dt, A, B, C), 50.0),
                plain_ms=(lambda: ref.ssd_chunk(x, dt, A, B, C), 50.0))
    row["library_ms"] = row["library_device_ms"] = None
    return row


def check_ssd_bwd(dev, gen, *, b, nc, L, h, p, n):
    """The SSD backward kernel at fp32 inputs and random output gradients
    against ``ref.ssd_chunk_bwd``: dx, ddt, dB and dC within 1e-5 of each
    gradient's scale (fp32 sums in other orders), dA within 1e-4 (a sum of
    b nc L terms of both signs); a second run equal bit for bit; timed
    beside the plain version (no one PyTorch call computes it)."""
    from repro_torch.kernels import ops, ref
    args = ssd_bwd_inputs(b, nc, L, h, p, n, gen, dev)
    x, B = args[0], args[3]
    got, again = ops.ssd_chunk_bwd(*args), ops.ssd_chunk_bwd(*args)
    want = ref.ssd_chunk_bwd(*args)
    errs, worst = [], 0.0
    for name, o, w, rel in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                               (1e-5, 1e-5, 1e-4, 1e-5, 1e-5)):
        err = float((o.double() - w.double()).abs().max())
        tol = rel * max(float(w.double().abs().max()), 1e-30)
        if not err <= tol:
            raise AssertionError(f"ssd_chunk_bwd {name} at b={b} nc={nc} L={L} h={h} p={p} "
                                 f"n={n}: err {err} > {tol}")
        errs.append(err)
        worst = max(worst, err / tol)
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"ssd_chunk_bwd at b={b} nc={nc} L={L} h={h}: two runs differ")
    del want, again
    CHECKED.add(ssd_bwd_key(x, B))
    # the products run on the tensor cores in split fp32; the bound at the
    # CUDA cores' fp32 rate stands beside it
    b_ms, by = ssd_bwd_split_bound(b, nc, L, h, p, n)
    c_ms, c_by = ssd_bwd_bound(b, nc, L, h, p, n)
    row = timed({"shape": f"b={b} nc={nc} L={L} h={h} p={p} n={n} float32",
                 "max_abs_err": max(errs), "errs_dx_ddt_dA_dB_dC": errs,
                 "worst_over_bound": worst, "bitwise_repeat": True,
                 "plan": ops.ssd_chunk_bwd_plan(b, nc, L, h, p, n, dev),
                 "bound_ms": b_ms, "bound_by": by, "fp32_core_bound_ms": c_ms,
                 "fp32_core_bound_by": c_by},
                ms=(lambda: ops.ssd_chunk_bwd(*args), 50.0),
                plain_ms=(lambda: ref.ssd_chunk_bwd(*args), 50.0))
    row["library_ms"] = row["library_device_ms"] = None
    return row


def hold_unchecked(dev, gen, seen: dict, checks: dict, path: str) -> None:
    """Every kernel signature in ``seen`` (``recorded_kernel_calls``) that no
    check has held yet, held against its plain version on fresh inputs; the
    rows join ``checks`` with their path."""
    held = {"flash_attention": check_flash, "flash_attention_bwd": check_flash_bwd,
            "ssd_chunk": check_ssd, "ssd_chunk_bwd": check_ssd_bwd}
    for key, (name, kw) in seen.items():
        if key in CHECKED:
            continue
        row = held[name](dev, gen, **kw)
        row["path"] = path
        checks[name].append(row)
        log(f"[{path.split()[0]}-check] {path} {name} {row['shape']}: err "
            f"{row['max_abs_err']:.3e} (tol {row.get('tol', 'per output')}"
            + (f", per element {row['per_element_worst_over_bound']:.3f} of its bound"
               if "per_element_worst_over_bound" in row else "")
            + (f", worst gradient {row['worst_over_bound']:.3f} of its bound"
               if "worst_over_bound" in row else "")
            + f"), kernel {row['ms']:.4f} ms ({_fmt(row['device_ms'])} device), plain "
            f"{row['plain_ms']:.4f} ms, library {_fmt(row['library_ms'])} ms "
            f"({_fmt(row['library_device_ms'])} device), bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']})")
    if any(key not in CHECKED for key in seen):
        raise AssertionError(f"{path}: kernel signatures left unchecked")


# ---------------------------------------------------------------- phases 4-7

class _DrawsOn:
    """CPU-seeded draws moved to ``device``: the same numbers on both sides
    of the agreement check."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def client(self, *address):
        return _DrawsOn(self.inner.client(*address), self.device)

    def permutation(self, epoch, n):
        return self.inner.permutation(epoch, n).to(self.device)

    def epoch_keep_masks(self, epoch, steps, sites):
        return [k.to(self.device) for k in self.inner.epoch_keep_masks(epoch, steps, sites)]

    def augment(self, rnd, row, slot, weights):
        return tuple(t.to(self.device) for t in
                     self.inner.augment(rnd, row, slot, weights.cpu()))


def agreement_check(dev, cinic: bool = False):
    """Astraea for 2 rounds on the card and on the CPU from the same params
    and draws: EMNIST (8 classes, 16 px) or the reduced CINIC arm (10
    classes, 16x16x3, ``cinic_cnn`` width 8)."""
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.core.draws import SeededDraws
    from repro_torch.data.federated import CINIC_LIKE, EMNIST_LIKE, partition
    from repro_torch.models.cnn import cinic_cnn, emnist_cnn, init_params
    from repro_torch.optim import adam
    if cinic:
        spec = dataclasses.replace(CINIC_LIKE, image_size=16, noise=0.5, distort=0.35)
        make, gd = (lambda: cinic_cnn(10, 16, 3, 8)), "normal"
    else:
        spec = dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16)
        make, gd = (lambda: emnist_cnn(8, 16)), "letterfreq"
    fed = partition(spec, num_clients=12, total_samples=300, test_samples=80,
                    sizes="instagram", global_dist=gd, local="random", seed=0)
    init = init_params(make(), 0)
    runs = []
    for where in ("cpu", dev):
        tr = AstraeaTrainer(make(), adam(1e-3), fed, clients_per_round=8,
                            gamma=4, local=LocalSpec(10, 1), alpha=ALPHA, seed=0,
                            device=where, init_params=init,
                            draws=_DrawsOn(SeededDraws(1, "cpu"), where))
        tr.fit(2, eval_every=2)
        runs.append((tr.engine.last_groups,
                     {k: v.cpu() for k, v in tr.params.items()},
                     tr.comm.round_log))
    (g_cpu, p_cpu, l_cpu), (g_dev, p_dev, l_dev) = runs
    err = max(float((p_cpu[k] - p_dev[k]).abs().max()) for k in p_cpu)
    if g_cpu != g_dev or l_cpu != l_dev or not err <= 1e-4:
        raise AssertionError(f"card vs CPU: groups {g_dev} vs {g_cpu}, "
                             f"ledger {l_dev} vs {l_cpu}, params err {err}")
    return {"groups": g_dev, "params_max_abs_err": err, "tol": 1e-4}


def fl_trainer(name, fed, dev, make_model, row_exec="vmap", init_params=None, **kw):
    """The main path's FedAvg or Astraea trainer, seed 0, at ``row_exec``;
    ``kw`` adds trainer fields (``lora_rank``, ``telemetry``, ...)."""
    from repro_torch.core import AstraeaTrainer, FedAvgTrainer, LocalSpec
    from repro_torch.optim import adam
    common = dict(clients_per_round=CLIENTS, local=LocalSpec(20, 2), seed=0,
                  device=dev, row_exec=row_exec, init_params=init_params, **kw)
    if name == "FedAvg":
        return FedAvgTrainer(make_model(), adam(1e-3), fed, **common)
    return AstraeaTrainer(make_model(), adam(1e-3), fed, gamma=GAMMA,
                          mediator_epochs=1, alpha=ALPHA, **common)


def main_path(fed, dev, make_model, n_params):
    """FedAvg then Astraea for ``ROUNDS`` rounds each at full width, the
    rows in lockstep and each round's local training one CUDA graph; the
    launch counts are reset before and read after.  Returns the rows, the
    launches, the peak memory and, per trainer, the trainer and its
    weights after round 1 (for ``row_exec_check``)."""
    from repro_torch.kernels import ops
    rows, trainers = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    for name in ("FedAvg", "Astraea"):
        tr = fl_trainer(name, fed, dev, make_model)
        secs = []
        for r in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if r == 0:
                trainers[name] = (tr, {k: v.clone() for k, v in tr.params.items()})
        m = tr.evaluate()
        m["round_seconds"] = secs
        m["pad"] = tr.engine.pad
        m["mediators"] = tr.engine.last_groups
        m["num_round_traces"] = tr.engine.num_round_traces
        rows[name] = m
        if not (math.isfinite(m["accuracy"]) and math.isfinite(m["loss"])):
            raise AssertionError(f"{name}: non-finite metrics {m}")
        if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
            raise AssertionError(f"{name}: non-finite params")
        if tr.engine.num_round_traces != 1 or tr.engine._program.graph is None:
            raise AssertionError(f"{name}: round program built "
                                 f"{tr.engine.num_round_traces} times, graph "
                                 f"{tr.engine._program.graph}; expected one capture")
        n = sum(p.numel() for p in tr.params.values())
        if n != n_params:
            raise AssertionError(f"{name}: {n} params, expected {n_params}")
        w = 4 * n_params
        if name == "FedAvg":
            expect = [w * 2 * CLIENTS * (r + 1) for r in range(ROUNDS)]
        else:
            plan_bytes = 4 * fed.num_classes * fed.num_clients
            per_round = w * (2 * CLIENTS + 2 * math.ceil(CLIENTS / GAMMA))
            expect = [plan_bytes + per_round * (r + 1) for r in range(ROUNDS)]
        if tr.comm.round_log != expect:
            raise AssertionError(f"{name}: WAN ledger {tr.comm.round_log} != {expect}")
        m["wan_mib"] = tr.comm.total_bytes / 2 ** 20
    launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}: {launches}")
    return rows, launches, torch.cuda.max_memory_allocated(dev) / 1e9, trainers


def row_exec_check(fed, dev, make_model, vmap_runs):
    """Per trainer: one more lockstep round under ``torch.profiler``; then
    the same trainer with ``row_exec="map"`` from the same seed: its first
    round timed and held to the lockstep trainer's first round (not
    profiled: analysing the ~10^5 eager launches of one round took 22.6 s
    at EMNIST's width and 36.0 s at CINIC-10's on an H100 host, which the
    script's time limit cannot hold).

    The hold: after one full-width round the two paths (fp32 sums in
    other orders, carried through the round's Adam steps) must lie no
    further apart, in L2 over the round's own update, than twice the
    distance at which the loop itself lands from weights perturbed by
    1e-7 (a third trainer): CINIC-10's rounds amplify any such difference
    to a tenth of the update or more, EMNIST's do not.  Returns per
    trainer both paths' seconds and the lockstep round's launches and
    device busy and idle."""
    from repro_torch.examples.profile_round import profile_round
    from repro_torch.models.cnn import init_params
    out = {}
    for name, (tr, first) in vmap_runs.items():
        vmap_prof = profile_round(tr, top=6)
        if tr.engine.num_round_traces != 1:
            raise AssertionError(f"{name}: the profiled round rebuilt the round program")
        mp = fl_trainer(name, fed, dev, make_model, row_exec="map")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp.run_round()
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        init = init_params(make_model(), 0, dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        noisy = fl_trainer(name, fed, dev, make_model, row_exec="map", init_params={
            k: v + 1e-7 * torch.randn(v.shape, generator=gen, device=dev)
            for k, v in init.items()})
        noisy.run_round()

        def flat(p):
            return torch.cat([p[k].flatten() for k in init])
        update = float((flat(first) - flat(init)).norm())
        rel = float((flat(mp.params) - flat(first)).norm()) / update
        rel_noise = float((flat(mp.params) - flat(noisy.params)).norm()) / update
        if not rel <= 2 * rel_noise:
            raise AssertionError(f"{name}: the map round lies {rel:.3e} of the update from "
                                 f"the vmap round, more than twice the {rel_noise:.3e} a "
                                 "1e-7 perturbation of the weights moves it")
        max_abs = float((flat(mp.params) - flat(first)).abs().max())
        out[name] = {"map_round_s": map_s, "rel_l2_vs_vmap": rel,
                     "rel_l2_perturbed": rel_noise, "max_abs_vs_vmap": max_abs,
                     "vmap_profile": vmap_prof,
                     "num_round_traces": tr.engine.num_round_traces}
        del mp, noisy
    return out


def log_row_exec(arm, rows, check):
    for name, c in check.items():
        p = c["vmap_profile"]
        secs = rows[name]["round_seconds"]
        log(f"[rows] {arm} {name}: num_round_traces {c['num_round_traces']}; vmap "
            f"s/round {' '.join(f'{x:.4f}' for x in secs)} (first includes the "
            f"capture), map {c['map_round_s']:.4f}; map vs vmap after one round: "
            f"{c['rel_l2_vs_vmap']:.3e} of the update (L2; the loop from weights "
            f"perturbed by 1e-7: {c['rel_l2_perturbed']:.3e}), max abs "
            f"{c['max_abs_vs_vmap']:.3e}")
        log(f"[rows] {arm} {name} vmap (profiled round): wall {p['wall_s']:.4f} s, "
            f"device busy {p['busy_s']:.4f} s, idle {100 * p['idle_share']:.1f} % "
            f"(kernel time summed {p['kernel_s']:.4f} s), "
            f"{p['host_launches']} host launches ({p['graph_launches']} graph), "
            f"{p['device_kernels']} device kernels; analysis {p['analysis_s']:.1f} s")


def cinic_cohort_counts(fed):
    """Astraea's first CINIC cohort as the engine packs it: the selection of
    default_rng(seed).choice at the expected post-augmentation counts."""
    from repro_torch.core.augmentation import augmentation_plan
    counts = fed.client_counts()
    sel = np.random.default_rng(0).choice(fed.num_clients, CLIENTS, replace=False)
    return counts[sel] * (1.0 + augmentation_plan(counts.sum(0), ALPHA))


def path_a(dev, cohort):
    """Alg. 3 step by step on the card: the loop over 1,024 integer
    histograms plus the (mediator x client) sweep of its schedule, counts
    reset before and read after; then the checks against the one-launch
    greedy kernel and, on the CINIC cohort's fractional counts, the CPU."""
    from repro_torch.core import scheduling
    from repro_torch.kernels import ops
    counts = np.random.default_rng(1).integers(0, 200, (1024, 47))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    loop = scheduling.reschedule(counts, GAMMA, impl="loop", device=dev)
    loop_s = time.perf_counter() - t0
    sweep = scheduling.mediator_client_scores(loop, counts, device=dev)
    launches = {k: ops.LAUNCHES[k] for k in ("kld_score", "kld_score_matrix")}
    if launches != {"kld_score": 1024, "kld_score_matrix": 1}:
        raise AssertionError(f"Path A launched {launches}; expected 1,024 kld_score "
                             "(one per pick) and 1 kld_score_matrix")
    batched = scheduling.reschedule(counts, GAMMA, impl="batched", device=dev)
    if scheduling.picks_of(loop).tolist() != scheduling.picks_of(batched).tolist():
        raise AssertionError("the card loop's picks differ from kld_greedy_picks: "
                             f"{scheduling.first_divergence(counts, GAMMA, scheduling.picks_of(batched), scheduling.picks_of(loop))}")
    if sweep.shape != (256, 1024) or not np.isfinite(sweep).all():
        raise AssertionError(f"score sweep {sweep.shape} not finite")
    t0 = time.perf_counter()
    scheduling.reschedule(counts, GAMMA, impl="batched", device=dev)
    batched_s = time.perf_counter() - t0
    ops.reset_launches()
    card = scheduling.reschedule(cohort, GAMMA, impl="loop", device=dev)
    if ops.LAUNCHES["kld_score"] != len(cohort):
        raise AssertionError(f"{ops.LAUNCHES['kld_score']} kld_score launches "
                             f"for {len(cohort)} picks")
    cpu = scheduling.reschedule(cohort, GAMMA, impl="loop", device="cpu")
    div = scheduling.first_divergence(cohort, GAMMA, scheduling.picks_of(cpu),
                                      scheduling.picks_of(card))
    if div is not None and not div["tie"]:
        raise AssertionError(f"card loop vs CPU loop on the CINIC cohort: {div}")
    return {"launches": launches, "loop_s": loop_s, "batched_s": batched_s,
            "picks_equal_greedy": True, "cinic_cohort_divergence": div,
            "cinic_cohort_groups": [m.clients for m in card]}


# ---------------------------------------------------------------- phase 10

# the JAX example's fleet: a wave per mediator, one mediator in three 4x slower
FLEET = dict(model="fixed", straggler_frac=0.34, slowdown=4.0, seed=0)
MILLION = 1_000_000


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms, for runs held to each other bit
    for bit: at this width its default algorithms are not deterministic
    (``cudnn_spread`` measures how far two identical runs part), so no two
    runs could be held bitwise under them."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def p10_trainer(fed, dev, row_exec="vmap", **kw):
    """Astraea at phase 5's EMNIST arm (c=16, gamma=4, B=20, E=2, alpha=0.67
    online, seed 0), with the store or async spec of ``kw``."""
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    return AstraeaTrainer(emnist_cnn(47, 28), adam(1e-3), fed, clients_per_round=CLIENTS,
                          gamma=GAMMA, local=LocalSpec(20, 2), mediator_epochs=1,
                          alpha=ALPHA, seed=0, device=dev, row_exec=row_exec, **kw)


def run_timed(tr, rounds=ROUNDS, label=""):
    """``rounds`` rounds, each timed by the host clock between two device
    syncs, with the FL kernel launches counted from 0; an async trainer
    flushes its pending waves after the last (untimed)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if tr.runner is not tr.engine:
        tr.runner.flush()
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
    if not all(bool(torch.isfinite(p).all()) for p in tr.params.values()):
        raise AssertionError(f"{label}: non-finite params")
    return secs, launches


def same_params(a, b) -> bool:
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def same_state(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def expected_wan(fed, rounds=ROUNDS):
    w = 4 * 68_873
    plan = 4 * fed.num_classes * fed.num_clients
    per_round = 2 * w * (CLIENTS * 1 + math.ceil(CLIENTS / GAMMA))
    return [plan + per_round * (r + 1) for r in range(rounds)]


def cudnn_spread(fed, dev) -> float:
    """Two identical sync "vmap" Astraea runs of 2 rounds under cuDNN's
    default algorithms: the largest parameter difference between them."""
    runs = []
    for _ in range(2):
        tr = p10_trainer(fed, dev)
        for _ in range(2):
            tr.run_round()
        runs.append(tr)
    torch.cuda.synchronize()
    a, b = runs
    return max(float((a.params[k] - b.params[k]).abs().max()) for k in a.params)


def async_s0(fed, dev):
    """S=0 with a wave per mediator behind the 4x straggler: masked async
    bitwise the sync "vmap" run, overlapped async under "map" bitwise the
    sync "map" run; one Eq. 6 launch per commit, one warp per round."""
    from repro_torch.core import AsyncSpec, StragglerSpec
    out = {}
    for row_exec, dispatch in (("vmap", "masked"), ("map", "overlapped")):
        sync = p10_trainer(fed, dev, row_exec)
        sync_s, sync_l = run_timed(sync, label=f"sync {row_exec}")
        spec = AsyncSpec(staleness_bound=0, wave_size=1, dispatch=dispatch,
                         straggler=StragglerSpec(**FLEET))
        tr = p10_trainer(fed, dev, row_exec, async_spec=spec)
        secs, launches = run_timed(tr, label=f"async S=0 {dispatch} {row_exec}")
        commits = tr.runner.num_commits
        if not same_params(tr, sync):
            err = max(float((tr.params[k] - sync.params[k]).abs().max()) for k in sync.params)
            raise AssertionError(f"S=0 {dispatch} under {row_exec!r} differs from the sync "
                                 f"run by {err:.3e}; expected bit for bit")
        if launches["fedavg_agg"] != commits or launches["affine_warp"] != ROUNDS:
            raise AssertionError(f"S=0 {dispatch}: launches {launches} for {commits} "
                                 f"commits and {ROUNDS} rounds")
        if not tr.comm.round_log == sync.comm.round_log == expected_wan(fed):
            raise AssertionError(f"S=0 {dispatch}: WAN ledger {tr.comm.round_log}")
        out[f"{dispatch} {row_exec}"] = {
            "bitwise": True, "launches": launches, "sync_launches": sync_l,
            "round_seconds": secs, "sync_round_seconds": sync_s, "commits": commits,
            "graphs_built": tr.engine.num_round_traces}
        del sync, tr
    return out


def async_s2(fed, dev):
    """S=2, a wave per mediator, the 4x straggler: the blocking baseline
    (masked, the host waits for every wave) and overlapped in turns (masked
    dispatch without the waits runs at S=0 in ``async_s0``; left out here
    for the script's time limit); seconds per round, overlap share, graphs
    and their bytes,
    simulated speedup, the staleness histogram and, for the non-blocking
    modes, one profiled round more; the WAN ledger equal to the round
    formula in every mode."""
    from repro_torch.core import AsyncSpec, StragglerSpec
    from repro_torch.examples.profile_round import profile_round
    modes = (("blocking", dict(dispatch="masked", block_each_wave=True)),
             ("overlapped", dict(dispatch="overlapped")))
    out = {}
    for name, kw in modes:
        spec = AsyncSpec(staleness_bound=2, wave_size=1,
                         straggler=StragglerSpec(**FLEET), **kw)
        tr = p10_trainer(fed, dev, async_spec=spec)
        secs, launches = run_timed(tr, label=f"S=2 {name}")
        run = tr.runner
        if tr.comm.round_log != expected_wan(fed):
            raise AssertionError(f"S=2 {name}: WAN ledger {tr.comm.round_log} != "
                                 f"{expected_wan(fed)}")
        if launches["fedavg_agg"] != run.num_commits or \
                launches["affine_warp"] != ROUNDS:
            raise AssertionError(f"S=2 {name}: launches {launches}")
        stales = [s for c in run.commit_log for s in c["staleness"]]
        if max(stales) > 2 or len(stales) != ROUNDS * math.ceil(CLIENTS / GAMMA):
            raise AssertionError(f"S=2 {name}: staleness {stales}")
        m = tr.evaluate()
        if not (math.isfinite(m["accuracy"]) and math.isfinite(m["loss"])):
            raise AssertionError(f"S=2 {name}: non-finite metrics {m}")
        row = {"round_seconds": secs, "overlap_frac": run.overlap_frac,
               "graphs_built": tr.engine.num_round_traces,
               "programs": tr.engine.programs(), "sim_speedup": run.sim_speedup,
               "staleness_hist": dict(sorted(collections.Counter(stales).items())),
               "commits": run.num_commits, "launches": launches,
               "accuracy": m["accuracy"]}
        # then, but for the baseline, one more round under the profiler
        # (device busy, idle and launches; its ~10^5 events take seconds)
        row["profile"] = None if kw.get("block_each_wave") else profile_round(tr, top=4)
        out[name] = row
        del tr, run
    return out


def cinic_graph_bytes(fed, dev):
    """The graphs an async CINIC-10 Astraea engine builds at the paper's
    width (``cinic_cnn(10, 32, 3, 32)``): one masked round (the full-width
    round program) and one overlapped round with a wave per mediator (a
    width-1 program); each program's static buffers and graph pool."""
    from repro_torch.core import AstraeaTrainer, AsyncSpec, LocalSpec, StragglerSpec
    from repro_torch.models.cnn import cinic_cnn
    from repro_torch.optim import adam
    out = {}
    for dispatch in ("masked", "overlapped"):
        spec = AsyncSpec(staleness_bound=2, wave_size=1, dispatch=dispatch,
                         straggler=StragglerSpec(**FLEET))
        tr = AstraeaTrainer(cinic_cnn(10, 32, 3, 32), adam(1e-3), fed,
                            clients_per_round=CLIENTS, gamma=GAMMA, local=LocalSpec(20, 2),
                            alpha=ALPHA, seed=0, device=dev, async_spec=spec)
        tr.run_round()
        torch.cuda.synchronize()
        out[dispatch] = tr.engine.programs()
        del tr
        torch.cuda.empty_cache()
    return out


def store_runs(fed, dev):
    """Replicated, host and spilled stores, a reschedule every round: the
    same params bit for bit; streamed MiB per reschedule, s/round."""
    out, runs = {}, {}
    for policy in ("replicated", "host", "spilled"):
        tr = p10_trainer(fed, dev, store=policy, reschedule_every_round=True)
        secs, launches = run_timed(tr, label=f"store {policy}")
        st = tr.engine.store.stats()
        runs[policy] = tr
        out[policy] = {"round_seconds": secs, "launches": launches,
                       "streamed_mib_per_reschedule":
                           st["streamed_bytes"] / max(st["num_streams"], 1) / 2 ** 20,
                       "device_mib": st["per_device_bytes"] / 2 ** 20,
                       "intra_pod_bytes": tr.comm.intra_pod_bytes,
                       "wan_bytes": tr.comm.total_bytes}
    rep = runs["replicated"]
    for policy, tr in runs.items():
        if not same_params(tr, rep) or tr.comm.round_log != rep.comm.round_log:
            raise AssertionError(f"the {policy} store's run differs from the replicated one")
    if not runs["host"].engine.store._staging[0][0].is_pinned():
        raise AssertionError("the host store's staging buffers are not pinned")
    return out


def million_clients(dev):
    """A spilled ``StreamingFederation`` of 1,000,000 clients at the EMNIST
    shape (47 classes, 28x28x1), 3 rounds at prefetch depth 1 and 2: the
    store's device bytes U_cap x bytes per client, the same as over 1,000
    clients; seconds per round, LRU evictions, finite accuracy."""
    from repro_torch.data.synthetic import StreamingFederation, federation_counts
    from repro_torch.data.federated import EMNIST_LIKE
    spec = dataclasses.replace(EMNIST_LIKE, num_classes=47)
    t0 = time.perf_counter()
    big = StreamingFederation(spec, federation_counts(MILLION, 47, seed=0),
                              batch_size=20, seed=0)
    setup_s = time.perf_counter() - t0
    small = StreamingFederation(spec, federation_counts(1_000, 47, seed=0),
                                batch_size=20, seed=0)
    held = {}
    tr = p10_trainer(small, dev, store="spilled", reschedule_every_round=True)
    tr.run_round()
    held[1_000] = sum(t.nbytes for t in tr.engine.store._dev)
    del tr
    out = {"setup_s": setup_s, "pad": big.pad, "bytes_per_client": big.nbytes_per_client}
    for depth in (1, 2):
        tr = p10_trainer(big, dev, store="spilled", reschedule_every_round=True,
                         store_prefetch_depth=depth)
        secs, launches = run_timed(tr, label=f"1M spilled depth {depth}")
        st = tr.engine.store.stats()
        held[MILLION] = sum(t.nbytes for t in tr.engine.store._dev)
        m = tr.evaluate()
        if not (math.isfinite(m["accuracy"]) and math.isfinite(m["loss"])):
            raise AssertionError(f"1M clients: non-finite metrics {m}")
        if not held[MILLION] == st["per_device_bytes"] == CLIENTS * big.nbytes_per_client \
                == held[1_000]:
            raise AssertionError(f"1M clients: device bytes {held} vs "
                                 f"{CLIENTS} x {big.nbytes_per_client}")
        out[f"depth {depth}"] = {
            "round_seconds": secs, "launches": launches, "device_bytes": held[MILLION],
            "device_bytes_k1000": held[1_000], "lru_evictions": st["lru_evictions"],
            "prefetch_hits": st["prefetch_hits"], "tier_rows": st["tier_rows"],
            "cache_hit_rows": st["cache_hit_rows"], "accuracy": m["accuracy"],
            "streamed_bytes": st["streamed_bytes"]}
        del tr
    return out


def checkpoint_resume(fed, dev):
    """The sync trainer saved after 2 rounds and loaded into a fresh
    trainer on the card: its round 3 equals the uninterrupted trainer's
    round 3 bit for bit."""
    import tempfile
    from repro_torch.core import load_trainer, save_trainer
    tr = p10_trainer(fed, dev)
    for _ in range(2):
        tr.run_round()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "astraea.ckpt")
        save_trainer(path, tr)
        nbytes = Path(path).stat().st_size
        fresh = load_trainer(path, p10_trainer(fed, dev))
    if not same_params(fresh, tr) or fresh._round != 2:
        raise AssertionError("the restored trainer's params differ from the saved ones")
    tr.run_round()
    fresh.run_round()
    torch.cuda.synchronize()
    if not same_params(fresh, tr) or fresh.comm.total_bytes != tr.comm.total_bytes:
        raise AssertionError("round 3 after a restore differs from the uninterrupted one")
    return {"bitwise": True, "file_bytes": nbytes, "round": fresh._round}


def phase10(fed, cinic_fed, dev, path_launches: dict, lap) -> dict:
    """Phase 10 (module docstring): async rounds, client stores and
    checkpoints at phase 5's EMNIST arm, each run's launch counts reset
    just before it and read after; the async and 1M paths' counts join
    ``path_launches``; ``lap(name)`` logs each part's seconds."""
    torch.cuda.empty_cache()
    spread = cudnn_spread(fed, dev)
    log(f"[async] cuDNN's default algorithms: two identical sync runs of 2 rounds part "
        f"by {spread:.3e} (the bitwise checks below use its deterministic ones)")
    with deterministic_convolutions():
        s0 = async_s0(fed, dev)
    for name, r in s0.items():
        log(f"[async] S=0 {name}: bitwise equal to the sync run; launches {r['launches']} "
            f"({r['commits']} commits); s/round "
            f"{' '.join(f'{x:.4f}' for x in r['round_seconds'])} (sync "
            f"{' '.join(f'{x:.4f}' for x in r['sync_round_seconds'])}); graphs "
            f"{r['graphs_built']}")
    lap("10 async S=0")
    s2 = async_s2(fed, dev)
    path_launches["async S=2 overlapped"] = dict(s2["overlapped"]["launches"])
    for name, t in s2.items():
        progs = ", ".join(f"{k} (width {v['width']}): buffers "
                          f"{v['buffer_bytes'] / 2 ** 20:.2f} MiB, pool "
                          f"{v['graph_pool_bytes'] / 2 ** 20:.2f} MiB"
                          for k, v in t["programs"].items())
        log(f"[async] S=2 {name:10s}: s/round "
            f"{' '.join(f'{x:.4f}' for x in t['round_seconds'])}, overlap_frac "
            f"{t['overlap_frac']:.3f}, sim_speedup {t['sim_speedup']:.3f}, staleness "
            f"{t['staleness_hist']}, graphs {t['graphs_built']} [{progs}]")
        p = t["profile"]
        if p is None:
            continue
        log(f"[async] S=2 {name:10s} (profiled round): wall {p['wall_s']:.4f} s, "
            f"device busy {p['busy_s']:.4f} s, idle {100 * p['idle_share']:.1f} %, "
            f"{p['host_launches']} host launches ({p['graph_launches']} graph), "
            f"{p['device_kernels']} device kernels")
    lap("10 async S=2")
    graphs = cinic_graph_bytes(cinic_fed, dev)
    for dispatch, progs in graphs.items():
        for k, v in progs.items():
            log(f"[async] CINIC-10 {dispatch}: {k} width {v['width']}: buffers "
                f"{v['buffer_bytes'] / 2 ** 20:.2f} MiB, graph pool "
                f"{v['graph_pool_bytes'] / 2 ** 20:.2f} MiB")
    lap("10 CINIC graphs")
    with deterministic_convolutions():
        stores = store_runs(fed, dev)
    for policy, r in stores.items():
        log(f"[store] {policy:10s}: s/round {' '.join(f'{x:.4f}' for x in r['round_seconds'])}"
            f", streamed {r['streamed_mib_per_reschedule']:.3f} MiB per reschedule, "
            f"device {r['device_mib']:.3f} MiB; params bitwise equal across stores")
    million = million_clients(dev)
    path_launches["spilled 1M"] = dict(million["depth 2"]["launches"])
    for depth in ("depth 1", "depth 2"):
        r = million[depth]
        log(f"[store] spilled {MILLION:,} clients, prefetch {depth}: s/round "
            f"{' '.join(f'{x:.4f}' for x in r['round_seconds'])}, device "
            f"{r['device_bytes']:,} B (K=1,000: {r['device_bytes_k1000']:,} B), LRU "
            f"evictions {r['lru_evictions']}, prefetch hits {r['prefetch_hits']}, "
            f"top1 {r['accuracy']:.4f}")
    log(f"[store] the 1M federation's histograms in {million['setup_s']:.2f} s, pad "
        f"{million['pad']}, {million['bytes_per_client']:,} B per client")
    lap("10 stores")
    with deterministic_convolutions():
        ckpt = checkpoint_resume(fed, dev)
    log(f"[ckpt] saved after 2 rounds ({ckpt['file_bytes']:,} B), restored on the card: "
        "round 3 bitwise equal to the uninterrupted run")
    lap("10 checkpoint")

    return {"cudnn_default_spread": spread, "async_s0": s0, "async_s2": s2, "cinic_graphs": graphs, "stores": stores,
            "million_clients": million, "checkpoint": ckpt}


def materialized_round(fed, dev):
    """One full-width CINIC Astraea round with the materialized Alg. 2
    phase: its warp launches (the whole federation in one) and the extra
    storage it costs."""
    from repro_torch.core import AstraeaTrainer, LocalSpec
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import cinic_cnn
    from repro_torch.optim import adam
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = AstraeaTrainer(cinic_cnn(10, 32, 3, 32), adam(1e-3), fed,
                        clients_per_round=CLIENTS, gamma=GAMMA, local=LocalSpec(20, 2),
                        alpha=ALPHA, aug_mode="materialized", seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warps = ops.LAUNCHES["affine_warp"]
    t0 = time.perf_counter()
    tr.run_round()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
    if warps != 1 or launches != {"fedavg_agg": 1, "kld_greedy_picks": 1,
                                  "affine_warp": 1}:
        raise AssertionError(f"materialized round launched {launches} "
                             f"({warps} warps in the phase); expected 1 each")
    added = sum(x.shape[0] for x in tr.data.client_images) - \
        sum(x.shape[0] for x in fed.client_images)
    if not (tr.extra_storage_frac > 0 and added > 0):
        raise AssertionError("the materialized phase added no samples")
    m = tr.evaluate()
    if not (math.isfinite(m["accuracy"]) and math.isfinite(m["loss"])):
        raise AssertionError(f"materialized round: non-finite metrics {m}")
    return {"setup_s": setup_s, "round_s": round_s, "launches": launches,
            "extra_storage_frac": tr.extra_storage_frac, "added_samples": added,
            "accuracy": m["accuracy"], "loss": m["loss"]}


def ln_scales_to_one(model) -> int:
    """Set every LayerNorm scale of ``model`` to 1 and return how many
    there are.  The reference's init zeroes them and its LayerNorm
    multiplies by the scale itself, so at init every LayerNorm output (and
    logit) of an ``norm="ln"`` model is 0."""
    n = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("norm1", "norm2", "norm_x", "final_norm",
                                       "enc_final_norm"):
            p.fill_(1.0)
            n += 1
    return n


def to_fan_in(model) -> None:
    """Rescale every stacked layer matrix of ``model`` from the reference
    init's ``1/sqrt(layers)`` to the standard ``1/sqrt(d_in)``.  At the
    reference's scale the reduced whisper's and granite's decode logits are
    ill-conditioned: a 1e-7 relative perturbation of the weights moves them
    by up to 4.2e-3 and 4.8e-4 of their scale on the CPU alone (1.7e-6 at
    the standard fan-in), past the agreement's 2e-4."""
    cfg = model.cfg
    stacks = {"layers": cfg.n_layers, "encoder": cfg.encoder_layers}
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = stacks.get(name.split(".", 1)[0])
            if n and p.dim() >= 2:
                p.mul_(math.sqrt(n / p.shape[-2]))


def serve_agreement(dev, cfg, fan_in: bool = False):
    """A reduced model, f32 weights from one seed (LayerNorm scales set to
    1, ``ln_scales_to_one``, under ``norm="ln"``; with ``fan_in`` at the
    standard fan-in, ``to_fan_in``), a VLM's or an audio model's stub
    inputs from another: prefill of a prompt of 2W (window mask and ring wrap; 128
    without a window) and 8 teacher-forced decode steps on the card
    against the same runs on the CPU.  Tolerance 2e-4 of the logit scale:
    fp32 sums in other orders (cuBLAS, the kernels) amplified by the
    reference init's large activations, as in tests/test_torch_serve.py."""
    from repro_torch.launch.serve import modality_inputs, prefix_len
    from repro_torch.models import transformer as T
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0))
    if cfg.norm == "ln":
        ln_scales_to_one(cpu)
    if fan_in:
        to_fan_in(cpu)
    card = T.Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    s, steps = 2 * (cfg.sliding_window or 64), 8
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, s + steps), generator=gen)
    extra = modality_inputs(cfg, 2, gen, "cpu")
    start = prefix_len(cfg) + s
    lc, cc = T.forward_prefill(cpu, {"tokens": toks[:, :s], **extra}, pad_to=start + steps)
    lg, cg = T.forward_prefill(card, {"tokens": toks[:, :s].to(dev),
                                      **{k: v.to(dev) for k, v in extra.items()}},
                               pad_to=start + steps)
    errs, scales = [], []
    for i in range(steps + 1):
        errs.append(float((lg.cpu() - lc).abs().max()))
        scales.append(max(float(lc.abs().max()), 1.0))
        if i == steps:
            break
        pos = start + i
        tok = toks[:, s + i:s + i + 1]
        lc, cc = T.forward_decode(cpu, {"tokens": tok, "positions": torch.full((2,), pos)}, cc)
        lg, cg = T.forward_decode(card, {"tokens": tok.to(dev),
                                         "positions": torch.full((2,), pos, device=dev)}, cg)
    rel = max(e / sc for e, sc in zip(errs, scales))
    if not rel <= 2e-4:
        raise AssertionError(f"serving {cfg.name} card vs CPU: logits errors {errs} "
                             f"(scales {scales})")
    return {"logits_max_abs_err": errs, "logit_scale": scales, "max_rel_err": rel,
            "tol_rel": 2e-4, "prompt": s, "decode_steps": steps,
            "head_dim": cfg.resolved_head_dim, "fan_in": fan_in}


# the families whose reduced configs phase 8 holds at the standard fan-in
# (``to_fan_in``)
FAN_IN_ARCHS = ("granite-moe-3b-a800m", "whisper-base", "internvl2-1b")

# the serving runs at full width: (arch, batch, prompt, new tokens,
# parameters, flash and SSD launches per prefill, flash launches per decode
# step); Hymba, gemma and the three families of slice 17 at Hymba's traffic
# (a VLM's 2,048 positions are 256 stub vision tokens and 1,792 text;
# whisper's prompt is 256 tokens over 1,536 stub frames), the other three
# short, so the script stays well inside its time limit
SERVE_RUNS = (
    ("hymba-1.5b", 4, 2048, 16, 1_393_625_120, 32, 32, 0),
    ("gemma-2b", 4, 2048, 16, 2_506_172_416, 18, 0, 0),
    ("qwen3-4b", 1, 512, 4, 4_022_468_096, 36, 0, 0),
    ("h2o-danube-1.8b", 1, 512, 4, 1_831_201_280, 24, 0, 0),
    ("mamba2-370m", 1, 512, 4, 368_338_432, 0, 48, 0),
    # MoE: 32 layers of GQA 24:8 at d=64, 40 experts top-8
    ("granite-moe-3b-a800m", 4, 2048, 16, 3_298_793_472, 32, 0, 0),
    # VLM: GQA 14:2 with QKV bias
    ("internvl2-1b", 4, 1792, 16, 493_780_992, 24, 0, 0),
    # audio: 6 encoder (non-causal) + 6 decoder + 6 cross-attention launches
    # a prefill, the 6 cross-attentions in each decode step
    ("whisper-base", 4, 256, 16, 73_542_144, 18, 0, 6),
)


@contextlib.contextmanager
def recorded_kernel_calls(seen: dict):
    """While open, every ``ops.flash_attention``, ``ops.flash_attention_bwd``
    (the autograd function's backward calls it), ``ops.ssd_chunk`` and
    ``ops.ssd_chunk_bwd`` call on the card adds its signature
    (``flash_key``/``flash_bwd_key``/``ssd_key``/``ssd_bwd_key``) to
    ``seen``, with the keyword arguments that rebuild it in ``check_flash``,
    ``check_flash_bwd``, ``check_ssd`` or ``check_ssd_bwd``.  The wrappers
    themselves run and count as always."""
    from repro_torch.kernels import ops
    flash, flash_bwd = ops.flash_attention, ops.flash_attention_bwd
    ssd, ssd_bwd = ops.ssd_chunk, ops.ssd_chunk_bwd

    def flash_kw(q, k, causal, window, q_offset):
        b, sq, h, d = q.shape
        return dict(b=b, sq=sq, skv=k.shape[1], h=h, kv=k.shape[2], d=d, dtype=q.dtype,
                    causal=causal, window=window, q_offset=q_offset)

    def flash_rec(q, k, v, *, causal=True, window=None, q_offset=0):
        if q.is_cuda:
            seen[flash_key(q, k, causal, window, q_offset)] = (
                "flash_attention", flash_kw(q, k, causal, window, q_offset))
        return flash(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def flash_bwd_rec(q, k, v, out, dout, *, causal=True, window=None, q_offset=0,
                      lse=None):
        if q.is_cuda:
            seen[flash_bwd_key(q, k, causal, window, q_offset)] = (
                "flash_attention_bwd", flash_kw(q, k, causal, window, q_offset))
        return flash_bwd(q, k, v, out, dout, causal=causal, window=window,
                         q_offset=q_offset, lse=lse)

    def ssd_rec(x, dt, A, B, C):
        if x.is_cuda:
            b, nc, L, h, p = x.shape
            seen[ssd_key(x, B)] = ("ssd_chunk", dict(b=b, nc=nc, L=L, h=h, p=p,
                                                     n=B.shape[-1], dtype=x.dtype))
        return ssd(x, dt, A, B, C)

    def ssd_bwd_rec(x, dt, A, B, C, dy, dS, dg):
        if x.is_cuda:
            b, nc, L, h, p = x.shape
            seen[ssd_bwd_key(x, B)] = ("ssd_chunk_bwd", dict(b=b, nc=nc, L=L, h=h, p=p,
                                                             n=B.shape[-1]))
        return ssd_bwd(x, dt, A, B, C, dy, dS, dg)

    ops.flash_attention, ops.flash_attention_bwd = flash_rec, flash_bwd_rec
    ops.ssd_chunk, ops.ssd_chunk_bwd = ssd_rec, ssd_bwd_rec
    try:
        yield seen
    finally:
        ops.flash_attention, ops.flash_attention_bwd = flash, flash_bwd
        ops.ssd_chunk, ops.ssd_chunk_bwd = ssd, ssd_bwd


def serve_path(dev, arch, batch, prompt, tokens, params, flash, ssd, decode_flash):
    """``arch`` at full width through the serving entry point, the launch
    counts reset just before and read just after: ``flash`` and ``ssd``
    launches in the prefill, ``decode_flash`` flash launches (the audio
    decoder's cross-attention) and no SSD launch in each decode step,
    finite logits, ``(batch, tokens)`` tokens.  The model is built once
    (weights from seed 0; LayerNorm scales set to 1, ``ln_scales_to_one``),
    served and then profiled (``profile_serve``).  Returns the run's record
    and the kernel signatures it called (``recorded_kernel_calls``)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = T.init_model(cfg, gen, device=dev)
    ln_scales = ln_scales_to_one(model) if cfg.norm == "ln" else 0
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    seen: dict = {}
    ops.reset_launches()
    with recorded_kernel_calls(seen):
        r = serve(cfg, batch=batch, prompt_len=prompt, tokens=tokens, device=dev,
                  generator=gen, model=model)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    pre, dec = r["prefill_launches"], r["decode_launches"]
    if r["params"] != params:
        raise AssertionError(f"{arch} has {r['params']} params, expected {params}")
    if (pre["flash_attention"], pre["ssd_chunk"]) != (flash, ssd) or \
            dec["flash_attention"] != decode_flash * (tokens - 1) or dec["ssd_chunk"]:
        raise AssertionError(f"{arch}: prefill launched {pre}, decode {dec}; expected "
                             f"{flash} flash_attention and {ssd} ssd_chunk in the prefill, "
                             f"{decode_flash} flash_attention a decode step")
    if launches["flash_attention_bwd"] or launches["ssd_chunk_bwd"]:
        raise AssertionError(f"{arch}: serving launched a backward kernel: {launches}")
    if not r["logits_finite"]:
        raise AssertionError(f"{arch} serve: non-finite logits")
    if tuple(r["tokens"].shape) != (batch, tokens):
        raise AssertionError(f"{arch}: generated {tuple(r['tokens'].shape)} tokens")
    steps = r["decode_step_s"]
    out = {"arch": arch, "batch": batch, "prompt": prompt, "tokens": tokens,
           "init_s": init_s, "init_peak_mem_gb": init_peak, "ln_scales_set_to_one": ln_scales,
           "prefill_s": r["prefill_s"], "decode_step_s": steps,
           "decode_ms_per_token": 1e3 * sum(steps) / len(steps),
           "prefill_launches": pre, "decode_launches": dec,
           "decode_flash_per_step": dec["flash_attention"] / len(steps),
           "launches": launches, "params": r["params"], "peak_mem_gb": peak,
           "sample": r["tokens"][0].tolist()}
    del r
    out["profile"] = profile_serve(dev, model, batch, prompt)
    return out, seen


def _device_busy_ms(prof) -> tuple[float, list[tuple[str, float, int]]]:
    """Summed kernel time (ms) of a profiler window and its kernels (name,
    ms, calls), largest first."""
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def profile_serve(dev, model, batch, prompt, steps: int = 4):
    """Where a full-width serve step of ``model`` spends its time: one warm
    prefill and ``steps`` decode steps under ``torch.profiler``, each
    against its host-clock wall time; device idle share = 1 - busy/wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import modality_inputs, prefix_len
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (batch, prompt + steps), generator=gen,
                         device=dev)
    inputs = {"tokens": toks[:, :prompt], **modality_inputs(model.cfg, batch, gen, dev)}
    start = prefix_len(model.cfg) + prompt
    T.forward_prefill(model, inputs, pad_to=start + steps)                 # warm-up
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = T.forward_prefill(model, inputs, pad_to=start + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels = _device_busy_ms(prof)
    flash = sum(ms for name, ms, _ in kernels if "flash" in name)
    out["prefill"] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                      "idle_share": 1.0 - busy / (wall * 1e3), "top_kernels": kernels[:8],
                      "flash_device_ms": flash, "flash_share": flash / busy,
                      "ssd_device_ms": sum(ms for name, ms, _ in kernels if "ssd" in name),
                      "kernel_launches": sum(e.count for e in prof.key_averages()
                                             if e.device_type == torch.autograd.DeviceType.CUDA)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            pos = torch.full((batch,), start + i, dtype=torch.long, device=dev)
            T.forward_decode(model, {"tokens": toks[:, prompt + i:prompt + i + 1],
                                     "positions": pos}, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels = _device_busy_ms(prof)
    top = kernels[:8]
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    flash = sum(ms for name, ms, _ in kernels if "flash" in name)
    out["decode"] = {"wall_ms_per_token": wall * 1e3 / steps,
                     "flash_device_ms_per_token": flash / steps,
                     "device_busy_ms_per_token": busy / steps,
                     "idle_share": 1.0 - busy / (wall * 1e3), "top_kernels": top,
                     "kernel_launches_per_token": launches / steps}
    return out


# ---------------------------------------------------------------- phase 11

# qwen3-4b at full width; the LoRA round's rank, its trainable values and
# the bytes a leg carries in bf16 (the reference's own mapping gives the
# same: tests/test_torch_lora.py)
TRAIN_ARCH, TRAIN_PARAMS = "qwen3-4b", 4_022_468_096
LORA_RANK, LORA_TRAINABLE, LORA_LEG_BYTES = 16, 17_931_776, 35_863_552
# its largest leaf (the embedding, 151,936 x 2,560): phase 3 checks Eq. 6 there
TRAIN_LARGEST_LEAF = 388_956_160
# the SSD, MoE, audio and VLM families phase 11 trains at full width
HYMBA_PARAMS, MAMBA2_PARAMS = 1_393_625_120, 368_338_432
GRANITE_PARAMS, WHISPER_PARAMS, INTERNVL2_PARAMS = 3_298_793_472, 73_542_144, 493_780_992
# their LoRA rounds' (trainable values, bytes a bf16 leg) at rank 16, from
# the reference's own mapping (tests/test_torch_lora.py): granite's adapters
# batch over (layers, expert)
LORA_LEGS = {"granite-moe-3b-a800m": (54_670_848, 109_341_696)}
# the federated runs' traffic: 8 synthetic clients of 128 tokens, gamma 4
FL_CLIENTS, FL_GAMMA, FL_SEQ, FL_LR = 8, 4, 128, 5e-4
# the training launchers' steps in phase 11 (their default is 20)
LAUNCHER_STEPS = 5


def fl_client_streams(dev):
    """The federated runs' clients: token streams and topic histograms."""
    from repro_torch import configs
    from repro_torch.launch import fl_train
    return fl_train.synth_client_streams(torch.Generator(device=dev).manual_seed(1),
                                         FL_CLIENTS, configs.get(TRAIN_ARCH).vocab, FL_SEQ)


def fl_client_counts(dev):
    return fl_client_streams(dev)[1]


class HeldEq6:
    """Within the block, every ``ops.fedavg_agg`` call (``fedavg_agg_tree``
    reaches it too) is held against ``ref.fedavg_agg`` on the same deltas
    and weights: within 1e-5 of the deltas' largest magnitude (fp32 sums
    in another order; the normalized weights sum to 1).  The check's own
    seconds are kept apart, so a timed run can leave them out."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.calls, self.worst, self.seconds = 0, 0.0, 0.0
        kernel = self._kernel = ops.fedavg_agg

        def held(deltas, weights):
            out = kernel(deltas, weights)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = ref.fedavg_agg(deltas, weights)
            err = float((out.float() - plain.float()).abs().max())
            scale = float(deltas.abs().max())
            self.calls += 1
            if not err <= 1e-5 * scale:
                raise AssertionError(f"Eq. 6 on {tuple(deltas.shape)}: err {err} > "
                                     f"1e-5 x {scale}")
            self.worst = max(self.worst, err / max(scale, 1e-30))
            del plain
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        ops.fedavg_agg = held
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.fedavg_agg = self._kernel
        return False


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# the backward kernel's passes, by the names the profiler records
BWD_KERNELS = ("bwd_dq_tc_kernel", "bwd_dkdv_tc_kernel", "bwd_reduce_tc_kernel",
               "bwd_dq_f32_kernel", "bwd_dkdv_f32_kernel", "bwd_reduce_f32_kernel")


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host-clock wall, device
    busy (summed kernel time), idle share, device kernels, the flash and
    SSD backwards' device ms and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, kernels = _device_busy_ms(prof)
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(calls for _, _, calls in kernels),
            "flash_bwd_ms": sum(ms for name, ms, _ in kernels
                                if any(k in name for k in BWD_KERNELS)),
            "ssd_bwd_ms": sum(ms for name, ms, _ in kernels if "ssd_bwd" in name),
            "top_kernels": kernels[:8]}


def log_profile(label: str, prof: dict) -> None:
    log(f"[train-profile] {label}: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle {100 * prof['idle_share']:.1f} %, "
        f"{prof['kernel_launches']} kernels, flash backward {prof['flash_bwd_ms']:.2f} ms, "
        f"SSD backward {prof['ssd_bwd_ms']:.2f} ms")
    for name, ms, calls in prof["top_kernels"]:
        log(f"[train-profile]   {ms:9.3f} ms {calls:6d}x {name[:90]}")


def want_launches(cfg, steps: int, **extra) -> dict:
    """Every kernel's launches in ``steps`` training steps of ``cfg``: a
    forward and a backward flash launch per attention layer -- an audio
    model's encoder layers and its decoder's cross-attention layers
    included -- a forward and a backward SSD launch per SSM layer, and
    under ``cfg.remat`` a second forward launch of each (the layer's
    recompute in the backward); ``extra`` for the rest."""
    from repro_torch.kernels import ops
    fwd = 2 if cfg.remat else 1
    cross = cfg.n_layers if cfg.arch_type == "audio" else 0
    attn = steps * (cfg.n_layers + cfg.encoder_layers + cross) if cfg.has_attention else 0
    ssd = steps * cfg.n_layers if cfg.has_ssm else 0
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(flash_attention=fwd * attn, flash_attention_bwd=attn, ssd_chunk=fwd * ssd,
                ssd_chunk_bwd=ssd, **extra)
    return want


def largest_update(new: dict, old: dict) -> float:
    return max(float((new[k].float() - old[k].float()).abs().max()) for k in old)


def train_family(dev, arch: str, n_expect: int, seq: int, seen: dict,
                 path_launches: dict, fl_data=None, fan_in: bool = False,
                 lora_round: bool = True, tp: str | None = None, smi: str = "",
                 lap=None) -> dict:
    """``arch`` at full width (bf16, weights from seed 0; an ``norm="ln"``
    model's LayerNorm scales set to 1, ``ln_scales_to_one``, as the
    reference's init zeroes them and every output with them; with
    ``fan_in`` the stacked layer matrices at the standard fan-in,
    ``to_fan_in``): two AdamW steps of ``make_train_step`` at batch 4 x
    ``seq`` (``make_batch``'s:
    a VLM's first half stub vision tokens, an audio model's 1,536 stub
    frames), the attention and SSD gradients on the card's backward
    kernels; with ``fl_data`` (phase 11's 2 mediators: their token streams
    mapped into this vocab, rows, weights, steps per mediator) also a LoRA
    rank-16 round of ``make_fl_round`` (its Eq. 6 launch held to its plain
    version); with ``tp`` (phase 15's letter) that round -- or, without
    ``fl_data``'s LoRA round (``lora_round=False``), a full-delta round -- again
    tensor-parallel over a model axis of ``P15_T`` (``tp_family_round``:
    in bf16, then as a t=1 / t=2 pair on the weights cast to fp32).  Each
    run's launch counts reset just before it
    and read just after; finite losses, a moved update, seconds and peak
    memory.  Kernel signatures go to ``seen``; ``lap`` times the family's
    phase 11 part and its phase 15 part apart."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import lora
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, schedules
    cfg = configs.get(arch)
    torch.cuda.empty_cache()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ln_scales = ln_scales_to_one(model) if cfg.norm == "ln" else 0
    if fan_in:
        to_fan_in(model)
    params = T.train_params(model)
    n_params = sum(p.numel() for p in params.values())
    if n_params != n_expect:
        raise AssertionError(f"{arch}: {n_params} parameters, expected {n_expect}")
    opt = adamw(schedules.warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    shape = configs.InputShape("phase11", seq, 4, "train")
    batches = []
    for i in range(2):
        b = configs.make_batch(cfg, shape, seed=1 + i, device=dev)["batch"]
        b["labels"] = torch.roll(b["tokens"], -1, dims=1)
        batches.append(b)
    start = {k: t.clone() for k, t in params.items()}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    secs, losses = [], []
    with recorded_kernel_calls(seen):
        for b in batches:
            (params, state, loss), sec = _sync_time(lambda: step(params, state, b))
            secs.append(sec)
            losses.append(float(loss))
    launches = dict(ops.LAUNCHES)
    path_launches[f"train {arch}"] = launches
    if launches != want_launches(cfg, 2):
        raise AssertionError(f"{arch} train steps: launches {launches}, expected "
                             f"{want_launches(cfg, 2)}")
    moved = largest_update(params, start)
    del start
    if not all(math.isfinite(x) for x in losses) or moved == 0.0:
        raise AssertionError(f"{arch} train steps: losses {losses}, largest update {moved}")
    res = {"train": {"s_per_step": secs, "losses": losses, "peak_gb": _peak_gb(),
                     "launches": launches, "tokens": 4 * seq, "largest_update": moved,
                     "params": n_params, "ln_scales_set_to_one": ln_scales,
                     "fan_in": fan_in,
                     "microbatches_suggested": steps.suggest_microbatches(cfg, 4, seq),
                     "flop_bound_ms": 6 * n_params * 4 * seq / 989e12 * 1e3}}
    log(f"[train] {arch} {n_params:,} params bf16, AdamW, batch 4 x {seq}: s/step "
        f"{' '.join(f'{x:.4f}' for x in secs)} (6 N tokens at 989 TFLOP/s: "
        f"{res['train']['flop_bound_ms']:.2f} ms), losses {losses}, largest update "
        f"{moved:.3e}, peak {res['train']['peak_gb']:.2f} GB, launches {launches}"
        + (f"; its {ln_scales} LayerNorm scales set to 1 after init" if ln_scales else "")
        + ("; at the standard fan-in" if fan_in else ""))
    if cfg.encoder_layers:
        # suggest_microbatches' napkin (6 bytes a saved residual of d a
        # position a layer) reads the decoder's seq for every layer; with
        # the encoder's frames in its own layers instead
        napkin = (cfg.n_layers + cfg.encoder_layers) * 4 * seq * cfg.d_model * 6
        frames = (cfg.n_layers * seq + cfg.encoder_layers * cfg.source_positions) \
            * 4 * cfg.d_model * 6
        res["train"]["napkin_bytes"] = {"decoder_seq": napkin, "encoder_frames": frames}
        log(f"[train] {arch} suggest_microbatches(batch 4, seq {seq}) = "
            f"{res['train']['microbatches_suggested']}: its napkin counts {napkin:,} B of "
            f"saved residuals at the decoder's seq, {frames:,} B with the encoder's "
            f"{cfg.source_positions} frames (budget 4e9 B); measured peak "
            f"{res['train']['peak_gb']:.2f} GB")
    del state, opt, step
    torch.cuda.empty_cache()
    if fl_data is not None and lora_round:
        tokens, labels, w, per_med = fl_data
        mapping = T.adapter_mapping(cfg, LORA_RANK)
        leg = lora.exchange_nbytes(mapping, 2)
        if arch in LORA_LEGS and (lora.num_trainable_params(mapping), leg) != LORA_LEGS[arch]:
            raise AssertionError(f"{arch} rank {LORA_RANK}: {lora.num_trainable_params(mapping)} "
                                 f"trainable, {leg} bytes a leg; the reference's mapping "
                                 f"gives {LORA_LEGS[arch]}")
        a_tree = lora.init_adapter_A(lora.A_SALT, mapping, dev)
        ad_state = lora.init_adapter_state(mapping, params)
        fl = steps.make_fl_round(model, 2, learning_rate=FL_LR, local_steps=per_med,
                                 lora_mapping=mapping)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with HeldEq6() as held, recorded_kernel_calls(seen):
            new_state, sec = _sync_time(lambda: fl(params, a_tree, ad_state, tokens, labels, w))
        sec -= held.seconds
        launches = dict(ops.LAUNCHES)
        path_launches[f"lora round {arch}"] = launches
        want = want_launches(cfg, 2 * per_med, fedavg_agg=1)
        if launches != want:
            raise AssertionError(f"{arch} LoRA round: launches {launches}, expected {want}")
        moved = largest_update(new_state, ad_state)
        with torch.no_grad():
            loss = float(T.forward_train(model, {"tokens": tokens[:2], "labels": labels[:2]},
                                         lora.merge_params(params, a_tree, new_state,
                                                           mapping))[0])
        if not math.isfinite(loss) or moved == 0.0:
            raise AssertionError(f"{arch} LoRA round: loss {loss}, largest update {moved}")
        res["lora_round"] = {"s_per_round": sec, "loss": loss, "peak_gb": _peak_gb(),
                             "launches": launches, "largest_update": moved,
                             "trainable": lora.num_trainable_params(mapping),
                             "leg_bytes": leg, "ratio": leg / (2 * n_params),
                             "eq6_held": {"calls": held.calls, "worst_rel": held.worst}}
        log(f"[fl] {arch} LoRA rank {LORA_RANK} round, 2 mediators x {per_med} steps: "
            f"{sec:.3f} s, loss {loss:.4f}, largest adapter update {moved:.3e}, peak "
            f"{_peak_gb():.2f} GB, {res['lora_round']['trainable']:,} trainable, {leg:,} B "
            f"a leg (adapter/full {leg / (2 * n_params):.6f}), launches {launches}; Eq. 6 "
            f"held to its plain version: {held.calls} call, worst {held.worst:.2e}")
        del fl
        if tp is not None:
            if lap is not None:
                lap(f"11 {arch}")
            res["tp_round"] = tp_family_round(dev, tp, model, params, fl_data, new_state,
                                              seen, path_launches, smi,
                                              lora=(mapping, a_tree, ad_state))
        del a_tree, ad_state, new_state
    elif fl_data is not None and tp is not None:
        if lap is not None:
            lap(f"11 {arch}")
        res["tp_round"] = tp_family_round(dev, tp, model, params, fl_data, None, seen,
                                          path_launches, smi)
    if lap is not None:
        lap(f"15 ({tp}) {arch} TP round" if tp is not None else f"11 {arch}")
    del model, params
    torch.cuda.empty_cache()
    return res


def phase11(dev, gen, checks: dict, path_launches: dict, lap, smi: str = "") -> dict:
    """qwen3-4b at full width (bf16, weights from seed 0): two AdamW steps
    of ``make_train_step`` at batch 4 x 128, a LoRA rank-16 round and a
    full-delta round of ``make_fl_round`` over the 2 mediators Alg. 3 makes
    of 8 synthetic clients (on the card's greedy kernel), each with its
    launch counts reset just before and read just after, seconds, peak
    memory and the WAN ledger, and every Eq. 6 launch of the two rounds
    held to its plain version (``HeldEq6``; its seconds left out of the
    rounds'); then through ``train_family`` hymba-1.5b (steps and a LoRA
    round over the same mediators), mamba2-370m (steps at 4 x 512),
    granite-moe-3b-a800m (steps and a LoRA round), whisper-base and
    internvl2-1b (steps); then the launchers at their reduced configs
    (qwen3-4b, mamba2-370m, granite, whisper, internvl2 at
    ``LAUNCHER_STEPS`` steps, and ``fl_train``);
    every kernel signature these runs called that no check had held (the
    flash backward's too) is then held against its plain version
    (``checks`` gains the rows)."""
    from repro_torch import configs
    from repro_torch.core import scheduling
    from repro_torch.core.comm import CommMeter
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train, steps, train
    from repro_torch.models import lora
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, schedules
    cfg = configs.get(TRAIN_ARCH)
    res: dict = {}
    torch.cuda.empty_cache()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)
    n_params = sum(p.numel() for p in params.values())
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{TRAIN_ARCH}: {n_params} parameters, expected {TRAIN_PARAMS}")
    layers = cfg.n_layers

    def counts_ok(name, launches, flash, extra):
        # under remat each layer's forward runs again in the backward
        want = {k: 0 for k in ops.LAUNCHES}
        want.update(flash_attention=(2 if cfg.remat else 1) * flash,
                    flash_attention_bwd=flash, **extra)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")

    # (a) AdamW steps: forward, backward, clipping, the leafwise update
    opt = adamw(schedules.warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    shape = configs.InputShape("phase11", 128, 4, "train")
    batches = []
    for i in range(2):
        b = configs.make_batch(cfg, shape, seed=1 + i, device=dev)["batch"]
        b["labels"] = torch.roll(b["tokens"], -1, dims=1)
        batches.append(b)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    secs, losses = [], []
    for b in batches:
        (params, state, loss), sec = _sync_time(lambda: step(params, state, b))
        secs.append(sec)
        losses.append(float(loss))
    launches = dict(ops.LAUNCHES)
    path_launches[f"train {TRAIN_ARCH}"] = launches
    counts_ok("train step", launches, 2 * layers, {})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train step losses {losses}")
    res["train"] = {"s_per_step": secs, "losses": losses, "peak_gb": _peak_gb(),
                    "launches": launches, "tokens": 4 * 128,
                    "flop_bound_ms": 6 * n_params * 512 / 989e12 * 1e3,
                    "profile": profile_call(lambda: step(params, state, batches[0]))}
    log(f"[train] {TRAIN_ARCH} {n_params:,} params bf16, AdamW, batch 4 x 128: "
        f"s/step {' '.join(f'{x:.4f}' for x in secs)} (6 N tokens at 989 TFLOP/s: "
        f"{res['train']['flop_bound_ms']:.2f} ms), losses {losses}, peak "
        f"{res['train']['peak_gb']:.2f} GB, launches {launches}")
    log_profile("AdamW step (a third, profiled)", res["train"]["profile"])
    del state, opt, step
    torch.cuda.empty_cache()
    lap("11 train step")
    res["counted_step"] = counted_step(dev, cfg, model, params, batches[0], path_launches)
    lap("13 (a) counted step")

    # the federation: Alg. 3 on the card (one greedy launch), 2 mediators
    streams, counts = fl_client_streams(dev)
    ops.reset_launches()
    meds = scheduling.reschedule(counts, gamma=FL_GAMMA, device=dev)
    sched = dict(ops.LAUNCHES)
    path_launches["fl schedule"] = sched
    if len(meds) != 2 or sched["kld_greedy_picks"] != 1:
        raise AssertionError(f"Alg. 3: {len(meds)} mediators, launches {sched}")
    tokens, labels, w, per_med = fl_train.pack_mediators(meds, streams, counts, FL_SEQ, 2)
    steps_per_round = 2 * per_med

    def eval_loss(p):
        with torch.no_grad():
            return float(T.forward_train(model, {"tokens": tokens[:2], "labels": labels[:2]},
                                         p)[0])

    def ledger(adapter_bytes):
        meter = CommMeter(n_params, bytes_per_param=2)
        meter.adapter_payload_bytes = adapter_bytes
        meter.astraea_round(FL_CLIENTS, FL_GAMMA)
        meter.end_round()
        return meter

    # (b) LoRA rank 16: only the adapter state trains and rides the WAN
    mapping = T.adapter_mapping(cfg, LORA_RANK)
    leg = lora.exchange_nbytes(mapping, 2)
    if lora.num_trainable_params(mapping) != LORA_TRAINABLE or leg != LORA_LEG_BYTES:
        raise AssertionError(f"rank {LORA_RANK}: {lora.num_trainable_params(mapping)} "
                             f"trainable, {leg} bytes a leg")
    a_tree = lora.init_adapter_A(lora.A_SALT, mapping, dev)
    ad_state = lora.init_adapter_state(mapping, params)
    fl = steps.make_fl_round(model, 2, learning_rate=FL_LR, local_steps=per_med,
                             lora_mapping=mapping)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with HeldEq6() as held:
        ad_state, sec = _sync_time(lambda: fl(params, a_tree, ad_state, tokens, labels, w))
    sec -= held.seconds
    launches = dict(ops.LAUNCHES)
    path_launches[f"lora round {TRAIN_ARCH}"] = launches
    counts_ok("LoRA round", launches, steps_per_round * layers, {"fedavg_agg": 1})
    meter = ledger(leg)
    loss = eval_loss(lora.merge_params(params, a_tree, ad_state, mapping))
    ratio = meter.adapter_reduction_ratio
    if not math.isfinite(loss) or abs(ratio - leg / (2 * n_params)) > 1e-12:
        raise AssertionError(f"LoRA round: loss {loss}, ratio {ratio}")
    one_step = steps.make_fl_round(model, 1, learning_rate=FL_LR, local_steps=1,
                                   lora_mapping=mapping)
    res["lora_round"] = {"s_per_round": sec, "loss": loss, "peak_gb": _peak_gb(),
                         "launches": launches, "trainable": LORA_TRAINABLE,
                         "eq6_held": {"calls": held.calls, "worst_rel": held.worst},
                         "leg_bytes": leg, "ratio": ratio, "ledger": meter.ledger_totals(),
                         "profile": profile_call(lambda: one_step(
                             params, a_tree, ad_state, tokens[:1], labels[:1], w[:1]))}
    log(f"[fl] LoRA rank {LORA_RANK} round, 2 mediators x {per_med} steps: "
        f"{sec:.3f} s, loss {loss:.4f}, peak {_peak_gb():.2f} GB, launches {launches}; "
        f"Eq. 6 held to its plain version: {held.calls} call, worst {held.worst:.2e} "
        f"of the deltas' scale")
    log(f"[fl] LoRA WAN: {LORA_TRAINABLE:,} trainable, {leg:,} B a leg (full "
        f"{2 * n_params:,}), adapter/full ratio {ratio:.6f}; ledger {meter.ledger_totals()}")
    log_profile("LoRA round of one mediator and one step (profiled)",
                res["lora_round"]["profile"])
    del a_tree, ad_state, fl, one_step
    torch.cuda.empty_cache()
    lap("11 LoRA round")

    # (c) full delta: each mediator's weights in bf16, Eq. 6 leaf by leaf
    largest = max(p.numel() for p in params.values())
    if largest != TRAIN_LARGEST_LEAF:
        raise AssertionError(f"largest leaf {largest}, phase 3 checks {TRAIN_LARGEST_LEAF}")
    fl = steps.make_fl_round(model, 2, learning_rate=FL_LR, local_steps=per_med)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with HeldEq6() as held:
        new, sec = _sync_time(lambda: fl(params, tokens, labels, w))
    sec -= held.seconds
    launches = dict(ops.LAUNCHES)
    path_launches[f"full-delta round {TRAIN_ARCH}"] = launches
    counts_ok("full-delta round", launches, steps_per_round * layers,
              {"fedavg_agg": len(params)})
    meter = ledger(None)
    loss = eval_loss(new)
    moved = max(float((new[k].float() - params[k].float()).abs().max()) for k in params)
    if not math.isfinite(loss) or moved == 0.0:
        raise AssertionError(f"full-delta round: loss {loss}, largest update {moved}")
    one_step = steps.make_fl_round(model, 1, learning_rate=FL_LR, local_steps=1)
    res["full_round"] = {"s_per_round": sec, "loss": loss, "peak_gb": _peak_gb(),
                         "launches": launches, "ledger": meter.ledger_totals(),
                         "largest_update": moved,
                         "eq6_held": {"calls": held.calls, "worst_rel": held.worst},
                         "profile": profile_call(lambda: one_step(
                             params, tokens[:1], labels[:1], w[:1]))}
    log(f"[fl] full-delta round, 2 mediators x {per_med} steps: {sec:.3f} s, loss "
        f"{loss:.4f}, peak {_peak_gb():.2f} GB, fedavg_agg launches "
        f"{launches['fedavg_agg']} (one a leaf), WAN {meter.total_bytes:,.0f} B "
        f"(adapter round: {res['lora_round']['ledger']['wan_bytes_total']:,.0f} B); "
        f"Eq. 6 held to its plain version: {held.calls} calls, worst {held.worst:.2e}")
    log_profile("full-delta round of one mediator and one step (profiled)",
                res["full_round"]["profile"])
    del fl, one_step
    torch.cuda.empty_cache()
    lap("11 full-delta round")

    # phase 15 (b): the same round tensor-parallel over a model axis of 2,
    # from the same start and inputs, held to (c)'s t=1 round
    tp_seen: dict = {}
    res["tp_round"] = tp_round_check(dev, model, params, new, moved, (tokens, labels, w),
                                     per_med, steps_per_round, eval_loss, path_launches,
                                     tp_seen, smi)
    torch.cuda.empty_cache()
    hold_unchecked(dev, gen, tp_seen, checks, f"train {TRAIN_ARCH} TP round")
    lap("15 (b) qwen3-4b TP round")
    # phase 16 (c): the same round over two mediator rows, one mediator each
    res["mediator_rows_round"] = mediator_rows_round_check(
        dev, model, params, new, (tokens, labels, w), per_med, steps_per_round,
        path_launches, smi)
    del new, model, params
    torch.cuda.empty_cache()
    lap("16 (c) qwen3-4b mediator rows round")

    # (d) the SSD families at full width, their SSD gradient on the card's
    # backward kernel; Hymba's LoRA round over the same 2 mediators, their
    # clients' tokens mapped into its vocab (the topic bands kept)
    seen: dict = {}
    hy_vocab = configs.get("hymba-1.5b").vocab
    hy_streams = [t * hy_vocab // cfg.vocab for t in streams]
    hy_tokens, hy_labels, hy_w, _ = fl_train.pack_mediators(meds, hy_streams, counts, FL_SEQ, 2)
    res["hymba"] = train_family(dev, "hymba-1.5b", HYMBA_PARAMS, 128, seen, path_launches,
                                fl_data=(hy_tokens, hy_labels, hy_w, per_med), tp="f",
                                smi=smi, lap=lap)
    # mamba2's steps at 4 x 512, then (phase 15 (e)) a full-delta round
    # over the same 2 mediators at t=2 in bf16, then at t=1 and at t=2 on
    # fp32 weights (tp_family_round)
    mb_vocab = configs.get("mamba2-370m").vocab
    mb_streams = [t * mb_vocab // cfg.vocab for t in streams]
    mb_tokens, mb_labels, mb_w, _ = fl_train.pack_mediators(meds, mb_streams, counts, FL_SEQ, 2)
    res["mamba2"] = train_family(dev, "mamba2-370m", MAMBA2_PARAMS, 512, seen, path_launches,
                                 fl_data=(mb_tokens, mb_labels, mb_w, per_med),
                                 lora_round=False, tp="e", smi=smi, lap=lap)

    # (e) the MoE, audio and VLM families at full width, 4 x 128: granite's
    # steps and a LoRA round over the same 2 mediators (its adapters batched
    # over the layers and the experts), whisper's and internvl2's steps
    # (make_fl_round feeds a mediator only tokens and labels, as the
    # reference's does: neither can take its frames or vision tokens).
    # granite trains at the standard fan-in (``to_fan_in``): at the
    # reference init's 1/sqrt(layers) its round's plain SGD (lr 5e-4, no
    # clipping, as the reference's) meets adapter gradients of 1.7e6 at
    # the first step and NaN at the second; at the fan-in they stay ~0.1
    gr_vocab = configs.get("granite-moe-3b-a800m").vocab
    gr_streams = [t * gr_vocab // cfg.vocab for t in streams]
    gr_tokens, gr_labels, gr_w, _ = fl_train.pack_mediators(meds, gr_streams, counts, FL_SEQ, 2)
    res["granite"] = train_family(dev, "granite-moe-3b-a800m", GRANITE_PARAMS, 128, seen,
                                  path_launches, fl_data=(gr_tokens, gr_labels, gr_w, per_med),
                                  fan_in=True, tp="d", smi=smi, lap=lap)
    res["whisper"] = train_family(dev, "whisper-base", WHISPER_PARAMS, 128, seen, path_launches)
    res["internvl2"] = train_family(dev, "internvl2-1b", INTERNVL2_PARAMS, 128, seen,
                                    path_launches)
    lap("11 whisper-base, internvl2-1b")

    # (f) the launchers at their reduced defaults, LAUNCHER_STEPS steps
    # and two rounds (the script's time limit)
    ops.reset_launches()
    depth = ["--steps", str(LAUNCHER_STEPS)]
    tr = train.main(depth)
    path_launches["launch.train"] = dict(ops.LAUNCHES)
    archs = ("mamba2-370m", "granite-moe-3b-a800m", "whisper-base", "internvl2-1b")
    arch_losses = {}
    for arch in archs:
        ops.reset_launches()
        with recorded_kernel_calls(seen):
            arch_losses[arch] = train.main(["--arch", arch] + depth)["losses"]
        path_launches[f"launch.train {arch}"] = dict(ops.LAUNCHES)
    ops.reset_launches()
    ft = fl_train.main(["--lora-rank", "2", "--rounds", "2"])
    path_launches["launch.fl_train"] = dict(ops.LAUNCHES)
    every = tr["losses"] + ft["losses"] + [x for v in arch_losses.values() for x in v]
    if not all(math.isfinite(x) for x in every):
        raise AssertionError(f"launchers: {tr['losses']} {arch_losses} {ft['losses']}")
    names = ["launch.train"] + [f"launch.train {a}" for a in archs] + ["launch.fl_train"]
    res["launchers"] = {"train_losses": tr["losses"], "arch_train_losses": arch_losses,
                        "fl_losses": ft["losses"], "fl_ratio": ft["ratio"],
                        "launches": {k: path_launches[k] for k in names}}
    log(f"[launch] train (reduced {TRAIN_ARCH}, {LAUNCHER_STEPS} steps): loss "
        f"{tr['losses'][0]:.4f} -> {tr['losses'][-1]:.4f}; "
        + "; ".join(f"train --arch {a} (reduced, {LAUNCHER_STEPS} steps): loss {v[0]:.4f} -> "
                    f"{v[-1]:.4f}" for a, v in arch_losses.items())
        + f"; fl_train --lora-rank 2 (2 rounds): losses {ft['losses']}, ratio "
        f"{ft['ratio']:.4f}; launches " + " / ".join(str(path_launches[k]) for k in names))
    # every kernel signature these runs called, held against its plain
    # version on fresh inputs (the models freed), unless a check did
    res["kernel_signatures"] = [str(key) for key in seen]
    hold_unchecked(dev, gen, seen, checks, "train families")
    lap("11 launchers")
    return res


# ---------------------------------------------------------------- phase 12

# the LoRA rank of phase 12's adapter rounds and the adapter widths it gives
# at the two arms (the reference's lora.build_mapping gives the same:
# tests/test_torch_lora_engine.py); full rank of emnist_cnn(47, 28)
CNN_LORA_RANK, EMNIST_ADAPTER, CINIC_ADAPTER, EMNIST_FULL_RANK = 2, 753, 2_142, 150
# the runs timed in turns at the EMNIST arm, per trainer: (label, lora_rank)
LORA_TURNS = (("full-delta", None), ("rank 2", CNN_LORA_RANK), ("full rank", EMNIST_FULL_RANK))
# the reference's span taxonomy (src/repro/obs/README.md)
TAXONOMY = {"round", "plan_refresh", "reschedule", "pack", "store_stream", "aggregate",
            "wave", "dispatch_gap", "commit", "store_exchange", "commit_lag",
            "store_prefetch"}


def expected_legs_wan(fed, name, payload, rounds=ROUNDS):
    """The WAN ledger after each round when every leg carries ``payload``
    bytes: ``2c`` legs a FedAvg round; ``2(c + ceil(c/gamma))`` an Astraea
    round, plus the Alg. 2 plan broadcast."""
    if name == "FedAvg":
        return [payload * 2 * CLIENTS * (r + 1) for r in range(rounds)]
    plan = 4 * fed.num_classes * fed.num_clients
    legs = 2 * (CLIENTS + math.ceil(CLIENTS / GAMMA))
    return [plan + payload * legs * (r + 1) for r in range(rounds)]


def lora_run(name, fed, dev, make_model, n_params, rank, rounds=ROUNDS, **kw):
    """``rounds`` rounds of a trainer at ``lora_rank=rank`` (None: full
    delta), each timed between two device syncs, with the FL kernels'
    launches counted from 0: one Eq. 6 launch a round, one warp a round
    (Astraea's online plan), one greedy pass (Astraea); one round program,
    captured; the WAN ledger exact at the adapter payload; finite merged
    weights."""
    from repro_torch.kernels import ops
    from repro_torch.models import lora
    tr = fl_trainer(name, fed, dev, make_model, lora_rank=rank, **kw)
    eng = tr.engine
    torch.cuda.synchronize()
    ops.reset_launches()
    secs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
    astraea = name == "Astraea"
    want = {"fedavg_agg": rounds, "affine_warp": rounds if astraea else 0,
            "kld_greedy_picks": 1 if astraea else 0}
    label = f"{name} lora_rank={rank}"
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if eng.num_round_traces != 1 or eng._program.graph is None:
        raise AssertionError(f"{label}: {eng.num_round_traces} round programs, graph "
                             f"{eng._program.graph}; expected one capture")
    payload = 4 * n_params if rank is None else lora.exchange_nbytes(eng._lora_mapping)
    if tr.comm.round_log != expected_legs_wan(fed, name, payload, rounds):
        raise AssertionError(f"{label}: WAN ledger {tr.comm.round_log}")
    merged = eng.merged_params()
    if not all(bool(torch.isfinite(p).all()) for p in merged.values()):
        raise AssertionError(f"{label}: non-finite weights")
    return tr, {"round_seconds": secs, "launches": launches, "leg_bytes": payload,
                "ratio": tr.comm.adapter_reduction_ratio, "width": eng._layout.total}


def phase12(fed, cinic_fed, dev, gen, checks: dict, path_launches: dict, lap) -> dict:
    """Phase 12 (module docstring): the CNN engine's LoRA adapter exchange
    and the round telemetry, through the trainers, on the card, under
    cuDNN's deterministic algorithms (its runs are held to each other bit
    for bit)."""
    with deterministic_convolutions():
        return _phase12(fed, cinic_fed, dev, gen, checks, path_launches, lap)


def _phase12(fed, cinic_fed, dev, gen, checks, path_launches, lap) -> dict:
    from repro_torch.core import AsyncSpec, StragglerSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.metrics_endpoint import MetricsServer
    from repro_torch.models.cnn import cinic_cnn, emnist_cnn
    from repro_torch.obs import (Telemetry, load_jsonl, start_device_trace,
                                 stop_device_trace, validate_events)
    import urllib.request
    out: dict = {"turns": {}}
    emnist = lambda: emnist_cnn(47, 28)                             # noqa: E731
    # Eq. 6 at the adapter widths: FedAvg's 16 rows and Astraea's 4 at
    # EMNIST's, Astraea's 4 at CINIC's, each against its plain version
    eq6 = [check_fedavg(dev, m, n, torch.float32, gen, dummy=False)
           for m, n in ((16, EMNIST_ADAPTER), (4, EMNIST_ADAPTER), (4, CINIC_ADAPTER))]
    checks["fedavg_agg"] += eq6
    out["eq6"] = eq6
    for name in ("FedAvg", "Astraea"):
        rows = []
        for label, rank in LORA_TURNS:
            tr, row = lora_run(name, fed, dev, emnist, 68_873, rank)
            if name == "Astraea" and rank == CNN_LORA_RANK:
                sync = tr               # the sync run async S=0 is held to
            if rank is None:
                full_delta = tr         # the run full rank is held to
            want_width = {None: 68_873, CNN_LORA_RANK: EMNIST_ADAPTER,
                          EMNIST_FULL_RANK: 68_873}[rank]
            if row["width"] != want_width:
                raise AssertionError(f"{name} {label}: Eq. 6 over {row['width']} "
                                     f"columns, expected {want_width}")
            if rank == EMNIST_FULL_RANK:
                if row["ratio"] != 1.0:
                    raise AssertionError(f"{name} full rank: ratio {row['ratio']}")
                if not same_state(tr.engine.merged_params(), full_delta.params):
                    raise AssertionError(f"{name} full rank: merged weights differ "
                                         "from the full-delta run's")
                row["bitwise_full_delta"] = True
            row["label"] = label
            rows.append(row)
            key = f"lora {name} {label}"
            for k, v in row["launches"].items():
                path_launches.setdefault(key, {}).setdefault(k, 0)
                path_launches[key][k] += v
            del tr
        del full_delta
        out["turns"][name] = rows
    lap("12 LoRA EMNIST turns")
    # async S=0 over the adapter state, a wave per mediator behind the 4x
    # straggler: the adapters, merged weights and WAN ledger bit for bit the
    # last sync rank-2 Astraea run's
    spec = AsyncSpec(staleness_bound=0, wave_size=1, straggler=StragglerSpec(**FLEET))
    tr = fl_trainer("Astraea", fed, dev, emnist, lora_rank=CNN_LORA_RANK, async_spec=spec)
    secs, launches = run_timed(tr, label="LoRA async S=0")
    if not (same_state(tr.engine.adapters, sync.engine.adapters)
            and same_state(tr.engine.merged_params(), sync.engine.merged_params())
            and tr.comm.round_log == sync.comm.round_log):
        raise AssertionError("LoRA async S=0 differs from its sync run")
    if launches["fedavg_agg"] != tr.runner.num_commits:
        raise AssertionError(f"LoRA async S=0: launches {launches}, "
                             f"{tr.runner.num_commits} commits")
    out["async_s0"] = {"bitwise": True, "round_seconds": secs, "launches": launches,
                       "commits": tr.runner.num_commits}
    path_launches["lora async S=0"] = dict(launches)
    del tr
    lap("12 LoRA async")
    # one Astraea round at CINIC-10's width, rank 2
    tr, row = lora_run("Astraea", cinic_fed, dev, lambda: cinic_cnn(10, 32, 3, 32),
                       CINIC_PARAMS, CNN_LORA_RANK, rounds=1)
    if row["width"] != CINIC_ADAPTER:
        raise AssertionError(f"CINIC rank 2: width {row['width']}, expected {CINIC_ADAPTER}")
    out["cinic"] = row
    path_launches["lora cinic"] = dict(row["launches"])
    del tr
    torch.cuda.empty_cache()
    lap("12 LoRA CINIC")
    # a traced rank-2 Astraea run: spans under record_function, a device
    # trace around its rounds after the capture, the four artifacts, a live
    # /metrics scrape; bit for bit the untraced sync run, one capture
    trace_dir = ROOT / "build" / "phase12_trace"
    tel = Telemetry(str(trace_dir), profile=True)
    tr, row = lora_run("Astraea", fed, dev, emnist, 68_873, CNN_LORA_RANK, rounds=1,
                       telemetry=tel)
    if not start_device_trace(str(trace_dir)):
        raise AssertionError("start_device_trace: no CUDA profiler activity on the card")
    try:
        for _ in range(ROUNDS - 1):
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            row["round_seconds"].append(time.perf_counter() - t0)
    finally:
        device_trace = stop_device_trace()
    launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
    if launches != {"fedavg_agg": ROUNDS, "kld_greedy_picks": 1, "affine_warp": ROUNDS}:
        raise AssertionError(f"traced run: launches {launches}")
    if not same_state(tr.engine.adapters, sync.engine.adapters) \
            or tr.engine.num_round_traces != 1:
        raise AssertionError(f"telemetry changed the run: {tr.engine.num_round_traces} "
                             "programs, or other bits than the untraced run's")
    paths = tel.flush()
    missing = [k for k, v in paths.items() if not Path(v).is_file()]
    events = load_jsonl(paths["events_jsonl"])
    validate_events(events)
    names = {e["name"] for e in events}
    with open(device_trace) as f:
        device_names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # Astraea reschedules once: rounds 2 and 3 open "round" and "aggregate"
    want_spans, traced_spans = {"round", "reschedule", "pack", "store_stream",
                                "aggregate"}, {"round", "aggregate"}
    if missing or not names <= TAXONOMY or not want_spans <= names \
            or not traced_spans <= device_names:
        raise AssertionError(f"telemetry: missing artifacts {missing}, spans {names}, "
                             f"in the device trace {traced_spans & device_names}")
    with MetricsServer(tel.metrics) as srv:
        scraped = urllib.request.urlopen(srv.url, timeout=10).read().decode()
    if scraped != tel.metrics.to_prometheus():
        raise AssertionError("the /metrics scrape differs from to_prometheus()")
    rounds = [e for e in events if e["name"] == "round"]
    out["telemetry"] = {"round_seconds": row["round_seconds"], "events": len(events),
                        "spans": sorted(names), "device_trace_bytes":
                        Path(device_trace).stat().st_size,
                        "round_span_ms": [e["dur_us"] / 1e3 for e in rounds],
                        "scrape_bytes": len(scraped)}
    path_launches["lora traced"] = launches
    del tr, sync
    lap("12 telemetry")
    return out


def log_phase12(p12: dict) -> None:
    for name, rows in p12["turns"].items():
        for r in rows:
            ratio = "n/a" if r["ratio"] is None else f"{r['ratio']:.6f}"
            log(f"[lora] EMNIST {name:7s} {r['label']:10s}: Eq. 6 over {r['width']:,} "
                f"columns, {r['leg_bytes']:,} B a leg (ratio {ratio}), s/round "
                f"{' '.join(f'{x:.4f}' for x in r['round_seconds'])} (first includes the "
                f"capture), launches {r['launches']}")
    c = p12["cinic"]
    log(f"[lora] CINIC-10 Astraea rank 2: Eq. 6 over {c['width']:,} columns, "
        f"{c['leg_bytes']:,} B a leg (ratio {c['ratio']:.6f} of {4 * CINIC_PARAMS:,} B), "
        f"round {c['round_seconds'][0]:.4f} s (with the capture), launches {c['launches']}")
    a = p12["async_s0"]
    log(f"[lora] async S=0 rank 2: bitwise equal to its sync run; {a['commits']} commits, "
        f"launches {a['launches']}; s/round {' '.join(f'{x:.4f}' for x in a['round_seconds'])}")
    for r in p12["eq6"]:
        device = "n/a" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        log(f"[lora] Eq. 6 {r['shape']}: kernel {r['ms']:.4f} ms (device {device}), "
            f"plain {r['plain_ms']:.4f}, `wn @ d` {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.6f} ({r['bound_by']}), err {r['max_abs_err']:.3e}")
    t = p12["telemetry"]
    log(f"[obs] traced rank-2 Astraea (profile=True; device trace over rounds 2-3): s/round "
        f"{' '.join(f'{x:.4f}' for x in t['round_seconds'])}, round spans "
        f"{' '.join(f'{x:.2f}' for x in t['round_span_ms'])} ms, {t['events']} events, "
        f"spans {t['spans']}, device trace {t['device_trace_bytes']:,} B, /metrics "
        f"scrape {t['scrape_bytes']:,} B equal to to_prometheus()")


# ---------------------------------------------------------------- phase 13

# the memory estimate's limit against the measured peak, and the card whose
# bytes the dry run's layouts are sized for
MEM_TOLERANCE, CARD_BYTES = 0.25, 80e9


def _by_op_sum(*costs) -> dict:
    out: dict = {}
    for c in costs:
        for k, v in c.by_op.items():
            row = out.setdefault(k, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            for f in row:
                row[f] += v[f]
    return out


def counted_step(dev, cfg, model, params, batch, path_launches: dict) -> dict:
    """Phase 13 (a): one qwen3-4b AdamW step at 4 x 128 on phase 11's model,
    counted on the card by ``roofline.step_costs`` (the kernels' launches
    reset just before and read just after), against the dry run's count of
    the same step on meta (``launch.dryrun.run_one`` on the one-card mesh,
    its optimizer): the FLOPs and the kernel charges must be equal, the
    launches the charges, and the dry run's per-device bytes within
    ``MEM_TOLERANCE`` of the step's measured peak.  Aten ops whose byte
    proxy differs (another aten path on the card) are printed.  Then one
    uncounted step, timed: its share of the bf16 peak, by ``model_flops``
    and by the counted FLOPs."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adam
    from repro_torch.roofline import HW, model_flops, step_costs
    shape = configs.InputShape("phase13", 128, 4, "train")
    t0 = time.perf_counter()
    rec = dryrun.run_one(TRAIN_ARCH, shape, mesh=make_host_mesh(), cfg=cfg, keep_meta=True)
    meta_s = time.perf_counter() - t0
    grad, update = rec["meta"]["grad"], rec["meta"]["update"]
    opt = adam(1e-4)                              # the dry run's optimizer
    step = steps.make_train_step(model, opt)
    batch = {k: batch[k].to(torch.int32) for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    others = torch.cuda.memory_allocated() - param_bytes   # not the step's
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    card = step_costs(step, params, state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    path_launches[f"counted step {TRAIN_ARCH}"] = launches
    peak = torch.cuda.max_memory_allocated() - others
    _, sec = _sync_time(lambda: step(params, state, batch))
    meta_kernels = rec["counted_costs"]["kernels"]
    meta_flops = grad.flops + update.flops
    if card.kernels != meta_kernels or card.flops != meta_flops:
        raise AssertionError(f"card count {card.flops} {card.kernels} != meta count "
                             f"{meta_flops} {meta_kernels}")
    if {k: v for k, v in launches.items() if v} != card.launches:
        raise AssertionError(f"launches {launches} != charges {card.launches}")
    est = rec["memory"]["peak_estimate_bytes"]
    ratio = est / peak
    if abs(ratio - 1.0) > MEM_TOLERANCE:
        raise AssertionError(f"dry-run estimate {est} B against the measured peak {peak} B: "
                             f"ratio {ratio:.3f}")
    meta_ops = _by_op_sum(grad, update)
    pairs = {k: tuple(ops_.get(k, {}).get("bytes", 0.0) for ops_ in (card.by_op, meta_ops))
             for k in set(card.by_op) | set(meta_ops)}
    differ = {k: v for k, v in sorted(pairs.items()) if v[0] != v[1]}
    mflops = model_flops(cfg, 4 * 128, "train")
    peak_flops = HW().peak_flops
    res = {"meta_s": meta_s, "counted_s": counted_s, "s_per_step": sec,
           "flops": card.flops, "meta_flops": meta_flops, "kernels": card.kernels,
           "bytes": card.bytes, "meta_bytes": grad.bytes + update.bytes,
           "bytes_differ": differ, "model_flops": mflops,
           "model_flops_share": mflops / (sec * peak_flops),
           "counted_flops_share": card.flops / (sec * peak_flops),
           "estimate_bytes": est, "measured_peak_bytes": peak, "other_bytes": others,
           "estimate_over_peak": ratio, "memory": rec["memory"]}
    del state, opt, step
    torch.cuda.empty_cache()
    log(f"[phase13] (a) {TRAIN_ARCH} AdamW step, 4 x 128 bf16: counted on the card "
        f"{card.flops:.6e} FLOPs, kernels {card.launches} == the dry run's meta count "
        f"({meta_s:.1f} s on meta, {counted_s:.2f} s counted on the card); a step "
        f"uncounted {sec:.4f} s: model_flops {mflops:.6e} -> "
        f"{100 * res['model_flops_share']:.2f} % of 989 TFLOP/s, counted "
        f"{100 * res['counted_flops_share']:.2f} %")
    log(f"[phase13] (a) memory: dry-run estimate {est / 1e9:.3f} GB per device "
        f"({json.dumps({k: v for k, v in rec['memory'].items() if k.endswith('bytes')})}), "
        f"measured peak {peak / 1e9:.3f} GB (max_memory_allocated less {others / 1e9:.3f} GB "
        f"of earlier phases' tensors), ratio {ratio:.4f} (limit 1 +- {MEM_TOLERANCE})")
    log(f"[phase13] (a) bytes proxy: card {card.bytes:.6e}, meta {res['meta_bytes']:.6e}; "
        f"ops that differ (card, meta): {differ}")
    return res


def phase13(dev, counted: dict, path_launches: dict, lap) -> dict:
    """(b) the quickstart twin on the card at its full config: it launches
    each FL kernel, and its WAN MiB equal the closed forms; (c) the dry run
    on meta of grok-1-314b and qwen1.5-110b ``train_4k`` on the single-pod
    production mesh: each device's state bytes and the 80 GB cards each
    layout needs.  (a) ran in phase 11 (``counted_step``)."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):       # its table, off the result lines
        q = quickstart.main(["--device", "cuda"])
    q_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    path_launches["quickstart"] = launches
    missing = [k for k in FL_KERNELS if launches[k] < 1]
    w = 4 * q["num_params"]
    c, g, rounds = quickstart.PER_ROUND, quickstart.GAMMA, quickstart.ROUNDS
    plan = 4 * q["num_classes"] * q["num_clients"]
    # each evaluated round's cumulative ledger
    want_f = [h["round"] * 2 * c * w / 2 ** 20 for h in q["fedavg"]]
    want_a = [(plan + h["round"] * 2 * w * (c + math.ceil(c / g))) / 2 ** 20
              for h in q["astraea"]]
    got_f = [h["traffic_mb"] for h in q["fedavg"]]
    got_a = [h["traffic_mb"] for h in q["astraea"]]
    acc = [h["accuracy"] for h in q["fedavg"] + q["astraea"]]
    if missing or got_f != want_f or got_a != want_a or not all(map(math.isfinite, acc)):
        raise AssertionError(f"quickstart: launches {launches}, WAN {got_f} {got_a} against "
                             f"{want_f} {want_a}, accuracy {acc}")
    log(f"[phase13] (b) quickstart twin, {rounds} rounds a trainer: {q_s:.1f} s, launches "
        f"{launches}; WAN MiB FedAvg {got_f[-1]} Astraea {got_a[-1]} (closed forms exact); "
        f"top-1 FedAvg {q['fedavg'][-1]['accuracy']:.4f} Astraea {acc[-1]:.4f}")
    lap("13 (b) quickstart")
    dry = {}
    for arch in ("grok-1-314b", "qwen1.5-110b"):
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, "train_4k")
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} train_4k: {rec}")
        m, cards = rec["memory"], rec["cards_80gb"]
        state = m["param_bytes"] + m["grad_bytes"] + m["opt_bytes"]
        dry[f"{arch} {rec['mesh']}"] = {"s": time.perf_counter() - t0, "memory": m,
                                         "cards_80gb": cards, "state_bytes": state,
                                         "roofline": rec["roofline"]}
        log(f"[phase13] (c) dry run {arch} train_4k {rec['mesh']} ({rec['n_chips']} devices, "
            f"{rec['counted_costs']['microbatches']} microbatches, "
            f"{time.perf_counter() - t0:.1f} s on meta): state {state / 1e9:.3f} GB a device "
            f"(params {m['param_bytes'] / 1e9:.3f}, grads {m['grad_bytes'] / 1e9:.3f}, AdamW "
            f"{m['opt_bytes'] / 1e9:.3f}), activations (estimate) "
            f"{m['activation_bytes_estimate'] / 1e9:.3f} GB; 80 GB cards for the state: "
            + ", ".join(f"{layout} {c['cards']} {c['mesh']} ({c['microbatches']} "
                        f"microbatches, {c['per_device_bytes'] / 1e9:.3f} GB)"
                        for layout, c in cards.items()))
    lap("13 (c) dry runs")
    return {"counted_step": counted, "quickstart": {"s": q_s, "launches": launches,
                                                    "wan_mib": [got_f, got_a], "accuracy": acc},
            "dry_runs": dry}


# ---------------------------------------------------------------- phase 14

P14_SHARDS, P14_PROCESSES, P14_CHILD_TIMEOUT_S = 4, 2, 300
# phase 15: the model axis's size.  TP rows at the EMNIST arm against the
# gather oracle after two rounds, in L2 over the parameters relative to the
# two rounds' update: only the order of the input gradient's all-reduce
# differs (each output channel's sum is the whole layer's): 4.545e-7 on an
# H100 (700 W)
P15_T, P15_ARM_BOUND = 2, 1e-5
# qwen3-4b's TP round at t=2 against its t=1 round: the round's update
# (new - start, fp32) in L2 relative to the t=1 round's.  A round that
# applies no update reads 1; the t=1 round with its gradient negated, run
# beside it, reads 1.977 on an H100 (700 W).  The round moves 1.06 M of
# the 4.0 G bf16 weights by single ulps, and a gradient rounded the other
# way near half an ulp moves an element or leaves it: 392,907 elements
# differ there and the TP round reads 0.345.  The TP backward's
# maths is held on its own: one microbatch's gradient through qwen3-4b at
# full width, cut to 2 layers, in fp32 (TF32 off), TP against the whole
# model, in L2 over every weight and in the worst leaf: 5.2e-6 and 7.0e-6
# there (sums reordered at 2,560 and 9,728 wide); a zero gradient reads 1
P15_DELTA_BOUND, P15_GRAD_LAYERS, P15_GRAD_BOUND = 0.5, 2, 1e-4
# phase 15 (d)-(f) hold a round pair on fp32 weights (t=1 and t=2 from
# one fp32 start): fp32 sums reordered, 6.97e-6 (granite), 5.54e-4
# (mamba2) and 7.05e-4 (hymba at the reference's init) on an H100 (700 W);
# the t=1 round with its gradient negated reads 2.00 there
P15_DELTA_BOUND_F32 = 1e-2
# phase 16 (a): "vmap" against "map" at the EMNIST arm, in L2 relative to
# the update, the bound the card's round tests hold the engine's "vmap" to
P16_VMAP_BOUND = 1e-4


def phase15a(fed, dev, smi: str, four: dict, path_launches: dict) -> dict:
    """Phase 15 (a), the model axis at phase 5's EMNIST arm under cuDNN's
    deterministic algorithms, on a 2 x 2 ``(mediator, model)`` mesh of four
    logical positions on the card: three Astraea rounds with a reschedule
    each under the gather oracle (``tp_rows=False``) over the replicated
    and the sharded store, each bit for bit the sharded store's run on the
    2 x 1 mesh (each mediator row a round program of ``M_pad / 2`` rows on
    both: a lockstep program's bits follow its width; the stores agree bit
    for bit, phase 14 (a)), its WAN ledger phase 14
    (a)'s 4 x 1 run's (``four``), one capture a mediator row, the split
    leaves' bytes a position half the 4 x 1's (the 47-class head, which
    the rules leave whole, whole), the model axis charged to the
    intra-pod ledger at 2 x 2 only; async S=0 (masked, a wave per
    mediator) over the sharded store bit for bit the sync 2 x 2 run; TP rows (``"auto"`` on the
    card; phase 16 (b): each mediator row on its own two columns), one
    capture a mediator row: after
    two rounds at the reference's own config (``tests/test_tp_rows.py``'s
    tiny federation) within 1e-5 relative and 1e-6 absolute of the
    oracle's two rounds (the reference's bound), and at the EMNIST arm
    within ``P15_ARM_BOUND`` of the oracle, in L2 over the parameters
    relative to the two rounds' update; seconds a round of each."""
    from repro_torch.core import AsyncSpec, StragglerSpec
    from repro_torch.launch.mesh import make_fl_mesh, model_devices
    from repro_torch.models.cnn import emnist_cnn, init_params
    tag = f"[phase15] ({smi}; logical positions on one card: device copies, not NVLink)"
    mesh = make_fl_mesh(mediator=2, model=P15_T, devices=(dev,) * (2 * P15_T))
    mesh21 = make_fl_mesh(mediator=2, model=1, devices=(dev,) * 2)
    res: dict = {"card": smi}

    def run(label, rounds=ROUNDS, snapshot_after=None, at=mesh, **kw):
        tr = p10_trainer(fed, dev, mesh=at, reschedule_every_round=True, **kw)
        from repro_torch.kernels import ops
        torch.cuda.synchronize()
        ops.reset_launches()
        secs, snap = [], None
        for r in range(rounds):
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if snapshot_after == r + 1:
                snap = {k: v.clone() for k, v in tr.params.items()}
        if tr.runner is not tr.engine:
            tr.runner.flush()
        torch.cuda.synchronize()
        launches = {k: ops.LAUNCHES[k] for k in FL_KERNELS}
        path_launches[f"15 (a) {label}"] = launches
        n = tr.engine.mesh.shape["mediator"]
        if launches != {"fedavg_agg": rounds, "kld_greedy_picks": rounds,
                        "affine_warp": n * rounds}:
            raise AssertionError(f"phase 15 (a) {label}: launches {launches}")
        rows_on_positions(tr, n, f"phase 15 (a) {label}")
        res[label] = {"round_seconds": secs, "launches": launches,
                      "tp_rows": tr.engine._tp_rows,
                      "per_position_param_bytes":
                          tr.engine.store.stats()["per_device_param_bytes"],
                      "model_axis_bytes": tr.comm.model_axis_tp_bytes,
                      "intra_pod_bytes": tr.comm.intra_pod_bytes}
        log(f"{tag} (a) {label}: s/round {' '.join(f'{x:.4f}' for x in secs)}, launches "
            f"{launches}, one capture, param bytes a position "
            f"{res[label]['per_position_param_bytes']:,}, model-axis bytes "
            f"{tr.comm.model_axis_tp_bytes:,.0f} (intra-pod ledger)")
        return tr, snap

    with deterministic_convolutions():
        rep, snap2 = run("2x2 replicated oracle", tp_rows=False, snapshot_after=2)
        sharded, _ = run("2x2 sharded oracle", tp_rows=False, store="sharded")
        # the stores agree bit for bit (phase 14 (a)), so one 2 x 1 run, of
        # the sharded store, holds both 2 x 2 runs
        sharded21, _ = run("2x1 sharded", at=mesh21, store="sharded")
        for tr, name in ((rep, "replicated"), (sharded, "sharded ragged")):
            want = four[name]
            if not same_params(tr, sharded21):
                raise AssertionError(f"phase 15 (a): 2 x 2 {name} differs from the 2 x 1 "
                                     f"sharded run")
            if tr.comm.round_log != want["round_log"]:
                raise AssertionError(f"phase 15 (a): {name} WAN ledger {tr.comm.round_log}")
            if not tr.comm.model_axis_tp_bytes > 0:
                raise AssertionError(f"phase 15 (a): {name} charged no model-axis bytes")
        if four["replicated"]["intra_pod"] != 0:
            raise AssertionError("phase 15 (a): 4 x 1 replicated charged intra-pod bytes")
        eng = rep.engine
        whole = four["replicated"]["param_bytes"]
        for k, dim in eng._dims.items():
            held = eng._shards.positions[0][k].nbytes
            if held * (P15_T if dim is not None else 1) != eng.params[k].nbytes:
                raise AssertionError(f"phase 15 (a): {k} holds {held} B a position")
        split = sum(v.nbytes for k, v in eng.params.items() if eng._dims[k] is not None)
        got = eng.store.stats()["per_device_param_bytes"]
        if got != whole - split // P15_T:
            raise AssertionError(f"phase 15 (a): {got} B a position of {whole}")
        res["param_bytes"] = {"per_position": got, "replica": whole, "split": split,
                              "ratio": got / whole}
        log(f"{tag} (a) 2 x 2 (replicated and sharded stores) == 2 x 1 (sharded) bit for "
            f"bit, WAN "
            f"ledgers 4 x 1's; param bytes a position {got:,} of the replica's {whole:,} "
            f"({got / whole:.4f}: the split leaves' {split:,} B halve, the 47-class head "
            f"stays whole as the rules leave it)")
        spec = AsyncSpec(staleness_bound=0, wave_size=1, dispatch="masked",
                         straggler=StragglerSpec(**FLEET))
        asy, _ = run("2x2 async S=0 sharded oracle", tp_rows=False, store="sharded",
                     async_spec=spec)
        if not same_params(asy, sharded):
            raise AssertionError("phase 15 (a): async S=0 over the sharded store on 2 x 2 "
                                 "differs from the sync run")
        res["async_store_exchange_bytes"] = asy.comm.store_exchange_bytes
        tp, _ = run("2x2 TP rows", rounds=2, tp_rows="auto")
        if not tp.engine._tp_rows:
            raise AssertionError("phase 15 (a): tp_rows='auto' did not resolve on the card")
        # phase 16 (b): each mediator row's TP rows on its own model columns
        columns = [tuple(p.model.devices) for p in tp.engine._programs]
        if columns != [model_devices(mesh, i) for i in range(2)]:
            raise AssertionError(f"phase 16 (b): TP rows on {columns}")
        init = init_params(emnist_cnn(47, 28), 0, dev)

        def flat(p):
            return torch.cat([p[k].flatten() for k in init])
        update = float((flat(snap2) - flat(init)).norm())
        rel = float((flat(tp.params) - flat(snap2)).norm()) / update
        if not rel <= P15_ARM_BOUND:
            raise AssertionError(f"phase 15 (a): TP rows lie {rel:.3e} of the update from the "
                                 f"oracle (bound {P15_ARM_BOUND})")
        ref_cfg = tp_rows_at_reference_config(dev)
        res["tp_vs_oracle"] = {"rel_l2": rel, "bound": P15_ARM_BOUND,
                               "max_abs": float((flat(tp.params) - flat(snap2)).abs().max()),
                               "reference_config": ref_cfg}
        log(f"{tag} (a) async S=0 over the sharded store bitwise its sync run (store_exchange "
            f"{asy.comm.store_exchange_bytes:,.0f} B, once a wave); TP rows after 2 rounds at the "
            f"EMNIST arm: {rel:.3e} of the update from the oracle in L2 (bound "
            f"{P15_ARM_BOUND}; max abs {res['tp_vs_oracle']['max_abs']:.3e}); at the "
            f"reference's config (tiny federation) within "
            f"rtol 1e-5 atol 1e-6 of the oracle: largest |diff| {ref_cfg['max_abs']:.3e}, "
            f"worst {ref_cfg['worst_over_bound']:.3f} of the bound, s/round TP "
            f"{' '.join(f'{x:.4f}' for x in ref_cfg['tp_round_seconds'])}")
        log(f"[phase16] ({smi}; logical positions on one card) (b) the 2 x 2 TP rows above: "
            f"each mediator row a round program and a graph on its own two columns, "
            f"{rel:.3e} of the oracle's update in L2 (bound {P15_ARM_BOUND}), s/round "
            f"{' '.join(f'{x:.4f}' for x in res['2x2 TP rows']['round_seconds'])}")
    return res


def tp_rows_at_reference_config(dev) -> dict:
    """TP rows against the gather oracle at ``tests/test_tp_rows.py``'s
    config (12 clients, 8 classes, 16 px, c=6, gamma=3, B=10, E=1, Adam
    1e-3, seed 0) on a 2 x 2 mesh of logical positions, two rounds under
    "vmap": within the reference's rtol 1e-5, atol 1e-6."""
    from repro_torch.core import EngineConfig, FLRoundEngine, LocalSpec
    from repro_torch.data.federated import EMNIST_LIKE, partition
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models.cnn import emnist_cnn
    from repro_torch.optim import adam
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=8, image_size=16),
                    num_clients=12, total_samples=600, test_samples=160, sizes="instagram",
                    global_dist="letterfreq", local="random", seed=0)
    mesh = make_fl_mesh(mediator=2, model=P15_T, devices=(dev,) * (2 * P15_T))
    engines, secs = {}, []
    for mode in ("auto", False):
        cfg = EngineConfig.astraea(clients_per_round=6, gamma=3, local=LocalSpec(10, 1),
                                   seed=0, pad_mediators_to=2, tp_rows=mode)
        e = FLRoundEngine(emnist_cnn(8, 16), adam(1e-3), fed, cfg, mesh=mesh, device=dev)
        for _ in range(2):
            t0 = time.perf_counter()
            e.run_round()
            torch.cuda.synchronize()
            if mode == "auto":
                secs.append(time.perf_counter() - t0)
        engines[mode] = e
    tp, oracle = engines["auto"], engines[False]
    if not tp._tp_rows or tp.num_round_traces != 2:       # one a mediator row
        raise AssertionError("phase 15 (a): the reference config's TP engine")
    worst = 0.0
    for k, want in oracle.params.items():
        got = tp.params[k]
        worst = max(worst, float(((got - want).abs() / (1e-6 + 1e-5 * want.abs())).max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=k)
    return {"worst_over_bound": worst, "tp_round_seconds": secs,
            "max_abs": max(float((tp.params[k] - v).abs().max())
                           for k, v in oracle.params.items())}


def tp_round_check(dev, model, params, new, moved, batch, per_med, steps_per_round,
                   eval_loss, path_launches, seen, smi) -> dict:
    """Phase 15 (b), inside phase 11: qwen3-4b's full-delta round
    tensor-parallel over a model axis of ``P15_T`` logical positions on the
    card, from phase 11 (c)'s start and inputs, held to its t=1 round
    ``new``: the round's update within ``P15_DELTA_BOUND`` of the t=1
    round's in L2 (elements each round moves counted), and the gradient
    of the first microbatch through qwen3-4b cut to ``P15_GRAD_LAYERS``
    layers in fp32, tensor-parallel, within ``P15_GRAD_BOUND`` of the
    whole model's (overall and in every leaf); flash forward and backward launches
    ``P15_T`` times (c)'s (each position's heads, H/t : KV/t), one
    ``fedavg_agg`` a shard of each split leaf and one a whole leaf, each
    held to its plain version (``HeldEq6``); per-shard Eq. 6 bit for bit
    the whole leaf's on three leaves (split along dims 0 and 1); seconds,
    peak GB; its kernel signatures recorded in ``seen``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import model_axis, sharding, steps
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models import transformer as T
    tag = f"[phase15] ({smi}; logical positions on one card: device copies, not NVLink)"
    tokens, labels, w = batch
    cfg = model.cfg
    mesh = make_fl_mesh(mediator=1, model=P15_T, devices=(dev,) * P15_T)
    dims = sharding.placements(T.param_specs(cfg, model.max_seq), mesh)
    fl = steps.make_fl_round(model, 2, learning_rate=FL_LR, local_steps=per_med, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with HeldEq6() as held, recorded_kernel_calls(seen):
        got, sec = _sync_time(lambda: fl(params, tokens, labels, w))
    sec -= held.seconds
    launches = dict(ops.LAUNCHES)
    path_launches[f"15 (b) TP round {TRAIN_ARCH}"] = launches
    flash = P15_T * steps_per_round * cfg.n_layers
    n_eq6 = sum(P15_T if dims[k] is not None else 1 for k in params)
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(flash_attention=(2 if cfg.remat else 1) * flash, flash_attention_bwd=flash,
                fedavg_agg=n_eq6)
    if launches != want:
        raise AssertionError(f"TP round: launches {launches}, expected {want}")
    loss = eval_loss(got)
    diff = max(float((got[k].float() - new[k].float()).abs().max()) for k in params)
    n_diff = sum(int((got[k] != new[k]).sum()) for k in params)
    n_all = sum(p.numel() for p in params.values())
    moved_t1 = sum(int((new[k] != params[k]).sum()) for k in params)
    moved_tp = sum(int((got[k] != params[k]).sum()) for k in params)

    def update_rel(out):
        err = norm = 0.0
        for k, p in params.items():
            d1 = new[k].float() - p.float()
            err += float((out[k].float() - p.float() - d1).square().sum())
            norm += float(d1.square().sum())
        return (err / norm) ** 0.5
    delta_rel = update_rel(got)
    if not math.isfinite(loss) or not delta_rel <= P15_DELTA_BOUND:
        raise AssertionError(f"TP round: loss {loss}, its update {delta_rel} of the t=1 "
                             f"round's from it in L2 (bound {P15_DELTA_BOUND})")
    sig = sorted({(k[1], k[2]) for k in seen if k[0] == "flash_attention"})
    del got
    # the check's power: the t=1 round with the gradient negated
    neg_rel = update_rel(steps.make_fl_round(model, 2, learning_rate=-FL_LR,
                                             local_steps=per_med)(params, tokens, labels, w))
    if not neg_rel > P15_DELTA_BOUND:
        raise AssertionError(f"TP round: a round with the gradient negated reads {neg_rel}, "
                             f"within the bound {P15_DELTA_BOUND}")
    # the TP backward's maths: one microbatch's gradient in fp32 at full
    # width, P15_GRAD_LAYERS layers, TP against the whole model
    micro = tokens.shape[0] // 2 // per_med
    grad = tp_grad_check(dev, cfg, {"tokens": tokens[:micro], "labels": labels[:micro]},
                         fan_in=False)
    grad_rel, worst = grad["rel_l2"], (grad["worst_leaf_rel_l2"], grad["worst_leaf"])
    # per-shard Eq. 6 against the whole leaf's, fp32 deltas of two rows
    g = torch.Generator(device=dev).manual_seed(15)
    eq6_bitwise = {}
    for name in ("embed", "layers.0.attn.wq", "layers.0.mlp.w_down"):
        shape = params[name].shape
        d = torch.randn((2,) + tuple(shape), generator=g, device=dev)
        wts = torch.rand(2, generator=g, device=dev) * 100
        whole = ops.fedavg_agg(d.reshape(2, -1), wts).reshape(shape)
        parts = []
        for s in model_axis.split(d, 1 + dims[name], (dev,) * P15_T):
            parts.append(ops.fedavg_agg(s.reshape(2, -1), wts).reshape(s.shape[1:]))
        eq6_bitwise[name] = bool(torch.equal(torch.cat(parts, dims[name]), whole))
        del d, whole, parts
    if not all(eq6_bitwise.values()):
        raise AssertionError(f"per-shard Eq. 6 differs from the whole leaf's: {eq6_bitwise}")
    out = {"s_per_round": sec, "peak_gb": _peak_gb(), "launches": launches, "loss": loss,
           "largest_diff": diff, "largest_update_t1": moved,
           "delta_rel_l2": delta_rel, "delta_bound": P15_DELTA_BOUND,
           "delta_rel_l2_negated_round": neg_rel,
           "grad_rel_l2": grad_rel, "grad_bound": P15_GRAD_BOUND,
           "grad_worst_leaf": {"rel_l2": worst[0], "name": worst[1]},
           "grad_one_partial_dropped": grad["dropped_rel_l2"],
           "elements_moved_t1": moved_t1, "elements_moved_tp": moved_tp,
           "elements_differing": n_diff, "elements": n_all,
           "eq6_held": {"calls": held.calls, "worst_rel": held.worst},
           "eq6_per_shard_bitwise": eq6_bitwise, "flash_signatures": sig}
    log(f"{tag} (b) {TRAIN_ARCH} full-delta round at t={P15_T}, 2 mediators x {per_med} "
        f"steps: {sec:.3f} s, loss {loss:.4f}, peak {out['peak_gb']:.2f} GB, launches "
        f"{launches} (flash {P15_T} x (c)'s, fedavg_agg {n_eq6}: one a shard and one a whole "
        f"leaf, each held to its plain version, worst {held.worst:.2e}); its update "
        f"{delta_rel:.4e} of the t=1 round's from it in L2 (bound {P15_DELTA_BOUND}; no "
        f"update reads 1, the t=1 round with its gradient negated {neg_rel:.4f}): the t=1 "
        f"round moves {moved_t1:,} of {n_all:,} "
        f"elements, the TP round {moved_tp:,}, {n_diff:,} differ, largest |diff| {diff:.3e} "
        f"(the t=1 round's largest update {moved:.3e}); a microbatch's fp32 gradient "
        f"through {P15_GRAD_LAYERS} full-width layers, TP against whole: {grad_rel:.4e} "
        f"in L2, worst leaf {worst[1]} {worst[0]:.4e} (bound {P15_GRAD_BOUND}; with one "
        f"position's partial dropped from every all-reduce {grad['dropped_rel_l2']:.4f}); "
        f"flash at (q, k) {sig}; per-shard Eq. 6 bit for bit the whole leaf's: {eq6_bitwise}")
    return out


def tp_grad_check(dev, cfg, mb: dict, fan_in: bool) -> dict:
    """The TP backward's maths for phase 15: the gradient of one
    microbatch ``mb`` through ``cfg`` at full width cut to
    ``P15_GRAD_LAYERS`` layers, fp32, weights from seed 15 (with
    ``fan_in`` at the standard fan-in, ``to_fan_in``), tensor-parallel over
    ``P15_T`` logical positions against the whole model: in L2 over every
    weight and in the worst leaf, each within ``P15_GRAD_BOUND``; the same
    with one position's partial dropped from every all-reduce (a wrong TP
    forward) must read above it.  The full weights' gradient covers the
    expert shards', the SSM's and the narrowed heads' backward."""
    from repro_torch.launch import model_axis, sharding, steps
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models import transformer as T
    mesh = make_fl_mesh(mediator=1, model=P15_T, devices=(dev,) * P15_T)
    cut = dataclasses.replace(cfg, n_layers=P15_GRAD_LAYERS, dtype="float32")
    small = T.init_model(cut, torch.Generator(device=dev).manual_seed(15), device=dev)
    if fan_in:
        to_fan_in(small)
    whole_p = T.train_params(small)
    sdims = sharding.placements(T.param_specs(cut, small.max_seq), mesh)
    _, want_g = steps._loss_and_grads(lambda p: T.forward_train(small, mb, p)[0], whole_p)
    tree = model_axis.split_tree(whole_p, sdims, (dev,) * P15_T)
    tp = T.TensorParallel(small, sdims, (dev,) * P15_T, dev)

    def rel(got_g):
        err = norm = 0.0
        worst = (0.0, "")
        for k, wg in want_g.items():
            g = got_g[k] if sdims[k] is None else torch.cat(
                [got_g[model_axis.shard_key(k, j)] for j in range(P15_T)], sdims[k])
            e, n = float((g - wg).square().sum()), float(wg.square().sum())
            err, norm = err + e, norm + n
            if n > 0 and (e / n) ** 0.5 > worst[0]:
                worst = ((e / n) ** 0.5, k)
        return (err / norm) ** 0.5, worst

    def tp_grads():
        return steps._loss_and_grads(lambda p: T.forward_train(small, mb, p, par=tp)[0],
                                     tree)[1]
    grad_rel, worst = rel(tp_grads())
    reduce = model_axis.reduce_from_positions
    model_axis.reduce_from_positions = lambda parts, device: reduce(
        list(parts[:-1]) + [torch.zeros_like(parts[-1])], device)
    try:
        dropped_rel, _ = rel(tp_grads())
    finally:
        model_axis.reduce_from_positions = reduce
    del small, whole_p, tree, want_g
    if not (grad_rel <= P15_GRAD_BOUND and worst[0] <= P15_GRAD_BOUND):
        raise AssertionError(f"{cfg.name}: the fp32 TP gradient lies {grad_rel} of the whole "
                             f"model's from it in L2, {worst[0]} in {worst[1]} (bound "
                             f"{P15_GRAD_BOUND})")
    if not dropped_rel > P15_GRAD_BOUND:
        raise AssertionError(f"{cfg.name}: a TP gradient with one partial dropped reads "
                             f"{dropped_rel}, within the bound {P15_GRAD_BOUND}")
    return {"rel_l2": grad_rel, "worst_leaf": worst[1], "worst_leaf_rel_l2": worst[0],
            "dropped_rel_l2": dropped_rel, "bound": P15_GRAD_BOUND, "fan_in": fan_in}


def tp_want_launches(cfg, dims: dict, n_steps: int, **extra) -> dict:
    """``want_launches`` of a round over ``P15_T`` positions: flash once a
    position where the attention's heads split, the SSD scan once a
    position where its heads split (once on the home device where they
    stay whole, as hymba's 25)."""
    want = want_launches(cfg, n_steps, **extra)
    t_attn = P15_T if cfg.has_attention and dims["layers.0.attn.wq"] is not None else 1
    t_ssd = P15_T if cfg.has_ssm and dims["layers.0.ssm.A_log"] is not None else 1
    for k, t in (("flash_attention", t_attn), ("flash_attention_bwd", t_attn),
                 ("ssd_chunk", t_ssd), ("ssd_chunk_bwd", t_ssd)):
        want[k] *= t
    return want


def tp_family_round(dev, letter: str, model, params, fl_data, t1: dict | None, seen: dict,
                    path_launches: dict, smi: str, lora=None) -> dict:
    """Phase 15 (d)-(f), inside ``train_family``: ``model``'s round (full
    width, remat on) tensor-parallel over ``P15_T`` logical positions on
    the card, from the t=1 round's start and inputs (``fl_data``; with
    ``lora = (mapping, a_tree, state)`` over that adapter state).

    * The bf16 round at t=2, what ``fl_train --model-parallel`` runs:
      finite and moved, exact launch counts from the placements
      (``tp_want_launches``: Eq. 6 one launch a shard of each split leaf
      and one a whole leaf, or one for the adapter tree), every Eq. 6
      launch held to its plain version, its kernel signatures in ``seen``;
      its update against the bf16 t=1 round's (``t1``, phase 11's, where
      given) printed but not bounded: a bf16 leaf that a round moves by
      less than an ulp flips on rounding noise, and that floor reads above
      TP's difference in these rounds (``examples/tp_round_noise.py``).
    * The same round as a pair on the weights cast to fp32, t=1 and t=2
      from one start (launches held too): the TP round's update within
      ``P15_DELTA_BOUND_F32`` of the t=1 round's in L2, which the t=1
      round with its gradient negated must read above.
    * The first microbatch's fp32 gradient through ``P15_GRAD_LAYERS``
      full-width layers (``tp_grad_check``).

    Seconds and peak GB for each run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models import lora as lora_lib
    from repro_torch.models import transformer as T
    tag = f"[phase15] ({smi}; logical positions on one card: device copies, not NVLink)"
    tokens, labels, w, per_med = fl_data
    mesh = make_fl_mesh(mediator=1, model=P15_T, devices=(dev,) * P15_T)

    def setup(model, params, state):
        dims = sharding.placements(T.param_specs(model.cfg, model.max_seq), mesh)
        if lora is None:
            n_eq6 = (len(params), sum(P15_T if dims[k] is not None else 1 for k in params))

            def round_at(m=None, lr=FL_LR):
                fl = steps.make_fl_round(model, 2, mesh=m, learning_rate=lr, local_steps=per_med)
                return fl(params, tokens, labels, w)
            return dims, params, n_eq6, round_at
        mapping, a_tree = lora[:2]

        def round_at(m=None, lr=FL_LR):
            fl = steps.make_fl_round(model, 2, mesh=m, lora_mapping=mapping, learning_rate=lr,
                                     local_steps=per_med)
            return fl(params, a_tree, state, tokens, labels, w)
        return dims, state, (1, 1), round_at

    def timed(cfg, dims, round_at, label, m, eq6):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with HeldEq6() as held, recorded_kernel_calls(seen):
            got, sec = _sync_time(lambda: round_at(m))
        sec -= held.seconds
        launches = dict(ops.LAUNCHES)
        path_launches[f"15 ({letter}) {label} round {cfg.name}"] = launches
        want = (want_launches(cfg, 2 * per_med, fedavg_agg=eq6) if m is None else
                tp_want_launches(cfg, dims, 2 * per_med, fedavg_agg=eq6))
        if launches != want:
            raise AssertionError(f"15 ({letter}) {cfg.name} {label} round: launches "
                                 f"{launches}, expected {want}")
        return got, {"s_per_round": sec, "peak_gb": _peak_gb(), "launches": launches,
                     "eq6_held": {"calls": held.calls, "worst_rel": held.worst}}

    def update_rel(res, ref, start):
        err = norm = 0.0
        for k, p in start.items():
            d1 = ref[k].float() - p.float()
            err += float((res[k].float() - p.float() - d1).square().sum())
            norm += float(d1.square().sum())
        return (err / norm) ** 0.5

    def finite(res):
        return all(bool(torch.isfinite(v.float()).all()) for v in res.values())

    out = {"what": "lora" if lora else "full-delta"}
    # the bf16 round at t=2
    torch.cuda.empty_cache()
    dims, start, n_eq6, round_at = setup(model, params, lora[2] if lora else None)
    got, bf = timed(model.cfg, dims, round_at, f"bf16 t={P15_T}", mesh, n_eq6[1])
    bf["largest_update"] = largest_update(got, start)
    if not finite(got) or bf["largest_update"] == 0.0:
        raise AssertionError(f"15 ({letter}) {model.cfg.name} bf16 TP round: finite "
                             f"{finite(got)}, largest update {bf['largest_update']}")
    if t1 is not None:
        bf["delta_rel_l2_vs_t1"] = update_rel(got, t1, start)
    out[f"bf16 t={P15_T}"] = bf
    del got, round_at

    # the fp32 pair
    cast = T.Transformer(dataclasses.replace(model.cfg, dtype="float32"), device=dev,
                         max_seq=model.max_seq)
    cast.load_state_dict(params)
    cfg, cparams = cast.cfg, T.train_params(cast)
    state = lora_lib.init_adapter_state(lora[0], cparams) if lora else None
    torch.cuda.empty_cache()
    dims, start, n_eq6, round_at = setup(cast, cparams, state)
    t1f, out["t=1"] = timed(cfg, dims, round_at, "t=1", None, n_eq6[0])
    out["t=1"]["largest_update"] = largest_update(t1f, start)
    got, out[f"t={P15_T}"] = timed(cfg, dims, round_at, f"t={P15_T}", mesh, n_eq6[1])
    bound = P15_DELTA_BOUND_F32
    delta_rel = update_rel(got, t1f, start)
    ok = finite(got)
    diff = max(float((got[k].float() - t1f[k].float()).abs().max()) for k in start)
    del got
    if not ok or not delta_rel <= bound:
        raise AssertionError(f"15 ({letter}) {cfg.name} TP round: finite {ok}, its update "
                             f"{delta_rel} of the t=1 round's from it in L2 (bound {bound})")
    neg_rel = update_rel(round_at(lr=-FL_LR), t1f, start)
    if not neg_rel > bound:
        raise AssertionError(f"15 ({letter}) {cfg.name}: the t=1 round with its gradient "
                             f"negated reads {neg_rel}, within the bound {bound}")
    del t1f, round_at, cast, cparams, state, start
    torch.cuda.empty_cache()
    micro = tokens.shape[0] // 2 // per_med
    with recorded_kernel_calls(seen):
        grad = tp_grad_check(dev, cfg, {"tokens": tokens[:micro], "labels": labels[:micro]},
                             fan_in=True)
    out.update({"delta_rel_l2": delta_rel, "delta_bound": bound,
                "delta_rel_l2_negated_round": neg_rel, "largest_diff": diff, "grad": grad,
                "placement": {k: d for k, d in dims.items()
                              if k.startswith("layers.0.") or not k.startswith("layers.")}})
    one, tp_run = out["t=1"], out[f"t={P15_T}"]
    vs_t1 = (f", its update {bf['delta_rel_l2_vs_t1']:.4e} of phase 11's bf16 t=1 round's "
             f"in L2 (not bounded: bf16 rounding noise)" if t1 is not None else "")
    log(f"{tag} ({letter}) {cfg.name} {out['what']} round, 2 mediators x {per_med} steps of "
        f"1 x {tokens.shape[1]}: bf16 at t={P15_T} {bf['s_per_round']:.3f} s, peak "
        f"{bf['peak_gb']:.2f} GB, launches {bf['launches']} (predicted from the placements), "
        f"finite, largest update {bf['largest_update']:.3e}{vs_t1}; on fp32 weights t=1 "
        f"{one['s_per_round']:.3f} s, {one['peak_gb']:.2f} GB, launches {one['launches']}; "
        f"t={P15_T} {tp_run['s_per_round']:.3f} s, peak {tp_run['peak_gb']:.2f} GB, "
        f"launches {tp_run['launches']}, Eq. 6 held to its plain version "
        f"({tp_run['eq6_held']['calls']} calls, worst {tp_run['eq6_held']['worst_rel']:.2e}); "
        f"its update {delta_rel:.4e} of the t=1 round's from it in L2 (bound {bound}; no "
        f"update reads 1, the t=1 round with its gradient negated {neg_rel:.4f}), largest "
        f"|diff| {diff:.3e}; a microbatch's fp32 gradient through {P15_GRAD_LAYERS} "
        f"full-width layers (standard fan-in), TP against whole: {grad['rel_l2']:.4e} in L2, "
        f"worst leaf {grad['worst_leaf']} {grad['worst_leaf_rel_l2']:.4e} (bound "
        f"{P15_GRAD_BOUND}; one position's partial dropped from every all-reduce: "
        f"{grad['dropped_rel_l2']:.4f})")
    return out


def phase14(fed, dev, smi: str, path_launches: dict, lap) -> dict:
    """The mediator axis.  (a) Four logical shards on ``cuda:0`` at phase
    5's EMNIST arm, three Astraea rounds with a reschedule each, under
    cuDNN's deterministic algorithms: the replicated store and the sharded
    store under both exchanges bit for bit equal (and their WAN ledger the
    closed form), each shard a quarter of the replicated store's bytes (the
    card's peak over each run printed beside it), the
    ragged exchange at most the all-gather's and both above 0, the
    placement's fetches adding up (async S=0 over the sharded store is
    phase 15 (a)'s, on the 2 x 2 mesh).  (b) Two processes on
    ``cuda:0``, spawned after phase 2 built the kernels (they load the
    library, never build it), each joining a ``TCPStore`` this process
    hosts: two overlapped async rounds of (a)'s arm over the replicated
    store and a ``ProcessWaveDispatcher``; their params bit for bit equal
    to each other's and to this process's single-process run, their
    per-key ledgers equal; then (phase 15 (c)) one more pair of rounds on
    each child's ``process_local_mesh(model=2)`` (TP rows on the card),
    bit for bit this process's run of the same.  A child that fails or
    outlives ``P14_CHILD_TIMEOUT_S`` fails the phase.  (a) runs on the 4 x
    1 ``(mediator, model)`` mesh, the 1-D mesh's program; its replicated
    and sharded runs' params are kept in ``four`` for phase 15 (a).
    Logical shards and processes on one card measure device and host
    copies, not NVLink or NCCL."""
    from datetime import timedelta

    from repro_torch.examples import distributed_waves
    from repro_torch.launch.mesh import make_fl_mesh, process_local_mesh
    tag = f"[phase14] ({smi}; one card: device copies, not NVLink or NCCL)"
    # the 4 x 1 (mediator, model) mesh: the 1-D mediator mesh's program
    # (model axis 1), phase 15 (a)'s oracle
    mesh = make_fl_mesh(mediator=P14_SHARDS, model=1, devices=(dev,) * P14_SHARDS)
    res: dict = {"card": smi}
    four: dict = {}

    # (a) the stores over four logical shards
    runs, stats = {}, {}
    with deterministic_convolutions():
        for name, kw in (("replicated", dict(store="replicated")),
                         ("sharded ragged", dict(store="sharded", store_exchange="ragged")),
                         ("sharded gather", dict(store="sharded", store_exchange="gather"))):
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            tr = p10_trainer(fed, dev, mesh=mesh, reschedule_every_round=True, **kw)
            secs, launches = run_timed(tr, label=name)
            peak = torch.cuda.max_memory_allocated(dev) - held
            path_launches[f"14 {name}"] = launches
            # one warp launch a mediator row a round (each row's slots on its
            # position), one Eq. 6 and one greedy pass a round
            if launches != {"fedavg_agg": ROUNDS, "kld_greedy_picks": ROUNDS,
                            "affine_warp": P14_SHARDS * ROUNDS}:
                raise AssertionError(f"{name}: launches {launches}")
            rows_on_positions(tr, P14_SHARDS, name)
            store = tr.engine.store
            stats[name] = {"round_seconds": secs, "launches": launches,
                           "per_device_bytes": store.per_device_bytes(),
                           "card_peak_bytes": peak,
                           "exchange_bytes_per_round": store.exchange_bytes_per_round,
                           "ledger": tr.comm.ledger_totals(),
                           "store_stats": {k: v for k, v in
                                           (tr.engine.last_schedule_stats or {}).items()
                                           if k.startswith("store_")}}
            runs[name] = tr
            four[name] = {"params": {k: v.clone() for k, v in tr.params.items()},
                          "round_log": list(tr.comm.round_log),
                          "intra_pod": tr.comm.intra_pod_bytes,
                          "param_bytes": tr.engine.store.stats()["per_device_param_bytes"],
                          "round_seconds": secs,
                          "moved_bytes": getattr(store, "moved_bytes", 0),
                          "store_exchange_bytes": tr.comm.store_exchange_bytes}
            log(f"{tag} (a) {name}: s/round {' '.join(f'{x:.4f}' for x in secs)}, launches "
                f"{launches}, device bytes a shard {store.per_device_bytes():,}, the card's "
                f"peak over the run {peak:,} B (max_memory_allocated less what was held "
                f"before; all shards on this card), exchange "
                f"{store.exchange_bytes_per_round:,} B a round (last), ledger "
                f"store_exchange {tr.comm.store_exchange_bytes:,.0f} B, "
                f"{stats[name]['store_stats']}")
        rep = runs["replicated"]
        ragged, gather = runs["sharded ragged"], runs["sharded gather"]
        for name in ("sharded ragged", "sharded gather"):
            tr = runs[name]
            if not same_params(tr, rep):
                raise AssertionError(f"{name} differs from the replicated store")
            if not tr.comm.round_log == rep.comm.round_log == expected_wan(fed):
                raise AssertionError(f"{name}: WAN ledger {tr.comm.round_log}")
            if tr.engine.store.per_device_bytes() * P14_SHARDS != \
                    rep.engine.store.per_device_bytes():
                raise AssertionError(f"{name}: {tr.engine.store.per_device_bytes()} B a shard")
            st = stats[name]["store_stats"]
            if st["store_local_fetches"] + st["store_remote_fetches"] != \
                    st["store_total_fetches"] or st["store_total_fetches"] != CLIENTS:
                raise AssertionError(f"{name}: fetches {st}")
        r_bytes = ragged.engine.store.exchange_bytes_per_round
        g_bytes = gather.engine.store.exchange_bytes_per_round
        if not 0 < r_bytes <= g_bytes or rep.comm.store_exchange_bytes != 0:
            raise AssertionError(f"exchange bytes ragged {r_bytes}, gather {g_bytes}")
        log(f"{tag} (a) replicated == sharded ragged == sharded gather, bit for bit; "
            f"device bytes a shard {ragged.engine.store.per_device_bytes():,} x "
            f"{P14_SHARDS} = replicated {rep.engine.store.per_device_bytes():,}; exchange "
            f"a round ragged {r_bytes:,} B <= gather {g_bytes:,} B")
        # phase 16 (a): a fourth round of the ragged run, profiled (its three
        # rounds' params are in ``four``)
        from repro_torch.examples.profile_round import profile_round
        four["sharded ragged"]["profile"] = {k: v for k, v in profile_round(ragged).items()
                                             if k != "top"}
    res["stores"] = stats
    del runs, rep, ragged, gather, tr
    torch.cuda.empty_cache()
    lap("14 (a) sharded store")
    res["model_axis"] = phase15a(fed, dev, smi, four, path_launches)
    torch.cuda.empty_cache()
    lap("15 (a) model axis, EMNIST")
    res["mediator_rows"] = phase16a(fed, dev, smi, four, path_launches)
    torch.cuda.empty_cache()
    lap("16 (a) mediator rows, EMNIST")

    # (b) two processes on this card
    store = torch.distributed.TCPStore("127.0.0.1", 0, None, is_master=True,
                                       wait_for_workers=False,
                                       timeout=timedelta(seconds=P14_CHILD_TIMEOUT_S))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TORCHELASTIC_USE_AGENT_STORE="True")
    outs = [ROOT / "build" / f"phase14_rank{i}.npz" for i in range(P14_PROCESSES)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.distributed_waves", "--arm", "emnist",
         "--device", f"cuda:{dev.index}", "--coordinator", f"127.0.0.1:{store.port}",
         "--num-processes", str(P14_PROCESSES), "--process-id", str(i), "--out", str(out),
         "--model-parallel", str(P15_T)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, out in enumerate(outs)]
    texts = []
    try:
        # the single-process run, while the children start up
        with deterministic_convolutions():
            solo = distributed_waves.run_waves("emnist", dev)
            solo_tp = distributed_waves.run_waves(
                "emnist", dev, mesh=process_local_mesh(P15_T, device=dev))
        for p in procs:
            texts.append(p.communicate(timeout=P14_CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a phase-14 child outlived {P14_CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    children_s = time.perf_counter() - t0
    for p, text in zip(procs, texts):
        if p.returncode:
            raise AssertionError(f"a phase-14 child exited {p.returncode}:\n{text[-3000:]}")
    want = distributed_waves.summary(solo)
    want_tp = distributed_waves.summary(solo_tp)
    path_launches["14 single-process waves"] = solo["launches"]
    path_launches["15 (c) single-process waves, model axis 2"] = solo_tp["launches"]
    if solo_tp["runner"].engine.store.stats()["model_axis"] != P15_T or \
            not solo_tp["runner"].engine._tp_rows:
        raise AssertionError("phase 15 (c): the process-local mesh trained no TP rows")
    children = []
    for i, out in enumerate(outs):
        with np.load(out) as z:
            report = json.loads(str(z["report"]))
            if report["failures"] or report["nvcc_builds"] != 0:
                raise AssertionError(f"child {i}: {report}")
            for prefix, w in (("", want), ("model_", want_tp)):
                names, keys = sorted(w["params"]), sorted(w["ledger"])
                if list(z[f"{prefix}names"]) != names or not all(
                        np.array_equal(z[f"{prefix}p_{j}"], w["params"][k])
                        for j, k in enumerate(names)):
                    raise AssertionError(f"child {i}: {prefix}params differ from the "
                                         f"single-process run")
                if list(z[f"{prefix}ledger_keys"]) != keys or not np.array_equal(
                        z[f"{prefix}ledger"], [w["ledger"][k] for k in keys]):
                    raise AssertionError(f"child {i}: {prefix}ledger differs from the "
                                         f"single-process run")
                if json.loads(str(z[f"{prefix}commit_log"])) != w["commit_log"]:
                    raise AssertionError(f"child {i}: {prefix}commit log differs")
            mrun = report["model_axis_run"]
            if mrun["model_axis"] != P15_T or not mrun["tp_rows"]:
                raise AssertionError(f"child {i}: model-axis run {mrun}")
        path_launches[f"14 process {i}"] = report["launches"]
        path_launches[f"15 (c) process {i}"] = mrun["launches"]
        children.append(report)
        log(f"[phase15] ({smi}; logical positions on one card: device copies, not NVLink) "
            f"(c) process {i}: one more pair of rounds on process_local_mesh(model="
            f"{P15_T}), TP rows: published {mrun['num_published']}, received "
            f"{mrun['num_received']}, s/round "
            f"{' '.join(f'{x:.4f}' for x in mrun['round_seconds'])}, launches "
            f"{mrun['launches']}")
        log(f"{tag} (b) process {i} of {P14_PROCESSES} on cuda:{dev.index}: published "
            f"{report['num_published']}, received {report['num_received']}, s/round "
            f"{' '.join(f'{x:.4f}' for x in report['round_seconds'])}, launches "
            f"{report['launches']}, nvcc builds {report['nvcc_builds']}")
    log(f"{tag} (b) {P14_PROCESSES} processes: params bit for bit equal to each other's "
        f"and to the single-process run (s/round "
        f"{' '.join(f'{x:.4f}' for x in solo['round_seconds'])}, launches "
        f"{solo['launches']}), per-key ledgers equal; the children took {children_s:.1f} s")
    log(f"[phase15] ({smi}; logical positions on one card: device copies, not NVLink) "
        f"(c) {P14_PROCESSES} processes on process_local_mesh(model={P15_T}): params bit "
        f"for bit each other's and the single-process run's (s/round "
        f"{' '.join(f'{x:.4f}' for x in solo_tp['round_seconds'])}, launches "
        f"{solo_tp['launches']}), per-key ledgers equal")
    res["processes"] = {"children": children, "children_s": children_s,
                        "single_round_seconds": solo["round_seconds"],
                        "single_launches": solo["launches"],
                        "model_axis_single_round_seconds": solo_tp["round_seconds"]}
    lap("14 (b) two processes")
    return res


# ---------------------------------------------------------------- phase 16

def rows_on_positions(tr, n: int, label: str) -> None:
    """The trainer's engine trains each of its mesh's ``n`` mediator rows
    as its own round program on that row's home, each captured once as a
    CUDA graph (``num_round_traces`` counts one a row)."""
    from repro_torch.launch.mesh import model_devices
    eng = tr.engine
    progs = eng._programs
    if eng.num_round_traces != n or len(progs) != n or any(p.graph is None for p in progs):
        raise AssertionError(f"{label}: {eng.num_round_traces} round programs, graphs "
                             f"{[p.graph is not None for p in progs]}; expected {n}")
    if [p.device for p in progs] != [model_devices(eng.mesh, i)[0] for i in range(n)]:
        raise AssertionError(f"{label}: programs on {[p.device for p in progs]}")


def engine_device_rows(tr):
    """The oracle of phase 16: every schedule row on the engine's device in
    one block (one round program, one graph), each store's slots gathered
    there -- how the rows trained before they moved to their positions."""
    eng = tr.engine
    eng.row_positions = lambda: [(eng.device,)]
    return tr


def phase16a(fed, dev, smi: str, four: dict, path_launches: dict) -> dict:
    """Phase 16 (a), the mediator axis as compute at phase 5's EMNIST arm
    (three Astraea rounds with a reschedule each, under cuDNN's
    deterministic algorithms) on phase 14 (a)'s ``4 x 1`` mesh of logical
    positions, each mediator row's schedule rows trained on its own
    position: ``"map"`` over the sharded store (ragged) bit for bit the same
    run with every row on the engine's device (``engine_device_rows``);
    ``"vmap"`` (four programs, four graphs a round; phase 14 (a)'s ragged
    run, its fourth round profiled there) within ``P16_VMAP_BOUND`` of
    ``"map"`` in L2 relative to the update;
    the device exchange's bytes, counted where they move, equal to the
    intra-pod ledger's under both exchanges (phase 14 (a)'s runs); seconds
    a round and a profiled fourth round's device busy (the union of its
    kernels' intervals) and idle, beside the engine-device run's (one
    program, one graph)."""
    from repro_torch.examples.profile_round import profile_round
    from repro_torch.launch.mesh import make_fl_mesh
    from repro_torch.models.cnn import emnist_cnn, init_params
    tag = (f"[phase16] ({smi}; four logical positions on one card: device copies, "
           f"no overlap across cards)")
    mesh = make_fl_mesh(mediator=P14_SHARDS, model=1, devices=(dev,) * P14_SHARDS)
    res: dict = {"card": smi}
    for name in ("sharded ragged", "sharded gather"):
        got = four[name]
        if not got["moved_bytes"] == got["store_exchange_bytes"] > 0:
            raise AssertionError(f"phase 16 (a) {name}: moved {got['moved_bytes']} B, "
                                 f"charged {got['store_exchange_bytes']} B")
        res[f"{name} exchange"] = {"moved_bytes": got["moved_bytes"],
                                   "charged_bytes": got["store_exchange_bytes"]}
        log(f"{tag} (a) {name} (phase 14 (a), vmap): four graphs a round, exchange moved "
            f"between the positions {got['moved_bytes']:,} B = the intra-pod ledger's "
            f"{got['store_exchange_bytes']:,.0f} B over {ROUNDS} rounds")
    runs = {}
    with deterministic_convolutions():
        for label, row_exec, oracle in (("engine device vmap", "vmap", True),
                                        ("positions map", "map", False),
                                        ("engine device map", "map", True)):
            tr = p10_trainer(fed, dev, row_exec=row_exec, mesh=mesh, store="sharded",
                             reschedule_every_round=True)
            if oracle:
                engine_device_rows(tr)
            secs, launches = run_timed(tr, label=f"phase 16 (a) {label}")
            path_launches[f"16 (a) {label}"] = launches
            warps = 1 if oracle else P14_SHARDS
            if launches != {"fedavg_agg": ROUNDS, "kld_greedy_picks": ROUNDS,
                            "affine_warp": warps * ROUNDS}:
                raise AssertionError(f"phase 16 (a) {label}: launches {launches}")
            if row_exec == "vmap":
                rows_on_positions(tr, 1 if oracle else P14_SHARDS, f"phase 16 (a) {label}")
            runs[label] = {"params": {k: v.clone() for k, v in tr.params.items()},
                           "round_seconds": secs, "launches": launches,
                           "round_log": list(tr.comm.round_log)}
            if row_exec == "vmap":
                # one more round, profiled: device busy is the union of the
                # kernels' intervals (a graph's kernels overlap)
                prof = profile_round(tr)
                runs[label]["profile"] = {k: v for k, v in prof.items() if k != "top"}
            del tr
            torch.cuda.empty_cache()
    ragged = four["sharded ragged"]
    runs["positions vmap"] = {"params": ragged["params"], "round_log": ragged["round_log"],
                              "round_seconds": ragged["round_seconds"],
                              "profile": ragged["profile"],
                              "launches": path_launches["14 sharded ragged"]}
    pm, om = runs["positions map"], runs["engine device map"]
    if not same_state(pm["params"], om["params"]) or pm["round_log"] != om["round_log"]:
        raise AssertionError("phase 16 (a): rows on positions under 'map' differ from the "
                             "engine-device run")
    init = init_params(emnist_cnn(47, 28), 0, dev)

    def flat(p):
        return torch.cat([p[k].flatten() for k in init])
    update = float((flat(pm["params"]) - flat(init)).norm())
    res["vmap_vs_map"] = {}
    for label in ("positions vmap", "engine device vmap"):
        diff = flat(runs[label]["params"]) - flat(pm["params"])
        rel = float(diff.norm()) / update
        res["vmap_vs_map"][label] = {"rel_l2": rel, "max_abs": float(diff.abs().max()),
                                     "bitwise": rel == 0.0}
        if not rel <= P16_VMAP_BOUND:
            raise AssertionError(f"phase 16 (a): {label} lies {rel:.3e} of the update from "
                                 f"'map' (bound {P16_VMAP_BOUND})")
    res["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "params"}
                   for k, v in runs.items()}
    log(f"{tag} (a) 'map' rows on the positions == the engine-device run bit for bit "
        f"(params and WAN ledger); 'vmap' against 'map' in L2 of the update: positions "
        f"{res['vmap_vs_map']['positions vmap']['rel_l2']:.3e}, engine device "
        f"{res['vmap_vs_map']['engine device vmap']['rel_l2']:.3e} (bound {P16_VMAP_BOUND})")
    for label, r in runs.items():
        prof = r.get("profile")
        log(f"{tag} (a) {label}: s/round {' '.join(f'{x:.4f}' for x in r['round_seconds'])}"
            + (f"; profiled round wall {1e3 * prof['wall_s']:.1f} ms, device busy "
               f"{1e3 * prof['busy_s']:.1f} ms (union), idle {100 * prof['idle_share']:.1f} "
               f"%, {prof['device_kernels']} device kernels, {prof['graph_launches']} graph "
               f"launches, {prof['host_launches']} host launches" if prof else "")
            + f"; launches {r['launches']}")
    return res


def mediator_rows_round_check(dev, model, params, new, batch, per_med, steps_per_round,
                              path_launches, smi) -> dict:
    """Phase 16 (c), inside phase 11: qwen3-4b's full-delta round over a
    ``2 x 1`` mesh of logical positions (one mediator a mediator row, each
    on its own position, their steps interleaved), from phase 11 (c)'s
    start and inputs: bit for bit its in-turn t=1 round ``new``; flash
    launches as at t=1; Eq. 6 as the reference's ``psum_eq6``, one
    ``fedavg_agg`` a mediator row a leaf over the leaf's column block (each
    held to its plain version); seconds and peak GB."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_fl_mesh
    tag = f"[phase16] ({smi}; two logical positions on one card)"
    tokens, labels, w = batch
    cfg = model.cfg
    mesh = make_fl_mesh(mediator=2, model=1, devices=(dev,) * 2)
    fl = steps.make_fl_round(model, 2, learning_rate=FL_LR, local_steps=per_med, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with HeldEq6() as held:
        got, sec = _sync_time(lambda: fl(params, tokens, labels, w))
    sec -= held.seconds
    launches = dict(ops.LAUNCHES)
    path_launches[f"16 (c) mediator rows round {TRAIN_ARCH}"] = launches
    flash = steps_per_round * cfg.n_layers
    n_eq6 = sum(len(steps.eq6_blocks(p.numel(), 2)) for p in params.values())
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(flash_attention=(2 if cfg.remat else 1) * flash, flash_attention_bwd=flash,
                fedavg_agg=n_eq6)
    if launches != want:
        raise AssertionError(f"phase 16 (c): launches {launches}, expected {want}")
    differ = [k for k in params if not torch.equal(got[k], new[k])]
    if differ:
        raise AssertionError(f"phase 16 (c): {len(differ)} leaves differ from the in-turn "
                             f"round, e.g. {differ[:3]}")
    res = {"s_per_round": sec, "peak_gb": _peak_gb(), "launches": launches,
           "eq6_held": {"calls": held.calls, "worst_rel": held.worst}, "bitwise": True}
    log(f"{tag} (c) {TRAIN_ARCH} full-delta round on a 2 x 1 mesh, one mediator a row: bit "
        f"for bit the in-turn t=1 round; {sec:.3f} s, peak {res['peak_gb']:.2f} GB (the t=1 "
        f"round's result held beside it), flash "
        f"{launches['flash_attention']} + {launches['flash_attention_bwd']} (as at t=1), "
        f"fedavg_agg {launches['fedavg_agg']} (a column block a row of each of "
        f"{len(params)} leaves; held to its plain version, worst {held.worst:.2e})")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.core.augmentation import augmentation_plan
    from repro_torch.data.federated import CINIC_LIKE, EMNIST_LIKE, partition
    from repro_torch.kernels import build
    from repro_torch.models.cnn import cinic_cnn, emnist_cnn

    t_start = time.perf_counter()
    phase_s: dict[str, float] = {}

    def lap(name: str) -> None:
        """Log the seconds since the previous lap (the script's time budget)."""
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"[time] {name}: {phase_s[name]:.1f} s")

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = resolve_device()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    lap("1 device")

    # ---- 2. build
    t0 = time.perf_counter()
    build_log: list[str] = []
    build.build(build_log)
    build.library()
    build_s = time.perf_counter() - t0
    lap("2 build")
    log(f"[build] {build_s:.2f} s -> {build.library_path().name}")
    for line in "\n".join(build_log).splitlines():
        if "registers" in line or "Compiling entry" in line or "nvcc" in line:
            log(f"[build]   {line.strip()}")

    # the main paths' federations (the EMNIST pad sets the warp's batch)
    fed = partition(dataclasses.replace(EMNIST_LIKE, num_classes=47), **FED_KW)
    cinic_fed = partition(dataclasses.replace(CINIC_LIKE, noise=0.5, distort=0.35),
                          **CINIC_FED_KW)
    sizes = [x.shape[0] for x in fed.client_images]
    pad = -(-max(sizes) // 20) * 20

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    checks = {"fedavg_agg": [], "kld_greedy_picks": [], "kld_score": [],
              "kld_score_matrix": [], "affine_warp": []}
    for m in (16, 4):
        for dt in (torch.float32, torch.bfloat16):
            checks["fedavg_agg"].append(
                check_fedavg(dev, m, 68_873, dt, gen))
    checks["fedavg_agg"].append(check_fedavg(dev, 16, CINIC_PARAMS, torch.float32, gen))
    checks["fedavg_agg"].append(check_fedavg(dev, 16, 2 ** 24, torch.float32, gen))
    # phase 11's Eq. 6 over its 2 mediators (fewer rows than the kernel's
    # 4-row unroll): the full-delta round's largest leaf and the LoRA
    # round's flat adapter buffer, both rows weighted
    for n in (TRAIN_LARGEST_LEAF, LORA_TRAINABLE):
        checks["fedavg_agg"].append(check_fedavg(dev, 2, n, torch.float32, gen, dummy=False))
    lap("3 fedavg_agg")
    # the scoring kernels: the CINIC cohort (its first pick's histogram as
    # the open mediator), the JAX bench's shapes (uniform * 100 mediators,
    # uniform * 50 clients) and a large sweep
    cohort = cinic_cohort_counts(cinic_fed)
    checks["kld_score"].append(check_score(dev, cohort[0], cohort))
    for k in (512, 4096):
        checks["kld_score"].append(check_score(
            dev, rng.random(47) * 100, rng.random((k, 47)) * 50))
    # the matrix: Path A's sweep (256 x 1,024, its main path's shape, first),
    # a CINIC-size one and a large one
    for m, k in ((256, 1024), (16, 512), (256, 4096)):
        checks["kld_score_matrix"].append(check_score_matrix(
            dev, rng.random((m, 47)) * 100, rng.random((k, 47)) * 50))
    # past the old class limits (12,288 one mediator, 1,024 the matrix):
    # the mediator read from global memory; the matrix in f64 sums, its
    # tiles still staged (two fit in 96 KB up to C = 2,048 at its 4 lanes)
    wide = np.random.default_rng(1)
    checks["kld_score"].append(check_score(
        dev, wide.random(60_000) * 100, wide.random((16, 60_000)) * 50))
    checks["kld_score_matrix"].append(check_score_matrix(
        dev, wide.random((16, 2_000)) * 100, wide.random((512, 2_000)) * 50))
    checks["affine_warp"].append(check_warp(dev, CLIENTS * pad, 28, 28, 1, gen))
    checks["affine_warp"].append(check_warp(dev, 4096, 32, 32, 3, gen))
    checks["affine_warp"].append(check_warp(dev, CLIENTS * pad, 20, 36, 3, gen))
    lap("3 scoring and warp")
    # the serve path's shapes: Hymba prefill, b=4, s=2048 = 2W
    hy = dict(b=4, sq=2048, skv=2048, h=25, kv=5, d=64)
    checks["flash_attention"] = [
        check_flash(dev, gen, **hy, dtype=torch.bfloat16, window=1024),
        check_flash(dev, gen, **hy, dtype=torch.float32, window=1024),
        check_flash(dev, gen, **hy, dtype=torch.bfloat16, window=None),
        check_flash(dev, gen, **{**hy, "sq": 64}, dtype=torch.bfloat16, window=1024,
                    q_offset=1984),
        check_flash(dev, gen, **{**hy, "kv": 25}, dtype=torch.bfloat16, window=1024),
        # the zoo's other head dims: danube's (d=80, SWA 4096) and qwen3's
        # (d=128, full causal) heads, 32 over 8 KV heads
        check_flash(dev, gen, b=1, sq=2048, skv=2048, h=32, kv=8, d=80,
                    dtype=torch.bfloat16, window=4096),
        check_flash(dev, gen, b=1, sq=2048, skv=2048, h=32, kv=8, d=128,
                    dtype=torch.bfloat16, window=None),
        # and in fp32 on the CUDA cores (the reduced configs serve in fp32)
        check_flash(dev, gen, b=1, sq=2048, skv=2048, h=32, kv=8, d=80,
                    dtype=torch.float32, window=4096),
        check_flash(dev, gen, b=1, sq=2048, skv=2048, h=32, kv=8, d=128,
                    dtype=torch.float32, window=None)]
    # gemma-2b's prefill layer: 8 query heads over one KV head of 256, full
    # causal, in bf16 (the tensor cores) and f32 (the CUDA cores)
    gemma = dict(b=4, sq=2048, skv=2048, h=8, kv=1, d=256, window=None)
    checks["flash_attention"] += [check_flash(dev, gen, **gemma, dtype=torch.bfloat16),
                                  check_flash(dev, gen, **gemma, dtype=torch.float32)]
    # granite's (GQA 24:8) and internvl2's (14:2) prefill layers in bf16,
    # here rather than after their serving runs: there the profiler has
    # dropped records (0.040 ms of device time for granite's 0.194 ms
    # kernel by events), and SDPA's device time is read beside them
    checks["flash_attention"] += [
        check_flash(dev, gen, b=4, sq=2048, skv=2048, h=h, kv=kv, d=64,
                    dtype=torch.bfloat16, window=None) for h, kv in ((24, 8), (14, 2))]
    lap("3 flash_attention")
    # the attention backward: qwen3-4b's training layer (phase 11's shape,
    # first), the reduced configs' layer, danube's head under a window with a
    # query offset, gemma's layer (d=256, MQA 8:1), each in bf16 and f32
    qwen_layer = dict(b=4, sq=128, skv=128, h=32, kv=8, d=128, window=None)
    bwd_shapes = [qwen_layer, dict(b=4, sq=128, skv=128, h=4, kv=4, d=64, window=None),
                  dict(b=1, sq=1024, skv=2048, h=32, kv=8, d=80, window=512, q_offset=1024),
                  dict(b=4, sq=1024, skv=1024, h=8, kv=1, d=256, window=None)]
    checks["flash_attention_bwd"] = [
        check_flash_bwd(dev, gen, **shape, dtype=dt)
        for shape in bwd_shapes for dt in (torch.bfloat16, torch.float32)]
    # Hymba's training attention layer (phase 11's): GQA 5:1 at head dim 64
    checks["flash_attention_bwd"].append(check_flash_bwd(
        dev, gen, b=4, sq=128, skv=128, h=25, kv=5, d=64, window=1024, dtype=torch.bfloat16))
    # the training layers of phase 11's MoE, audio and VLM runs (4 x 128,
    # head dim 64): whisper's encoder over 1,536 frames, non-causal (bf16
    # and f32), its cross-attention (128 queries over the 1,536 frames),
    # granite's GQA 24:8 and internvl2's 14:2 layers
    whisper_enc = dict(b=4, sq=1536, skv=1536, h=8, kv=8, d=64, window=None, causal=False)
    checks["flash_attention_bwd"] += [
        check_flash_bwd(dev, gen, **whisper_enc, dtype=torch.bfloat16),
        check_flash_bwd(dev, gen, **whisper_enc, dtype=torch.float32),
        check_flash_bwd(dev, gen, **{**whisper_enc, "sq": 128}, dtype=torch.bfloat16),
        check_flash_bwd(dev, gen, b=4, sq=128, skv=128, h=24, kv=8, d=64, window=None,
                        dtype=torch.bfloat16),
        check_flash_bwd(dev, gen, b=4, sq=128, skv=128, h=14, kv=2, d=64, window=None,
                        dtype=torch.bfloat16)]
    lap("3 flash_attention_bwd")
    ssd = dict(b=4, nc=32, L=64, h=25, p=64, n=16)
    checks["ssd_chunk"] = [check_ssd(dev, gen, **ssd, dtype=torch.float32),
                           check_ssd(dev, gen, **ssd, dtype=torch.bfloat16)]
    lap("3 ssd_chunk")
    # the SSD backward: Hymba's training layer (phase 11's, first),
    # mamba2-370m's 4 x 512 layer, Hymba's serve-length shape and a reduced
    # config's block
    checks["ssd_chunk_bwd"] = [check_ssd_bwd(dev, gen, **shape) for shape in (
        dict(b=4, nc=2, L=64, h=25, p=64, n=16), dict(b=4, nc=8, L=64, h=32, p=64, n=128),
        dict(b=4, nc=32, L=64, h=25, p=64, n=16), dict(b=1, nc=1, L=64, h=4, p=32, n=16))]
    lap("3 ssd_chunk_bwd")
    # Astraea's first cohort as the engine schedules it: the selection of
    # default_rng(seed).choice, at the expected post-augmentation counts.
    # The greedy rows come last: their quarter-second kernels have left the
    # profiler recording no device time for the rows after them.
    counts = fed.client_counts()
    sel = np.random.default_rng(0).choice(64, CLIENTS, replace=False)
    main_counts = counts[sel] * (1.0 + augmentation_plan(counts.sum(0), ALPHA))
    big = [rng.integers(0, 200, (4096, 47)), np.tile(rng.integers(1, 50, (1, 47)), (4096, 1))]
    checks["kld_greedy_picks"].append(check_greedy(dev, main_counts, GAMMA))
    # phase 11's schedule: its synthetic clients' topic histograms
    checks["kld_greedy_picks"].append(check_greedy(dev, fl_client_counts(dev), FL_GAMMA))
    # past what one CTA's shared memory holds (K > 16,384, C > 1,024),
    # before the rows whose plain versions are profiled
    checks["kld_greedy_picks"].append(check_greedy(
        dev, rng.integers(0, 200, (16_385, 47)), GAMMA, loop_exact=True))
    checks["kld_greedy_picks"].append(check_greedy(
        dev, rng.integers(0, 200, (512, 1100)), GAMMA, loop_exact=True))
    for counts_big in big:
        checks["kld_greedy_picks"].append(check_greedy(dev, counts_big, GAMMA))
    lap("3 kld_greedy_picks")
    log("[kernel] times in ms per call: CUDA events (device time from the profiler)")
    for name, rows in checks.items():
        for r in rows:
            log(f"[kernel] {name:17s} {r['shape']:24s} err {r['max_abs_err']:.3e} "
                f"kernel {_fmt(r['ms'])} ({_fmt(r['device_ms'])}, "
                f"{r['kernels_per_call']:g} kernels/call)  "
                f"plain {_fmt(r['plain_ms'])} ({_fmt(r['plain_device_ms'])})  "
                f"library {_fmt(r['library_ms'])} ({_fmt(r['library_device_ms'])})  "
                f"bound {r['bound_ms']:.6f} ({r['bound_by']})")
    for r in checks["flash_attention_bwd"]:
        log(f"[kernel] flash_attention_bwd {r['shape']}: worst gradient {r['worst_over_bound']:.3f} "
            f"of its bound (fp32 1e-5, bf16 2^-7 of the gradient's scale)"
            + (f", SDPA's bf16 backward {r['sdpa_worst_over_bound']:.3f} of it (errors "
               f"{', '.join(f'{e:.3e}' for e in r['sdpa_errs_dq_dk_dv'])})"
               if "sdpa_worst_over_bound" in r else "")
            + f"; with lse {_fmt(r['ms'])} ({_fmt(r['device_ms'])}), direct call "
            f"{_fmt(r['direct_ms'])} ({_fmt(r['direct_device_ms'])}), split {r['split']}, "
            f"7/5 of the operations bound {r['ops_7_of_5_ms']:.6f} ms")
    for r in checks["flash_attention"]:
        if "per_element_worst_over_bound" in r:
            log(f"[kernel] flash_attention {r['shape']}: worst element "
                f"{r['per_element_worst_over_bound']:.3f} of 2^-8 (|exact| + sum p|v| / l)")
        if "lse_ms" in r:
            log(f"[kernel] flash_attention {r['shape']}: writing lse {_fmt(r['lse_ms'])} "
                f"({_fmt(r['lse_device_ms'])}) against {_fmt(r['ms'])} ({_fmt(r['device_ms'])})")
    for r in checks["ssd_chunk_bwd"]:
        log(f"[kernel] ssd_chunk_bwd {r['shape']}: worst gradient {r['worst_over_bound']:.3f} "
            f"of its bound (dA 1e-4, the rest 1e-5 of the gradient's scale), errors "
            f"{', '.join(f'{e:.3e}' for e in r['errs_dx_ddt_dA_dB_dC'])}, two runs bitwise "
            f"equal; plan {r['plan']}")
    for r in checks["kld_greedy_picks"]:
        log(f"[kernel] kld_greedy_picks {r['shape']}: cluster {r['plan']}, "
            f"{r['us_per_step']:.3f} us per step")
    for r in checks["kld_score_matrix"]:
        log(f"[kernel] kld_score_matrix {r['shape']}: plan {r['plan']}")
    for r in checks["affine_warp"]:
        log(f"[kernel] affine_warp {r['shape']}: {r['stages']} stages, "
            f"{r['ms'] / r['library_ms']:.3f}x grid_sample's event time")

    # ---- 4. card vs CPU on small Astraea runs
    agree = {"emnist": agreement_check(dev), "cinic": agreement_check(dev, cinic=True)}
    for name, a in agree.items():
        log(f"[agree] card vs CPU Astraea ({name}, 16px, 2 rounds): params "
            f"max abs err {a['params_max_abs_err']:.3e}, schedules equal")

    lap("4 agreement")

    # ---- 5. the EMNIST main path at full width
    rows, launches, peak, runs = main_path(fed, dev, lambda: emnist_cnn(47, 28), 68_873)
    path_launches = {"emnist": dict(launches)}
    log(f"[main] emnist launches {launches}, peak {peak:.3f} GB")
    log(f"\n{'method':10s} {'top1':>7s} {'loss':>7s} {'traffic MB':>11s} "
        f"{'s/round':>8s}")
    for name, m in rows.items():
        log(f"{name:10s} {m['accuracy']:7.4f} {m['loss']:7.4f} "
            f"{m['traffic_mb']:11.3f} {np.mean(m['round_seconds']):8.3f}")
    rows_check = {"emnist": row_exec_check(fed, dev, lambda: emnist_cnn(47, 28), runs)}
    log_row_exec("emnist", rows, rows_check["emnist"])
    del runs

    lap("5 EMNIST path")

    # ---- 6. Path A: Alg. 3 step by step on the card
    alg3 = path_a(dev, cohort)
    path_launches["alg3_loop"] = alg3["launches"]
    log(f"[path-a] loop over K=1,024 C=47 on the card: {alg3['loop_s']:.4f} s "
        f"(one-launch greedy pass {alg3['batched_s']:.4f} s), launches "
        f"{alg3['launches']}, picks equal the greedy kernel's; CINIC cohort "
        f"divergence from the CPU loop: {alg3['cinic_cohort_divergence']}")

    lap("6 Path A")

    # ---- 7. Path B: the CINIC-10 arm at the paper's width
    cinic_rows, cinic_launches, cinic_peak, runs = main_path(
        cinic_fed, dev, lambda: cinic_cnn(10, 32, 3, 32), CINIC_PARAMS)
    path_launches["cinic"] = dict(cinic_launches)
    log(f"[cinic] cinic_cnn {CINIC_PARAMS:,} params, 32x32x3: launches "
        f"{cinic_launches}, peak {cinic_peak:.3f} GB")
    for name, m in cinic_rows.items():
        log(f"[cinic] {name:8s} top1 {m['accuracy']:.4f} loss {m['loss']:.4f} "
            f"WAN {m['wan_mib']:.3f} MiB s/round "
            f"{' '.join(f'{x:.3f}' for x in m['round_seconds'])}")
    rows_check["cinic"] = row_exec_check(cinic_fed, dev, lambda: cinic_cnn(10, 32, 3, 32),
                                         runs)
    log_row_exec("cinic", cinic_rows, rows_check["cinic"])
    del runs
    torch.cuda.empty_cache()
    materialized = materialized_round(cinic_fed, dev)
    path_launches["cinic_materialized"] = dict(materialized["launches"])
    log(f"[cinic] materialized Alg. 2: {materialized['added_samples']} warped copies "
        f"(extra storage {materialized['extra_storage_frac']:.4f}) in "
        f"{materialized['setup_s']:.3f} s, round {materialized['round_s']:.3f} s, "
        f"launches {materialized['launches']}")

    lap("7 Path B")

    # ---- 8. serving: card vs CPU on a reduced Hymba, a reduced gemma at
    # its full head dim (``reduced`` sets 64), and the reduced MoE, audio
    # and VLM families
    from repro_torch import configs
    serve_agree = {
        "hymba": serve_agreement(dev, dataclasses.replace(
            configs.reduced(configs.get("hymba-1.5b")), n_kv_heads=2)),
        "gemma": serve_agreement(dev, dataclasses.replace(
            configs.reduced(configs.get("gemma-2b")), head_dim=256)),
        **{arch.split("-")[0]: serve_agreement(dev, configs.reduced(configs.get(arch)),
                                               fan_in=True)
           for arch in FAN_IN_ARCHS}}
    for name, a in serve_agree.items():
        log(f"[serve-agree] reduced {name} (f32, head dim {a['head_dim']}"
            + (", weights at the standard fan-in" if a["fan_in"] else "") + "), prompt "
            f"{a['prompt']} + {a['decode_steps']} decode steps: logits max rel err "
            f"{a['max_rel_err']:.3e} (tol {a['tol_rel']})")

    lap("8 serve agreement")

    # ---- 9. the serving paths at full width, one model at a time (each
    # freed before the next loads), each profiled after its run
    served = {}
    for arch, batch, prompt, tokens, params, flash, ssd, decode_flash in SERVE_RUNS:
        r, seen = serve_path(dev, arch, batch, prompt, tokens, params, flash, ssd,
                             decode_flash)
        served[arch] = r
        path_launches[f"serve {arch}"] = {k: r["launches"][k]
                                          for k in ("flash_attention", "ssd_chunk")}
        log(f"[serve] {arch} {r['params']:,} params bf16, batch {batch}, prompt {prompt}, "
            f"{tokens} tokens: prefill {r['prefill_s']:.3f} s, decode "
            f"{r['decode_ms_per_token']:.2f} ms/token, peak {r['peak_mem_gb']:.2f} GB")
        log(f"[serve] {arch} prefill launches {r['prefill_launches']}; decode launches "
            f"{r['decode_launches']} ({r['decode_flash_per_step']:g} flash a step); all "
            f"logits finite"
            + (f"; its {r['ln_scales_set_to_one']} LayerNorm scales set to 1 after init "
               f"(the reference's init zeroes them, and every output with them)"
               if r["ln_scales_set_to_one"] else ""))
        pf, dc = r["profile"]["prefill"], r["profile"]["decode"]
        log(f"[serve-profile] {arch} prefill (warm, profiled): wall {pf['wall_ms']:.1f} ms, "
            f"device busy {pf['device_busy_ms']:.1f} ms, idle "
            f"{100 * pf['idle_share']:.1f} %, {pf['kernel_launches']} kernels; flash "
            f"{pf['flash_device_ms']:.2f} ms ({100 * pf['flash_share']:.1f} % of device "
            f"time), SSD {pf['ssd_device_ms']:.2f} ms")
        for name, ms, calls in pf["top_kernels"]:
            log(f"[serve-profile]   prefill {ms:9.3f} ms {calls:5d}x {name[:90]}")
        log(f"[serve-profile] {arch} decode (profiled): {dc['wall_ms_per_token']:.2f} "
            f"ms/token wall, {dc['device_busy_ms_per_token']:.2f} ms device, idle "
            f"{100 * dc['idle_share']:.1f} %, {dc['kernel_launches_per_token']:.0f} "
            f"kernels/token")
        for name, ms, calls in dc["top_kernels"]:
            log(f"[serve-profile]   decode {ms:9.3f} ms {calls:5d}x {name[:90]}")
        # every kernel signature this run called, held against its plain
        # version on fresh inputs (the model freed), unless phase 3 already did
        r["kernel_signatures"] = [str(key) for key in seen]
        hold_unchecked(dev, gen, seen, checks, f"serve {arch}")
        lap(f"9 serve {arch}")
    log(f"[serve-table] {'arch':22s} {'batch x seq + new':>18s} {'prefill s':>9s} "
        f"{'decode ms/tok':>13s} {'peak GB':>8s} {'idle pre/dec %':>14s} "
        f"{'flash pre/dec-step':>18s}")
    for arch, r in served.items():
        pf, dc = r["profile"]["prefill"], r["profile"]["decode"]
        log(f"[serve-table] {arch:22s} {r['batch']:>5d} x {r['prompt']:>5d} + {r['tokens']:<4d} "
            f"{r['prefill_s']:9.3f} {r['decode_ms_per_token']:13.2f} {r['peak_mem_gb']:8.2f} "
            f"{100 * pf['idle_share']:6.1f}/{100 * dc['idle_share']:<6.1f} "
            f"{r['prefill_launches']['flash_attention']:>9d}/{r['decode_flash_per_step']:<8g}")

    # ---- 10. async rounds, client stores and checkpoints
    p10 = phase10(fed, cinic_fed, dev, path_launches, lap)

    # ---- 11. training qwen3-4b, hymba-1.5b and mamba2-370m at full width,
    # and the launchers
    p11 = phase11(dev, gen, checks, path_launches, lap, smi)

    # ---- 12. the CNN engine's LoRA adapter exchange and round telemetry
    p12 = phase12(fed, cinic_fed, dev, gen, checks, path_launches, lap)
    log_phase12(p12)

    # ---- 13. the step-cost counter on the card, the quickstart twin, the
    # dry runs of the two largest models
    p13 = phase13(dev, p11.pop("counted_step"), path_launches, lap)

    # ---- 14. the mediator axis: logical shards and two processes on this card
    # ---- 15. the model axis (run inside phases 11 and 14): the 2-D mesh at
    # the EMNIST arm, qwen3-4b's TP round, the children's model-axis rounds
    # ---- 16. the mediator rows as compute (run inside phases 11 and 14)
    p14 = phase14(fed, dev, smi, path_launches, lap)
    phases_s = sum(phase_s.values())
    log(f"[time] phases {phases_s:.1f} s in all, phase 12 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('12 ')):.1f} s, phase 13 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('13 ')):.1f} s, phase 14 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('14 ')):.1f} s, phase 15 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('15 ')):.1f} s (its (c) in "
        f"14 (b)), phase 16 "
        f"{sum(v for k, v in phase_s.items() if k.startswith('16 ')):.1f} s (its (b) in "
        f"15 (a)); {1200 - phases_s:.1f} s left of a 1,200 s call")

    # every kernel's launches over the paths that drive it (each path's
    # counts were reset just before it and read just after)
    launches = {name: sum(p.get(name, 0) for p in path_launches.values())
                for name in checks}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"no path launched {missing}: {path_launches}")
    source = {"fedavg_agg": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
              "kld_greedy_picks": "src/repro_torch/kernels/csrc/kld_greedy.cu",
              "kld_score": "src/repro_torch/kernels/csrc/kld_score.cu",
              "kld_score_matrix": "src/repro_torch/kernels/csrc/kld_score.cu",
              "affine_warp": "src/repro_torch/kernels/csrc/affine_warp.cu",
              "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
              "ssd_chunk_bwd": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu"}
    replaces = {"fedavg_agg": "src/repro/kernels/fedavg_agg.py:68",
                "kld_greedy_picks": "src/repro/kernels/kld_score.py:215",
                "kld_score": "src/repro/kernels/kld_score.py:80",
                "kld_score_matrix": "src/repro/kernels/kld_score.py:116",
                "affine_warp": "src/repro/kernels/affine_warp.py:82",
                "flash_attention": "src/repro/kernels/flash_attention.py:95",
                # no pallas_call: the reference differentiates this attention in XLA
                "flash_attention_bwd": "src/repro/kernels/ref.py:59",
                "ssd_chunk": "src/repro/kernels/ssd_chunk.py:88",
                "ssd_chunk_bwd": "no pallas_call: the reference differentiates "
                                 "src/repro/kernels/ref.py:78 / src/repro/models/ssm.py:56 "
                                 "in XLA"}
    summary = []
    for name, rs in checks.items():
        r = rs[0]                      # the main path's shape
        summary.append({"name": name, "route": "cuda", "source": source[name],
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"], "shape": r["shape"]})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, "build_seconds": build_s,
         "checks": checks, "agreement": agree, "main_path": rows,
         "main_path_peak_mem_gb": peak, "alg3_loop": alg3, "cinic": cinic_rows,
         "cinic_peak_mem_gb": cinic_peak, "cinic_materialized": materialized,
         "row_exec": rows_check,
         "serve_agreement": serve_agree, "serve": served,
         "phase10": p10, "phase11": p11, "phase12": p12, "phase13": p13, "phase14": p14,
         "path_launches": path_launches, "launches": launches, "phase_seconds": phase_s,
         "kernels": summary}, indent=1, default=str))
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
