"""Astraea federated training of a transformer (``repro/launch/fl_train.py``).

Alg. 3 schedules synthetic non-IID clients' token streams onto mediators
(on the card, the one-launch ``kld_greedy_picks`` kernel); each round is
``launch.steps.make_fl_round``; the ``CommMeter`` keeps the WAN ledger.

  PYTHONPATH=src python -m repro_torch.launch.fl_train --arch qwen3-4b --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu --lora-rank 2
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.fl_train --device cpu

The reduced (CPU smoke) variant of ``--arch``, as the reference.  The
reference runs one mediator per ("pod", "data") slice of its mesh, so on
one device it trains the first mediator's clients only; so does this
launcher.  ``--devices`` names the mesh's positions row-major, ``n * t`` of
them for ``--model-parallel t``: mediator row ``i`` holds positions ``i *
t ... i * t + t - 1``, and the round trains ``n = positions / t``
mediators, one a mediator row on its own devices
(``make_fl_round(model, n, mesh=...)``); a count ``t`` does not divide
raises, as in the reference.

Several processes (``--coordinator host:port --num-processes P
--process-id i``, or torchrun's environment) join through
``launch.mesh.init_distributed``; each trains on its process-local device
(``--device``, or the card of its local rank), so every process books the
single-process run's WAN ledger.  ``--model-parallel t`` runs the round
tensor-parallel over a model axis of ``t`` positions
(``launch/steps.py::make_fl_round(mesh=...)``): ``t`` logical positions on
``--device``'s card, or the positions ``--devices`` names, for every
``--arch`` the round trains, full-delta or with ``--lora-rank``; the WAN
ledger does not change with ``t``.  An audio model's or a VLM's round
raises for its missing frames or vision embeddings at any ``t``, as the
reference's does.

  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu --model-parallel 2
  PYTHONPATH=src python -m repro_torch.launch.fl_train --devices cpu,cpu,cpu,cpu \
      --model-parallel 2 --clients 8 --gamma 4
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu --model-parallel 2 \
      --arch granite-moe-3b-a800m --lora-rank 2
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core import scheduling
from repro_torch.core.comm import CommMeter
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, make_fl_mesh, process_local_mesh
from repro_torch.launch.steps import make_fl_round
from repro_torch.models import lora as lora_lib
from repro_torch.models import transformer as T


def synth_client_streams(generator: torch.Generator, n_clients: int, vocab: int,
                         seq: int, n_topics: int = 8):
    """Synthetic non-IID clients: each client's ``seq`` tokens lie in one
    topic band of the vocab, so its label histogram is ``seq`` at its
    topic.  Returns the streams (on the generator's device) and the
    ``(n_clients, n_topics)`` histograms."""
    dev = generator.device
    streams, counts = [], np.zeros((n_clients, n_topics))
    band = vocab // n_topics
    for i in range(n_clients):
        topic = int(torch.randint(0, n_topics, (), generator=generator, device=dev))
        lo = topic * band
        streams.append(torch.randint(lo, lo + band, (seq,), generator=generator, device=dev))
        counts[i, topic] = seq
    return streams, counts


def pack_mediators(meds, streams, counts, seq: int, n_mediators: int):
    """Tokens, labels ``(n_mediators * per_med, seq)`` and per-row weights
    of the first ``n_mediators`` mediators: each mediator's clients
    client-major, padded with zero rows to the largest mediator, every row
    weighted by its mediator's token count (the reference's repeat, so
    ``n_m`` is ``per_med`` times it for every mediator alike); labels are
    the tokens shifted by one."""
    per_med = max(len(m.clients) for m in meds)
    dev = streams[0].device
    rows, weights = [], []
    for m in meds[:n_mediators]:
        pad = per_med - len(m.clients)
        rows += [streams[c] for c in m.clients]
        rows += [torch.zeros(seq, dtype=streams[0].dtype, device=dev)] * pad
        weights += [float(sum(counts[c].sum() for c in m.clients))] * per_med
    tokens = torch.stack(rows)
    labels = torch.roll(tokens, -1, dims=1)
    w = torch.tensor(weights, dtype=torch.float32, device=dev)
    return tokens, labels, w, per_med


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=C.ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--lora-rank", type=int, default=None,
                    help="LoRA adapter rank: freeze the backbone and ship only the "
                         "adapter state over the WAN; 0 freezes everything, unset = "
                         "full-delta exchange")
    ap.add_argument("--lora-alpha", type=float, default=None,
                    help="LoRA merge scale alpha (default: rank, i.e. 1.0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; under several "
                         "processes, the card of the local rank)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size: the round runs tensor-parallel over this "
                         "many positions (logical ones on --device's card unless "
                         "--devices names them)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the mesh's positions, row-major "
                         "(e.g. cuda:0,cuda:1,cuda:2,cuda:3 with --model-parallel 2: two "
                         "mediator rows of two columns); the round trains one mediator "
                         "a row; default: --model-parallel logical positions on the "
                         "round's device")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the run's TCPStore, hosted by process 0 "
                         "(env: MASTER_ADDR, MASTER_PORT); each process trains on "
                         "its process-local device")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="processes in the run (env: WORLD_SIZE)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (env: RANK)")
    args = ap.parse_args(argv)
    if args.model_parallel < 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: must be >= 1")

    distributed = init_distributed(args.coordinator, args.num_processes, args.process_id)
    if distributed:
        import torch.distributed as dist
        dev = process_local_mesh(device=args.device).devices[0]
        if dist.get_rank() == 0:
            print(f"distributed: {dist.get_world_size()} processes joined, "
                  f"process 0 on {dev}")
    else:
        dev = resolve_device(args.device)
    cfg = C.reduced(C.get(args.arch))
    mesh = None
    n_mediators = 1                       # one device: the reference's 1 x 1 mesh
    if args.model_parallel > 1 or args.devices:
        # this process's positions (under several processes each keeps its
        # process-local mesh, as the reference does)
        positions = [resolve_device(d) for d in args.devices.split(",")] if args.devices \
            else [dev] * args.model_parallel
        if len(positions) % args.model_parallel:
            raise SystemExit(f"{len(positions)} positions are not divisible by "
                             f"--model-parallel {args.model_parallel}")
        n_mediators = len(positions) // args.model_parallel
        mesh = make_fl_mesh(mediator=n_mediators, model=args.model_parallel,
                            devices=positions)
        print(f"mesh: {n_mediators} mediator rows x {args.model_parallel} model columns "
              f"on {', '.join(str(d) for d in positions)}")
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = T.train_params(model)

    # WAN ledger: the paper's traffic claim, measured instead of assumed
    meter = CommMeter(T.param_count(cfg), bytes_per_param=cfg.torch_dtype().itemsize)
    mapping = a_tree = state = None
    if args.lora_rank is not None:
        mapping = T.adapter_mapping(cfg, args.lora_rank, args.lora_alpha)
        a_tree = lora_lib.init_adapter_A(lora_lib.A_SALT, mapping, dev)
        state = lora_lib.init_adapter_state(mapping, params)
        meter.adapter_payload_bytes = lora_lib.exchange_nbytes(mapping, meter.bytes_per_param)
        print(f"lora rank={args.lora_rank}: {lora_lib.num_trainable_params(mapping)} "
              f"trainable params, {meter.adapter_payload_bytes} bytes/leg "
              f"(full leg {int(meter.model_bytes)})")

    streams, counts = synth_client_streams(torch.Generator(device=dev).manual_seed(1),
                                           args.clients, cfg.vocab, args.seq)
    # Alg. 3: schedule clients onto mediators by KLD-to-uniform of topics
    meds = scheduling.reschedule(counts, gamma=args.gamma, device=dev)
    stats = scheduling.schedule_stats(meds)
    print(f"mediators={stats['num_mediators']} kld_mean={stats['kld_mean']:.3f}")
    if len(meds) < n_mediators:
        raise SystemExit(f"Alg. 3 made {len(meds)} mediators for {n_mediators} mediator "
                         f"rows: schedule more --clients")
    tokens, labels, w, per_med = pack_mediators(meds, streams, counts, args.seq, n_mediators)

    fl_round = make_fl_round(model, n_mediators, learning_rate=args.lr,
                             local_steps=per_med, mediator_epochs=1, lora_mapping=mapping,
                             mesh=mesh)
    n_clients_sched = sum(len(m.clients) for m in meds[:n_mediators])
    losses = []
    for r in range(args.rounds):
        t0 = time.time()
        if mapping is not None:
            state = fl_round(params, a_tree, state, tokens, labels, w)
            eval_params = lora_lib.merge_params(params, a_tree, state, mapping)
        else:
            params = fl_round(params, tokens, labels, w)
            eval_params = params
        # each round: model/adapter down+up per client plus the
        # server<->mediator legs (the Astraea WAN formula)
        wan0 = meter.total_bytes
        meter.astraea_round(n_clients_sched, args.gamma)
        meter.end_round()
        with torch.no_grad():
            loss, _ = T.forward_train(model, {"tokens": tokens[:2], "labels": labels[:2]},
                                      eval_params)
        losses.append(float(loss))
        print(f"round {r}: loss={losses[-1]:.4f} wan={meter.total_bytes - wan0:.0f}B "
              f"({time.time() - t0:.1f}s)")
        if not math.isfinite(losses[-1]):
            raise RuntimeError("training diverged")

    # the measured per-round WAN ledger (not the back-of-envelope claim)
    print("WAN ledger:")
    ledger = meter.ledger_totals()
    for key, total in ledger.items():
        print(f"  {key}: {total:.0f}")
    ratio = meter.adapter_reduction_ratio
    if ratio is not None:
        print(f"  adapter/full byte ratio: {ratio:.4f} "
              f"({(1 - ratio) * 100:.1f}% WAN reduction)")
    print("done")
    return {"losses": losses, "ledger": ledger, "ratio": ratio,
            "mediators": stats["num_mediators"], "mediators_trained": n_mediators}


if __name__ == "__main__":
    main()
