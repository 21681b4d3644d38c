"""Serving entry point: batched prefill, then greedy decode with the KV/SSM cache.

  PYTHONPATH=src python -m repro_torch.launch.serve                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --device cpu

The CLI serves the reduced (CPU smoke) variant of ``--arch`` (any of the
ten ids of ``configs.ARCH_IDS``) with random weights, as the reference's
``repro.launch.serve`` does; ``serve(cfg, ...)`` takes any config, e.g.
``configs.get("gemma-2b")`` at full width.

A VLM reads stub vision embeddings ahead of its prompt and an audio model
stub frame embeddings through its encoder; ``serve`` draws both from its
generator.  Two departures from the reference's driver, whose
``forward_prefill``/``forward_decode`` are sound but which feeds decode
wrongly:

* decode positions start after the whole prefilled sequence, ``vision
  tokens + prompt``; the reference's start at ``prompt``, so a VLM's decode
  writes over prompt slots of its cache;
* an audio model's decode cross-attends to the encoder output its prefill
  returned (``cache["enc_out"]``); the reference passes the raw frame
  embeddings as ``enc_out``, which its prefill never attended to.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def modality_inputs(cfg: C.ArchConfig, batch: int, generator: torch.Generator,
                    device) -> dict:
    """A VLM's stub vision embeddings ``vision_embeds (batch, vision_tokens,
    d)`` or an audio model's stub frame embeddings ``enc_feats (batch,
    source_positions, d)``, standard normal from ``generator`` in the
    model's dtype; ``{}`` for the text families."""
    shape = {"vlm": ("vision_embeds", cfg.vision_tokens),
             "audio": ("enc_feats", cfg.source_positions)}.get(cfg.arch_type)
    if shape is None:
        return {}
    name, n = shape
    x = torch.randn(batch, n, cfg.d_model, generator=generator, device=device)
    return {name: x.to(cfg.torch_dtype())}


def prefix_len(cfg: C.ArchConfig) -> int:
    """Positions ahead of the prompt: a VLM's vision tokens."""
    return cfg.vision_tokens if cfg.arch_type == "vlm" else 0


def serve(cfg: C.ArchConfig, *, batch: int, prompt_len: int, tokens: int,
          device=None, generator: torch.Generator | None = None,
          model: T.Transformer | None = None) -> dict:
    """Random weights (unless ``model``, built for ``cfg`` on ``device``, is
    given; learned positions sized to the decode budget), then prompts and
    a VLM's or audio model's stub inputs (``modality_inputs``) from
    ``generator`` (one seeded with 0 on the device when not given); a
    ``batch x prompt_len`` prefill into a cache sized for the whole
    sequence (vision tokens, prompt and ``tokens``), then ``tokens - 1``
    greedy decode steps.  Returns the generated tokens ``(batch, tokens)``,
    whether every logit of every step was finite, the prefill and
    per-step decode seconds (host clock around synchronized work), the
    kernel launches of the prefill and of the decode steps (all of them)
    and the model's parameter count."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    start = prefix_len(cfg) + prompt_len
    if model is None:
        model = T.init_model(cfg, generator, device=dev, max_seq=start + tokens)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=generator,
                            device=dev)
    inputs = {"tokens": prompts, **modality_inputs(cfg, batch, generator, dev)}
    prefill = make_prefill_step(model, pad_to=start + tokens)
    step = make_serve_step(model)

    _sync(dev)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    tok, logits, cache = prefill(inputs)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    mid = dict(ops.LAUNCHES)

    out, finite = [tok], bool(torch.isfinite(logits).all())
    step_s = []
    for i in range(tokens - 1):
        pos = torch.full((batch,), start + i, dtype=torch.long, device=dev)
        t0 = time.perf_counter()
        tok, logits, cache = step({"tokens": tok, "positions": pos}, cache)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        out.append(tok)
        finite = finite and bool(torch.isfinite(logits).all())
    return {"tokens": torch.cat(out, dim=1), "logits_finite": finite,
            "prefill_s": prefill_s, "decode_step_s": step_s,
            "prefill_launches": {k: mid[k] - before[k] for k in mid},
            "decode_launches": {k: ops.LAUNCHES[k] - mid[k] for k in mid},
            "params": T.param_count(cfg, model.max_seq)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=C.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = C.reduced(C.get(args.arch))
    r = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
              device=args.device)
    print(f"prefill done in {r['prefill_s']:.2f}s; decoding {args.tokens} tokens")
    steps = r["decode_step_s"]
    ms = 1e3 * sum(steps) / max(len(steps), 1)
    print(f"decode: {ms:.1f} ms/token/batch; sample row: "
          f"{r['tokens'][0].tolist()}")
    return r


if __name__ == "__main__":
    main()
