"""Serving steps (``repro/launch/steps.py::make_prefill_step`` /
``make_serve_step``): greedy next-token choice on top of the model's
prefill and decode passes.  The steps also return the logits, so a caller
can check them."""
from __future__ import annotations

from repro_torch.models import transformer as T


def make_prefill_step(model: T.Transformer, pad_to: int | None = None):
    """``step(batch) -> (next tokens (b, 1), logits (b, 1, vocab), cache)``."""
    def prefill_step(batch):
        logits, cache = T.forward_prefill(model, batch, pad_to=pad_to)
        return logits.argmax(-1), logits, cache
    return prefill_step


def make_serve_step(model: T.Transformer):
    """One decode step: ``step(batch, cache) -> (next tokens (b, 1), logits
    (b, 1, vocab), cache)``; the cache is updated in place."""
    def serve_step(batch, cache):
        logits, cache = T.forward_decode(model, batch, cache)
        return logits.argmax(-1), logits, cache
    return serve_step
