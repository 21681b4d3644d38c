"""Table III's metric over a trainer's history: the WAN traffic spent
until the model first reached a target accuracy (a copy of
``benchmarks/fl_experiments.py::traffic_to_reach``).

A history is the list ``fit`` returns: one dict per evaluation with at
least ``accuracy`` and ``traffic_mb`` (the cumulative ledger, MiB).
"""
from __future__ import annotations


def best_accuracy(history: list[dict]) -> float:
    return max(h["accuracy"] for h in history)


def traffic_to_reach(history: list[dict], target: float) -> float | None:
    """``traffic_mb`` at the first evaluation with accuracy >= ``target``;
    None if none reached it."""
    for h in history:
        if h["accuracy"] >= target:
            return h["traffic_mb"]
    return None
