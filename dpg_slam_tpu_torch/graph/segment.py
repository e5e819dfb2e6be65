"""Ordered segment sums: a reproducible stand-in for float ``index_add_``.

On a CUDA tensor ``index_add_`` accumulates with float atomics, so the
order of the additions into a row, and with it the rounding, changes from
run to run. Here the destination indices are sorted once, stably, and each
destination row sums its values in their input order, one after another
(``torch.segment_reduce``). That is the order in which ``index_add_`` adds
on the CPU, so on the CPU the result equals ``index_add_``'s to the bit,
and on the card every run gives the same bits.

A SegmentPlan holds the sort and the segment offsets. The pose-graph solves
build one per solve (their factor indices are fixed for the whole solve)
and reuse it for every assembly. A value bound for row n is dropped: the
solves send their masked factor slots there, so no row sums the masked
slots' zeros (they sort last and lie past the last offset; summed, they
would make one long sequential segment, and they change no sum but the
sign of a zero). Neither the plan nor the sum reads the host: the
offsets come from ``searchsorted`` (``bincount`` would size its output on
the host) and ``segment_reduce`` runs with ``unsafe=True`` (it would check
the offsets on the host).

Where the rows outnumber the values (the dense normal matrix: S·N·N block
rows, a few per node filled), one segment per row would make
``segment_reduce`` walk every empty row. The plan then has one segment
per value instead: the segment of the last value bound for a row spans
all of that row's values, the others are empty. The sums are written to
their rows by index (each row once; the empty segments all write zeros to
a spare row that is dropped), so the bits are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SegmentPlan", "segment_plan", "segment_sum"]


class SegmentPlan(NamedTuple):
    order: torch.Tensor           # (M,) int64 stable sort of the destination rows
    offsets: torch.Tensor         # int64 segment starts in that order, and the end
    rows: torch.Tensor | None     # (M,) row of each segment (n: the spare row), or None: segment k is row k
    n: int                        # rows of the sum


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The plan for summing M values into n rows at destinations idx
    (M,), each in [0, n]; the values bound for row n are dropped."""
    idx = idx.reshape(-1).to(torch.int64)
    keys, order = torch.sort(idx, stable=True)
    M = keys.numel()
    if n <= M:
        return SegmentPlan(order, torch.searchsorted(keys, torch.arange(n + 1, dtype=torch.int64, device=idx.device)),
                           None, n)
    # Value t's segment runs from the start of its row's run to t + 1 if t
    # is the run's last value, else it is empty; the dropped values' runs
    # start and end at their first place, so their segments are empty.
    offsets = torch.searchsorted(keys, torch.cat([keys, torch.full((1,), n, dtype=torch.int64, device=idx.device)]))
    last = torch.cat([keys[1:] != keys[:-1], torch.ones((min(M, 1),), dtype=torch.bool, device=idx.device)])
    return SegmentPlan(order, offsets, torch.where(last, keys, n), n)


def segment_sum(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(n, ...) sums of vals (M, ...) by plan: row k is 0 + the values
    bound for k, added in their order in vals (zeros for a row no value
    goes to)."""
    sums = torch.segment_reduce(vals[plan.order], "sum", offsets=plan.offsets, axis=0, unsafe=True)
    if plan.rows is None:
        return sums
    out = vals.new_zeros((plan.n + 1,) + vals.shape[1:])
    out[plan.rows] = sums
    return out[: plan.n]
