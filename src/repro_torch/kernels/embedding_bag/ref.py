"""The plain PyTorch versions of ``segment_sum`` and ``embedding_bag``
(mirror ``repro/kernels/embedding_bag/ref.py``).

``segment_sum_ref`` is what ``ops.segment_sum`` runs for a CPU tensor and
what the kernel is held against on the card: ``index_add_`` of the in-range
rows into f64 zeros, rounded once to f32, as the kernel sums.  (The
reference sums in f32; summed in f32, two orders of a segment of millions
of rows differ far beyond f32 rounding, so neither would be a yardstick
for the other.)  On the CPU ``index_add_`` adds the rows in ascending order, the
kernel's own order; on the card it adds with atomics, in an order that
changes from run to run, below the f32 rounding.

``segment_fold_ref`` is the plain version of pass II's deterministic sum
(``ops.segment_fold_``): ``index_add_`` of the in-range rows into the
accumulator itself, in its own dtype.  On the CPU ``index_add_`` adds the
rows in ascending order, a left fold, bit for bit ``np.add.at`` and the
kernel's order; on the card it adds with atomics.
"""
from __future__ import annotations

import torch


def segment_sum_ref(vals, seg_ids, *, n_segments: int):
    """out[s] = sum of the rows n with seg_ids[n] == s, summed in f64 and
    returned as f32 [S, D]; rows whose id lies outside [0, n_segments) are
    dropped."""
    ok = (seg_ids >= 0) & (seg_ids < n_segments)
    out = torch.zeros((n_segments, vals.shape[1]), dtype=torch.float64, device=vals.device)
    return out.index_add_(0, seg_ids[ok].long(), vals[ok].double()).float()


def segment_fold_ref(acc, slot, vals):
    """acc.view(-1)[s] += vals[n] for every row n with slot[n] == s, in row
    order and in ``acc``'s dtype, in place; rows whose slot lies outside
    [0, acc.numel()) are dropped.  Returns ``acc``."""
    flat = acc.view(-1)
    ok = (slot >= 0) & (slot < flat.numel())
    flat.index_add_(0, slot[ok].long(), vals[ok].to(acc.dtype))
    return acc


def embedding_bag_ref(table, ids, bag_segments, *, n_bags: int, mode: str = "sum",
                      per_sample_weights=None):
    """EmbeddingBag: rows = table[ids] (ids clipped to the table, negative =
    padding), optionally scaled by ``per_sample_weights``, summed per bag id;
    ``mode="mean"`` divides by the bag's count of non-padding ids (at least 1)."""
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]
    if per_sample_weights is not None:
        rows = rows * per_sample_weights[:, None]
    valid = ids >= 0
    rows = torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    out = segment_sum_ref(rows, bag_segments, n_segments=n_bags)
    if mode == "mean":
        cnt = segment_sum_ref(valid.float()[:, None], bag_segments, n_segments=n_bags)
        out = out / cnt.clamp(min=1.0)
    return out
