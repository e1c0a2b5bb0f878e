"""Public ops: segment_sum and embedding_bag (port of
``repro/kernels/embedding_bag/ops.py``).

``segment_sum`` is routed by the device of its tensor: a CPU tensor runs the
plain version (``segment_sum_ref``), a CUDA tensor launches the kernel
(``kernels/csrc/segment_sum.cu``) or raises.  There is no backend knob and
no fallback.  ``embedding_bag`` gathers the rows and reduces them through
``segment_sum``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import embedding_bag_ref, segment_sum_ref  # noqa: F401

_P = ctypes.c_void_p
_SIGNATURES = {
    # vals, dtype, perm, offsets, S, D, out, stream
    "segment_sum_launch": ([_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            _P, _P], ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_sum(vals, seg_ids, *, n_segments: int):
    """out[s] = sum_{n: seg_ids[n] == s} vals[n] as f32 [S, D]; ids outside
    [0, n_segments) are dropped."""
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg_ids, n_segments=n_segments)
    return segment_sum_cuda(vals, seg_ids, n_segments=n_segments)


def grouping(seg_ids, n_segments: int):
    """The rows of each segment in a stable order: ``(perm, offsets)``, where
    segment s owns positions ``offsets[s]:offsets[s+1]`` (int64 [S + 1]) of
    ``perm`` (int64 [N]), or of the identity where ``perm`` is None.

    Non-decreasing ids are their own grouping (a bag's ids are); other ids
    go through ``torch.sort(stable=True)`` with the out-of-range ones keyed
    past the last segment, so every range leaves them out.  One host sync:
    the test whether the ids are sorted."""
    keys, perm = seg_ids, None
    if seg_ids.shape[0] > 1 and bool((seg_ids[1:] < seg_ids[:-1]).any()):
        in_range = (seg_ids >= 0) & (seg_ids < n_segments)
        keys, perm = torch.sort(torch.where(in_range, seg_ids, n_segments), stable=True)
    offsets = torch.searchsorted(keys.contiguous(), torch.arange(
        n_segments + 1, dtype=keys.dtype, device=keys.device))
    return perm, offsets


def segment_sum_cuda(vals, seg_ids, *, n_segments: int):
    """The CUDA kernel over ``grouping(seg_ids)``: it reads ``vals`` through
    the order (no permuted copy) and sums each segment's rows in ascending
    row order."""
    dev = vals.device
    if dev.type != "cuda" or seg_ids.device != dev:
        raise ValueError(f"segment_sum_cuda needs CUDA tensors on one device, got "
                         f"{dev} and {seg_ids.device}")
    if vals.dim() != 2 or seg_ids.dim() != 1 or seg_ids.shape[0] != vals.shape[0]:
        raise ValueError(f"vals must be [N, D] and seg_ids [N], got {tuple(vals.shape)} "
                         f"and {tuple(seg_ids.shape)}")
    if vals.dtype not in _DTYPES:
        raise ValueError(f"segment_sum_cuda takes float32, bfloat16 or float16 rows, "
                         f"got {vals.dtype}")
    if seg_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"seg_ids must be int32 or int64, got {seg_ids.dtype}")
    D = vals.shape[1]
    S = int(n_segments)
    vals = vals.contiguous()
    out = torch.empty((S, D), dtype=torch.float32, device=dev)
    if S == 0 or D == 0:
        return out
    perm, offsets = grouping(seg_ids, S)
    lib = _build.load("segment_sum", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.segment_sum_launch(vals.data_ptr(), _DTYPES[vals.dtype],
                                    perm.data_ptr() if perm is not None else None,
                                    offsets.data_ptr(), S, D, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {rc}")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0


def embedding_bag(table, ids, bag_segments, *, n_bags: int, mode: str = "sum",
                  per_sample_weights=None):
    """Gather + bag-reduce as f32 [n_bags, D].  ids: [N] (negative =
    padding, ids past the table clipped to its last row, as the reference
    does); bag_segments: [N] bag ids; ``mode`` "sum" or "mean" (divided by
    the bag's count of non-padding ids, at least 1).

    Padding rows are left out before the gather, not zeroed after it: the
    sums are the same, no second [N, D] array is made, and a subsequence of
    non-decreasing bag ids stays non-decreasing.  ``per_sample_weights``
    scales the gathered rows in place.  ``mode="mean"`` reduces twice, as
    the reference op does: the rows, then the counts."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    kept = (ids >= 0).nonzero().squeeze(1)
    rows = table[ids[kept].clamp(max=table.shape[0] - 1)]
    segs = bag_segments[kept]
    if per_sample_weights is not None:
        w = per_sample_weights[kept][:, None]
        rows = rows.mul_(w) if torch.result_type(rows, w) == rows.dtype else rows * w
    out = segment_sum(rows, segs, n_segments=n_bags)
    if mode == "mean":
        ones = torch.ones((rows.shape[0], 1), dtype=torch.float32, device=rows.device)
        del rows
        cnt = segment_sum(ones, segs, n_segments=n_bags)
        out.div_(cnt.clamp_(min=1.0))
    return out
