"""Public ops: segment_sum and embedding_bag (port of
``repro/kernels/embedding_bag/ops.py``).

Both ops are routed by the device of their tensors: a CPU tensor runs the
plain version (``segment_sum_ref``, ``embedding_bag_ref``), a CUDA tensor
launches the kernel or raises.  There is no backend knob and no fallback.
``segment_sum`` launches ``kernels/csrc/segment_sum.cu``; ``embedding_bag``
launches ``kernels/csrc/embedding_bag.cu``, which reads each bag's rows
straight from the table (no gathered copy, no ``segment_sum``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _build
from .ref import embedding_bag_ref, segment_sum_ref  # noqa: F401

_P = ctypes.c_void_p
_SIGNATURES = {
    # vals, dtype, perm, offsets, S, D, out, stream
    "segment_sum_launch": ([_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            _P, _P], ctypes.c_int),
}
_LL = ctypes.c_longlong
_BAG_SIGNATURES = {
    # table, dtype, V, row_stride, D, ids, ids_int64, perm, offsets, S,
    # weights, wkind, mean, out, stream
    "embedding_bag_launch": ([_P, ctypes.c_int, _LL, _LL, ctypes.c_int, _P, ctypes.c_int,
                              _P, _P, _LL, _P, ctypes.c_int, ctypes.c_int, _P, _P],
                             ctypes.c_int),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_sum(vals, seg_ids, *, n_segments: int):
    """out[s] = sum_{n: seg_ids[n] == s} vals[n] as f32 [S, D]; ids outside
    [0, n_segments) are dropped."""
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg_ids, n_segments=n_segments)
    return segment_sum_cuda(vals, seg_ids, n_segments=n_segments)


def grouping(seg_ids, n_segments: int, *, sorted_ids: bool = False):
    """The rows of each segment in a stable order: ``(perm, offsets)``, where
    segment s owns positions ``offsets[s]:offsets[s+1]`` (int64 [S + 1]) of
    ``perm`` (int64 [N]), or of the identity where ``perm`` is None.

    Non-decreasing ids are their own grouping (a bag's ids are); other ids
    go through ``torch.sort(stable=True)`` with the out-of-range ones keyed
    past the last segment, so every range leaves them out.  One host sync,
    the test whether the ids are sorted, unless ``sorted_ids`` says they are
    (then the ranges come from ``searchsorted`` alone, on the device)."""
    keys, perm = seg_ids, None
    if (not sorted_ids and seg_ids.shape[0] > 1
            and bool((seg_ids[1:] < seg_ids[:-1]).any())):
        in_range = (seg_ids >= 0) & (seg_ids < n_segments)
        keys, perm = torch.sort(torch.where(in_range, seg_ids, n_segments), stable=True)
    offsets = torch.searchsorted(keys.contiguous(),
                                 _boundaries(n_segments, keys.dtype, keys.device))
    return perm, offsets


@functools.lru_cache(maxsize=32)
def _boundaries(n_segments: int, dtype, device):
    """``arange(n_segments + 1)``, made once per shape (read only): one
    allocation and launch fewer per call on a host-bound path."""
    return torch.arange(n_segments + 1, dtype=dtype, device=device)


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
    the bag's count of non-padding ids, at least 1)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, bag_segments, n_bags=n_bags, mode=mode,
                                 per_sample_weights=per_sample_weights)
    return embedding_bag_cuda(table, ids, bag_segments, n_bags=n_bags, mode=mode,
                              per_sample_weights=per_sample_weights)


def embedding_bag_sorted(table, ids, bag_segments, *, n_bags: int, mode: str = "sum",
                         per_sample_weights=None):
    """``embedding_bag`` for a caller whose bag ids are non-decreasing by
    construction (``models.recsys.history_pool``'s ``arange(B)`` repeated):
    a CPU tensor runs the plain version, a CUDA tensor the fused kernel with
    the bags' ranges from ``searchsorted`` alone, so no host sync."""
    if table.device.type == "cpu":
        return embedding_bag(table, ids, bag_segments, n_bags=n_bags, mode=mode,
                             per_sample_weights=per_sample_weights)
    return embedding_bag_cuda(table, ids, bag_segments, n_bags=n_bags, mode=mode,
                              per_sample_weights=per_sample_weights, sorted_bags=True)


def _bag_args(table, bag_segments, n_bags: int, per_sample_weights=None, *,
                       sorted_bags: bool = False):
    """What the kernel reads besides the table and the ids: ``(perm,
    offsets, weights, wkind)``.  ``grouping`` gives the bags' ranges;
    ``wkind`` is 0 without weights, 1 for f32 products (the weights as f32)
    and 2 where PyTorch's product keeps the table's bf16/f16 dtype (the
    weights in it).  Makes no host sync where ``sorted_bags``."""
    perm, offsets = grouping(bag_segments, n_bags, sorted_ids=sorted_bags)
    if per_sample_weights is None:
        return perm, offsets, None, 0
    w = per_sample_weights
    if w.dtype not in _DTYPES:
        raise ValueError(f"per_sample_weights must be float32, bfloat16 or float16, "
                         f"got {w.dtype}")
    if torch.result_type(table, w) == table.dtype != torch.float32:
        return perm, offsets, w.contiguous(), 2
    return perm, offsets, w.float().contiguous(), 1


def embedding_bag_cuda(table, ids, bag_segments, *, n_bags: int, mode: str = "sum",
                       per_sample_weights=None, sorted_bags: bool = False):
    """The gather-fused CUDA kernel: one launch reads each bag's non-padding
    rows straight from ``table`` (no gathered copy), weighs them, sums them
    in f64 in ascending row order and, for "mean", divides by the count it
    took in the same pass.

    The caller says whether the bag ids are non-decreasing
    (``sorted_bags=True``): then the bags' ranges come from ``searchsorted``
    on the device and the call makes no host sync, which matters on
    serve_p99's path, where the host is the bottleneck.  A check on the
    device could not choose between that route and the stable sort that
    other ids need without a sync, and computing the sort every time would
    cost serve_bulk a sort of 13 M ids.  ``history_pool`` builds its bags as
    ``arange(B)`` repeated, non-decreasing by construction, and pools them
    through ``embedding_bag_sorted``.  Without the
    promise, ``grouping`` tests the ids (one sync) and sorts unsorted ones,
    and the kernel reads the rows through that order."""
    dev = table.device
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    tensors = [ids, bag_segments] + ([per_sample_weights] if per_sample_weights is not None
                                     else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in [table, *tensors]]}")
    if table.dim() != 2 or table.dtype not in _DTYPES or table.stride(1) != 1:
        raise ValueError(f"table must be [V, D] float32, bfloat16 or float16 with unit "
                         f"column stride, got {table.dtype} {tuple(table.shape)} strides "
                         f"{table.stride()}")
    N = ids.shape[0]
    if any(t.dim() != 1 or t.shape[0] != N for t in tensors):
        raise ValueError(f"ids, bag_segments and per_sample_weights must be [N], got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(t.dtype not in (torch.int32, torch.int64) for t in (ids, bag_segments)):
        raise ValueError(f"ids and bag_segments must be int32 or int64, got {ids.dtype} "
                         f"and {bag_segments.dtype}")
    V, D = table.shape
    S = int(n_bags)
    out = torch.empty((S, D), dtype=torch.float32, device=dev)
    if S == 0 or D == 0:
        return out
    if V == 0 and N:
        raise ValueError("embedding_bag_cuda: ids into an empty table")
    perm, offsets, w, wkind = _bag_args(table, bag_segments, S, per_sample_weights,
                                        sorted_bags=sorted_bags)
    ids = ids.contiguous()
    lib = _build.load("embedding_bag", _BAG_SIGNATURES)
    # the launch goes to the current device: switch only where it is another
    guard = (torch.cuda.device(dev) if dev.index not in (None, torch.cuda.current_device())
             else contextlib.nullcontext())
    with guard:
        rc = lib.embedding_bag_launch(
            table.data_ptr(), _DTYPES[table.dtype], max(V, 1), table.stride(0), D,
            ids.data_ptr(), int(ids.dtype == torch.int64),
            perm.data_ptr() if perm is not None else None, offsets.data_ptr(), S,
            w.data_ptr() if w is not None else None, wkind, int(mode == "mean"),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {rc}")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
