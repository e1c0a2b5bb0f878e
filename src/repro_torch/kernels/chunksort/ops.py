"""Public op: device dispatch for the chunk-order sort kernel.

``sort_with_perm(keys)`` takes an int32 [n] tensor, or a batch of chunks
int32 [B, n] with n <= 2048, and returns ``(ks int32, perm int64)`` of the
same shape: the stable ascending sort of each row (``perm`` indexes within
its row).  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (``kernels/csrc/chunksort.cu``) or raises.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import sort_with_perm_ref


_P = ctypes.c_void_p
_SIGNATURES = {
    # keys, n, ks_out, perm_out, scratch_k, scratch_i, stream
    "chunksort_sort_pairs": ([_P, ctypes.c_int, _P, _P, _P, _P, _P], ctypes.c_int),
    "chunksort_block": ([], ctypes.c_int),
    # keys, B, n, ks_out, perm_out, stream
    "chunksort_sort_rows": ([_P, ctypes.c_int, ctypes.c_int, _P, _P, _P], ctypes.c_int),
}
# the largest row the batched entry sorts (one CTA per row, in registers)
ROW_MAX = 2048


@functools.cache
def _library():
    """(the library, the largest power of two it sorts without scratch),
    read once: the sort runs once per ingest step, on a host-bound path."""
    lib = _build.load("chunksort", _SIGNATURES)
    return lib, lib.chunksort_block()


def sort_with_perm(keys):
    """Stable ascending sort of an int32 chunk [n], or of each row of a
    batch [B, n]: ``(ks, perm)``, routed by the tensor's device."""
    if keys.device.type == "cpu":
        return sort_with_perm_ref(keys)
    return sort_with_perm_cuda(keys)


def sort_with_perm_cuda(keys):
    """The CUDA kernel.  A chunk of up to 2048 keys is one launch of one
    CTA; larger inputs sort as the padded power of two P.  The kernel pads
    itself, as the reference op pads (``repro/kernels/chunksort/ops.py``):
    slot i >= n holds (EMPTY, i), and EMPTY is the maximal int32 and i
    exceeds every real index, so pads sort strictly after all real entries
    -- real EMPTY keys included -- and the first n outputs are exact."""
    if keys.device.type != "cuda":
        raise ValueError(f"sort_with_perm_cuda needs a CUDA tensor, got {keys.device}")
    if keys.dim() == 2:
        return _sort_rows_cuda(keys)
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"keys must be int32 [n] or [B, n], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    keys = keys.contiguous()
    n = keys.shape[0]
    ks = torch.empty(n, dtype=torch.int32, device=keys.device)
    perm = torch.empty(n, dtype=torch.int64, device=keys.device)
    if n == 0:
        return ks, perm
    lib, block = _library()
    P = 1 << max(0, n - 1).bit_length()
    scratch = P if P > block else 0
    scratch_k = torch.empty(scratch, dtype=torch.int32, device=keys.device)
    scratch_i = torch.empty(scratch, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.chunksort_sort_pairs(keys.data_ptr(), n, ks.data_ptr(), perm.data_ptr(),
                                      scratch_k.data_ptr(), scratch_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"chunksort kernel launch failed: CUDA error {rc}")
    sort_with_perm_cuda.launches += 1
    return ks, perm


def _sort_rows_cuda(keys):
    """A batch of chunks [B, n <= 2048]: one launch, one CTA per row."""
    B, n = keys.shape
    if keys.dtype != torch.int32 or n > ROW_MAX:
        raise ValueError(f"keys must be int32 [B, n] with n <= {ROW_MAX}, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    keys = keys.contiguous()
    ks = torch.empty((B, n), dtype=torch.int32, device=keys.device)
    perm = torch.empty((B, n), dtype=torch.int64, device=keys.device)
    if B == 0 or n == 0:
        return ks, perm
    lib, _ = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.chunksort_sort_rows(keys.data_ptr(), B, n, ks.data_ptr(),
                                     perm.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"chunksort kernel launch failed: CUDA error {rc}")
    sort_with_perm_cuda.launches += 1
    return ks, perm


sort_with_perm_cuda.launches = 0
