"""Public ops: device dispatch for the capscore kernels.

* ``capscore(keys, eids, weights, l, tau, salt)`` -> ``(score, delta,
  entry)``, each [N]: element scoring under one scalar lane (l, tau);
* ``capscore_multi(keys, eids, weights, ls, taus, salt)`` -> ``(score,
  delta, entry, kb)``, each [L, N]: every lane of a grid, element hashes
  shared;
* ``capscore_agg(ks, eids, ws, seg, ls, taus, salt)`` scores every l lane of
  a key-sorted chunk and reduces per key, returning ``(w_total [C], entered
  bool [L, C], contrib, kb_min, min_score [L, C])``; given a batch of B
  chunks (``ks``, ``eids``, ``ws``, ``seg`` [B, C], ``taus`` [B, L] and
  ``salt`` a tensor of B salts, int32 or uint32 bits; ``ls`` [L] shared) it
  reduces each in one launch and every output gains a leading [B];

with the return types of ``repro/kernels/capscore/ops.py`` (``entry`` is
int32).  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (``kernels/csrc/capscore.cu``, ``capscore_agg.cu``) or raises.  The
TPU tile registry has no counterpart: the kernels take any length >= 1
(``capscore_agg`` up to ``MAX_LANES`` lanes).  The outputs of one call are
views into one allocation (the bool ``entered`` apart).

``capscore_agg`` on a CUDA tensor needs ``seg`` to be the dense segment ids
of ``ks`` (0, 1, ... in order, as ``chunk_order`` makes them): the kernel
writes each row from the segment that ends at it, and a row that a seg with
gaps leaves to no segment is undefined there.  The plain version takes any
sorted ``seg`` in [0, C) and gives such rows the reduction identities.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import capscore_agg_ref, capscore_multi_ref, capscore_ref

_P = ctypes.c_void_p
_SIGNATURES = {
    # ks, eids, ws, seg, C, ls, taus, L, salt,
    # w_total, entered, contrib, kb_min, min_score, stream
    "capscore_agg_launch": ([_P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                             ctypes.c_uint, _P, _P, _P, _P, _P, _P],
                            ctypes.c_int),
    # ks, eids, ws, seg, B, C, ls, taus, L, salts,
    # w_total, entered, contrib, kb_min, min_score, stream
    "capscore_agg_batch_launch": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                                   ctypes.c_int, _P, _P, _P, _P, _P, _P, _P],
                                  ctypes.c_int),
}
_SCORE_SIGNATURES = {
    # keys, eids, weights, n, ls, taus, L, salt, score, delta, entry, kb, stream
    "capscore_multi_launch": ([_P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                               ctypes.c_uint, _P, _P, _P, _P, _P], ctypes.c_int),
    # keys, eids, weights, n, l, tau, salt, score, delta, entry, stream
    "capscore_launch": ([_P, _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                         ctypes.c_uint, _P, _P, _P, _P], ctypes.c_int),
}


def capscore(keys, eids, weights, l, tau, salt):
    """Single-lane element scoring under scalar ``(l, tau)`` (rounded to
    f32), routed by device."""
    if keys.device.type == "cpu":
        return capscore_ref(keys, eids, weights, l, tau, salt)
    return capscore_cuda(keys, eids, weights, l, tau, salt)


def capscore_multi(keys, eids, weights, ls, taus, salt):
    """Multi-lane element scoring (``ls``/``taus`` f32 [L]), routed by
    device."""
    if keys.device.type == "cpu":
        return capscore_multi_ref(keys, eids, weights, ls, taus, salt)
    return capscore_multi_cuda(keys, eids, weights, ls, taus, salt)


def capscore_agg(ks, eids, ws, seg, ls, taus, salt):
    """Fused multi-l scoring + per-key chunk aggregation of one chunk or of
    a batch of chunks, routed by device."""
    if ks.device.type == "cpu":
        return capscore_agg_ref(ks, eids, ws, seg, ls, taus, salt)
    return capscore_agg_cuda(ks, eids, ws, seg, ls, taus, salt)


# capscore_agg.cu's MAX_LANES (it keeps one carry per group of 4 lanes);
# tests/test_torch_capscore.py holds the two equal
MAX_LANES = 4096


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(dev, fn, *args):
    """``fn(*args, stream)`` on ``dev``'s current stream (its raw handle, no
    ``torch.cuda.Stream`` object made), inside the device's context only
    where ``dev`` is not already the current device."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def capscore_agg_cuda(ks, eids, ws, seg, ls, taus, salt):
    """The CUDA kernel: one CTA per chunk, segmented scans over its tiles.
    ``seg`` must be the dense segment ids of ``ks`` (``chunk_order``'s)."""
    if ks.dim() == 2:
        return _capscore_agg_batch_cuda(ks, eids, ws, seg, ls, taus, salt)
    dev = ks.device
    # straight-line checks: this wrapper runs once per ingest chunk
    if dev.type != "cuda":
        raise ValueError(f"capscore_agg_cuda needs CUDA tensors, got {dev}")
    if not (ks.dim() == 1 and ks.numel() > 0 and ls.dim() == 1
            and 0 < ls.numel() <= MAX_LANES):
        raise ValueError(f"capscore_agg needs ks [C] with C >= 1 and ls [L] with "
                         f"1 <= L <= {MAX_LANES}, got {tuple(ks.shape)}, {tuple(ls.shape)}")
    if not (ks.shape == eids.shape == ws.shape == seg.shape and ls.shape == taus.shape):
        raise ValueError(f"capscore_agg needs ks, eids, ws, seg [C] and ls, taus [L], got "
                         f"{[tuple(t.shape) for t in (ks, eids, ws, seg, ls, taus)]}")
    if not (ks.dtype == eids.dtype == seg.dtype == torch.int32
            and ws.dtype == ls.dtype == taus.dtype == torch.float32):
        raise ValueError(f"capscore_agg needs int32 ks, eids, seg and float32 ws, ls, taus, "
                         f"got {[t.dtype for t in (ks, eids, ws, seg, ls, taus)]}")
    if not dev == eids.device == ws.device == seg.device == ls.device == taus.device:
        raise ValueError(f"capscore_agg needs every tensor on {dev}, got "
                         f"{[str(t.device) for t in (eids, ws, seg, ls, taus)]}")
    if not (ks.is_contiguous() and eids.is_contiguous() and ws.is_contiguous()
            and seg.is_contiguous() and ls.is_contiguous() and taus.is_contiguous()):
        raise ValueError("capscore_agg needs contiguous tensors")
    C, L = ks.shape[0], ls.shape[0]
    # the four f32 outputs carved from one allocation
    w_total, contrib, kb_min, min_score = torch.empty(
        (1 + 3 * L, C), dtype=torch.float32, device=dev).split((1, L, L, L))
    w_total = w_total[0]
    entered = torch.empty((L, C), dtype=torch.bool, device=dev)
    lib = _build.load("capscore_agg", _SIGNATURES)
    rc = _launch(dev, lib.capscore_agg_launch,
                 ks.data_ptr(), eids.data_ptr(), ws.data_ptr(), seg.data_ptr(), C,
                 ls.data_ptr(), taus.data_ptr(), L, int(salt) & 0xFFFFFFFF,
                 w_total.data_ptr(), entered.data_ptr(), contrib.data_ptr(),
                 kb_min.data_ptr(), min_score.data_ptr())
    if rc != 0:
        raise RuntimeError(f"capscore_agg kernel launch failed: CUDA error {rc}")
    capscore_agg_cuda.launches += 1
    return w_total, entered, contrib, kb_min, min_score


def _capscore_agg_batch_cuda(ks, eids, ws, seg, ls, taus, salts):
    """B chunks in one launch on a grid of (B, 1 + helpers)."""
    dev = ks.device
    if dev.type != "cuda":
        raise ValueError(f"capscore_agg_cuda needs CUDA tensors, got {dev}")
    if not (ks.numel() > 0 and ls.dim() == 1 and 0 < ls.numel() <= MAX_LANES):
        raise ValueError(f"capscore_agg needs ks [B, C] with B, C >= 1 and ls [L] with "
                         f"1 <= L <= {MAX_LANES}, got {tuple(ks.shape)}, {tuple(ls.shape)}")
    B, C = ks.shape
    L = ls.shape[0]
    if salts.dtype == torch.uint32:
        salts = salts.view(torch.int32)
    for name, t, dtype, shape in (("eids", eids, torch.int32, (B, C)),
                                  ("ws", ws, torch.float32, (B, C)),
                                  ("seg", seg, torch.int32, (B, C)),
                                  ("ks", ks, torch.int32, (B, C)),
                                  ("ls", ls, torch.float32, (L,)),
                                  ("taus", taus, torch.float32, (B, L)),
                                  ("salts", salts, torch.int32, (B,))):
        _check(name, t, dtype, shape, dev)
    # the four f32 outputs carved from one allocation, each contiguous
    w_total, contrib, kb_min, min_score = torch.empty(
        B * C * (1 + 3 * L), dtype=torch.float32, device=dev).split(
            (B * C, B * L * C, B * L * C, B * L * C))
    w_total = w_total.view(B, C)
    contrib, kb_min, min_score = (x.view(B, L, C) for x in (contrib, kb_min, min_score))
    entered = torch.empty((B, L, C), dtype=torch.bool, device=dev)
    lib = _build.load("capscore_agg", _SIGNATURES)
    rc = _launch(dev, lib.capscore_agg_batch_launch,
                 ks.data_ptr(), eids.data_ptr(), ws.data_ptr(), seg.data_ptr(), B, C,
                 ls.data_ptr(), taus.data_ptr(), L, salts.data_ptr(),
                 w_total.data_ptr(), entered.data_ptr(), contrib.data_ptr(),
                 kb_min.data_ptr(), min_score.data_ptr())
    if rc != 0:
        raise RuntimeError(f"capscore_agg kernel launch failed: CUDA error {rc}")
    capscore_agg_cuda.launches += 1
    return w_total, entered, contrib, kb_min, min_score


capscore_agg_cuda.launches = 0


def _check_elements(name, keys, eids, weights):
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if keys.dim() != 1 or keys.shape[0] == 0:
        raise ValueError(f"{name} needs keys [N] with N >= 1, got {tuple(keys.shape)}")
    n = keys.shape[0]
    for arg, t, dt in (("keys", keys, torch.int32), ("eids", eids, torch.int32),
                       ("weights", weights, torch.float32)):
        _check(arg, t, dt, (n,), dev)
    return dev, n


def capscore_multi_cuda(keys, eids, weights, ls, taus, salt):
    """The CUDA kernel: four elements per thread, every lane of them."""
    dev, n = _check_elements("capscore_multi_cuda", keys, eids, weights)
    L = ls.shape[0] if ls.dim() == 1 else 0
    if L == 0:
        raise ValueError(f"capscore_multi needs ls [L] with L >= 1, got {tuple(ls.shape)}")
    _check("ls", ls, torch.float32, (L,), dev)
    _check("taus", taus, torch.float32, (L,), dev)
    # the four outputs carved from one allocation, entry as int32 bits
    score, delta, entry, kb = torch.empty((4, L, n), dtype=torch.float32,
                                          device=dev).unbind(0)
    entry = entry.view(torch.int32)
    lib = _build.load("capscore", _SCORE_SIGNATURES)
    rc = _launch(dev, lib.capscore_multi_launch,
                 keys.data_ptr(), eids.data_ptr(), weights.data_ptr(), n,
                 ls.data_ptr(), taus.data_ptr(), L, int(salt) & 0xFFFFFFFF,
                 score.data_ptr(), delta.data_ptr(), entry.data_ptr(), kb.data_ptr())
    if rc != 0:
        raise RuntimeError(f"capscore_multi kernel launch failed: CUDA error {rc}")
    capscore_multi_cuda.launches += 1
    return score, delta, entry, kb


capscore_multi_cuda.launches = 0


def capscore_cuda(keys, eids, weights, l, tau, salt):
    """The CUDA kernel, single lane: ``(l, tau, salt)`` go by value."""
    dev, n = _check_elements("capscore_cuda", keys, eids, weights)
    score, delta, entry = torch.empty((3, n), dtype=torch.float32, device=dev).unbind(0)
    entry = entry.view(torch.int32)
    lib = _build.load("capscore", _SCORE_SIGNATURES)
    rc = _launch(dev, lib.capscore_launch,
                 keys.data_ptr(), eids.data_ptr(), weights.data_ptr(), n,
                 float(l), float(tau), int(salt) & 0xFFFFFFFF,
                 score.data_ptr(), delta.data_ptr(), entry.data_ptr())
    if rc != 0:
        raise RuntimeError(f"capscore kernel launch failed: CUDA error {rc}")
    capscore_cuda.launches += 1
    return score, delta, entry


capscore_cuda.launches = 0
