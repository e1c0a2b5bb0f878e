"""Public ops: device dispatch for the capscore kernels.

* ``capscore(keys, eids, weights, l, tau, salt)`` -> ``(score, delta,
  entry)``, each [N]: element scoring under one scalar lane (l, tau);
* ``capscore_multi(keys, eids, weights, ls, taus, salt)`` -> ``(score,
  delta, entry, kb)``, each [L, N]: every lane of a grid, element hashes
  shared;
* ``capscore_agg(ks, eids, ws, seg, ls, taus, salt)`` scores every l lane of
  a key-sorted chunk and reduces per key, returning ``(w_total [C], entered
  bool [L, C], contrib, kb_min, min_score [L, C])``;

with the return types of ``repro/kernels/capscore/ops.py`` (``entry`` is
int32).  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (``kernels/csrc/capscore.cu``, ``capscore_agg.cu``) or raises.  The
TPU tile registry has no counterpart: the kernels take any length >= 1.
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
    """Fused multi-l scoring + per-key chunk aggregation, routed by device."""
    if ks.device.type == "cpu":
        return capscore_agg_ref(ks, eids, ws, seg, ls, taus, salt)
    return capscore_agg_cuda(ks, eids, ws, seg, ls, taus, salt)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def capscore_agg_cuda(ks, eids, ws, seg, ls, taus, salt):
    """The CUDA kernel: one warp per key segment, all lanes per walk."""
    dev = ks.device
    if dev.type != "cuda":
        raise ValueError(f"capscore_agg_cuda needs CUDA tensors, got {dev}")
    C = ks.shape[0]
    L = ls.shape[0]
    if C == 0 or L == 0:
        raise ValueError(f"capscore_agg needs C >= 1 and L >= 1, got {C}, {L}")
    for name, t, dt, shape in (("ks", ks, torch.int32, (C,)),
                               ("eids", eids, torch.int32, (C,)),
                               ("ws", ws, torch.float32, (C,)),
                               ("seg", seg, torch.int32, (C,)),
                               ("ls", ls, torch.float32, (L,)),
                               ("taus", taus, torch.float32, (L,))):
        _check(name, t, dt, shape, dev)
    w_total = torch.empty(C, dtype=torch.float32, device=dev)
    entered = torch.empty((L, C), dtype=torch.bool, device=dev)
    contrib = torch.empty((L, C), dtype=torch.float32, device=dev)
    kb_min = torch.empty((L, C), dtype=torch.float32, device=dev)
    min_score = torch.empty((L, C), dtype=torch.float32, device=dev)
    lib = _build.load("capscore_agg", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.capscore_agg_launch(
            ks.data_ptr(), eids.data_ptr(), ws.data_ptr(), seg.data_ptr(), C,
            ls.data_ptr(), taus.data_ptr(), L, int(salt) & 0xFFFFFFFF,
            w_total.data_ptr(), entered.data_ptr(), contrib.data_ptr(),
            kb_min.data_ptr(), min_score.data_ptr(), stream)
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
    """The CUDA kernel: one thread per element, every lane per thread."""
    dev, n = _check_elements("capscore_multi_cuda", keys, eids, weights)
    L = ls.shape[0] if ls.dim() == 1 else 0
    if L == 0:
        raise ValueError(f"capscore_multi needs ls [L] with L >= 1, got {tuple(ls.shape)}")
    _check("ls", ls, torch.float32, (L,), dev)
    _check("taus", taus, torch.float32, (L,), dev)
    score = torch.empty((L, n), dtype=torch.float32, device=dev)
    delta = torch.empty((L, n), dtype=torch.float32, device=dev)
    entry = torch.empty((L, n), dtype=torch.int32, device=dev)
    kb = torch.empty((L, n), dtype=torch.float32, device=dev)
    lib = _build.load("capscore", _SCORE_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.capscore_multi_launch(
            keys.data_ptr(), eids.data_ptr(), weights.data_ptr(), n,
            ls.data_ptr(), taus.data_ptr(), L, int(salt) & 0xFFFFFFFF,
            score.data_ptr(), delta.data_ptr(), entry.data_ptr(), kb.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"capscore_multi kernel launch failed: CUDA error {rc}")
    capscore_multi_cuda.launches += 1
    return score, delta, entry, kb


capscore_multi_cuda.launches = 0


def capscore_cuda(keys, eids, weights, l, tau, salt):
    """The CUDA kernel, single lane: ``(l, tau, salt)`` go by value."""
    dev, n = _check_elements("capscore_cuda", keys, eids, weights)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    delta = torch.empty(n, dtype=torch.float32, device=dev)
    entry = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.load("capscore", _SCORE_SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.capscore_launch(
            keys.data_ptr(), eids.data_ptr(), weights.data_ptr(), n,
            float(l), float(tau), int(salt) & 0xFFFFFFFF,
            score.data_ptr(), delta.data_ptr(), entry.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"capscore kernel launch failed: CUDA error {rc}")
    capscore_cuda.launches += 1
    return score, delta, entry


capscore_cuda.launches = 0
