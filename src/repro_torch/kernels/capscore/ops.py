"""Public op: device dispatch for the fused capscore_agg kernel.

``capscore_agg(ks, eids, ws, seg, ls, taus, salt)`` scores every l lane of a
key-sorted chunk and reduces per key, returning
``(w_total [C], entered bool [L, C], contrib, kb_min, min_score [L, C])`` as
``repro/kernels/capscore/ops.py`` does.  A CPU tensor runs the plain version;
a CUDA tensor launches ``kernels/csrc/capscore_agg.cu`` or raises.  The TPU
tile registry has no counterpart: the kernel takes any chunk length.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import capscore_agg_ref

_P = ctypes.c_void_p
_SIGNATURES = {
    # ks, eids, ws, seg, C, ls, taus, L, salt,
    # w_total, entered, contrib, kb_min, min_score, stream
    "capscore_agg_launch": ([_P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                             ctypes.c_uint, _P, _P, _P, _P, _P, _P],
                            ctypes.c_int),
}


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
