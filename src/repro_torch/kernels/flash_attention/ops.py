"""Public attention op with backend dispatch (port of
``repro/kernels/flash_attention/ops.py``).

Backends, with the reference's names so configs carry over:

* ``None`` and ``"pallas"`` — ``flash_attention``: the hand-written CUDA
  kernels for a CUDA tensor (bf16: the tensor-core kernel
  ``kernels/csrc/flash_attention_sm90.cu``; f32: the FMA kernel
  ``kernels/csrc/flash_attention.cu``), ``attention_ref`` for a CPU tensor;
* ``"xla_chunked"`` — ``xla_chunked_attention``, one q chunk at a time
  (scores S x chunk), plain PyTorch;
* ``"naive"`` — ``attention_ref``, the full S x S scores.

q is [B, Hq, S, D], k and v [B, Hkv, S, D] with Hq % Hkv == 0; each returns
[B, Hq, S, D] in q.dtype.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

_P = ctypes.c_void_p
# both launch functions: q, k, v, o, B, Hq, Hkv, S, D, strides[12], scale,
# causal, stream -> cudaError_t
SIGNATURE = ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, _P, ctypes.c_float, ctypes.c_int, _P], ctypes.c_int)
# dtype -> (library, launch function, launch counter)
KERNELS = {
    torch.bfloat16: ("flash_attention_sm90", "flash_attention_tc_launch", "launches_tc"),
    torch.float32: ("flash_attention", "flash_attention_launch", "launches_fma"),
}
HEAD_DIMS = (16, 32, 64, 128)


def xla_chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 512):
    """Memory-efficient attention: scores for one q chunk at a time (peak
    S x chunk instead of S x S), k/v repeated per q head, f32 einsums."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    scale = 1.0 / (D**0.5)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    kpos = torch.arange(S, device=q.device)[None, :]
    out = torch.empty((B, Hq, S, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, c0:c0 + chunk].float(), kk) * scale
        if causal:
            qpos = c0 + torch.arange(chunk, device=q.device)[:, None]
            s = torch.where(qpos >= kpos, s, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vv)
        out[:, :, c0:c0 + chunk] = o / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention routed by device: the plain version (``attention_ref``)
    for a CPU tensor, the CUDA kernel for a CUDA tensor (or it raises)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)


def attention(q, k, v, *, causal: bool = True, backend: str | None = None,
              chunk: int = 512):
    if backend is None or backend == "pallas":
        return flash_attention(q, k, v, causal=causal)
    if backend == "xla_chunked":
        return xla_chunked_attention(q, k, v, causal=causal, chunk=chunk)
    if backend == "naive":
        return attention_ref(q, k, v, causal=causal)
    raise ValueError(backend)


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """The CUDA kernels, routed by dtype; there is no fallback between them.

    * bfloat16: the tensor-core kernel (``flash_attention_sm90.cu``), one
      block per (128-row q tile, q head, batch): TMA copies, wgmma products,
      P split into two bf16 halves for P.V; counted in ``.launches_tc``.
      TMA needs q, k, v to start on 16-byte boundaries and to step by whole
      16-byte units (strides that are multiples of 8 elements).
    * float32: the FMA kernel (``flash_attention.cu``), one block per
      (64-row q tile, q head, batch); counted in ``.launches_fma``.

    ``.launches`` counts both.  q, k, v may be strided views (the last dim
    must be contiguous), e.g. ``x.transpose(1, 2)`` of [B, S, H, D]
    projections.  The output is allocated as [B, S, Hq, D] and returned as
    its [B, Hq, S, D] view, so transposing it back is free."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides "
                             f"{t.stride()}")
    if q.dtype not in KERNELS:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, got {q.dtype}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(f"k, v must be [B, Hkv, S, D] = [{B}, {Hkv}, {S}, {D}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if B == 0 or S == 0:
        raise ValueError(f"flash_attention_cuda needs B >= 1 and S >= 1, got {B}, {S}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            steps = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
            if t.data_ptr() % 16 or any(s % 8 for s in steps):
                raise ValueError(f"{name} must start on a 16-byte boundary and step by "
                                 f"multiples of 8 elements for the TMA copies, got address "
                                 f"{t.data_ptr():#x}, strides {t.stride()}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    name, fn, counter = KERNELS[q.dtype]
    lib = _build.load(name, {fn: SIGNATURE})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            ctypes.cast(strides, _P), 1.0 / (D**0.5), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    setattr(flash_attention_cuda, counter, getattr(flash_attention_cuda, counter) + 1)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_fma = 0
