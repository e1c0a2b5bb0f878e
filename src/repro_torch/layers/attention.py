"""GQA attention layer: train, prefill and decode (port of
``repro/layers/attention.py``).

Activations between the projections are [B, S, heads, d]; the attention op
takes [B, heads, S, d] views of them.  On one card there is no head
sharding, so the reference's sharding hints have no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.flash_attention.ops import attention as attention_op
from .common import apply_rope, dense_init, rms_norm, rope_angles


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attention_chunk: int = 512
    backend: str | None = "xla_chunked"  # None / "pallas": the attention kernel


def attention_shapes(cfg: AttentionConfig) -> dict[str, tuple[int, ...]]:
    """The layer's parameter names and shapes, as ``init_attention`` makes them."""
    shapes = {
        "wq": (cfg.d_model, cfg.n_heads * cfg.d_head),
        "wk": (cfg.d_model, cfg.n_kv * cfg.d_head),
        "wv": (cfg.d_model, cfg.n_kv * cfg.d_head),
        "wo": (cfg.n_heads * cfg.d_head, cfg.d_model),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (cfg.d_head,)
        shapes["k_norm"] = (cfg.d_head,)
    return shapes


def init_attention(gen: torch.Generator, cfg: AttentionConfig, dtype):
    p = {name: dense_init(gen, *shape, dtype)
         for name, shape in attention_shapes(cfg).items() if len(shape) == 2}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.d_head, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones(cfg.d_head, dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, cfg: AttentionConfig, x, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend(p, cfg: AttentionConfig, q, k, v):
    B, S = q.shape[:2]
    out = attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=True, backend=cfg.backend,
                       chunk=min(cfg.attention_chunk, S))
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def attention_train(p, cfg: AttentionConfig, x, positions):
    """Full causal self-attention (training / prefill compute)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v)


def attention_prefill(p, cfg: AttentionConfig, x, positions):
    """Like train, but also returns the KV cache [B, S, n_kv, d]."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v), (k, v)


def attention_decode(p, cfg: AttentionConfig, x, cache, pos):
    """One-token decode against a KV cache.

    x: [B, 1, d_model]; cache: (k, v) each [B, C, n_kv, d] (C = max context);
    pos: [B] int positions.  The new k/v are written into the cache at
    ``pos`` in place and the same tensors are returned.  (The reference
    writes with a one-hot select so that GSPMD keeps a context-sharded cache
    local; on one card a direct write gives the same cache.)  Scores and the
    weighted sum are f32; the softmax weights are rounded to the cache's
    dtype first, as in the reference.
    """
    B = x.shape[0]
    ck, cv = cache
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_angles(pos[:, None].float(), cfg.d_head, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(B, device=x.device)
    ck[rows, pos] = k[:, 0].to(ck.dtype)
    cv[rows, pos] = v[:, 0].to(cv.dtype)

    C = ck.shape[1]
    group = cfg.n_heads // cfg.n_kv
    qg = q.reshape(B, cfg.n_kv, group, cfg.d_head)
    # bf16 -> f32 is exact, so these are the reference's f32-result einsums
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), ck.float())
    s = s / (cfg.d_head**0.5)
    valid = (torch.arange(C, device=x.device)[None, :] <= pos[:, None])[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", w.to(ck.dtype).float(), cv.float())
    o = o.reshape(B, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return o @ p["wo"], (ck, cv)
