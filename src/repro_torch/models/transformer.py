"""Dense transformer LM: prefill and decode (port of
``repro/models/transformer.py``'s serving half).

Pre-norm RMSNorm blocks, RoPE GQA attention (optional qk-norm, as qwen3)
and a SwiGLU MLP.  Parameters are the reference's tree as nested dicts of
tensors, layer leaves stacked on a leading [L, ...] axis; the reference's
``lax.scan`` over layers is a Python loop over views of those stacks.
Caches are stacked [L, B, C, n_kv, d] and logits are f32 [B, vocab], as in
the reference.  ``forward`` / ``loss_fn`` wait for the training path, and
the MoE FFN for its own slice (``moe`` must be None).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.incremental import resolve_device
from ..layers.attention import (
    AttentionConfig,
    attention_decode,
    attention_prefill,
    attention_shapes,
    init_attention,
)
from ..layers.common import dense_init, rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Any = None
    dtype: Any = torch.bfloat16
    attention_chunk: int = 512
    attention_backend: str | None = "xla_chunked"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def attn_cfg(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            d_head=self.head_dim, qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            attention_chunk=self.attention_chunk, backend=self.attention_backend,
        )

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv * 2)
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (it comes with the MoE "
            "layers and configs, after the segment_sum slice)")


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree's names and shapes (layer leaves with their
    leading [L] axis), as the reference's ``init_params`` makes them."""
    _dense_only(cfg)
    L, d = cfg.n_layers, cfg.d_model
    layer = {
        "attn": {n: (L, *s) for n, s in attention_shapes(cfg.attn_cfg()).items()},
        "ln1": (L, d),
        "ln2": (L, d),
        "mlp": {"w1": (L, d, cfg.d_ff), "w3": (L, d, cfg.d_ff), "w2": (L, cfg.d_ff, d)},
    }
    return {"embed": (cfg.vocab, d), "layers": layer, "ln_f": (d,), "head": (d, cfg.vocab)}


def _init_layer(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    return {
        "attn": init_attention(gen, cfg.attn_cfg(), cfg.dtype),
        "ln1": torch.ones(cfg.d_model, dtype=cfg.dtype, device=gen.device),
        "ln2": torch.ones(cfg.d_model, dtype=cfg.dtype, device=gen.device),
        "mlp": {
            "w1": dense_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
            "w3": dense_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
            "w2": dense_init(gen, cfg.d_ff, cfg.d_model, cfg.dtype),
        },
    }


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], layers)


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random weights from ``gen``, on the generator's device.  Each layer
    is drawn and copied into the preallocated stacks, so the peak is the
    model plus one layer."""
    shapes = param_shapes(cfg)
    dev = gen.device
    layers = tree_map(lambda s: torch.empty(s, dtype=cfg.dtype, device=dev),
                      shapes["layers"])
    embed = dense_init(gen, cfg.vocab, cfg.d_model, cfg.dtype, scale=0.02)
    for i in range(cfg.n_layers):
        tree_map(lambda dst, src: dst.copy_(src), layer_params(layers, i),
                 _init_layer(gen, cfg))
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": torch.ones(cfg.d_model, dtype=cfg.dtype, device=dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype),
    }


def _ffn(lp: dict, x):
    return swiglu(rms_norm(x, lp["ln2"]), lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"])


def prefill(params: dict, cfg: TransformerConfig, tokens):
    """tokens [B, S] -> (last-position logits f32 [B, vocab], (k, v) caches
    each [L, B, S, n_kv, d])."""
    _dense_only(cfg)
    B, S = tokens.shape
    acfg = cfg.attn_cfg()
    x = params["embed"][tokens]
    positions = torch.arange(S, dtype=torch.float32, device=x.device).expand(B, S)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h, (k, v) = attention_prefill(lp["attn"], acfg, rms_norm(x, lp["ln1"]), positions)
        x = x + h
        x = x + _ffn(lp, x)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x[:, -1:], params["ln_f"])
    logits = (x @ params["head"]).float()[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs))


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Zeroed (k, v) caches, each [L, batch, max_len, n_kv, d], on ``device``
    (None: the CUDA card)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params: dict, cfg: TransformerConfig, token, cache, pos):
    """One decode step.  token [B] int; cache stacked [L, B, C, n_kv, d];
    pos [B] int write positions.  Returns (logits f32 [B, vocab], cache):
    the new k/v are written into ``cache`` in place and it is returned."""
    _dense_only(cfg)
    acfg = cfg.attn_cfg()
    ck, cv = cache
    x = params["embed"][token[:, None]]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h, _ = attention_decode(lp["attn"], acfg, rms_norm(x, lp["ln1"]), (ck[i], cv[i]), pos)
        x = x + h
        x = x + _ffn(lp, x)
    x = rms_norm(x, params["ln_f"])
    logits = (x @ params["head"]).float()[:, 0]
    return logits, (ck, cv)
