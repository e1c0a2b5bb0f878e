"""RecSys serving: DIN, BST, MIND and two-tower retrieval (port of
``repro/models/recsys.py``'s serving half).

Plain functions over parameter trees (nested dicts of tensors, MLPs as
lists of ``{"w", "b"}``), as ``models/transformer.py``.  The two-tower
user tower pools its history through ``kernels.embedding_bag`` (an
EmbeddingBag in ``mean`` mode: padding id 0 becomes -1, bag b holds row b's
history), so on a card the pooling runs the ``segment_sum`` kernel; the
reference computes the same function as ``masked_mean(embed_lookup(...))``.
DIN, BST and MIND pool with attention and capsule einsums, as the reference
does.  The losses wait for the training path, and the tables are whole on
one card (the reference's sharding specs have no counterpart).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.embedding_bag import ops as eb_ops
from ..layers.common import dense_init, rms_norm


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def embed_lookup(table, ids):
    """Row lookup; id 0 is the padding row by convention."""
    return table[ids]


def masked_mean(emb, ids):
    """Mean-pool a [B, S, D] history with 0 = padding."""
    mask = (ids > 0).to(emb.dtype)[..., None]
    s = (emb * mask).sum(dim=1)
    n = mask.sum(dim=1).clamp(min=1.0)
    return s / n


def mlp_init(gen: torch.Generator, dims, dtype) -> list:
    return [{"w": dense_init(gen, dims[i], dims[i + 1], dtype),
             "b": torch.zeros(dims[i + 1], dtype=dtype, device=gen.device)}
            for i in range(len(dims) - 1)]


def mlp_apply(layers, x, act=F.relu, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _mlp_shapes(dims) -> list:
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)} for i in range(len(dims) - 1)]


# ---------------------------------------------------------------------------
# DIN — Deep Interest Network (arXiv:1706.06978)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 10_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    dtype: Any = torch.float32


def din_shapes(cfg: DINConfig) -> dict:
    d = cfg.embed_dim
    return {"items": (cfg.n_items, d), "attn": _mlp_shapes((4 * d, *cfg.attn_mlp, 1)),
            "top": _mlp_shapes((3 * d, *cfg.mlp, 1))}


def din_init(gen: torch.Generator, cfg: DINConfig) -> dict:
    d = cfg.embed_dim
    return {
        "items": dense_init(gen, cfg.n_items, d, cfg.dtype, scale=0.01),
        "attn": mlp_init(gen, (4 * d, *cfg.attn_mlp, 1), cfg.dtype),
        "top": mlp_init(gen, (3 * d, *cfg.mlp, 1), cfg.dtype),
    }


def din_forward(params, cfg: DINConfig, batch):
    hist, target = batch["hist"], batch["target"]
    h = embed_lookup(params["items"], hist)            # [B,S,d]
    t = embed_lookup(params["items"], target)          # [B,d]
    tb = t[:, None, :].expand(h.shape)
    z = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    w = mlp_apply(params["attn"], z, act=torch.sigmoid)[..., 0]   # [B,S] (no softmax, per DIN)
    w = w * (hist > 0)
    pooled = torch.einsum("bs,bsd->bd", w.to(h.dtype), h)
    x = torch.cat([pooled, t, pooled * t], dim=-1)
    return mlp_apply(params["top"], x)[..., 0]


# ---------------------------------------------------------------------------
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 10_000_000
    embed_dim: int = 32
    seq_len: int = 20          # history (incl. target as last position)
    n_heads: int = 8
    n_blocks: int = 1
    d_ff: int = 128
    mlp: tuple = (1024, 512, 256)
    dtype: Any = torch.float32


def bst_shapes(cfg: BSTConfig) -> dict:
    d, nb = cfg.embed_dim, cfg.n_blocks
    blocks = {n: (nb, d, d) for n in ("wq", "wk", "wv", "wo")}
    blocks.update(w1=(nb, d, cfg.d_ff), w2=(nb, cfg.d_ff, d), ln1=(nb, d), ln2=(nb, d))
    return {"items": (cfg.n_items, d), "pos": (cfg.seq_len, d), "blocks": blocks,
            "top": _mlp_shapes((cfg.seq_len * d, *cfg.mlp, 1))}


def bst_init(gen: torch.Generator, cfg: BSTConfig) -> dict:
    d, dev = cfg.embed_dim, gen.device
    blocks = {}
    for n, shape in bst_shapes(cfg)["blocks"].items():
        if n in ("ln1", "ln2"):
            blocks[n] = torch.ones(shape, dtype=cfg.dtype, device=dev)
        else:
            blocks[n] = torch.stack([dense_init(gen, *shape[1:], cfg.dtype)
                                     for _ in range(shape[0])])
    return {
        "items": dense_init(gen, cfg.n_items, d, cfg.dtype, scale=0.01),
        "pos": dense_init(gen, cfg.seq_len, d, cfg.dtype, scale=0.01),
        "blocks": blocks,
        "top": mlp_init(gen, (cfg.seq_len * d, *cfg.mlp, 1), cfg.dtype),
    }


def _bst_block(bp, cfg: BSTConfig, x):
    B, S, d = x.shape
    hd = d // cfg.n_heads
    z = rms_norm(x, bp["ln1"])
    q = (z @ bp["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (z @ bp["wk"]).reshape(B, S, cfg.n_heads, hd)
    v = (z @ bp["wv"]).reshape(B, S, cfg.n_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).reshape(B, S, d).to(x.dtype)
    x = x + o @ bp["wo"]
    z = rms_norm(x, bp["ln2"])
    return x + F.leaky_relu((z @ bp["w1"]).float()).to(x.dtype) @ bp["w2"]


def bst_forward(params, cfg: BSTConfig, batch):
    seq = torch.cat([batch["hist"], batch["target"][:, None]], dim=1)
    seq = seq[:, -cfg.seq_len:]
    x = embed_lookup(params["items"], seq) + params["pos"][None]
    for i in range(cfg.n_blocks):
        x = _bst_block({n: a[i] for n, a in params["blocks"].items()}, cfg, x)
    flat = x.reshape(x.shape[0], -1)
    return mlp_apply(params["top"], flat, act=F.leaky_relu)[..., 0]


# ---------------------------------------------------------------------------
# MIND — Multi-Interest Network with Dynamic routing (arXiv:1904.08030)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 10_000_000
    embed_dim: int = 64
    seq_len: int = 50
    n_interests: int = 4
    capsule_iters: int = 3
    label_pow: float = 2.0
    dtype: Any = torch.float32


def mind_shapes(cfg: MINDConfig) -> dict:
    d = cfg.embed_dim
    return {"items": (cfg.n_items, d), "bilinear": (d, d)}


def mind_init(gen: torch.Generator, cfg: MINDConfig) -> dict:
    return {
        "items": dense_init(gen, cfg.n_items, cfg.embed_dim, cfg.dtype, scale=0.01),
        "bilinear": dense_init(gen, cfg.embed_dim, cfg.embed_dim, cfg.dtype),
    }


def _squash(s):
    s32 = s.float()
    n2 = (s32 ** 2).sum(dim=-1, keepdim=True)
    return (n2 / (1 + n2) * s32 / torch.sqrt(n2 + 1e-9)).to(s.dtype)


def mind_interests(params, cfg: MINDConfig, hist):
    """Behavior-to-interest dynamic routing -> [B, K, d] interest capsules."""
    e = embed_lookup(params["items"], hist)          # [B,S,d]
    eh = (e @ params["bilinear"]).float()            # [B,S,d]
    mask = (hist > 0).float()
    B, S, _ = e.shape
    K = cfg.n_interests
    # fixed (hash-derived) routing-logit init, as in the paper's random init
    b0 = torch.sin(torch.arange(S * K, dtype=torch.float32, device=e.device)
                   * 12.9898).reshape(1, S, K) * 0.1
    b = b0.expand(B, S, K)
    v = None
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(b, dim=-1) * mask[..., None]          # [B,S,K]
        s = torch.einsum("bsk,bsd->bkd", c, eh)                 # [B,K,d]
        v = _squash(s)
        b = b + torch.einsum("bkd,bsd->bsk", v, eh)
    return v.to(cfg.dtype)


def mind_point_serve(params, cfg: MINDConfig, batch):
    """Pointwise (user, target) scoring: max over interest capsules."""
    v = mind_interests(params, cfg, batch["hist"])      # [B,K,d]
    t = embed_lookup(params["items"], batch["target"])  # [B,d]
    s = torch.einsum("bkd,bd->bk", v.float(), t.float())
    return s.amax(dim=-1)


def mind_serve(params, cfg: MINDConfig, batch):
    """Score candidates: max over interests (retrieval scoring)."""
    v = mind_interests(params, cfg, batch["hist"])                # [B,K,d]
    cand = embed_lookup(params["items"], batch["candidates"])      # [NC,d]
    scores = torch.einsum("bkd,nd->bkn", v.float(), cand.float())
    return scores.amax(dim=1)                                      # [B,NC]


# ---------------------------------------------------------------------------
# Two-tower retrieval (YouTube, RecSys'19)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_items: int = 10_000_000
    n_users: int = 50_000_000
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    seq_len: int = 50
    dtype: Any = torch.float32

    @property
    def n_params(self) -> int:
        d = self.embed_dim
        m = self.tower_mlp

        def tower(d_in):
            return d_in * m[0] + m[0] * m[1] + m[1] * m[2]

        return (self.n_items + self.n_users) * d + tower(2 * d) + tower(d)


def twotower_shapes(cfg: TwoTowerConfig) -> dict:
    d = cfg.embed_dim
    return {"items": (cfg.n_items, d), "users": (cfg.n_users, d),
            "user_tower": _mlp_shapes((2 * d, *cfg.tower_mlp)),
            "item_tower": _mlp_shapes((d, *cfg.tower_mlp))}


def twotower_init(gen: torch.Generator, cfg: TwoTowerConfig) -> dict:
    d = cfg.embed_dim
    return {
        "items": dense_init(gen, cfg.n_items, d, cfg.dtype, scale=0.01),
        "users": dense_init(gen, cfg.n_users, d, cfg.dtype, scale=0.01),
        "user_tower": mlp_init(gen, (2 * d, *cfg.tower_mlp), cfg.dtype),
        "item_tower": mlp_init(gen, (d, *cfg.tower_mlp), cfg.dtype),
    }


def history_pool(items, hist):
    """Mean of each row's non-padding history embeddings, f32 [B, d]:
    ``masked_mean(embed_lookup(items, hist), hist)`` as an EmbeddingBag
    (id 0 -> -1 padding, bag b = row b), through the ``segment_sum`` kernel
    on a card."""
    B, S = hist.shape
    ids = torch.where(hist > 0, hist, -1).reshape(-1)
    bags = torch.arange(B, device=hist.device).repeat_interleave(S)
    return eb_ops.embedding_bag(items, ids, bags, n_bags=B, mode="mean")


def _normalize(u):
    return u / (torch.linalg.vector_norm(u.float(), dim=-1, keepdim=True) + 1e-6).to(u.dtype)


def _user_vec(params, cfg: TwoTowerConfig, batch, pool=None):
    """The user tower; ``pool(items, hist)`` pools the history
    (``history_pool`` by default)."""
    pooled = (pool or history_pool)(params["items"], batch["hist"]).to(cfg.dtype)
    ue = embed_lookup(params["users"], batch["user_id"])
    x = torch.cat([ue, pooled], dim=-1)
    return _normalize(mlp_apply(params["user_tower"], x, final_act=False))


def _item_vec(params, cfg: TwoTowerConfig, ids):
    ie = embed_lookup(params["items"], ids)
    return _normalize(mlp_apply(params["item_tower"], ie, final_act=False))


def twotower_serve(params, cfg: TwoTowerConfig, batch, pool=None):
    """CTR-style pointwise scoring of (user, target) pairs."""
    u = _user_vec(params, cfg, batch, pool)
    v = _item_vec(params, cfg, batch["target"])
    return (u.float() * v.float()).sum(dim=-1)


def twotower_retrieve(params, cfg: TwoTowerConfig, batch, pool=None):
    """batch=1 user vs n_candidates items: batched dot (NOT a loop) + top-k."""
    u = _user_vec(params, cfg, batch, pool)                 # [1, d']
    cand = _item_vec(params, cfg, batch["candidates"])      # [NC, d']
    scores = (cand.float() @ u.float().T)[:, 0]
    return torch.topk(scores, 100)


# arch id -> (param shapes, init)
ARCHS = {
    "two-tower-retrieval": (twotower_shapes, twotower_init),
    "din": (din_shapes, din_init),
    "bst": (bst_shapes, bst_init),
    "mind": (mind_shapes, mind_init),
}
