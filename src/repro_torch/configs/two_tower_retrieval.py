"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim=256
tower_mlp=1024-512-256 interaction=dot, sampled-softmax retrieval."""
import torch

from ..models.recsys import TwoTowerConfig

ARCH_ID = "two-tower-retrieval"
FAMILY = "recsys"


def full_config() -> TwoTowerConfig:
    return TwoTowerConfig(name=ARCH_ID, n_items=10_000_000, n_users=50_000_000,
                          embed_dim=256, tower_mlp=(1024, 512, 256), dtype=torch.float32)


def smoke_config() -> TwoTowerConfig:
    return TwoTowerConfig(name=ARCH_ID + "-smoke", n_items=1000, n_users=1000,
                          embed_dim=16, tower_mlp=(32, 24, 16), seq_len=8,
                          dtype=torch.float32)
