"""Synthetic recsys impression/click streams with Zipf item popularity
(port of ``repro/data/recsys_events.py``; numpy only, array-equal to the
reference for the same generator state).

Doubles as the ad-campaign stream for the paper's motivating application:
elements are (user, item) impressions; frequency-cap queries run over user
keys segmented by campaign/demographic."""
from __future__ import annotations

import numpy as np

from .streams import zipf_keys


def impression_batch(rng: np.random.Generator, *, batch: int, seq_len: int,
                     n_items: int, n_users: int):
    """Training batch: history + target + click label."""
    hist = zipf_keys(rng, batch * seq_len, 1.2, n_items).reshape(batch, seq_len)
    hist[rng.uniform(size=hist.shape) < 0.1] = 0  # padding holes
    target = zipf_keys(rng, batch, 1.2, n_items)
    # label correlated with history overlap so models can actually learn
    overlap = (hist == target[:, None]).any(axis=1)
    p = np.where(overlap, 0.6, 0.15)
    label = (rng.uniform(size=batch) < p).astype(np.float32)
    user_id = rng.integers(0, n_users, size=batch)
    return {
        "hist": hist.astype(np.int32),
        "target": target.astype(np.int32),
        "label": label,
        "user_id": user_id.astype(np.int32),
    }


def impression_stream_elements(batch_dict):
    """Flatten a batch into (user, item) stream elements for the sketches."""
    b = batch_dict
    users = np.repeat(b["user_id"], b["hist"].shape[1])
    items = b["hist"].reshape(-1)
    keep = items > 0
    return users[keep], items[keep]
