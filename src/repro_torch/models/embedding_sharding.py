"""Frequency-driven hot/cold embedding placement (port of
``repro/models/embedding_sharding.py``; paper -> systems loop).

Large recsys tables are row-sharded; every lookup of a hot key is then a
cross-device gather.  The SH_l sketch over the impression stream
(``stats.StreamStatsService``) identifies the heavy keys *without
aggregating the stream*; the top-H keys get a small replicated "hot" table,
the cold tail stays sharded.  cap statistics give an unbiased estimate of
the traffic split: hot_traffic ~= Q(sum, hot) / Q(sum, X), used to size H.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import estimators, freqfns
from ..stats.service import StreamStatsService


@dataclasses.dataclass
class HotColdPlan:
    hot_ids_sorted: np.ndarray       # sorted hot key ids
    est_hot_traffic_frac: float      # estimated share of lookups hitting hot


def plan_hot_cold(service: StreamStatsService, n_hot: int) -> HotColdPlan:
    hot = np.sort(service.hot_keys(n_hot))
    sketch = service.sketches()[max(service.config.ls)]
    total = estimators.estimate(sketch, freqfns.total())
    hot_traffic = estimators.estimate(sketch, freqfns.total(), segment=hot)
    frac = float(hot_traffic / max(total, 1e-9))
    return HotColdPlan(hot_ids_sorted=hot, est_hot_traffic_frac=frac)


def split_table(table, plan: HotColdPlan):
    """Materialize (hot_table [H, D] to replicate, hot ids on the table's
    device); the cold table is the original."""
    hot_ids = torch.from_numpy(plan.hot_ids_sorted.astype(np.int32)).to(table.device)
    return table[hot_ids], hot_ids


def hot_cold_lookup(cold_table, hot_table, hot_ids_sorted, ids):
    """Lookup ids, serving hot keys from the replicated table.  The rows are
    gathered from the cold table and the hot ones overwritten in place (the
    reference selects between two full gathers; the values are the same)."""
    ids = ids.to(hot_ids_sorted.dtype)
    loc = torch.searchsorted(hot_ids_sorted, ids).clamp_(0, hot_ids_sorted.shape[0] - 1)
    hot = (hot_ids_sorted[loc] == ids).nonzero(as_tuple=True)
    rows = cold_table[ids]
    rows[hot] = hot_table[loc[hot]]
    return rows
