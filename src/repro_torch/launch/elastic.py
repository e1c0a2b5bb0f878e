"""Elastic join/leave of the stats serving plane (port of the serving half of
``repro/launch/elastic.py``).

Randomness boundary: the demo inputs come from ``np.random`` and the
library's own counter-based hashing; library-side sampling randomness
derives only from the salted ``(key, eid)`` hashes in ``core/hashing.py``,
so restored and merged sketches stay coordinated.

* ``run_stats_handoff_demo`` -- the tenant-level join/leave surface: a
  tenant leaves a ``MultiTenantStats`` bank by slicing its row out of the
  bank's stacked checkpoint (``checkpoint.manager.restore_slice``) into a
  standalone ``StreamStatsService`` (bit-identical answers), and a
  standalone service joins a resident bank through
  ``MultiTenantStats.load_tenant_state_dict``.
* ``run_shard_tier_elastic_demo`` -- the tier-level counterpart: a shard of
  ``stats.shardtier.ShardTier`` leaves gracefully, queries degrade with a
  coverage stamp while its keys accumulate in its WAL, and ``join_shard``
  revives it from durable state, bit-identical to a tier that never lost
  it.

The reference module's training demo (``run_elastic_demo``, restart on a
smaller mesh) belongs to the training path, which the port does not carry
yet; this module imports nothing of it.  ``device=None`` runs on the CUDA
card and raises without one.

Run: ``PYTHONPATH=src python -m repro_torch.launch.elastic [--device cpu]``
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from ..checkpoint import manager as ckpt


def run_stats_handoff_demo(n_tenants=4, n_elems=2000, verbose=True, *, device=None):
    """Tenant leave/join between a stacked bank and standalone services.

    Checkpoints a ``MultiTenantStats`` bank, restores ONE tenant's row into
    a fresh ``StreamStatsService`` (leave), verifies the answer is
    bit-identical, then splices a standalone service back into a second
    bank (join) and verifies again.  Returns the per-tenant estimates.
    """
    from ..stats.service import MultiTenantStats, StatsConfig, StreamStatsService

    cfg = StatsConfig(k=128, ls=(1.0, 8.0), chunk=256)
    rng = np.random.default_rng(11)
    streams = [(rng.zipf(1.3, size=n_elems) % 500).astype(np.int64)
               for _ in range(n_tenants)]
    bank = MultiTenantStats(cfg, n_tenants=n_tenants, device=device)
    for t in range(n_tenants):
        bank.observe(t, streams[t])
    bank.drain()
    estimates = [bank.query_cap(t, 8.0) for t in range(n_tenants)]

    with tempfile.TemporaryDirectory() as d:
        bank.save_checkpoint(d, step=1)

        # leave: slice tenant 2 out of the bank checkpoint
        leaver = StreamStatsService(cfg, device=device)
        example = leaver.state_dict()
        example.pop("exact_ok")  # bank rows are 1-pass sketch state
        blob = ckpt.restore_slice(d, 1, example, index=2)
        blob["exact_ok"] = np.bool_(False)
        leaver.load_state_dict(blob)
        if leaver.campaign_forecast(8.0) != estimates[2]:
            raise AssertionError("leave handoff changed the tenant's answer")

        # join: splice a standalone service into a fresh bank's slot 0
        joiner = StreamStatsService(cfg, device=device)
        joiner.observe(streams[1])
        bank2 = MultiTenantStats(cfg, n_tenants=n_tenants, device=device)
        blob2 = joiner.state_dict()
        blob2.pop("exact_ok")
        bank2.load_tenant_state_dict(0, blob2)
        if bank2.query_cap(0, 8.0) != estimates[1]:
            raise AssertionError("join handoff changed the tenant's answer")
    if verbose:
        print(f"[elastic] stats handoff OK -- leave (bank->service) and "
              f"join (service->bank) both bit-identical across "
              f"{n_tenants} tenants")
    return estimates


def run_shard_tier_elastic_demo(n_shards=3, n_batches=8, batch=400,
                                verbose=True, *, device=None):
    """Elastic join/leave driven by the shard-tier coordinator's membership
    view (``stats.shardtier.ShardTier``).

    A shard leaves gracefully (final checkpoint, slot marked ``left``);
    queries degrade with an explicit coverage stamp while its keys keep
    accumulating in the slot's WAL; ``join_shard`` revives the slot from
    durable state and answers return to full coverage, bit-identical to a
    tier that never lost the shard.  Returns the healthy answer.
    """
    from ..core import freqfns, hashing
    from ..stats.query import Query
    from ..stats.service import StatsConfig
    from ..stats.shardtier import ShardTier, TierConfig

    cfg = StatsConfig(k=128, ls=(1.0, 8.0), chunk=128)
    # demo stream from the library's own counter-based hashing: skewed int
    # keys, unit weights
    eids = np.arange(n_batches * batch, dtype=np.int64)
    keys = (hashing.hash_combine_np(eids, np.int64(7)) % np.uint32(997)
            ).astype(np.int64) + 1
    batches = keys.reshape(n_batches, batch)
    queries = [Query(freqfns.distinct()), Query(freqfns.cap(8.0))]

    with tempfile.TemporaryDirectory() as d:
        oracle = ShardTier(cfg, TierConfig(n_shards=n_shards), d + "/oracle",
                           device=device)
        tier = ShardTier(cfg, TierConfig(n_shards=n_shards), d + "/tier",
                         device=device)
        for b in batches[: n_batches // 2]:
            oracle.ingest(b)
            tier.ingest(b)

        # leave: graceful decommission through the coordinator
        tier.leave_shard(1)
        if tier.membership()[1] != "left":
            raise AssertionError("shard 1 did not leave")
        for b in batches[n_batches // 2:]:
            oracle.ingest(b)
            tier.ingest(b)  # shard 1's keys land in its WAL, unapplied
        degraded = tier.query_batch(queries)
        if not (degraded.degraded and degraded.coverage < 1.0):
            raise AssertionError("answers without shard 1 are not stamped degraded")
        if verbose:
            print(f"[elastic] shard 1 left: coverage "
                  f"{degraded.coverage:.3f}, "
                  f"{degraded.staleness_elements} elements stale")

        # join: revive the slot from its durable state (checkpoint + WAL)
        if not (tier.join_shard(1) and tier.membership()[1] == "up"):
            raise AssertionError("shard 1 did not rejoin")
        healthy = tier.query_batch(queries)
        want = oracle.query_batch(queries)
        if healthy.degraded or healthy.coverage != 1.0:
            raise AssertionError("answers after the join are still degraded")
        if not np.array_equal(healthy.estimates, want.estimates):
            raise AssertionError("post-join answers differ from the never-left tier")
        if verbose:
            print(f"[elastic] shard 1 rejoined: answers bit-identical to "
                  f"the never-left tier ({healthy.estimates})")
    return healthy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the services (default: the CUDA card)")
    args = ap.parse_args(argv)
    run_stats_handoff_demo(device=args.device)
    run_shard_tier_elastic_demo(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
