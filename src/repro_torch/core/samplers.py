"""Salt lanes, the ``SampleResult`` record and host element ids.

Port of the parts of ``repro/core/samplers.py`` that the ingest -> sample ->
query path needs.  The sequential oracles (Algorithms 1-5) are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import hashing as H

# Salt lanes, so each use of randomness is an independent hash function.
SALT_ELEM = 0x01
SALT_BUCKET = 0x02
SALT_KEYBASE = 0x03
SALT_EVICT_U = 0x04
SALT_EVICT_R = 0x05
SALT_SHARD = 0x06  # shard/host disambiguation of element ids


@dataclasses.dataclass
class SampleResult:
    keys: np.ndarray          # sampled key ids
    counts: np.ndarray        # c_x (1-pass) or exact w_x (2-pass)
    tau: float                # threshold ((k+1)-smallest seed for fixed-k)
    l: float                  # cap parameter of the scheme
    kind: str                 # "discrete" | "continuous" | "distinct" | "sh"
    exact_weights: bool = False

    def asdict(self) -> dict:
        return dict(zip(self.keys.tolist(), self.counts.tolist()))


def shard_eids_np(shard_no, idx):
    """Element ids for position ``idx`` of shard/host ``shard_no``.

    Hash-derived rather than ``shard_no * n + idx``, which overflows int32
    once P*n > 2^31 and silently aliases element randomness across shards.
    Bit-identical to the device twin ``vectorized.shard_eids`` after the
    uint32 cast both apply.
    """
    idx = np.asarray(idx)
    salt_part = np.broadcast_to(np.uint32(SALT_SHARD), idx.shape)
    shard_part = np.broadcast_to(np.asarray(shard_no, np.uint32), idx.shape)
    return H.hash_combine_np(salt_part, shard_part, idx)
