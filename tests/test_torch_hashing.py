"""Port parity: counter-based hashing (repro_torch.core.hashing) is bit-exact
against the reference's jnp and numpy variants, edge values included.

Tolerance: exact.  Hashes and the 24-bit uniforms involve no
transcendental, so nothing may differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import to_np  # noqa: E402

from repro.core import hashing as RH  # noqa: E402
from repro.core import samplers as RS  # noqa: E402
from repro.core import vectorized as RV  # noqa: E402
from repro_torch.core import hashing as TH  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402

EDGES = np.array([0, 1, 2, 255, 2**16, 2**31 - 1, 2**31, 2**32 - 1],
                 dtype=np.uint64)


def _values(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, 500, dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, 1])
def test_mix32_exact(seed):
    x = _values(seed).astype(np.uint32)
    want = RH.mix32_np(x)
    got = to_np(TH.mix32(torch.from_numpy(x.astype(np.int64))))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(TH.mix32_np(x), want)


@pytest.mark.parametrize("salt", [0, 0x5EED, 2**32 - 1])
def test_hash_combine_exact(salt):
    """Tensor, Python-int and int32 (negative) parts all hash like the
    reference's uint32 casts."""
    x = _values(salt & 7).astype(np.uint32)
    want = to_np(RH.hash_combine(jnp.asarray(x), jnp.uint32(RS.SALT_ELEM),
                                 jnp.uint32(salt)))
    got = to_np(TH.hash_combine(torch.from_numpy(x.astype(np.int64)),
                                TS.SALT_ELEM, salt))
    assert np.array_equal(got, want.astype(np.int64))
    # int32 view of the same bits (keys arrive as int32)
    got32 = to_np(TH.hash_combine(torch.from_numpy(x.view(np.int32)),
                                  TS.SALT_ELEM, salt))
    assert np.array_equal(got32, got)
    # constant leading parts hash on the host and agree
    want_lead = RH.hash_combine_np(np.uint32(6), np.uint32(salt), x)
    got_lead = to_np(TH.hash_combine(6, salt, torch.from_numpy(x.astype(np.int64))))
    assert np.array_equal(got_lead, want_lead.astype(np.int64))
    assert np.array_equal(TH.hash_combine_np(np.uint32(6), np.uint32(salt), x),
                          want_lead)


def test_uniform01_exact():
    h = _values(3).astype(np.uint32)
    want = to_np(RH.uniform01(jnp.asarray(h)))
    got = to_np(TH.uniform01(torch.from_numpy(h.astype(np.int64))))
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(TH.uniform01_np(h), RH.uniform01_np(h))


@pytest.mark.parametrize("host_id", [0, 3, 2**31 - 1])
def test_shard_eids_exact(host_id):
    idx = np.arange(0, 4096, 7, dtype=np.int32)
    want = to_np(RV.shard_eids(jnp.uint32(host_id), jnp.asarray(idx)))
    got = to_np(TV.shard_eids(host_id, torch.from_numpy(idx)))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(TS.shard_eids_np(host_id, idx),
                          RS.shard_eids_np(host_id, idx))


@pytest.mark.parametrize("l", [1.0, 3.0, 4096.0])
def test_keybase_and_elem_uniform_exact(l):
    ids = _values(11).astype(np.uint32).view(np.int32)
    want_kb = to_np(RV.keybase(jnp.asarray(ids), l, 0x5EED))
    got_kb = to_np(TV.keybase(torch.from_numpy(ids), torch.tensor(l, dtype=torch.float32),
                              0x5EED))
    assert np.array_equal(got_kb, want_kb)
    want_u = to_np(RV.elem_uniform(jnp.asarray(ids), 0x5EED))
    got_u = to_np(TV.elem_uniform(torch.from_numpy(ids), 0x5EED))
    assert np.array_equal(got_u, want_u)
