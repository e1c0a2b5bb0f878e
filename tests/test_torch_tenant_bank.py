"""Port parity: the multi-tenant ``TenantBank`` (``repro_torch.core.incremental``)
against the reference's, and against the port's own standalone samplers.

Streams: uneven per-tenant batches (sub-chunk remainders, several chunks at
once), idle tenants, shared and per-tenant salts (one above 2^31), and
``evict_every`` 1 and 2.  Against the reference bank the state-dict leaves
and finalized samples agree under the rules of ``tests/_torch_ref.py``;
against a port ``MultiSampler(salt=salts[t])`` fed the same chunks, bank
tenant t is bit-identical (the bank runs the same f32 operations per row).
Also: ``flushed_state`` leaves the live state alone; tenant and whole-bank
state dicts round-trip; the batched plain kernels equal per-chunk calls; a
per-row salt column hashes as the int salt; one chunk sort and one
``capscore_agg`` call per tick, whatever the number of active tenants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL, assert_state_dicts_agree, count_atol  # noqa: E402

from repro.core import incremental as RI  # noqa: E402
from repro_torch.core import hashing as H  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import vectorized as VZ  # noqa: E402
from repro_torch.core.samplers import SALT_EVICT_U  # noqa: E402
from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore import ops as cops  # noqa: E402
from repro_torch.kernels.capscore.ref import capscore_agg_ref  # noqa: E402
from repro_torch.kernels.chunksort import ops as sops  # noqa: E402
from repro_torch.kernels.chunksort.ref import sort_with_perm_ref  # noqa: E402

LS = (1.0, 8.0, 64.0)
K, CHUNK, T = 40, 64, 5
SALTS = {"shared": 0x5EED, "per_tenant": [3, 0x5EED, 7, 2**32 - 5, 11]}


def _feed(banks_and_singles, seed, steps=14):
    """Drive banks (``observe`` + ``tick``) and per-tenant standalone
    samplers (``observe``) with the same uneven, partly idle traffic.
    Returns the largest weight fed."""
    rng = np.random.default_rng(seed)
    banks, singles = banks_and_singles
    max_w = 0.0
    for _ in range(steps):
        for t in range(T):
            if t == 3 or rng.random() < 0.35:  # tenant 3 stays idle
                continue
            n = int(rng.integers(1, 3 * CHUNK))
            keys = (rng.zipf(1.3, n) % 300).astype(np.int64)
            w = (rng.random(n) * 2 + 0.1).astype(np.float32)
            max_w = max(max_w, float(w.max()))
            for b in banks:
                b.observe(t, keys, w)
            for s in singles.get(t, ()):
                s.observe(keys, w)
        for b in banks:
            b.tick()
    return max_w


@pytest.mark.parametrize("salts", ["shared", "per_tenant"])
@pytest.mark.parametrize("evict_every", [1, 2])
def test_bank_matches_reference_bank(evict_every, salts):
    kw = dict(n_tenants=T, k=K, chunk=CHUNK, salts=SALTS[salts], evict_every=evict_every)
    ref = RI.TenantBank(LS, **kw)
    port = TI.TenantBank(LS, **kw, device="cpu")
    max_w = _feed(([ref, port], {}), seed=evict_every)
    assert [port.n_observed(t) for t in range(T)] == [ref.n_observed(t) for t in range(T)]
    assert np.array_equal(port.backlog_chunks(), ref.backlog_chunks())
    assert port.resident_bytes == ref.resident_bytes
    rf, pf = ref.finalize_all(), port.finalize_all()
    for t in range(T):
        for l in LS:
            r, p = rf[t][l], pf[t][l]
            assert np.array_equal(p.keys, r.keys), (t, l)
            np.testing.assert_allclose(p.counts, r.counts, rtol=RTOL, atol=count_atol(max_w))
            assert p.tau == pytest.approx(r.tau, rel=RTOL)
    assert_state_dicts_agree(port.state_dict(), ref.state_dict(), max_weight=max_w,
                             what="bank")
    # the finalize-time flush, stacked: the summaries with remainders folded
    rs, ps = ref.flushed_state(), port.flushed_state()
    assert np.array_equal(np.asarray(rs.bk_keys), ps.bk_keys.numpy())
    np.testing.assert_allclose(ps.bk_seeds.numpy(), np.asarray(rs.bk_seeds), rtol=RTOL)
    assert np.array_equal(np.asarray(rs.n_seen), ps.n_seen.astype(np.int32))


@pytest.mark.parametrize("salts", ["shared", "per_tenant"])
@pytest.mark.parametrize("evict_every", [1, 2])
def test_bank_tenant_is_bit_identical_to_a_standalone_sampler(evict_every, salts):
    salt_of = np.broadcast_to(np.asarray(SALTS[salts], np.int64), (T,))
    bank = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, salts=SALTS[salts],
                         evict_every=evict_every, device="cpu")
    singles = {t: [TI.MultiSampler(LS, k=K, chunk=CHUNK, salt=int(salt_of[t]),
                                   evict_every=evict_every, device="cpu")]
               for t in range(T)}
    _feed(([bank], singles), seed=10 + evict_every)
    fa = bank.finalize_all()
    flushed = bank.flushed_state()
    for t in range(T):
        single = singles[t][0]
        fs = single.finalize()
        for l in LS:
            assert np.array_equal(fa[t][l].keys, fs[l].keys)
            assert np.array_equal(fa[t][l].counts, fs[l].counts)
            assert fa[t][l].tau == fs[l].tau
        sd, ss = bank.tenant_state_dict(t), single.state_dict()
        assert sorted(sd) == sorted(ss)
        for name in ss:
            assert sd[name].dtype == ss[name].dtype and torch.equal(sd[name], ss[name]), name
        fst = single.flushed_state()
        assert torch.equal(flushed.bk_keys[t], fst.bk_keys)
        assert torch.equal(flushed.bk_seeds[t], fst.bk_seeds)
    assert bank.finalize(2)[LS[1]].keys.tolist() == fa[2][LS[1]].keys.tolist()


def test_flushed_state_leaves_the_live_state_untouched():
    bank = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, salts=SALTS["per_tenant"],
                         evict_every=2, device="cpu")
    _feed(([bank], {}), seed=3, steps=6)
    for t in range(T):  # a remainder on every tenant
        bank.observe(t, np.arange(t + 5), None)
    before = {k: v.clone() for k, v in bank.state_dict().items()}
    queued = [q.size for q in bank._queues]
    rounds = bank._rounds.copy()
    flushed = bank.flushed_state()
    bank.finalize_some([0, 4])
    after = bank.state_dict()
    for name, x in before.items():
        assert torch.equal(x, after[name]), name
    assert [q.size for q in bank._queues] == queued
    assert np.array_equal(bank._rounds, rounds)
    assert not torch.equal(flushed.table.keys, bank.state.table.keys)


def test_state_dicts_round_trip():
    bank = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, salts=SALTS["per_tenant"],
                         evict_every=2, device="cpu")
    _feed(([bank], {}), seed=5, steps=8)
    # the whole bank, and from the reference's numpy form
    twin = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    twin.load_state_dict({k: v.numpy() for k, v in bank.state_dict().items()})
    # one tenant into another slot of a fresh bank, and into a standalone sampler
    other = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    other.load_tenant_state_dict(4, bank.tenant_state_dict(1))
    lone = TI.MultiSampler(LS, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    lone.load_state_dict(bank.tenant_state_dict(1))
    rng = np.random.default_rng(9)
    keys = (rng.zipf(1.3, 5 * CHUNK + 17) % 300).astype(np.int64)
    for b, t in ((bank, 1), (twin, 1), (other, 4)):
        b.observe(t, keys)
        b.drain()
    lone.observe(keys)
    want = bank.tenant_state_dict(1)
    for name, x in twin.state_dict().items():
        assert torch.equal(x, bank.state_dict()[name]), name
    for got in (other.tenant_state_dict(4), lone.state_dict()):
        for name in want:
            assert torch.equal(got[name], want[name]), name
    with pytest.raises(ValueError, match="tenants"):
        TI.TenantBank(LS, n_tenants=T + 1, k=K, chunk=CHUNK, evict_every=2,
                      device="cpu").load_state_dict(bank.state_dict())


@pytest.mark.parametrize("B", [1, 3, 7])
def test_batched_plain_kernels_equal_per_chunk_calls(B):
    rng = np.random.default_rng(B)
    C, L = 96, 3
    keys = (rng.zipf(1.2, (B, C)) % 50).astype(np.int32)
    keys[:, -20:] = 2**31 - 1  # an EMPTY tail
    if B > 1:
        keys[1, :] = 42  # one key filling a chunk
    eids = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (B, C)).astype(np.int32))
    ws = torch.from_numpy((rng.random((B, C)) * 3 + 0.05).astype(np.float32))
    k = torch.from_numpy(keys)
    ks, perm = sort_with_perm_ref(k)
    order = chunk_order(k, eids, ws)
    ls = torch.tensor([1.0, 16.0, 256.0])
    taus = torch.from_numpy(rng.choice(np.array([np.inf, 0.5, 1e-3], np.float32), (B, L)))
    salts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, B).astype(np.int32))
    batched = capscore_agg_ref(order.ks, order.eids, order.ws, order.seg, ls, taus, salts)
    for b in range(B):
        one = chunk_order(k[b], eids[b], ws[b])
        assert torch.equal(ks[b], one.ks) and torch.equal(perm[b], one.perm)
        assert torch.equal(order.seg[b], one.seg) and torch.equal(order.ukeys[b], one.ukeys)
        single = capscore_agg_ref(one.ks, one.eids, one.ws, one.seg, ls, taus[b],
                                  int(salts[b]) & 0xFFFFFFFF)
        for got, want in zip(batched, single):
            assert torch.equal(got[b], want)
    # the dispatching ops route a CPU batch to the same plain versions
    assert all(torch.equal(a, b) for a, b in zip(sops.sort_with_perm(k), (ks, perm)))
    again = cops.capscore_agg(order.ks, order.eids, order.ws, order.seg, ls, taus, salts)
    assert all(torch.equal(a, b) for a, b in zip(again, batched))


def test_row_salt_column_hashes_as_the_int_salt():
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (4, 50)).astype(np.int32))
    rn = torch.tensor([1, 2, 3, 7], dtype=torch.int32)[:, None]
    salts = [0, 0x5EED, 2**31 + 5, 2**32 - 1]
    col = torch.tensor(salts, dtype=torch.int64).to(torch.int32)  # the bank's bits
    got = H.hash_combine(keys, SALT_EVICT_U, rn, col[:, None])
    for r, s in enumerate(salts):
        want = H.hash_combine(keys[r], SALT_EVICT_U, rn[r], s)
        assert torch.equal(got[r], want)
        assert np.array_equal(want.numpy(), H.hash_combine_np(
            keys[r].numpy(), np.uint32(SALT_EVICT_U), rn[r].numpy(), np.uint32(s)))
    # eviction of stacked rows with per-row salts equals each row's own
    table = VZ.TableState(
        keys=torch.sort(keys, dim=-1).values, counts=torch.rand(4, 50) * 5 + 1,
        kb=torch.rand(4, 50), seed=torch.rand(4, 50),
        tau=torch.tensor([0.5, float("inf"), 0.01, 2.0]), step=rn[:, 0],
        overflow=torch.zeros(4, dtype=torch.int32))
    l = torch.tensor([1.0, 8.0, 64.0, 3.0])
    stacked = VZ.evict_table(table, k=20, l=l, salt=col)
    for r, s in enumerate(salts):
        row = VZ.TableState(*(x[r:r + 1] for x in table))
        one = VZ.evict_table(row, k=20, l=l[r:r + 1], salt=s)
        for a, b in zip(stacked, one):
            assert torch.equal(a[r:r + 1], b)


def test_one_chunk_sort_and_one_capscore_agg_call_per_tick(monkeypatch):
    calls = {"sort": 0, "agg": 0}
    sort, agg = sops.sort_with_perm, TI.capscore_agg

    def counting_sort(keys):
        calls["sort"] += 1
        return sort(keys)

    def counting_agg(*args):
        calls["agg"] += 1
        return agg(*args)

    monkeypatch.setattr(sops, "sort_with_perm", counting_sort)
    monkeypatch.setattr(TI, "capscore_agg", counting_agg)
    bank = TI.TenantBank(LS, n_tenants=T, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    rng = np.random.default_rng(1)
    for t in range(T):
        bank.observe(t, rng.integers(0, 100, (t + 1) * CHUNK))
    for active in (5, 4, 3, 2, 1):
        calls.update(sort=0, agg=0)
        assert bank.tick() == active
        assert calls == {"sort": 1, "agg": 1}, (active, calls)
    calls.update(sort=0, agg=0)
    assert bank.tick() == 0 and calls == {"sort": 0, "agg": 0}


def test_bank_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.TenantBank(LS, n_tenants=2, k=K)
