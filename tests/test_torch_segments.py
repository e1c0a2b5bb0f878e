"""Port parity: sort-and-segment primitives (repro_torch.core.segments) are
bit-exact against the reference's.

Tolerance: exact — sorts, ranks, compaction and order statistics move
values without arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import to_np  # noqa: E402

from repro.core import segments as RG  # noqa: E402
from repro_torch.core import segments as TG  # noqa: E402

EMPTY = 2**31 - 1


def _keys(n, n_distinct, seed, empty_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-50, n_distinct, n).astype(np.int32)
    keys[rng.random(n) < empty_frac] = EMPTY
    return keys


@pytest.mark.parametrize("n,n_distinct,empty_frac",
                         [(1, 5, 0.0), (256, 40, 0.0), (300, 3, 0.2),
                          (777, 5000, 0.3), (513, 1, 1.0)])
def test_chunk_order_fields_exact(n, n_distinct, empty_frac):
    keys = _keys(n, n_distinct, n, empty_frac)
    eids = np.arange(1000, 1000 + n, dtype=np.int32)
    ws = np.random.default_rng(n).random(n).astype(np.float32)
    ref = RG.chunk_order(jnp.asarray(keys), jnp.asarray(eids), jnp.asarray(ws),
                         sort_backend="xla")
    got = TG.chunk_order(torch.from_numpy(keys), torch.from_numpy(eids),
                         torch.from_numpy(ws))
    for field in ("ks", "perm", "seg", "ukeys", "eids", "ws"):
        a, b = to_np(getattr(ref, field)), to_np(getattr(got, field))
        assert np.array_equal(a, b), field
    assert to_np(got.ks).dtype == np.int32 and to_np(got.seg).dtype == np.int32


@pytest.mark.parametrize("case", ["random", "ties", "signed", "inf"])
def test_kth_smallest_exact(case):
    rng = np.random.default_rng(7)
    x = rng.random(300).astype(np.float32)
    if case == "ties":
        x = rng.integers(0, 4, 300).astype(np.float32)
    elif case == "signed":
        x = (rng.standard_normal(300) * 10).astype(np.float32)
        x[:5] = [0.0, -0.0, -np.inf, 1e-38, -1e-38]
    elif case == "inf":
        x[rng.random(300) < 0.5] = np.inf
    for r in (0, 1, 17, 150, 298, 299):
        want = to_np(RG.kth_smallest(jnp.asarray(x), r))
        got = to_np(TG.kth_smallest(torch.from_numpy(x), r))
        assert want.view(np.int32) == got.view(np.int32), (case, r)
    # batched lanes with per-lane tensor ranks
    xs = np.stack([x, x[::-1].copy()])
    rs = np.array([3, 250])
    got = to_np(TG.kth_smallest(torch.from_numpy(xs), torch.from_numpy(rs)))
    for j in range(2):
        want = to_np(RG.kth_smallest(jnp.asarray(xs[j]), int(rs[j])))
        assert want.view(np.int32) == got[j].view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_valid_exact(seed):
    rng = np.random.default_rng(seed)
    n = 200
    valid = rng.random(n) < [0.0, 0.4, 1.0][seed]
    a = rng.integers(0, 1000, n).astype(np.int32)
    b = rng.random(n).astype(np.float32)
    ref = RG.compact_valid(jnp.asarray(valid), jnp.asarray(a), jnp.asarray(b),
                           fills=(EMPTY, np.inf))
    got = TG.compact_valid(torch.from_numpy(valid), torch.from_numpy(a),
                           torch.from_numpy(b), fills=(EMPTY, np.inf))
    for r, g in zip(ref, got):
        assert np.array_equal(to_np(r), to_np(g))
    # stacked lanes with a shared column
    valid2 = rng.random((3, n)) < 0.5
    got2 = TG.compact_valid(torch.from_numpy(valid2), torch.from_numpy(a),
                            fills=(EMPTY,))[0]
    for j in range(3):
        ref2 = RG.compact_valid(jnp.asarray(valid2[j]), jnp.asarray(a),
                                fills=(EMPTY,))[0]
        assert np.array_equal(to_np(got2)[j], to_np(ref2))


@pytest.mark.parametrize("out_len", [None, 50, 130])
def test_merge_sorted_runs_gather_exact(out_len):
    rng = np.random.default_rng(11)
    a = np.sort(rng.choice(400, 80, replace=False)).astype(np.int32)
    b = np.sort(rng.choice(400, 60, replace=False)).astype(np.int32)
    b[-5:] = EMPTY
    a[-3:] = EMPTY
    ref = RG.merge_sorted_runs_gather(jnp.asarray(a), jnp.asarray(b), out_len=out_len)
    got = TG.merge_sorted_runs_gather(torch.from_numpy(a), torch.from_numpy(b),
                                      out_len=out_len)
    for r, g in zip(ref, got):
        assert np.array_equal(to_np(r), to_np(g))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_exact(side):
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 50, 64)).astype(np.int32)
    v = rng.integers(-5, 60, 100).astype(np.int32)
    want = to_np(RG.searchsorted(jnp.asarray(a), jnp.asarray(v), side=side))
    got = to_np(TG.searchsorted(torch.from_numpy(a), torch.from_numpy(v), side=side))
    assert np.array_equal(want, got)


def test_bottom_k_by_exact_with_ties():
    rng = np.random.default_rng(5)
    score = rng.integers(0, 6, 100).astype(np.float32)
    score[rng.random(100) < 0.3] = np.inf
    keys = np.arange(100, dtype=np.int32)
    ref = RG.bottom_k_by(jnp.asarray(score), 40, jnp.asarray(keys), fills=(EMPTY,))
    got = TG.bottom_k_by(torch.from_numpy(score), 40, torch.from_numpy(keys),
                         fills=(EMPTY,))
    for r, g in zip(ref, got):
        assert np.array_equal(to_np(r), to_np(g))


def test_query_segments_match_reference():
    keys = np.arange(-100, 5000, 3, dtype=np.int64)
    pairs = [
        (RG.HashBucket(8, 3, salt=11), TG.HashBucket(8, 3, salt=11)),
        (RG.IdSet([1, 5, 99, 4000]), TG.IdSet([1, 5, 99, 4000])),
        (RG.as_segment(None), TG.as_segment(None)),
    ]
    for r, t in pairs:
        assert np.array_equal(r.mask_np(keys), t.mask_np(keys)), r.describe()
        assert r.describe() == t.describe()
    assert TG.as_segment(lambda k: k > 3).mask_np(keys).sum() == (keys > 3).sum()
    with pytest.raises(ValueError):
        TG.normalize_keys(np.array([EMPTY]))
    with pytest.raises(TypeError):
        TG.normalize_keys(np.array([1.5]))
    assert np.array_equal(TG.normalize_keys(keys), RG.normalize_keys(keys))


@pytest.mark.parametrize("n,n_distinct,empty_frac",
                         [(1, 5, 0.0), (300, 3, 0.2), (777, 5000, 0.3), (513, 1, 1.0)])
def test_sort_by_key_and_scatter_unique_exact(n, n_distinct, empty_frac):
    keys = _keys(n, n_distinct, n + 1, empty_frac)
    vals = np.arange(n, dtype=np.float32)  # distinct payload: shows stability
    rks, (rv,) = RG.sort_by_key(jnp.asarray(keys), jnp.asarray(vals))
    tks, (tv,) = TG.sort_by_key(torch.from_numpy(keys), torch.from_numpy(vals))
    assert np.array_equal(to_np(tks), np.asarray(rks))
    assert np.array_equal(to_np(tv), np.asarray(rv))
    rseg, _ = RG.segment_ids(rks)
    tseg, _ = TG.segment_ids(tks)
    assert np.array_equal(to_np(tseg), np.asarray(rseg))
    ruk, _ = RG.scatter_unique(rks, rseg, 0.0)
    assert np.array_equal(to_np(TG.scatter_unique(tks, tseg)), np.asarray(ruk))


def test_segment_primitives_batch_over_lanes():
    """Along the last dim of an [L, n] stack, each row equals its own 1-D
    call (the reference's vmap)."""
    rows = np.stack([_keys(200, 30, s, 0.1) for s in range(3)])
    ks, _ = TG.sort_by_key(torch.from_numpy(rows))
    seg, first = TG.segment_ids(ks)
    uk = TG.scatter_unique(ks, seg)
    for j in range(3):
        ks1, _ = TG.sort_by_key(torch.from_numpy(rows[j]))
        seg1, first1 = TG.segment_ids(ks1)
        assert torch.equal(ks[j], ks1) and torch.equal(seg[j], seg1)
        assert torch.equal(first[j], first1)
        assert torch.equal(uk[j], TG.scatter_unique(ks1, seg1))


@pytest.mark.parametrize("na,nb", [(1, 1), (80, 60), (64, 0), (0, 30), (300, 17)])
def test_merge_sorted_runs_exact(na, nb):
    """Scatter positions of the stable merge: equal to the reference's, and
    scattering the runs by them gives the stable sort of the union (ties:
    the first run first)."""
    rng = np.random.default_rng(na + nb)
    a = np.sort(rng.integers(0, 50, na)).astype(np.int32)
    b = np.sort(rng.integers(0, 50, nb)).astype(np.int32)
    if nb:
        b[-1] = EMPTY
    ref = RG.merge_sorted_runs(jnp.asarray(a), jnp.asarray(b))
    got = TG.merge_sorted_runs(torch.from_numpy(a), torch.from_numpy(b))
    for r, g in zip(ref, got):
        assert np.array_equal(to_np(r), to_np(g))
    merged = np.empty(na + nb, np.int32)
    merged[to_np(got[0])], merged[to_np(got[1])] = a, b
    assert np.array_equal(merged, np.sort(np.concatenate([a, b]), kind="stable"))
    src = np.empty(na + nb, np.int64)
    src[to_np(got[0])], src[to_np(got[1])] = np.arange(na), na + np.arange(nb)
    assert np.array_equal(src, np.argsort(np.concatenate([a, b]), kind="stable"))
