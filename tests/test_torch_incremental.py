"""Port parity: the multi-lane incremental sampler (repro_torch.core.
incremental.MultiSampler) against the reference's, on the same stream.

Tolerances (tests/_torch_ref.py has the log1p fact behind them): integer
leaves (table and summary keys, step, overflow, positions, remainder) and
the KeyBase column ``kb`` are exact; the e-derived f32 leaves (seeds,
summary seeds, tau) are within rtol 1e-5, and counts within rtol 1e-5 plus
4 ulp of the largest weight.  The samplers run chunk by chunk in lockstep,
so a divergence of a discrete leaf is caught at the chunk step that caused
it.  Every key on which the two table or summary key sets then differ must
be explained by its own deciding float pair within 4 ulp: the Delta of one
of its elements against that element's weight (entry), its eviction race z
against the z of a key on the other side of the threshold, or its summary
seed against the seed of a key on the other side of the bottom-(k+1) cut.
The assertion message prints the pair.  Lanes are independent, so a lane
that diverged so is dropped from the comparison from that chunk on, the
chunk is recorded (junit property ``diverged_lanes``), and the other lanes
stay in lockstep to the end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import MAX_ULP, RTOL, count_atol, to_np, ulp_distance  # noqa: E402

from repro.core import incremental as RI  # noqa: E402
from repro.kernels.capscore.ref import capscore_multi_ref as ref_multi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402
from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore.ops import capscore_agg  # noqa: E402
from repro_torch.kernels.capscore.ref import capscore_multi_ref  # noqa: E402

LS = (1.0, 16.0, 256.0)
K, CHUNK, SALT = 64, 256, 0x5EED
EMPTY = 2**31 - 1
EXACT = ("keys", "kb", "step", "overflow", "bk_keys", "n_seen", "n_real", "ls",
         "salt", "rem_keys", "rem_weights", "rem_len")
CLOSE = ("counts", "seed", "tau", "bk_seeds")
DISCRETE = ("keys", "bk_keys")
# leaves with a leading lane dimension; the rest are shared by all lanes
LANE_LEAVES = ("keys", "counts", "kb", "seed", "tau", "step", "overflow",
               "bk_keys", "bk_seeds")


def _stream(n, seed, weighted=False):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % 700).astype(np.int64)
    w = (rng.random(n) * 2 + 0.1).astype(np.float32) if weighted else None
    return keys, w


def _leaf_ok(name, a, b, max_weight):
    if name in EXACT:
        return np.array_equal(a, b)
    fin = np.isfinite(a)
    atol = count_atol(max_weight) if name == "counts" else 0.0
    return bool(np.array_equal(fin, np.isfinite(b))
                and np.allclose(b[fin], a[fin], rtol=RTOL, atol=atol))


def _leaf_diffs(ref_d, port_d, max_weight=1.0, lanes=None):
    """``(leaf, lane)`` pairs that break their tolerance (``lane`` is None
    for a shared leaf, or for a dtype/shape mismatch).  ``lanes`` limits
    the lane leaves to those lanes (default: all)."""
    bad = []
    for name in EXACT + CLOSE:
        a, b = np.asarray(ref_d[name]), to_np(port_d[name])
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append((name, None))
        elif name in LANE_LEAVES:
            for j in range(a.shape[0]) if lanes is None else sorted(lanes):
                if not _leaf_ok(name, a[j], b[j], max_weight):
                    bad.append((name, j))
        elif not _leaf_ok(name, a, b, max_weight):
            bad.append((name, None))
    return bad


def _live_keys(row) -> np.ndarray:
    row = np.asarray(row)
    return row[row != EMPTY]


def _across(vals, side, i, live=True):
    """Nearest value across a cut: the smallest ulp gap between ``vals[i]``
    and the ``live`` values whose ``side`` differs from entry i's, with
    that value (``inf, None`` if there is none)."""
    other = live & (side != side[i])
    other[i] = False
    if not other.any():
        return np.inf, None
    d = ulp_distance(np.broadcast_to(vals[i], vals[other].shape), vals[other])
    m = int(np.argmin(d))
    return float(d[m]), vals[other][m]


def _explain(before, ref_tau, spec, ck, cw, port_d, ref_d, lanes):
    """Explain every key on which the port's and the reference's table or
    summary key sets differ after one chunk step, in ``lanes``.

    ``before`` is the port's state before the step, ``ref_tau`` the
    reference's thresholds then, ``ck``/``cw`` the chunk the step took.
    Returns one record ``(gap_ulp, lane, key, leaf, pair)`` per differing
    key, worst first; ``gap_ulp`` is inf where no float pair decides it."""
    st = before
    order = chunk_order(ck, spec.eids(st.n_seen, "cpu"), cw)
    ks, ws = to_np(order.ks), to_np(order.ws)
    _, delta_t, _, _ = capscore_multi_ref(order.ks, order.eids, order.ws, st.l,
                                          st.table.tau, st.salt)
    _, delta_r, _, _ = ref_multi(*(jnp.asarray(to_np(a)) for a in
                                   (order.ks, order.eids, order.ws)),
                                 jnp.asarray(to_np(st.l)), jnp.asarray(ref_tau), st.salt)
    delta_t, delta_r = to_np(delta_t), np.asarray(delta_r)
    w_total, entered, contrib, kb_min, min_score = capscore_agg(
        order.ks, order.eids, order.ws, order.seg, st.l, st.table.tau, st.salt)
    merged = TV.fixed_k_merge(st.table, TV.ChunkAgg(order.ukeys, w_total, entered,
                                                    contrib, kb_min, min_score))
    valid, z, *_ = TV._evict_z(merged.keys, merged.counts, merged.kb, merged.tau,
                               st.l, st.salt, merged.step)
    ukeys, mins, z, valid = to_np(order.ukeys), to_np(min_score), to_np(z), to_np(valid)
    mkeys = to_np(merged.keys)
    records = []
    for j in sorted(lanes):
        # entry: x was not in the table and an element of x entered in one
        # package only -> that element's Delta against its weight
        old = set(_live_keys(to_np(st.table.keys)[j]).tolist())
        after = _live_keys(to_np(port_d["keys"])[j])
        kept = np.isin(mkeys[j], after) & valid[j]
        for x in set(after.tolist()) ^ set(_live_keys(ref_d["keys"][j]).tolist()):
            best = (np.inf, "no deciding pair")
            elems = np.nonzero(ks == x)[0]
            if x not in old and len(elems):
                d = np.minimum(ulp_distance(delta_t[j, elems], ws[elems]),
                               ulp_distance(delta_r[j, elems], ws[elems]))
                i = elems[int(np.argmin(d))]
                best = min(best, (float(d.min()), f"entry: Delta={delta_t[j, i]!r} (port) / "
                                  f"{delta_r[j, i]!r} (reference) vs w={ws[i]!r}"))
            at = np.nonzero((mkeys[j] == x) & valid[j])[0]
            if len(at):  # eviction race: z(x) against the nearest z across tau*
                gap, y = _across(z[j], kept, at[0], valid[j])
                best = min(best, (gap, f"eviction: z={z[j, at[0]]!r} vs z={y!r} across tau*"))
            records.append((best[0], j, x, "keys", best[1]))
        # summary: the bottom-(k+1) of the old summary and the chunk's keys
        seeds = {}
        for key, sd in zip(to_np(st.bk_keys)[j], to_np(st.bk_seeds)[j]):
            if key != EMPTY:
                seeds[int(key)] = sd
        for key, sd in zip(ukeys, mins[j]):
            if key != EMPTY:
                seeds[int(key)] = min(seeds.get(int(key), np.float32(np.inf)), sd)
        union = np.array(sorted(seeds), np.int64)
        useeds = np.array([seeds[int(key)] for key in union], np.float32)
        bk_after = _live_keys(to_np(port_d["bk_keys"])[j])
        in_bk = np.isin(union, bk_after)
        for x in set(bk_after.tolist()) ^ set(_live_keys(ref_d["bk_keys"][j]).tolist()):
            i = int(np.searchsorted(union, x))
            gap, y = (_across(useeds, in_bk, i) if i < len(union)
                      and union[i] == x else (np.inf, None))
            records.append((gap, j, x, "bk_keys",
                            f"summary: seed={useeds[i] if y is not None else None!r} "
                            f"vs seed={y!r} across the bottom-(k+1) cut"))
    return sorted(records, key=lambda r: -r[0])


def _lockstep(ref, port, keys, weights):
    """Feed both samplers chunk by chunk; compare state after each chunk.
    A lane whose discrete leaves diverge with every differing key explained
    is dropped from then on.  Returns ``{lane: chunk}`` of those lanes."""
    max_w = 1.0 if weights is None else float(weights.max())
    lanes, diverged = set(range(len(port.ls))), {}
    ref_d = ref.state_dict()
    for c, lo in enumerate(range(0, len(keys), CHUNK)):
        before, ref_tau = port.state, np.asarray(ref_d["tau"])
        kc = keys[lo:lo + CHUNK]
        wc = None if weights is None else weights[lo:lo + CHUNK]
        # the step takes the remainder buffer's keys first, then this batch's
        pk = np.concatenate([port._rem.keys, np.asarray(kc, np.int32)])
        pw = np.concatenate([port._rem.weights, np.ones(len(kc), np.float32)
                             if wc is None else wc])
        ref.observe(kc, wc)
        port.observe(kc, wc)
        ref_d, port_d = ref.state_dict(), port.state_dict()
        bad = _leaf_diffs(ref_d, port_d, max_w, lanes)
        if not bad:
            continue
        shared = [name for name, j in bad if j is None]
        assert not shared, f"chunk {c}: shared leaves {shared} differ"
        split = {j for name, j in bad if name in DISCRETE}
        close_only = {j for name, j in bad} - split
        assert not close_only, f"chunk {c}: lanes {close_only}: {bad} beyond tolerance"
        assert len(pk) // CHUNK == 1, f"chunk {c}: divergence not attributable to one step"
        records = _explain(before, ref_tau, port.spec, torch.from_numpy(pk[:CHUNK]),
                           torch.from_numpy(pw[:CHUNK]), port_d, ref_d, split)
        gap, j, x, leaf, pair = records[0]
        assert gap <= MAX_ULP, (f"chunk {c}: lane {j} {leaf} key {x} diverged unexplained; "
                                f"nearest deciding pair {pair}, {gap} ulp")
        lanes -= split
        diverged.update({j: c for j in split})
    return diverged


def _compare_finalize(ref, port, diverged, max_weight=1.0):
    """The finalized samples of every lane still in lockstep."""
    rres, pres = ref.finalize(), port.finalize()
    atol = count_atol(max_weight)
    for j, l in enumerate(LS):
        if j in diverged:
            continue
        assert np.array_equal(rres[l].keys, pres[l].keys), l
        np.testing.assert_allclose(pres[l].counts, rres[l].counts, rtol=RTOL, atol=atol)
        assert pres[l].tau == pytest.approx(rres[l].tau, rel=RTOL)


@pytest.mark.parametrize("evict_every", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_state_dict_parity_same_stream(evict_every, weighted, record_property):
    keys, w = _stream(6 * CHUNK + 100, seed=evict_every + 2 * weighted, weighted=weighted)
    kw = dict(k=K, chunk=CHUNK, salt=SALT, evict_every=evict_every)
    ref = RI.MultiSampler(LS, **kw)
    port = TI.MultiSampler(LS, device="cpu", **kw)
    diverged = _lockstep(ref, port, keys, w)
    record_property("diverged_lanes", diverged)
    assert len(diverged) < len(LS), f"every lane diverged: {diverged}"
    # the remainder (100 elements) is flushed identically at finalize
    _compare_finalize(ref, port, diverged, 1.0 if w is None else float(w.max()))


def test_host_id_and_leaf_names():
    keys, _ = _stream(3 * CHUNK, seed=9)
    ref = RI.MultiSampler(LS, k=K, chunk=CHUNK, salt=SALT, host_id=5)
    port = TI.MultiSampler(LS, k=K, chunk=CHUNK, salt=SALT, host_id=5, device="cpu")
    assert not _lockstep(ref, port, keys, None)
    rd, pd = ref.state_dict(), port.state_dict()
    assert list(rd) == list(pd)
    for name in rd:
        assert np.asarray(rd[name]).dtype == to_np(pd[name]).dtype, name


def test_explainer_measures_each_key_own_pair():
    """The explainer reports one record per differing key, with that key's
    own deciding pair: a summary key dropped from one side is judged by its
    seed against the nearest seed across the cut, a table key by its entry
    Delta or its race z — never by the chunk's smallest gap."""
    keys, _ = _stream(4 * CHUNK, seed=11)
    port = TI.MultiSampler(LS, k=K, chunk=CHUNK, salt=SALT, device="cpu")
    port.observe(keys[:3 * CHUNK])
    before = port.state
    ck = keys[3 * CHUNK:]
    port.observe(ck)
    port_d = {name: to_np(v) for name, v in port.state_dict().items()}
    # a "reference" that lost one summary key and one table key of lane 1
    fake = {name: v.copy() for name, v in port_d.items()}
    bk_x, t_x = int(fake["bk_keys"][1, 0]), int(_live_keys(fake["keys"][1])[-1])
    fake["bk_keys"][1, 0] = EMPTY
    fake["keys"][1, fake["keys"][1] == t_x] = EMPTY
    records = _explain(before, to_np(before.table.tau), port.spec,
                       torch.from_numpy(ck.astype(np.int32)), torch.ones(CHUNK),
                       port_d, fake, {1})
    assert sorted((r[1], r[2], r[3]) for r in records) == sorted(
        [(1, t_x, "keys"), (1, bk_x, "bk_keys")])
    for gap, _, _, _, pair in records:
        assert 0 < gap < np.inf, pair  # a real pair at a real, nonzero distance


@pytest.mark.parametrize("evict_every", [1, 2])
def test_state_from_reference_carry_across(evict_every, record_property):
    """First half in the reference, state carried across, second half in
    the port == the whole stream in the reference."""
    keys, _ = _stream(8 * CHUNK + 37, seed=21 + evict_every)
    cut = 4 * CHUNK + 91  # mid-chunk: the remainder buffer travels too
    kw = dict(k=K, chunk=CHUNK, salt=SALT, evict_every=evict_every)
    full = RI.MultiSampler(LS, **kw)
    half = RI.MultiSampler(LS, **kw)
    full.observe(keys[:cut])
    half.observe(keys[:cut])
    port = TI.MultiSampler(LS, device="cpu", **kw)
    port.load_state_dict(half.state_dict())
    assert not _leaf_diffs(full.state_dict(), port.state_dict())
    diverged = _lockstep(full, port, keys[cut:], None)
    record_property("diverged_lanes", diverged)
    assert len(diverged) < len(LS), f"every lane diverged: {diverged}"
    _compare_finalize(full, port, diverged)
    # and back: the port's state restores in the reference
    back = RI.MultiSampler(LS, **kw)
    back.load_state_dict(convert.state_to_reference(port.state_dict()))
    assert not _leaf_diffs(back.state_dict(), port.state_dict())


def test_chunk_loop_makes_no_tensor_from_host_values(monkeypatch):
    """On a card, a tensor made from host values inside the chunk loop is a
    host-to-device copy that waits for the stream; the loop makes none."""
    keys, _ = _stream(3 * CHUNK, seed=5)
    port = TI.MultiSampler(LS, k=K, chunk=CHUNK, device="cpu")
    port.observe(keys[:CHUNK])
    ck = torch.from_numpy(keys[CHUNK:].astype(np.int32))
    cw = torch.ones(2 * CHUNK)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host values in the chunk loop")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    TI.update_multi(port.state, ck, cw, port.spec)


def test_load_state_dict_rejects_capacity_mismatch():
    a = TI.MultiSampler(LS, k=K, chunk=CHUNK, device="cpu")
    b = TI.MultiSampler(LS, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        b.load_state_dict(a.state_dict())
    with pytest.raises(KeyError):
        a.load_state_dict({**a.state_dict(), "bogus": np.zeros(1)})


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.MultiSampler(LS, k=K, chunk=CHUNK)
