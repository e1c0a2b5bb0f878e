"""Port parity: the capscore ops — element scoring ``capscore`` (one lane)
and ``capscore_multi`` (a lane grid), and the fused score + per-key
aggregate ``capscore_agg``.

On the CPU the port runs its plain versions, held against the reference's
Pallas kernels (interpret mode) and their XLA duals.  The CUDA kernels are
held against the plain versions on the card in
tests/test_torch_kernels_cuda.py.

Tolerances (see tests/_torch_ref.py for the log1p fact behind them):
``kb``/``kb_min`` are exact (no transcendental); score and delta within 4
ulp; an ``entry`` flip must be explained by a Delta within 4 ulp of the
element's weight; ``entered`` is exact unless a flip
is explained by a Delta within 4 ulp of the element weight; ``min_score``
within 4 ulp; the sums ``w_total``/``contrib`` within rtol 1e-5 (the
kernels reassociate them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import (assert_rtol, assert_ulp_close, to_np,  # noqa: E402
                        ulp_distance)

from repro.kernels.capscore import ops as rops  # noqa: E402
from repro.kernels.capscore.ref import capscore_multi_ref as ref_multi  # noqa: E402
from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore import ops  # noqa: E402
from repro_torch.kernels.capscore.ref import capscore_multi_ref  # noqa: E402

EMPTY = 2**31 - 1
SALT = 0x5EED


def _chunk(C, L, seed, n_keys=300, empty_tail=0):
    """A key-sorted Zipf chunk (the ChunkOrder view) and lane parameters
    mixing tau = inf, tau*l > 1 and tau*l < 1."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, C) % n_keys).astype(np.int32)
    if empty_tail:
        keys[-empty_tail:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = (rng.random(C) * 3 + 0.05).astype(np.float32)
    order = chunk_order(torch.from_numpy(keys), torch.from_numpy(eids),
                        torch.from_numpy(ws))
    ls = np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0][:L], np.float32)
    taus = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2][:L], np.float32)
    return order, ls, taus


def _explain_entered(ent_a, ent_b, order, ls, taus):
    """Every entered flip must come from an element whose Delta lies within
    4 ulp of its weight under one of the two log1p's."""
    _, delta_t, _, _ = capscore_multi_ref(order.ks, order.eids, order.ws,
                                          torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    _, delta_r, _, _ = ref_multi(jnp.asarray(to_np(order.ks)), jnp.asarray(to_np(order.eids)),
                                 jnp.asarray(to_np(order.ws)), jnp.asarray(ls),
                                 jnp.asarray(taus), SALT)
    seg, ws = to_np(order.seg), to_np(order.ws)
    for j, s in zip(*np.nonzero(ent_a != ent_b)):
        elems = np.nonzero(seg == s)[0]
        d = np.minimum(ulp_distance(to_np(delta_t)[j, elems], ws[elems]),
                       ulp_distance(np.asarray(delta_r)[j, elems], ws[elems]))
        i = elems[int(np.argmin(d))]
        assert d.min() <= 4, (
            f"unexplained entered flip, lane {j} key row {s}: deciding pair "
            f"Delta={to_np(delta_t)[j, i]!r} (port) / {np.asarray(delta_r)[j, i]!r} "
            f"(reference) vs w={ws[i]!r}, {int(d.min())} ulp")


@pytest.mark.parametrize("C,L,empty_tail", [(256, 1, 0), (256, 4, 0), (300, 4, 37),
                                            (512, 8, 0)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_agg_matches_reference(C, L, empty_tail, backend):
    order, ls, taus = _chunk(C, L, seed=C + L, empty_tail=empty_tail)
    got = ops.capscore_agg(order.ks, order.eids, order.ws, order.seg,
                           torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    want = rops.capscore_agg(*(jnp.asarray(to_np(a)) for a in
                               (order.ks, order.eids, order.ws, order.seg)),
                             jnp.asarray(ls), jnp.asarray(taus), np.uint32(SALT),
                             backend=backend)
    w_t, ent_t, ctr_t, kb_t, ms_t = (to_np(a) for a in got)
    w_r, ent_r, ctr_r, kb_r, ms_r = (np.asarray(a) for a in want)
    assert np.array_equal(kb_t, kb_r), "kb_min"
    _explain_entered(ent_t, ent_r, order, ls, taus)
    assert_ulp_close(ms_t, ms_r, what="min_score")
    assert_rtol(w_t, w_r, what="w_total")
    same = ent_t == ent_r
    assert_rtol(ctr_t[same], ctr_r[same], what="contrib")


@pytest.mark.parametrize("L", [1, 4])
def test_capscore_multi_ref_matches_reference(L):
    order, ls, taus = _chunk(400, L, seed=9)
    got = capscore_multi_ref(order.ks, order.eids, order.ws, torch.from_numpy(ls),
                             torch.from_numpy(taus), SALT)
    want = ref_multi(*(jnp.asarray(to_np(a)) for a in (order.ks, order.eids, order.ws)),
                     jnp.asarray(ls), jnp.asarray(taus), SALT)
    score_t, delta_t, entry_t, kb_t = (to_np(a) for a in got)
    score_r, delta_r, entry_r, kb_r = (np.asarray(a) for a in want)
    assert np.array_equal(kb_t, kb_r)
    assert_ulp_close(score_t, score_r, what="score")
    assert_ulp_close(delta_t, delta_r, what="delta")
    flips = np.nonzero(entry_t != entry_r)
    ws = to_np(order.ws)
    for j, i in zip(*flips):
        assert min(ulp_distance(delta_t[j, i], ws[i]),
                   ulp_distance(delta_r[j, i], ws[i])) <= 4, (j, i)


def test_cpu_tensor_takes_plain_version():
    order, ls, taus = _chunk(128, 2, seed=1)
    before = ops.capscore_agg_cuda.launches
    ops.capscore_agg(order.ks, order.eids, order.ws, order.seg,
                     torch.from_numpy(ls), torch.from_numpy(taus), SALT)
    assert ops.capscore_agg_cuda.launches == before
    with pytest.raises(ValueError):
        ops.capscore_agg_cuda(order.ks, order.eids, order.ws, order.seg,
                              torch.from_numpy(ls), torch.from_numpy(taus), SALT)


def _elements(N, seed, empty_every=0):
    """Unsorted elements with non-unit weights (some EMPTY keys)."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, N) % 500).astype(np.int32)
    if empty_every:
        keys[::empty_every] = EMPTY
    eids = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    ws = (rng.random(N) * 3 + 0.05).astype(np.float32)
    return keys, eids, ws


def _assert_scores_agree(got, want, ws):
    """score/delta within 4 ulp, kb exact, entry flips explained."""
    score_t, delta_t, entry_t = got[:3]
    score_r, delta_r, entry_r = want[:3]
    assert_ulp_close(score_t, score_r, what="score")
    assert_ulp_close(delta_t, delta_r, what="delta")
    if len(got) == 4:
        assert np.array_equal(got[3], want[3]), "kb"
    assert entry_t.dtype == np.int32
    for idx in zip(*np.nonzero(entry_t != entry_r)):
        w = ws[idx[-1]]
        gap = min(ulp_distance(delta_t[idx], w), ulp_distance(delta_r[idx], w))
        assert gap <= 4, f"unexplained entry flip at {idx}: Delta {delta_t[idx]!r} / {delta_r[idx]!r} vs w={w!r}"


# l = 3.3 and 0.7 are not exact in f32: both packages must round them to f32
# before use (the reference does jnp.float32(l))
@pytest.mark.parametrize("l,tau", [(3.3, 0.5), (3.3, np.inf), (16.0, 1e-3), (0.7, 0.2),
                                   (1.0, 2.0)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_matches_reference(l, tau, backend):
    keys, eids, ws = _elements(300, seed=int(l * 10), empty_every=17)
    got = ops.capscore(*(torch.from_numpy(a) for a in (keys, eids, ws)), l, tau, SALT)
    want = rops.capscore(*(jnp.asarray(a) for a in (keys, eids, ws)), l, tau,
                         np.uint32(SALT), backend=backend)
    _assert_scores_agree([to_np(a) for a in got], [np.asarray(a) for a in want], ws)


@pytest.mark.parametrize("N,L", [(1, 1), (300, 4), (777, 8)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capscore_multi_matches_reference(N, L, backend):
    keys, eids, ws = _elements(N, seed=N + L, empty_every=11)
    ls = np.array([1.0, 3.3, 256.0, 4096.0, 0.7, 64.0, 1024.0, 8.0][:L], np.float32)
    taus = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2][:L], np.float32)
    got = ops.capscore_multi(*(torch.from_numpy(a) for a in (keys, eids, ws, ls, taus)),
                             SALT)
    want = rops.capscore_multi(*(jnp.asarray(a) for a in (keys, eids, ws, ls, taus)),
                               np.uint32(SALT), backend=backend)
    got, want = [to_np(a) for a in got], [np.asarray(a) for a in want]
    assert [a.shape for a in got] == [(L, N)] * 4
    _assert_scores_agree(got, want, ws)


def test_capscore_is_lane_of_capscore_multi():
    """The single-lane plain version is lane j of the grid's, bit for bit."""
    keys, eids, ws = (torch.from_numpy(a) for a in _elements(500, seed=5))
    ls = torch.tensor([3.3, 16.0], dtype=torch.float32)
    taus = torch.tensor([0.5, float("inf")], dtype=torch.float32)
    multi = ops.capscore_multi(keys, eids, ws, ls, taus, SALT)
    for j, (l, tau) in enumerate(((3.3, 0.5), (16.0, float("inf")))):
        single = ops.capscore(keys, eids, ws, l, tau, SALT)
        for a, b in zip(single, multi):
            assert torch.equal(a, b[j])


def test_cpu_tensors_take_plain_scoring():
    keys, eids, ws = (torch.from_numpy(a) for a in _elements(64, seed=2))
    ls = torch.tensor([2.0], dtype=torch.float32)
    before = (ops.capscore_cuda.launches, ops.capscore_multi_cuda.launches)
    ops.capscore(keys, eids, ws, 2.0, 0.5, SALT)
    ops.capscore_multi(keys, eids, ws, ls, ls, SALT)
    assert (ops.capscore_cuda.launches, ops.capscore_multi_cuda.launches) == before
    with pytest.raises(ValueError):
        ops.capscore_cuda(keys, eids, ws, 2.0, 0.5, SALT)
    with pytest.raises(ValueError):
        ops.capscore_multi_cuda(keys, eids, ws, ls, ls, SALT)
