"""Port parity: the single-sketch incremental sampler (repro_torch.core.
incremental ``init_state`` / ``update`` / ``finalize`` and
``IncrementalSampler``, fixed-k at evict_every 1 and 4, fixed-tau for every
kind), the reference multi-l route (``update_multi(reference=True)``), and
a reference single-sketch state carried across by ``convert``, against the
reference package on the same streams.

Tolerances (tests/_torch_ref.py): keys, and every value of the hash-only
kinds, exact; counts within rtol 1e-5 plus 4 ulp of the largest element
weight; e-derived thresholds and seeds within rtol 1e-5.  Within the port
on the CPU, the chunked entry points and the one-shot samplers, and the
reference route and the fused route, are bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ref import RTOL, count_atol, to_np  # noqa: E402

from repro.core import incremental as RI  # noqa: E402
from repro.core import vectorized as RV  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402

K, CHUNK, SALT = 64, 256, 0x5EED
KINDS = {"continuous": 16.0, "discrete": 16, "distinct": 1, "sh": 1e9}
LS = (1.0, 16.0, 256.0)


def _stream(n, seed, weighted=False):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % 700).astype(np.int64)
    w = (rng.random(n) * 2 + 0.1).astype(np.float32) if weighted else None
    return keys, w


def _feed(sampler, keys, w, sizes=(100, 700, 256, 1, 999)):
    """Uneven batches: remainders carried across ``observe`` calls."""
    lo, i = 0, 0
    while lo < len(keys):
        hi = min(len(keys), lo + sizes[i % len(sizes)])
        sampler.observe(keys[lo:hi], None if w is None else w[lo:hi])
        lo, i = hi, i + 1


def _results_agree(got, want, max_w=1.0, exact_tau=False):
    assert np.array_equal(got.keys, want.keys)
    np.testing.assert_allclose(got.counts, want.counts, rtol=RTOL, atol=count_atol(max_w))
    if exact_tau:
        assert np.float32(got.tau) == np.float32(want.tau)
    else:
        assert got.tau == pytest.approx(want.tau, rel=RTOL)
    assert (got.kind, np.float32(got.l)) == (want.kind, np.float32(want.l))


def _bit_identical(a, b):
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.counts, b.counts)
    assert np.float32(a.tau) == np.float32(b.tau)


@pytest.mark.parametrize("evict_every", [1, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_fixed_k_parity(evict_every, weighted):
    keys, w = _stream(9 * CHUNK + 100, seed=evict_every + 2 * weighted, weighted=weighted)
    kw = dict(k=K, chunk=CHUNK, salt=SALT, evict_every=evict_every)
    ref = RI.IncrementalSampler(16.0, **kw)
    port = TI.IncrementalSampler(16.0, device="cpu", **kw)
    _feed(ref, keys, w)
    _feed(port, keys, w)
    assert port.n_observed == ref.n_observed == len(keys)
    assert port.state.capacity == ref.state.capacity == K + evict_every * CHUNK
    got = port.finalize()
    _results_agree(got, ref.finalize(), 1.0 if w is None else float(w.max()))
    assert len(got.keys) <= K
    # finalize is non-destructive: the live state ingests on and agrees
    more, _ = _stream(3 * CHUNK, seed=40)
    ref.observe(more)
    port.observe(more)
    _results_agree(port.finalize(), ref.finalize(), 1.0 if w is None else float(w.max()))


@pytest.mark.parametrize("kind", list(KINDS))
def test_fixed_tau_parity(kind):
    keys, _ = _stream(8 * CHUNK + 37, seed=3)
    kw = dict(tau=0.05, kind=kind, chunk=CHUNK, capacity=1024, salt=SALT)
    ref = RI.IncrementalSampler(KINDS[kind], **kw)
    port = TI.IncrementalSampler(KINDS[kind], device="cpu", **kw)
    _feed(ref, keys, None)
    _feed(port, keys, None)
    got, want = port.finalize(), ref.finalize()
    if kind == "continuous":
        _results_agree(got, want, exact_tau=True)
    else:
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts, np.asarray(want.counts, np.float64))
        assert np.float32(got.tau) == np.float32(want.tau)


@pytest.mark.parametrize("kind", list(KINDS))
def test_incremental_equals_one_shot(kind):
    """Fed in uneven batches, the sampler finalizes bit for bit like the
    one-shot sampler on the whole stream (same chunk boundaries, the same
    end-of-stream padding)."""
    keys, _ = _stream(7 * CHUNK + 11, seed=5)
    l = KINDS[kind]
    port = TI.IncrementalSampler(l, tau=0.05, kind=kind, chunk=CHUNK, capacity=1024,
                                 salt=SALT, device="cpu")
    _feed(port, keys, None)
    _bit_identical(port.finalize(), TV.sample_fixed_tau(
        keys, tau=0.05, l=l, kind=kind, chunk=CHUNK, capacity=1024, salt=SALT, device="cpu"))
    if kind == "continuous":
        port = TI.IncrementalSampler(l, k=K, chunk=CHUNK, salt=SALT, device="cpu")
        _feed(port, keys, None)
        _bit_identical(port.finalize(), TV.sample_fixed_k(keys, k=K, l=l, chunk=CHUNK,
                                                          salt=SALT, device="cpu"))


def test_evict_every_schedule_and_final_projection():
    """E = 4: between scheduled evictions the live table holds more than k
    keys (up to k + 4 chunks); finalize projects it to <= k without
    touching it, and repeated finalizes agree."""
    keys, _ = _stream(10 * CHUNK, seed=8)
    s = TI.IncrementalSampler(16.0, k=K, chunk=CHUNK, salt=SALT, evict_every=4, device="cpu")
    sizes = []
    for lo in range(0, len(keys), CHUNK):
        s.observe(keys[lo:lo + CHUNK])
        sizes.append(int((s.state.table.keys != TV.EMPTY).sum()))
    assert max(sizes) > K and sizes[3] <= K and sizes[7] <= K
    before = [x.clone() for x in s.state.table]
    a, b = s.finalize(), s.finalize()
    assert len(a.keys) <= K
    _bit_identical(a, b)
    assert all(torch.equal(x, y) for x, y in zip(before, s.state.table))


def test_finalize_raises_on_fixed_tau_overflow():
    keys, _ = _stream(4 * CHUNK, seed=9)
    s = TI.IncrementalSampler(16.0, tau=0.5, chunk=CHUNK, capacity=16, device="cpu")
    s.observe(keys)
    with pytest.raises(RuntimeError, match="overflow"):
        s.finalize()


def test_init_state_validates():
    with pytest.raises(ValueError):
        TI.init_state(1.0, k=4, tau=0.1, device="cpu")
    with pytest.raises(ValueError):
        TI.init_state(1.0, device="cpu")
    with pytest.raises(ValueError):
        TI.init_state(1.0, k=4, kind="discrete", device="cpu")
    with pytest.raises(ValueError):
        TI.init_state(1.0, tau=0.1, evict_every=2, device="cpu")
    st, spec = TI.init_state(4.0, tau=0.1, capacity=100, device="cpu")
    assert spec.mode == "fixed_tau" and st.capacity == 100 and st.bk_keys is None
    with pytest.raises(ValueError, match="multiple"):
        TI.update(st, torch.zeros(10, dtype=torch.int32), torch.ones(10), spec)


@pytest.mark.parametrize("weighted", [False, True])
def test_update_multi_reference_route(weighted):
    """The oracle multi-l route against the reference's oracle route, and
    against the port's fused route (bit for bit on the CPU): per-lane
    samples, thresholds and the bottom-(k+1) summaries."""
    keys, w = _stream(6 * CHUNK, seed=12 + weighted, weighted=weighted)
    w = np.ones(len(keys), np.float32) if w is None else w
    rs, rspec = RI.init_multi_state(LS, k=K, chunk=CHUNK, salt=SALT)
    rs = RI.update_multi(rs, keys.astype(np.int32), w, rspec, donate=False, reference=True)
    ts, tspec = TI.init_multi_state(LS, k=K, chunk=CHUNK, salt=SALT, device="cpu")
    kd, wd = torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(w)
    got = TI.update_multi(ts, kd, wd, tspec, reference=True)
    fused = TI.update_multi(ts, kd, wd, tspec)
    rr = RI.finalize_multi(rs, rspec, ls=LS)
    tr, fr = TI.finalize_multi(got, tspec, ls=LS), TI.finalize_multi(fused, tspec, ls=LS)
    for l in LS:
        _results_agree(tr[l], rr[l], float(w.max()))
        _bit_identical(tr[l], fr[l])
    assert np.array_equal(to_np(got.bk_keys), np.asarray(rs.bk_keys))
    np.testing.assert_allclose(to_np(got.bk_seeds), np.asarray(rs.bk_seeds), rtol=RTOL)
    assert torch.equal(got.bk_keys, fused.bk_keys) and torch.equal(got.bk_seeds, fused.bk_seeds)
    assert got.n_seen == fused.n_seen == len(keys)


def test_reference_route_needs_evict_every_1():
    ts, spec = TI.init_multi_state(LS, k=K, chunk=CHUNK, evict_every=2, device="cpu")
    with pytest.raises(ValueError, match="evict_every=1"):
        TI.update_multi(ts, torch.zeros(CHUNK, dtype=torch.int32), torch.ones(CHUNK), spec,
                        reference=True)


def _ref_state_dict(st):
    st = jax.device_get(st)
    return {"table": {k: np.asarray(v) for k, v in st.table._asdict().items()},
            "n_seen": np.asarray(st.n_seen), "l": np.asarray(st.l),
            "salt": np.asarray(st.salt)}


@pytest.mark.parametrize("mode", ["fixed_k", "fixed_tau"])
def test_single_state_carried_across(mode):
    """A reference single-sketch state stopped mid-stream continues in the
    port and gives the reference's whole-stream sample; and back."""
    keys, _ = _stream(8 * CHUNK, seed=21)
    kw = (dict(k=K) if mode == "fixed_k" else dict(tau=0.05, capacity=1024))
    cut = 4 * CHUNK
    k32, w = keys.astype(np.int32), np.ones(len(keys), np.float32)
    rs, rspec = RI.init_state(16.0, chunk=CHUNK, salt=SALT, **kw)
    half = RI.update(rs, k32[:cut], w[:cut], rspec, donate=False)
    full = RI.update(half, k32[cut:], w[cut:], rspec, donate=False)
    ts = convert.single_state_from_reference(_ref_state_dict(half), device="cpu")
    _, tspec = TI.init_state(16.0, chunk=CHUNK, salt=SALT, device="cpu", **kw)
    assert ts.table.keys.shape == (1, ts.capacity) and ts.n_seen == cut
    ts = TI.update(ts, torch.from_numpy(k32[cut:]), torch.from_numpy(w[cut:]), tspec)
    _results_agree(TI.finalize(ts, tspec), RI.finalize(full, rspec),
                   exact_tau=mode == "fixed_tau")
    # back: the port's state continues in the reference
    d = convert.single_state_to_reference(ts)
    assert d["table"]["keys"].shape == (ts.capacity,) and d["salt"].dtype == np.uint32
    back = RI.SamplerState(
        table=RV.TableState(**{k: jnp.asarray(v) for k, v in d["table"].items()}),
        n_seen=jnp.asarray(d["n_seen"]), l=jnp.asarray(d["l"]), salt=jnp.asarray(d["salt"]))
    _results_agree(RI.finalize(back, rspec), TI.finalize(ts, tspec),
                   exact_tau=mode == "fixed_tau")
    with pytest.raises(TypeError):
        bad = _ref_state_dict(half)
        bad["salt"] = bad["salt"].astype(np.int64)
        convert.single_state_from_reference(bad, device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.IncrementalSampler(1.0, k=K)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.init_state(1.0, tau=0.1)
