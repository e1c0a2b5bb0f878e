"""Parity of the port's segment_sum / embedding_bag with the reference, on the CPU.

The port's ops on CPU tensors run the plain versions; they are held against
the reference's ``ops.segment_sum`` / ``ops.embedding_bag`` on both of its
routes: ``backend="pallas"`` (the TPU kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``backend="xla"``.  Tolerance: rtol
1e-5 and atol 1e-5 * max|want| (f32 sums taken in other orders); integer-
valued inputs exactly.  The CUDA kernel's own arithmetic -- each segment's
rows in ascending row order over ``ops.grouping``, summed in f64 -- is
modelled here in Python and must equal the plain version bit for bit,
which checks the wrapper's index bookkeeping without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import RTOL, to_np, x64_off
from repro.kernels.embedding_bag import ops as ref_ops
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref, segment_sum_ref

BACKENDS = ["pallas", "xla"]


def close(got, want, what=""):
    got, want = np.asarray(to_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


def _ref_segment_sum(vals, segs, S, backend):
    with x64_off():
        return np.asarray(ref_ops.segment_sum(jnp.asarray(vals), jnp.asarray(segs),
                                              n_segments=S, backend=backend))


# the reference test space: N ragged in 1..2000, D in {8, 64, 256}, S in {4, 128, 1024}
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [4, 128, 1024])
@pytest.mark.parametrize("d", [8, 64, 256])
@pytest.mark.parametrize("n", [1, 255, 257, 2000])
def test_segment_sum_matches_reference(n, d, s, backend):
    rng = np.random.default_rng(n + d + s)
    vals = rng.normal(size=(n, d)).astype(np.float32)
    segs = rng.integers(0, s, n).astype(np.int32)
    got = ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(segs), n_segments=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, d)
    close(got, _ref_segment_sum(vals, segs, s, backend), f"N={n} D={d} S={s}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_segment_sum_out_of_range_ids_and_bf16(backend):
    rng = np.random.default_rng(11)
    vals = rng.normal(size=(700, 64)).astype(np.float32)
    segs = rng.integers(-40, 140, 700).astype(np.int32)  # negative and >= S dropped
    got = ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(segs), n_segments=100)
    close(got, _ref_segment_sum(vals, segs, 100, backend), "out-of-range ids")
    bf = torch.from_numpy(vals).bfloat16()
    got = ops.segment_sum(bf, torch.from_numpy(segs), n_segments=100)
    close(got, _ref_segment_sum(to_np(bf.float()), segs, 100, backend), "bf16 rows")
    # every row dropped
    got = ops.segment_sum(torch.from_numpy(vals), torch.full((700,), -1, dtype=torch.int32),
                          n_segments=100)
    assert not got.any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_segment_sum_unsorted_and_empty_segments_exact(backend):
    # tests/test_kernels.py's case: integer-valued sums are exact
    vals = np.ones((512, 16), np.float32)
    segs = np.tile([7, 3, 7, 0], 128).astype(np.int32)
    got = to_np(ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(segs),
                                n_segments=10))
    assert got[7, 0] == 256 and got[3, 0] == 128 and got[0, 0] == 128
    assert np.all(got[[1, 2, 4, 5, 6, 8, 9]] == 0)
    assert np.array_equal(got, _ref_segment_sum(vals, segs, 10, backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode, weighted, backend):
    rng = np.random.default_rng(9)
    V, D, B, bag = 1000, 32, 64, 5
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=B * bag).astype(np.int32)
    ids[::7] = -1                       # padding entries
    ids[10:15] = -1                     # a bag of padding only
    segs = np.repeat(np.arange(B), bag).astype(np.int32)
    psw = rng.random(B * bag).astype(np.float32) + 0.5 if weighted else None
    with x64_off():
        want = np.asarray(ref_ops.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segs), n_bags=B, mode=mode,
            per_sample_weights=None if psw is None else jnp.asarray(psw), backend=backend))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = ops.embedding_bag(t(table), t(ids), t(segs), n_bags=B, mode=mode,
                            per_sample_weights=t(psw))
    close(got, want, f"embedding_bag {mode} weighted={weighted}")
    assert not got[2].any()
    plain = embedding_bag_ref(t(table), t(ids), t(segs), n_bags=B, mode=mode,
                              per_sample_weights=t(psw))
    close(got, to_np(plain), "op vs its plain version")


def test_embedding_bag_clips_ids_past_the_table():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([0, 9, -1, 3])
    got = ops.embedding_bag(table, ids, torch.tensor([0, 0, 1, 1]), n_bags=2, mode="mean")
    assert torch.equal(got, torch.stack([(table[0] + table[3]) / 2, table[3]]))


def _kernel_model(vals, seg_ids, S):
    """The CUDA kernel's arithmetic in Python: over ``ops.grouping``, each
    segment's rows added in order into f64 zeros, rounded once to f32."""
    perm, offsets = ops.grouping(seg_ids, S)
    order = perm if perm is not None else torch.arange(len(seg_ids))
    out = torch.zeros((S, vals.shape[1]), dtype=torch.float64)
    for s in range(S):
        for i in order[int(offsets[s]):int(offsets[s + 1])].tolist():
            out[s] += vals[i].double()
    return out.float()


@pytest.mark.parametrize("case", ["unsorted", "sorted", "sorted_with_out_of_range",
                                  "bags", "one_row", "all_dropped"])
def test_grouping_gives_the_plain_sums(case):
    rng = np.random.default_rng(len(case))
    n, S = (1, 5) if case == "one_row" else (300, 23)
    segs = rng.integers(-4, S + 4, n)
    if case == "unsorted":
        segs = rng.integers(0, S, n)
    elif case == "sorted":
        segs = np.sort(rng.integers(0, S, n))
    elif case == "sorted_with_out_of_range":
        segs = np.sort(segs)
    elif case == "bags":
        segs = np.repeat(np.arange(S), -(-n // S))[:n]
    elif case == "all_dropped":
        segs = np.full(n, S)
    vals = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    seg_ids = torch.from_numpy(segs.astype(np.int32))
    perm, _ = ops.grouping(seg_ids, S)
    assert (perm is None) == bool(np.all(np.diff(segs) >= 0))
    assert torch.equal(_kernel_model(vals, seg_ids, S),
                       segment_sum_ref(vals, seg_ids, n_segments=S))
