"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module makes the reference package importable on the
installed JAX: ``repro.core.incremental`` and ``repro.stats.query`` do
``from jax.experimental import enable_x64``, which current JAX no longer
has, so the alias ``jax.experimental.enable_x64 = jax.enable_x64`` is set
here, at import time.  Every test worker imports this module while it
collects the test files, so the alias is in place before any test runs.
The alias is process-wide.

Tolerances, from one fact: ``log1p`` differs between the frameworks (torch's
CPU ``log1p`` and XLA:CPU's disagree on about 15% of the 2^24 uniforms the
samplers draw, by at most 2 ulp), so every f32 value derived from
``e = -log1p(-u)`` cannot be bit-identical across the two packages:

* integers, hashes, ``u``, KeyBase and the f64 query arithmetic: exact;
* e-derived f32 values (scores, Delta, seeds, thresholds): rtol 1e-5, or
  within 4 ulp where a single rounding separates them;
* counts, which carry differences ``w - Delta``: rtol 1e-5 plus an absolute
  4 ulp of the largest element weight, because a 1-ulp change of Delta
  close to w is a large relative change of their difference;
* counts of a cross-host fixed-k merge: rtol 1e-5 plus, per key, 4 ulp
  of the largest count that key could hold before the merge's eviction
  adjusts it (its hosts' counts summed, plus at most l per duplicate-entry
  clip), because the adjustment subtracts an e-derived amount of that size
  and its rounding stays in the difference; plus each host's own count
  slack where the two packages ingested the shards separately;
* discrete outcomes (entered flags, sampled key sets): equal, unless a
  mismatch is explained by a deciding float pair within 4 ulp, which the
  assertion message prints.

Tolerances of the LM serving path (attention, layers, transformer, server):

* attention (``ATTN_TOL``): f32 2e-5 and bf16 2e-2, atol = rtol, the
  reference's own tolerances for its flash kernel against the naive oracle
  (``tests/test_kernels.py``): the blockwise online softmax sums in another
  order than the naive one, and a bf16 output may round to the other side
  (one bf16 ulp is 2^-8 relative);
* layers and the smoke transformers in f32 (``LM_F32_TOL``): atol = rtol =
  1e-4, because XLA:CPU and torch sum the matmuls in different orders and
  2 layers carry those differences into logits and caches;
* layer ops on bf16 inputs (``BF16_ULP_TOL``): rtol 2^-7, two bf16 ulps,
  since both packages compute in f32 and round once to bf16, where an f32
  difference of an ulp can land on either side of a bf16 rounding point.

JAX runs with x64 off around every reference call of the LM path
(``x64_off``): another test in the same worker may leave it on, and
``rope_angles`` would then keep its f64 inverse frequencies.
"""
from __future__ import annotations

import jax
import jax.experimental
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

# torch's CPU work runs on one thread in each test worker.  With its intra-op
# threads, torch's first elementwise ``exp`` after a fresh process's first
# JAX computation has come back with one (batch, head) block of
# ``attention_ref``'s exponentials off (its row sums up to 5.1e-5
# relative), while later calls were exact: the first flash-attention parity
# test of a worker then missed ATTN_TOL (5.33e-5 against 2e-5).
# ``tests/_first_call_probe.py`` counts such lapses in fresh processes and
# finds where they start; on one thread it counts none.  Any parity test's
# CPU reference could meet it, so the setting is for all of them; the
# workers still run in parallel.
torch.set_num_threads(1)

RTOL = 1e-5
MAX_ULP = 4
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LM_F32_TOL = 1e-4
BF16_ULP_TOL = 2.0**-7
EMPTY = 2**31 - 1  # the samplers' empty-slot key


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def x64_off():
    """Context manager: JAX with x64 disabled."""
    return jax.enable_x64(False)


def to_np(x) -> np.ndarray:
    """A torch tensor, JAX array or numpy array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in f32 units in the last place (inf == inf)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = np.abs(ordered(a) - ordered(b))
    return np.where(a == b, 0, d)


def assert_ulp_close(a, b, max_ulp=MAX_ULP, what="values"):
    d = ulp_distance(a, b)
    if d.size and d.max() > max_ulp:
        i = np.unravel_index(int(np.argmax(d)), d.shape)
        raise AssertionError(
            f"{what}: {int((d > max_ulp).sum())} entries beyond {max_ulp} ulp; "
            f"worst at {i}: {np.asarray(a)[i]!r} vs {np.asarray(b)[i]!r} "
            f"({int(d[i])} ulp)")


def count_atol(max_weight: float) -> float:
    """Absolute slack of a count: 4 ulp of the largest element weight."""
    return MAX_ULP * float(np.spacing(np.float32(max_weight)))


def merged_count_atol(host_tables, ls, merged_keys, host_atol=0.0) -> list[np.ndarray]:
    """Per-key absolute slack of fixed-k merged counts (see the module
    docstring): for lane j, one entry per key of ``merged_keys[j]``.

    ``host_tables``: each host's (keys, counts) pair of [L, cap] tables.
    A key's bound is the sum of its hosts' counts plus one entry clip of at
    most ``l`` per extra host holding it: the largest count it can carry
    before the merge's eviction subtracts from it.  ``host_atol`` is the
    slack each host's count already carries (``count_atol`` where the two
    packages ingested the shard separately, 0 where they share a state);
    it adds once per host holding the key."""
    out = []
    for j, mk in enumerate(merged_keys):
        mk = np.asarray(mk)
        total = np.zeros(mk.shape, np.float64)
        hosts = np.zeros(mk.shape, np.float64)
        for keys, counts in host_tables:
            hk, hc = np.asarray(keys[j]), np.asarray(counts[j], np.float64)
            order = np.argsort(hk, kind="stable")
            hk, hc = hk[order], hc[order]
            at = np.clip(np.searchsorted(hk, mk), 0, len(hk) - 1)
            hit = (hk[at] == mk) & (mk != EMPTY)
            total += np.where(hit, hc[at], 0.0)
            hosts += hit
        bound = total + np.maximum(hosts - 1.0, 0.0) * float(ls[j])
        out.append(MAX_ULP * np.spacing(bound.astype(np.float32)).astype(np.float64)
                   + hosts * host_atol)
    return out


def assert_counts_close(a, b, atol, what="counts"):
    """``|a - b| <= atol + RTOL * |b|`` elementwise, ``atol`` an array of
    per-entry slacks (``merged_count_atol``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~(np.abs(a - b) <= atol + RTOL * np.abs(b))
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(
            f"{what}: {int(bad.sum())} entries beyond rtol {RTOL} + per-key atol; "
            f"first at {i}: {a[i]!r} vs {b[i]!r} (atol {float(atol[i])!r})")


def assert_rtol(a, b, rtol=RTOL, what="values"):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=0,
                               err_msg=what)


# state-dict leaves of a sampler, service or bank, by the rule they are held to
EXACT_LEAVES = ("keys", "kb", "step", "overflow", "bk_keys", "n_seen", "n_real", "ls",
                "salt", "rem_keys", "rem_weights", "rem_len", "exact_ok")
E_DERIVED_LEAVES = ("seed", "tau", "bk_seeds")


def assert_state_dicts_agree(port, ref, max_weight=1.0, what="state"):
    """A port state dict against a reference one (either may be numpy or
    torch): the same leaf names and dtypes, and the values under the module
    docstring's rules: integers, keys, KeyBase, the lane grid and the
    remainders exact; e-derived seeds and taus within rtol 1e-5; counts
    within rtol 1e-5 plus 4 ulp of the largest element weight."""
    assert sorted(port) == sorted(ref), (what, sorted(port), sorted(ref))
    for name in ref:
        p, r = to_np(port[name]), to_np(ref[name])
        assert p.dtype == r.dtype and p.shape == r.shape, (what, name, p.dtype, r.dtype,
                                                         p.shape, r.shape)
        if name in EXACT_LEAVES:
            assert np.array_equal(p, r), (what, name)
        elif name in E_DERIVED_LEAVES:
            np.testing.assert_allclose(p, r, rtol=RTOL, err_msg=f"{what}: {name}")
        elif name == "counts":
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=count_atol(max_weight),
                                       err_msg=f"{what}: counts")
        else:
            raise AssertionError(f"{what}: no rule for leaf {name!r}")
