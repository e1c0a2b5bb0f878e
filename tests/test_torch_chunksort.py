"""Port parity: the chunk-order sort.

On the CPU the port's ``sort_with_perm`` runs its plain version; it is held
against the reference's Pallas kernel (interpret mode, as the reference's
own tests run it).  The CUDA kernel is held against the plain version on the
card in tests/test_torch_kernels_cuda.py.

Tolerance: exact.  The sort orders distinct (key, index) pairs, so its
output is the stable argsort by construction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import jax.numpy as jnp  # noqa: E402
from _torch_ref import to_np  # noqa: E402

from repro.kernels.chunksort import sort_with_perm as ref_sort  # noqa: E402
from repro_torch.kernels.chunksort import ops  # noqa: E402

EMPTY = 2**31 - 1


def _case(name, n, seed=0):
    rng = np.random.default_rng(seed + n)
    if name == "random":
        return rng.integers(0, max(2, n // 3), n).astype(np.int32)
    if name == "ties":
        return rng.integers(0, 3, n).astype(np.int32)
    if name == "empty_mix":
        keys = rng.integers(-20, 50, n).astype(np.int32)
        keys[rng.random(n) < 0.3] = EMPTY
        return keys
    if name == "all_empty":
        return np.full(n, EMPTY, np.int32)
    raise ValueError(name)


def _assert_same(a, b):
    assert np.array_equal(to_np(a[0]), to_np(b[0]))
    assert np.array_equal(to_np(a[1]), to_np(b[1]))


@pytest.mark.parametrize("name,n", [("random", 1), ("random", 7), ("random", 257),
                                    ("random", 2049), ("ties", 1000),
                                    ("empty_mix", 700), ("all_empty", 513)])
def test_sort_matches_reference_pallas(name, n):
    keys = _case(name, n)
    want = ref_sort(jnp.asarray(keys), backend="pallas")
    got = ops.sort_with_perm(torch.from_numpy(keys))
    _assert_same(got, want)
    assert to_np(got[1]).max(initial=0) < n  # no pad index leaks out


def test_cpu_tensor_takes_plain_version():
    keys = torch.from_numpy(_case("ties", 300))
    before = ops.sort_with_perm_cuda.launches
    _assert_same(ops.sort_with_perm(keys), ops.sort_with_perm_ref(keys))
    assert ops.sort_with_perm_cuda.launches == before
    with pytest.raises(ValueError):
        ops.sort_with_perm_cuda(keys)  # the kernel wrapper refuses CPU tensors


def test_kernel_variants_edit_the_sources_once():
    """``kernel_variants.py`` builds each variant of the ``chunksort``,
    ``embedding_bag``, ``capscore_agg`` and ``capscore_multi`` kernels by
    replacing pieces of their sources (or from a source of its own, which
    must define the entry points its wrapper calls); each piece must be
    there exactly once."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("kernel_variants", root / "kernel_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    assert set(kv.VARIANTS) == {"rows1", "rows2", "rows4", "rows8", "rows16", "rows1_vec4",
                                "registers", "registers_select", "smem_bitonic", "radix4",
                                "radix6", "scan", "scan_256x8", "rows_unstaged",
                                "tail_in_cta0", "warp_per_key", "vec4", "per_element"}
    assert (set(kv.SORTS) | set(kv.BAGS) | set(kv.AGGS) | set(kv.SCORES)
            == set(kv.VARIANTS))
    entry_points = {"radix4": ["chunksort_sort_pairs"], "radix6": ["chunksort_sort_pairs"],
                    "warp_per_key": ["capscore_agg_launch"],
                    "per_element": ["capscore_multi_launch", "capscore_launch"]}
    for name, (source, edits) in kv.VARIANTS.items():
        if source is None:
            for fn in entry_points[name]:
                assert f'extern "C" int {fn}(' in edits, (name, fn)
            continue
        text = (root / f"src/repro_torch/kernels/csrc/{source}.cu").read_text()
        for old, new in edits:
            assert text.count(old) == 1 and new != old, (name, old)
