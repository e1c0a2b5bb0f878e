"""Parity of the port's attention op with the reference's, on the CPU.

Each CPU route of ``repro_torch.kernels.flash_attention.ops.attention`` is
held against its reference counterpart on the same numpy inputs:
``None`` / ``"pallas"`` (the kernel's plain version, ``attention_ref``)
against the Pallas ``flash_attention`` in interpret mode, ``"xla_chunked"`` against
``xla_chunked_attention`` and ``"naive"`` against ``attention_ref``.
Tolerances: ``ATTN_TOL`` in ``tests/_torch_ref.py``.  The CUDA kernel
itself is tested on the card (``tests/test_torch_kernels_cuda.py``).
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ATTN_TOL, x64_off
from repro.kernels.flash_attention.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.ops import xla_chunked_attention as ref_chunked
from repro.kernels.flash_attention.ref import attention_ref as ref_naive
from repro_torch.kernels.flash_attention import ops

# (B, Hq, Hkv, S, D): GQA groups 1, 2, 4 and 8; S 128, 256, 384; D 16..128
CASES = [(2, 4, 4, 128, 16), (2, 4, 2, 256, 32), (1, 8, 1, 384, 64),
         (2, 4, 2, 128, 128), (1, 4, 4, 256, 128), (1, 8, 2, 128, 32)]
CHUNK = 64


def _inputs(case, dtype):
    B, Hq, Hkv, S, D = case
    rng = np.random.default_rng(sum(case))
    return (rng.normal(size=(B, Hq, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(case, causal, dtype, route):
    arrays = [jnp.asarray(a, dtype) for a in _inputs(case, dtype)]
    with x64_off():
        if route in (None, "pallas"):
            out = ref_flash(*arrays, causal=causal, interpret=True)
        elif route == "xla_chunked":
            out = ref_chunked(*arrays, causal=causal, chunk=CHUNK)
        else:
            out = ref_naive(*arrays, causal=causal)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("route", [None, "pallas", "xla_chunked", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_Hq{}_Hkv{}_S{}_D{}".format(*c))
def test_attention_route_matches_reference(case, causal, dtype, route):
    want = _reference(case, causal, dtype, "pallas" if route is None else route)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _inputs(case, dtype))
    got = ops.attention(tq, tk, tv, causal=causal, backend=route, chunk=CHUNK)
    assert got.dtype == tq.dtype and tuple(got.shape) == tq.shape
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_masks_a_ragged_tail(S, causal):
    """``flash_attention``'s CPU route takes an S that is not a tile
    multiple, as the kernel does (it masks its tail); held against the
    reference's naive oracle, which takes any S."""
    rng = np.random.default_rng(S)
    arrays = [rng.normal(size=(1, H, S, 32)).astype(np.float32) for H in (4, 2, 2)]
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrays), causal=causal)
    with x64_off():
        want = np.asarray(ref_naive(*(jnp.asarray(a) for a in arrays), causal=causal))
    tol = ATTN_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_flash_attention_cuda_raises_on_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64)
    before = ops.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_cuda(q, q, q)
    assert ops.flash_attention_cuda.launches == before


def test_fault_check_mutates_the_kernel_source_once():
    """``flash_fault_check.py`` plants each fault by replacing a piece of the
    kernel's source; each piece must be there exactly once."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("flash_fault_check",
                                                  root / "flash_fault_check.py")
    ffc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ffc)
    source = (root / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    assert set(ffc.MUTANTS) == {"drop_tile", "shift_mask", "zero_out"}
    for old, new in ffc.MUTANTS.values():
        assert source.count(old) == 1 and new != old


def test_unknown_backend_raises():
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError):
        ops.attention(q, q, q, backend="triton")
