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


ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    """A script at the repository's root, as a module (neither needs a card
    to import)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fault_check_mutates_the_kernel_source_once():
    """``flash_fault_check.py`` plants each fault by replacing a piece of a
    kernel's source: ``drop_tile``, ``shift_mask`` and ``zero_out`` in both
    the tensor-core and the FMA kernel, ``drop_lo`` in the tensor-core
    kernel; each piece must be there exactly once."""
    ffc = _script("flash_fault_check")
    both = {"flash_attention_sm90", "flash_attention"}
    assert {name: set(m) for name, m in ffc.MUTANTS.items()} == {
        "drop_tile": both, "shift_mask": both, "zero_out": both,
        "drop_lo": {"flash_attention_sm90"}}
    for mutant in ffc.MUTANTS.values():
        for lib, (old, new) in mutant.items():
            source = (ROOT / f"src/repro_torch/kernels/csrc/{lib}.cu").read_text()
            assert source.count(old) == 1 and new != old


def test_variants_edit_the_kernel_source_once():
    """``flash_variants.py`` builds each variant by replacing pieces of the
    tensor-core kernel's source; each piece must be there exactly once."""
    fv = _script("flash_variants")
    source = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_sm90.cu").read_text()
    assert set(fv.VARIANTS) == {"sound", "drop_lo", "stages2", "bk64_stages4", "trap_wait"}
    for edits in fv.VARIANTS.values():
        for old, new in edits:
            assert source.count(old) == 1 and new != old


def _split_p_attention(q, k, v, split: bool):
    """The tensor-core kernel's numerics in plain PyTorch on the CPU: f32
    scores scaled by 1/sqrt(D), causal mask, f32 softmax numerator p and row
    sum l; P.V with p rounded to bf16 once (``split=False``) or as
    P_hi = bf16(p) plus P_lo = bf16(p - P_hi), both products summed in f32
    (``split=True``); the output acc / l rounded to bf16."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (1.0 / D**0.5)
    s = torch.where(torch.ones((S, S), dtype=torch.bool).tril(), s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p_hi = p.bfloat16().float()
    acc = torch.einsum("bhqk,bhkd->bhqd", p_hi, vv)
    if split:
        acc = acc + torch.einsum("bhqk,bhkd->bhqd", (p - p_hi).bfloat16().float(), vv)
    return (acc / p.sum(dim=-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("B,Hq,Hkv,S,D,seed", [(1, 4, 2, 512, 64, 0), (2, 2, 2, 256, 32, 1),
                                               (1, 8, 2, 256, 128, 2)])
def test_split_p_holds_the_prefill_gate_and_single_rounding_does_not(B, Hq, Hkv, S, D, seed):
    """Why the tensor-core kernel splits P: against ``attention_ref`` under
    chip_smoke's bf16 prefill gate (``PREFILL_TOL["bfloat16"]``: atol 1e-4,
    rtol 2^-7, one bf16 ulp), P
    split into two bf16 halves holds (worst |d| / (atol + rtol |want|) <= 1),
    and P rounded once to bf16 does not."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).bfloat16()
               for H in (Hq, Hkv, Hkv))
    want = ops.attention_ref(q, k, v, causal=True).float()
    atol, rtol = _script("chip_smoke").PREFILL_TOL["bfloat16"]

    def worst(got):
        return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())

    assert worst(_split_p_attention(q, k, v, split=True)) <= 1.0
    assert worst(_split_p_attention(q, k, v, split=False)) > 1.0


def test_unknown_backend_raises():
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError):
        ops.attention(q, q, q, backend="triton")
