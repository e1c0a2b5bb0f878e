"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips with a reason where no NVIDIA
GPU is present (CUDA kernels have no CPU mode).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports only torch and the port, so it runs where JAX is absent.

Tolerances: ``chunksort`` exact (sorted distinct (key, index) pairs are the
stable argsort).  ``capscore_agg``: ``entered``, ``kb_min`` and
``min_score`` exact (the same IEEE divisions in the same order and the same
``log1pf`` as PyTorch's CUDA ``log1p``); ``w_total``/``contrib`` within rtol
1e-5, because the kernel sums in another order than the plain version.
``capscore_multi`` and ``capscore``: every output bit-identical (the same
IEEE operations in the same order and the same ``log1pf``).
``flash_attention``: within 2e-5 (f32) and 2e-2 (bf16) of ``attention_ref``
and of the kernel's plain blockwise version, the reference's own tolerances
for its flash kernel (the online softmax sums in another order; a bf16
output may round to the other side).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore import ops as cops  # noqa: E402
from repro_torch.kernels.chunksort import ops as sops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402

pytestmark = pytest.mark.cuda

EMPTY = 2**31 - 1
SALT = 0x5EED


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _sort_case(name, n):
    rng = np.random.default_rng(n)
    if name == "random":
        return rng.integers(0, max(2, n // 3), n).astype(np.int32)
    if name == "ties":
        return rng.integers(0, 3, n).astype(np.int32)
    if name == "zipf":  # the main path's chunk: Zipf(1.2) over 2^22 ids
        return (rng.zipf(1.2, n) % (1 << 22)).astype(np.int32)
    if name == "empty_mix":
        keys = rng.integers(-20, 50, n).astype(np.int32)
        keys[rng.random(n) < 0.3] = EMPTY
        return keys
    return np.full(n, EMPTY, np.int32)  # all_empty


@pytest.mark.parametrize("name,n", [("random", 1), ("random", 7), ("random", 2047),
                                    ("random", 2048), ("zipf", 2048),
                                    ("random", 2049), ("random", 65536),
                                    ("ties", 2048), ("ties", 65536),
                                    ("empty_mix", 2049), ("all_empty", 4097)])
def test_chunksort_kernel_matches_plain(name, n):
    _require_cuda()
    keys = torch.from_numpy(_sort_case(name, n)).cuda()
    before = sops.sort_with_perm_cuda.launches
    ks, perm = sops.sort_with_perm(keys)
    torch.cuda.synchronize()
    assert sops.sort_with_perm_cuda.launches == before + 1
    ks_p, perm_p = sops.sort_with_perm_ref(keys)
    assert torch.equal(ks, ks_p)
    assert torch.equal(perm, perm_p)


def _agg_case(C, L, seed, empty_tail):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, C) % (4 * C)).astype(np.int32)
    if empty_tail:
        keys[-empty_tail:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = (rng.random(C) * 3 + 0.05).astype(np.float32)
    order = chunk_order(*(torch.from_numpy(a).cuda() for a in (keys, eids, ws)))
    base_l = np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0], np.float32)
    base_t = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2], np.float32)
    ls = (np.resize(base_l, L) * (1 + np.arange(L) // 8)).astype(np.float32)
    taus = np.resize(base_t, L)
    return order, torch.from_numpy(ls).cuda(), torch.from_numpy(taus).cuda()


@pytest.mark.parametrize("C,L,empty_tail", [(2048, 4, 0), (2048, 8, 0), (2048, 4, 300),
                                            (7, 3, 2), (20000, 9, 0)])
def test_capscore_agg_kernel_matches_plain(C, L, empty_tail):
    _require_cuda()
    order, ls, taus = _agg_case(C, L, C + L, empty_tail)
    args = (order.ks, order.eids, order.ws, order.seg, ls, taus, SALT)
    before = cops.capscore_agg_cuda.launches
    got = cops.capscore_agg(*args)
    torch.cuda.synchronize()
    assert cops.capscore_agg_cuda.launches == before + 1
    want = cops.capscore_agg_ref(*args)
    assert torch.equal(got[1], want[1]), "entered"
    assert torch.equal(got[3], want[3]), "kb_min"
    assert torch.equal(got[4], want[4]), "min_score"
    for i, name in ((0, "w_total"), (2, "contrib")):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)


def _score_case(N, L, seed):
    """Unsorted elements with EMPTY keys and non-unit weights; lanes mixing
    tau = inf, tau*l > 1 and tau*l < 1, and an l that is not exact in f32."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, N) % (4 * N + 7)).astype(np.int32)
    keys[rng.random(N) < 0.05] = EMPTY
    eids = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    ws = (rng.random(N) * 3 + 0.05).astype(np.float32)
    ws[: N // 2] = 1.0
    base_l = np.array([1.0, 16.0, 256.0, 4096.0, 3.3, 64.0, 1024.0, 0.7], np.float32)
    base_t = np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2], np.float32)
    return ([torch.from_numpy(a).cuda() for a in (keys, eids, ws)],
            torch.from_numpy(np.resize(base_l, L)).cuda(),
            torch.from_numpy(np.resize(base_t, L)).cuda())


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("N", [1, 7, 2047, 2048, 2049, 65536])
def test_capscore_multi_kernel_matches_plain(N, L):
    _require_cuda()
    elems, ls, taus = _score_case(N, L, N * 10 + L)
    before = cops.capscore_multi_cuda.launches
    got = cops.capscore_multi(*elems, ls, taus, SALT)
    torch.cuda.synchronize()
    assert cops.capscore_multi_cuda.launches == before + 1
    want = cops.capscore_multi_ref(*elems, ls, taus, SALT)
    for g, w, name in zip(got, want, ("score", "delta", "entry", "kb")):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("l,tau", [(1.0, float("inf")), (3.3, 0.5), (256.0, 1e-3),
                                   (0.7, 0.2)])
@pytest.mark.parametrize("N", [1, 2049, 65536])
def test_capscore_kernel_matches_plain(N, l, tau):
    _require_cuda()
    elems, _, _ = _score_case(N, 1, N + 3)
    before = cops.capscore_cuda.launches
    got = cops.capscore(*elems, l, tau, SALT)
    torch.cuda.synchronize()
    assert cops.capscore_cuda.launches == before + 1
    want = cops.capscore_ref(*elems, l, tau, SALT)
    for g, w, name in zip(got, want, ("score", "delta", "entry")):
        assert g.dtype == w.dtype and torch.equal(g, w), name


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 4, 4, 256, 64), (2, 4, 2, 256, 64),
                                          (2, 8, 1, 384, 128), (1, 2, 2, 128, 16),
                                          (1, 4, 2, 128, 32), (1, 4, 2, 200, 32),
                                          (1, 2, 1, 1, 64), (1, 2, 2, 65, 128)])
def test_flash_attention_kernel_matches_plain(B, Hq, Hkv, S, D, causal, dtype, strided):
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + S + D)

    def make(H):
        x = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    q, k, v = make(Hq), make(Hkv), make(Hkv)
    before = fops.flash_attention_cuda.launches
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, Hq, S, D)
    tol = FLASH_TOL[dtype]
    want = fops.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_cuda_refuses_what_the_kernel_does_not_take():
    _require_cuda()
    q = torch.zeros((1, 4, 128, 64), device="cuda")
    k = torch.zeros((1, 3, 128, 64), device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        fops.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 2, 128, 48), device="cuda")
        fops.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        x = torch.zeros((1, 2, 128, 64), device="cuda", dtype=torch.float16)
        fops.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="last dim"):
        x = torch.zeros((1, 2, 64, 128), device="cuda").transpose(2, 3)
        fops.flash_attention_cuda(x, x, x)
