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
``segment_sum`` / ``embedding_bag``: within rtol 1e-5 and atol 1e-5 * max|want|
of the plain versions (both sum in f64 and round once to f32: the kernel
each segment's rows in ascending row order, the plain version's CUDA
``index_add_`` with atomics in any order); integer-valued rows exactly; two
launches on the same input bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.segments import chunk_order  # noqa: E402
from repro_torch.kernels.capscore import ops as cops  # noqa: E402
from repro_torch.kernels.chunksort import ops as sops  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eops  # noqa: E402
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


def _assert_sum_close(got, want):
    tol = 1e-5 * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("order", ["unsorted", "sorted", "out_of_range"])
@pytest.mark.parametrize("N,D,S", [(1, 8, 4), (255, 64, 128), (257, 256, 1024),
                                   (2000, 8, 1024), (2000, 256, 4), (1000, 3, 50),
                                   (25_600, 256, 512)])
def test_segment_sum_kernel_matches_plain(N, D, S, order, dtype):
    _require_cuda()
    rng = np.random.default_rng(N + D + S)
    segs = rng.integers(-5 if order == "out_of_range" else 0,
                        S + 5 if order == "out_of_range" else S, N)
    if order == "sorted":
        segs = np.sort(segs)
    seg = torch.from_numpy(segs.astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).cuda().to(dtype)
    before = eops.segment_sum_cuda.launches
    got = eops.segment_sum(vals, seg, n_segments=S)
    again = eops.segment_sum(vals, seg, n_segments=S)
    torch.cuda.synchronize()
    assert eops.segment_sum_cuda.launches == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, D)
    assert torch.equal(got, again), "two launches differ"
    _assert_sum_close(got, eops.segment_sum_ref(vals, seg, n_segments=S))


def test_segment_sum_kernel_exact_on_integer_rows():
    _require_cuda()
    vals = torch.ones((512, 16), device="cuda")
    seg = torch.from_numpy(np.tile([7, 3, 7, 0], 128).astype(np.int32)).cuda()
    got = eops.segment_sum(vals, seg, n_segments=10)
    assert got[7, 0] == 256 and got[3, 0] == 128 and got[0, 0] == 128
    assert not got[[1, 2, 4, 5, 6, 8, 9]].any()
    rng = np.random.default_rng(3)
    ints = torch.from_numpy(rng.integers(-50, 50, (4096, 64)).astype(np.float32)).cuda()
    seg = torch.from_numpy(rng.integers(0, 300, 4096).astype(np.int32)).cuda()
    assert torch.equal(eops.segment_sum(ints, seg, n_segments=300),
                       eops.segment_sum_ref(ints, seg, n_segments=300))
    none = eops.segment_sum(ints, torch.full_like(seg, -1), n_segments=300)
    assert not none.any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_kernel_matches_plain(mode, weighted):
    _require_cuda()
    rng = np.random.default_rng(9)
    V, D, B, bag = 5000, 256, 512, 50
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).cuda()
    ids = rng.integers(0, V, B * bag)
    ids[rng.random(B * bag) < 0.1] = -1
    ids[:bag] = -1  # a bag of padding only
    ids = torch.from_numpy(ids).cuda()
    segs = torch.arange(B, device="cuda").repeat_interleave(bag)
    psw = (torch.from_numpy(rng.random(B * bag).astype(np.float32)).cuda() + 0.5
           if weighted else None)
    before = eops.segment_sum_cuda.launches
    got = eops.embedding_bag(table, ids, segs, n_bags=B, mode=mode, per_sample_weights=psw)
    torch.cuda.synchronize()
    assert eops.segment_sum_cuda.launches == before + (2 if mode == "mean" else 1)
    assert not got[0].any()
    _assert_sum_close(got, eops.embedding_bag_ref(table, ids, segs, n_bags=B, mode=mode,
                                                  per_sample_weights=psw))


def test_segment_sum_cuda_refuses_what_the_kernel_does_not_take():
    _require_cuda()
    seg = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        eops.segment_sum_cuda(torch.zeros((8, 4), dtype=torch.float64, device="cuda"), seg,
                              n_segments=2)
    with pytest.raises(ValueError, match="int32 or int64"):
        eops.segment_sum_cuda(torch.zeros((8, 4), device="cuda"), seg.float(), n_segments=2)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        eops.segment_sum_cuda(torch.zeros((7, 4), device="cuda"), seg, n_segments=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eops.segment_sum_cuda(torch.zeros((8, 4)), seg.cpu(), n_segments=2)
