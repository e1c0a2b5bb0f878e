"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips with a reason where no NVIDIA
GPU is present (CUDA kernels have no CPU mode).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports only torch and the port, so it runs where JAX is absent.

Tolerances: ``chunksort`` exact (sorted distinct (key, index) pairs are the
stable argsort).  ``capscore_agg``: ``entered``, ``kb_min`` and
``min_score`` exact (the same IEEE divisions in the same order and the same
``log1pf`` as PyTorch's CUDA ``log1p``); ``w_total``/``contrib`` within rtol
1e-5, because the kernel sums in another order than the plain version; two
launches bit-identical (a fixed scan order).
``capscore_multi`` and ``capscore``: every output bit-identical (the same
IEEE operations in the same order and the same ``log1pf``).
``flash_attention``: within 2e-5 (f32, the 3xTF32 tensor-core kernel and the
FMA kernel it replaced) and 2e-2 (bf16) of ``attention_ref``, the reference's own tolerances
for its flash kernel (the online softmax sums in another order; a bf16
output may round to the other side); the tensor-core kernel's tile-boundary
cases also within one bf16 ulp (atol 1e-4, rtol 2^-7), chip_smoke's gate at
the serving prefill.
``segment_sum`` / ``embedding_bag`` (the gather-fused kernel): within rtol
1e-5 and atol 1e-5 * max|want| of the plain versions (both sum in f64 and
round once to f32: the kernels each segment's rows in ascending row order,
the plain version's CUDA ``index_add_`` with atomics in any order);
integer-valued rows exactly; two launches on the same input bit-identical.
The batched entries of the multi-tenant bank's tick (``chunksort`` [B, n],
``capscore_agg`` [B, C] with per-row salts and taus): each row equal to its
single-chunk launch bit for bit (NaN-aware), and to the plain versions as
above.  The bank on the card: every tenant bit-identical to a standalone
sampler on the card, one launch of each kernel per tick, no host sync in a
tick; against the bank on the CPU, integers exact and floats within rtol
1e-5 (counts plus 4 ulp of the largest weight).  The single-sketch samplers
on the card (``capscore_agg`` at L = 1 on fixed-tau chunks, the chunk steps
of ``IncrementalSampler``, the one-shot samplers, the reference multi-l
route, ``per_key_randomness``): the kernels' launches counted per chunk
step, two runs bit-identical, and against the same calls on the CPU under
the same rules (keys and hash-only values exact; f64 ``y``/``wx`` of
``per_key_randomness`` within 2 ulp).
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
    if name == "extremes":  # the packed word's sign flip at both ends of int32
        return rng.choice(np.array([-2**31, -2**31 + 1, -1, 0, 1, EMPTY - 1, EMPTY],
                                   np.int32), n)
    return np.full(n, EMPTY, np.int32)  # all_empty


@pytest.mark.parametrize("name,n", [("random", 1), ("random", 7), ("random", 2047),
                                    ("random", 2048), ("zipf", 2048),
                                    ("random", 2049), ("random", 65536),
                                    ("ties", 2048), ("ties", 65536),
                                    ("empty_mix", 2049), ("all_empty", 4097),
                                    ("extremes", 2048), ("extremes", 3000)]
                         + [(name, n) for name in ("all_empty", "ties")
                            for n in (1, 2, 2047, 2048, 2049, 4097)])
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


@pytest.mark.parametrize("n", [8, 2000, 5000])
def test_chunksort_kernel_reads_a_view_off_a_16_byte_boundary(n):
    """The in-register path loads eight keys at once where it can; a view
    that starts one int32 in takes the scalar loads."""
    _require_cuda()
    keys = torch.from_numpy(_sort_case("zipf", n + 1)).cuda()[1:]
    got = sops.sort_with_perm_cuda(keys)
    want = sops.sort_with_perm_ref(keys)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def _agg_edge_case(kind, C, L, seed):
    """Key-sorted chunks at the kernel's edges: Zipf keys with a key of 200
    elements straddling the first 2048-element tile boundary (from 1990),
    one key filling the chunk, an EMPTY tail, all EMPTY."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.2, C) % 997).astype(np.int32)
    if kind == "straddle" and C > 2190:
        keys[:1990] = np.arange(1990)
        keys[1990:2190] = 5000
        keys[2190:] = 5001 + keys[2190:]
    elif kind == "one_key":
        keys[:] = 42
    elif kind == "empty_tail":
        keys[-max(1, C // 3):] = EMPTY
    elif kind == "all_empty":
        keys[:] = EMPTY
    eids = rng.integers(0, 2**31 - 1, C).astype(np.int32)
    ws = (rng.random(C) * 3 + 0.05).astype(np.float32)
    order = chunk_order(*(torch.from_numpy(a).cuda() for a in (keys, eids, ws)))
    ls = np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0, 8.0], np.float32), L)
    taus = np.resize(np.array([np.inf, 0.5, 1e-3, 2e-3, 0.9, np.inf, 5e-4, 0.2],
                              np.float32), L)
    return order, torch.from_numpy(ls).cuda(), torch.from_numpy(taus).cuda()


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("kind,C", [(kind, C) for kind in ("zipf", "straddle")
                                    for C in (1, 37, 2048, 5000)]
                         + [(kind, C) for kind in ("one_key", "empty_tail", "all_empty")
                            for C in (37, 2048, 5000)])
def test_capscore_agg_kernel_at_its_edges(kind, C, L):
    """One CTA per chunk: tiles of 2048 with a carry, a segment across the
    tile boundary, one key in every element, EMPTY rows; two launches give
    the same bits."""
    _require_cuda()
    order, ls, taus = _agg_edge_case(kind, C, L, C * 10 + L)
    args = (order.ks, order.eids, order.ws, order.seg, ls, taus, SALT)
    got = cops.capscore_agg_cuda(*args)
    again = cops.capscore_agg_cuda(*args)
    want = cops.capscore_agg_ref(*args)
    torch.cuda.synchronize()
    for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
        assert torch.equal(got[i], want[i]), name
    for i, name in ((0, "w_total"), (2, "contrib")):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)
    for g, a in zip(got, again):
        assert torch.equal(g, a), "two launches differ"


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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("N", [2048, 1 << 20, (1 << 20) + 3])
def test_capscore_multi_kernel_on_batches_and_unaligned_views(N, L, offset):
    """Pass I's batch of 2^20 elements and a ragged one; inputs viewed one
    element in (off the 16-byte boundary of the vector loads)."""
    _require_cuda()
    elems, ls, taus = _score_case(N + offset, L, N + L + offset)
    elems = [t[offset:] for t in elems]
    got = cops.capscore_multi_cuda(*elems, ls, taus, SALT)
    want = cops.capscore_multi_ref(*elems, ls, taus, SALT)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("score", "delta", "entry", "kb")):
        assert g.dtype == w.dtype, name
        if g.is_floating_point():
            # Delta is inf / inf = NaN in a tau = inf lane for an element
            # whose uniform rounds to 1.0 (one in 2^24), in both versions
            nan = g.isnan()
            assert torch.equal(nan, w.isnan()), name
            g, w = g[~nan], w[~nan]
        assert torch.equal(g, w), name


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


def _same_bits(got, want) -> bool:
    """Equal bit for bit, NaN where the other is NaN (as chip_smoke's)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.is_floating_point():
        nan = got.isnan()
        return torch.equal(nan, want.isnan()) and torch.equal(got[~nan], want[~nan])
    return torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N", [2048, 1 << 20, (1 << 20) + 3])
def test_capscore_kernel_on_batches_and_unaligned_views(N, offset):
    """The single-l pass I's batch of 2^20 elements, a ragged one and one
    chunk, with inputs viewed one element in (off the 16-byte boundary of
    the vector loads); every output bit-identical, NaN-aware (Delta is
    inf / inf in a tau = inf lane for a uniform that rounds to 1.0)."""
    _require_cuda()
    elems, _, _ = _score_case(N + offset, 1, N + 7 + offset)
    elems = [t[offset:] for t in elems]
    for l, tau in ((16.0, float("inf")), (3.3, 0.5)):
        got = cops.capscore_cuda(*elems, l, tau, SALT)
        want = cops.capscore_ref(*elems, l, tau, SALT)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("score", "delta", "entry")):
            assert _same_bits(g, w), name


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


# chip_smoke.PREFILL_TOL["bfloat16"]: one bf16 ulp (atol for values near 0)
ONE_ULP_BF16 = (1e-4, 2**-7)


def _flash_case(B, Hq, Hkv, S, D, dtype, strided, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(H):
        x = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    return make(Hq), make(Hkv), make(Hkv)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [127, 128, 129, 257])
def test_flash_attention_tc_kernel_at_tile_boundaries(S, D, causal, strided):
    """The tensor-core kernel's 128-row q and kv tiles: S one short of,
    equal to and one past a tile, and past two; group 8 (Hq=32, Hkv=4).
    Held at the reference tolerance and at one bf16 ulp."""
    _require_cuda()
    q, k, v = _flash_case(1, 32, 4, S, D, torch.bfloat16, strided, S * 1000 + D)
    before = fops.flash_attention_cuda.launches_tc
    got = fops.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention_cuda.launches_tc == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 32, S, D)
    want = fops.attention_ref(q, k, v, causal=causal).float()
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    atol, rtol = ONE_ULP_BF16
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (32, 4)])  # GQA groups 1, 4, 8
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [31, 128, 129, 300])
def test_flash_attention_tf32_kernel_matches_plain(S, D, Hq, Hkv, causal, strided):
    """The f32 (3xTF32) tensor-core kernel at every head dim: S one short
    of a 32-row kv tile, a whole 128-row q tile, one past it and ragged
    across three; GQA groups 1, 4 and 8; contiguous and strided [B,S,H,D]
    views.  Within 2e-5 of ``attention_ref``; two launches bit-identical."""
    _require_cuda()
    q, k, v = _flash_case(2, Hq, Hkv, S, D, torch.float32, strided, S * 100 + D + Hq)
    before = fops.flash_attention_cuda.launches_tf32
    got = fops.flash_attention_cuda(q, k, v, causal=causal)
    again = fops.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention_cuda.launches_tf32 == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, Hq, S, D)
    assert torch.equal(got, again)
    want = fops.attention_ref(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_flash_attention_fma_kernel_matches_plain():
    """The FMA kernel, off the route and kept as the f32 kernel's yardstick,
    still computes attention (2e-5 of ``attention_ref``); its launches count
    in ``launches_fma`` and not in ``launches``."""
    _require_cuda()
    q, k, v = _flash_case(1, 8, 2, 200, 64, torch.float32, True, 3)
    f = fops.flash_attention_cuda
    before = (f.launches, f.launches_fma)
    got = fops.flash_attention_fma(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_fma) == (before[0], before[1] + 1)
    want = fops.attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_cuda_routes_by_dtype(dtype):
    """bf16 launches the bf16 tensor-core kernel, f32 the 3xTF32 one; the
    FMA kernel is on neither route."""
    _require_cuda()
    q, k, v = _flash_case(2, 8, 2, 256, 64, dtype, True, 7)
    f = fops.flash_attention_cuda
    before = (f.launches, f.launches_tc, f.launches_tf32, f.launches_fma)
    fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (f.launches, f.launches_tc, f.launches_tf32, f.launches_fma) == (
        before[0] + 1, before[1] + tc, before[2] + 1 - tc, before[3])


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
    # TMA copies: a bf16 view off a 16-byte boundary, or stepping by a row
    # that is no whole number of 16-byte units
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros((1, 2, 128, 72), device="cuda", dtype=torch.bfloat16)[..., 1:65]
        fops.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros((1, 2, 128, 68), device="cuda", dtype=torch.bfloat16)[..., :64]
        fops.flash_attention_cuda(x, x, x)
    # the same for f32, whose 16-byte units are 4 elements
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros((1, 2, 128, 72), device="cuda")[..., 1:65]
        fops.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros((1, 2, 128, 66), device="cuda")[..., :64]
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
    before = eops.embedding_bag_cuda.launches, eops.segment_sum_cuda.launches
    got = eops.embedding_bag(table, ids, segs, n_bags=B, mode=mode, per_sample_weights=psw)
    torch.cuda.synchronize()
    # one fused launch, whatever the mode, and no segment_sum
    assert (eops.embedding_bag_cuda.launches, eops.segment_sum_cuda.launches) == \
        (before[0] + 1, before[1])
    assert not got[0].any()
    _assert_sum_close(got, eops.embedding_bag_ref(table, ids, segs, n_bags=B, mode=mode,
                                                  per_sample_weights=psw))


def _bag_case(D, dtype, order, seed):
    """64 bags of 0..40 ids over a 1000-row table: 10% padding, a bag of
    padding only, empty bags, ids past the table, and bag ids out of range
    at both ends; ``order`` "sorted" or "unsorted" (a permutation)."""
    rng = np.random.default_rng(seed)
    V, B = 1000, 64
    lengths = rng.integers(0, 41, B)
    lengths[[3, 17]] = 0
    bags = np.concatenate([np.full(7, -1), np.repeat(np.arange(B), lengths), np.full(5, B)])
    ids = rng.integers(0, V + 50, len(bags))
    ids[rng.random(len(bags)) < 0.1] = -1
    ids[np.flatnonzero(bags == 5)] = -1
    if order == "unsorted":
        p = rng.permutation(len(bags))
        bags, ids = bags[p], ids[p]
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dtype).cuda()
    w = torch.from_numpy((rng.random(len(bags)) + 0.5).astype(np.float32)).cuda()
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return table, cuda(ids), cuda(bags.astype(np.int32)), w, B


@pytest.mark.parametrize("order", ["sorted_promised", "sorted", "unsorted"])
@pytest.mark.parametrize("mode,weights", [("sum", None), ("mean", None), ("sum", "table"),
                                          ("mean", "f32")])
@pytest.mark.parametrize("D", [3, 8, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_fused_embedding_bag_kernel_matches_plain(dtype, D, mode, weights, order):
    """The gather-fused kernel against ``embedding_bag_ref``: every table
    dtype, ragged and vector D, sum / mean / weighted (weights of the table's
    dtype round each product to it, f32 weights do not), bags sorted (with
    and without the caller's promise) and not; two launches bit-identical."""
    _require_cuda()
    table, ids, bags, w, B = _bag_case(D, dtype, "unsorted" if order == "unsorted"
                                       else "sorted", D + len(order))
    w = None if weights is None else w.to(dtype) if weights == "table" else w
    kw = dict(n_bags=B, mode=mode, per_sample_weights=w,
              sorted_bags=order == "sorted_promised")
    before = eops.embedding_bag_cuda.launches
    got = eops.embedding_bag_cuda(table, ids, bags, **kw)
    again = eops.embedding_bag_cuda(table, ids, bags, **kw)
    torch.cuda.synchronize()
    assert eops.embedding_bag_cuda.launches == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, D)
    assert torch.equal(got, again), "two launches differ"
    assert not got[[3, 5, 17]].any(), "empty and padding-only bags"
    _assert_sum_close(got, eops.embedding_bag_ref(table, ids, bags, n_bags=B, mode=mode,
                                                  per_sample_weights=w))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fused_embedding_bag_kernel_exact_on_integer_rows(mode):
    _require_cuda()
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.integers(-50, 51, (3000, 256)).astype(np.float32)).cuda()
    ids = rng.integers(-1, 3000, 40_000)
    bags = np.sort(rng.integers(0, 700, 40_000))
    ids, bags = torch.from_numpy(ids).cuda(), torch.from_numpy(bags).cuda()
    for promised in (True, False):
        got = eops.embedding_bag_cuda(table, ids, bags, n_bags=700, mode=mode,
                                      sorted_bags=promised)
        assert torch.equal(got, eops.embedding_bag_ref(table, ids, bags, n_bags=700,
                                                       mode=mode))


def test_embedding_bag_cuda_refuses_what_the_kernel_does_not_take():
    _require_cuda()
    ids = torch.zeros(8, dtype=torch.int32, device="cuda")
    table = torch.zeros((4, 16), device="cuda")
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        eops.embedding_bag_cuda(table.double(), ids, ids, n_bags=2)
    with pytest.raises(ValueError, match="unit column stride"):
        eops.embedding_bag_cuda(table.t(), ids, ids, n_bags=2)
    with pytest.raises(ValueError, match="int32 or int64"):
        eops.embedding_bag_cuda(table, ids.float(), ids, n_bags=2)
    with pytest.raises(ValueError, match=r"\[N\]"):
        eops.embedding_bag_cuda(table, ids[:7], ids, n_bags=2)
    with pytest.raises(ValueError, match="per_sample_weights"):
        eops.embedding_bag_cuda(table, ids, ids, n_bags=2,
                                per_sample_weights=torch.ones(8, device="cuda").double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        eops.embedding_bag_cuda(table, ids.cpu(), ids, n_bags=2)


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


# ---------------------------------------------------------------------------
# the batched entries of the multi-tenant bank's tick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,n", [(1, 2048), (7, 2048), (256, 2048), (1024, 2048), (5, 1),
                                 (9, 37), (3, 2000)])
def test_chunksort_rows_kernel_equals_single_launches(B, n):
    """One launch sorts B rows, each bit-identical to its own single-chunk
    launch and to the plain stable sort."""
    _require_cuda()
    rng = np.random.default_rng(B * 7 + n)
    keys = (rng.zipf(1.2, (B, n)) % (1 << 22)).astype(np.int32)
    keys[B // 2, :] = 42
    keys[-1, -max(1, n // 3):] = EMPTY
    k = torch.from_numpy(keys).cuda()
    before = sops.sort_with_perm_cuda.launches
    ks, perm = sops.sort_with_perm(k)
    assert sops.sort_with_perm_cuda.launches == before + 1
    want = sops.sort_with_perm_ref(k)
    assert torch.equal(ks, want[0]) and torch.equal(perm, want[1])
    for b in range(B):
        one = sops.sort_with_perm_cuda(k[b])
        assert torch.equal(ks[b], one[0]) and torch.equal(perm[b], one[1]), b


def _same_bits(got, want):
    nan = got.isnan() if got.is_floating_point() else torch.zeros_like(got, dtype=torch.bool)
    wnan = want.isnan() if want.is_floating_point() else torch.zeros_like(want, dtype=torch.bool)
    return (got.dtype == want.dtype and torch.equal(nan, wnan)
            and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("salt_dtype", ["int32", "uint32"])
@pytest.mark.parametrize("B,C,L", [(1, 2048, 4), (7, 2048, 4), (7, 37, 1), (256, 2048, 4),
                                   (3, 5000, 8)])
def test_capscore_agg_batch_kernel_equals_single_launches(B, C, L, salt_dtype):
    """One launch on a grid of (B, 1 + helpers): each chunk with its own
    salt and taus equals its single launch bit for bit (NaN-aware: Delta is
    NaN in a tau = inf lane when a uniform rounds to 1.0) and the plain
    version (sums within rtol 1e-5)."""
    _require_cuda()
    rng = np.random.default_rng(B + C + L)
    keys = (rng.zipf(1.2, (B, C)) % 997).astype(np.int32)
    keys[B // 2, :] = 42
    keys[-1, -max(1, C // 3):] = EMPTY
    eids = rng.integers(0, 2**31 - 1, (B, C)).astype(np.int32)
    ws = (rng.random((B, C)) * 3 + 0.05).astype(np.float32)
    # rows past 2048 keys (tiles with a carry) are sorted one by one: the
    # batched sort takes rows of up to 2048
    rows = [chunk_order(*(torch.from_numpy(a[b]).cuda() for a in (keys, eids, ws)))
            for b in range(B)]
    order = type(rows[0])(*(torch.stack(f) for f in zip(*rows)))
    ls = torch.from_numpy(np.resize(np.array([1.0, 16.0, 256.0, 4096.0, 3.0, 64.0, 1024.0,
                                              8.0], np.float32), L)).cuda()
    taus = torch.from_numpy(rng.choice(np.array([np.inf, 0.5, 1e-3, 0.9, 5e-4], np.float32),
                                       (B, L))).cuda()
    salts = rng.integers(0, 2**32, B).astype(np.uint32)
    st = torch.from_numpy(salts.view(np.int32)).cuda()
    if salt_dtype == "uint32":
        st = st.view(torch.uint32)
    args = (order.ks, order.eids, order.ws, order.seg, ls, taus, st)
    before = cops.capscore_agg_cuda.launches
    got = cops.capscore_agg(*args)
    assert cops.capscore_agg_cuda.launches == before + 1
    assert got[0].shape == (B, C) and got[1].shape == (B, L, C)
    for b in range(B):
        one = cops.capscore_agg_cuda(order.ks[b], order.eids[b], order.ws[b], order.seg[b],
                                     ls, taus[b], int(salts[b]))
        for g, w in zip(got, one):
            assert _same_bits(g[b], w), b
    want = cops.capscore_agg_ref(order.ks, order.eids, order.ws, order.seg, ls, taus,
                                 st.view(torch.int32))
    for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
        assert torch.equal(got[i], want[i]), name
    for i, name in ((0, "w_total"), (2, "contrib")):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("evict_every", [1, 2])
def test_bank_tick_on_the_card(evict_every):
    """The bank on the card: each tenant bit-identical to a standalone
    sampler on the card fed the same chunks, one chunksort and one
    capscore_agg launch per tick, no host sync in a tick; and against the
    bank on the CPU over the same chunks, integers and keys exact, the
    e-derived values within rtol 1e-5 (torch's CPU and CUDA log1p may
    round apart by an ulp), counts plus 4 ulp of the largest weight."""
    _require_cuda()
    from repro_torch.core.incremental import MultiSampler, TenantBank

    ls, k, chunk, T = (1.0, 8.0, 64.0), 96, 256, 6
    salts = [3, 0x5EED, 2**32 - 5, 7, 11, 0x5EED]
    card = TenantBank(ls, n_tenants=T, k=k, chunk=chunk, salts=salts, evict_every=evict_every)
    cpu = TenantBank(ls, n_tenants=T, k=k, chunk=chunk, salts=salts, evict_every=evict_every,
                     device="cpu")
    lone = [MultiSampler(ls, k=k, chunk=chunk, salt=s, evict_every=evict_every) for s in salts]
    rng = np.random.default_rng(evict_every)
    for _ in range(10):
        for t in range(T):
            if t == 4 or rng.random() < 0.3:
                continue
            n = int(rng.integers(1, 3 * chunk))
            keys = (rng.zipf(1.3, n) % 500).astype(np.int64)
            w = (rng.random(n) * 2 + 0.1).astype(np.float32)
            for b in (card, cpu):
                b.observe(t, keys, w)
            lone[t].observe(keys, w)
        s0, a0 = sops.sort_with_perm_cuda.launches, cops.capscore_agg_cuda.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            active = card.tick()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu.tick()
        launched = (sops.sort_with_perm_cuda.launches - s0, cops.capscore_agg_cuda.launches - a0)
        assert launched == ((1, 1) if active else (0, 0))
    fa = card.finalize_all()
    for t in range(T):
        fs = lone[t].finalize()
        for l in ls:
            assert np.array_equal(fa[t][l].keys, fs[l].keys)
            assert np.array_equal(fa[t][l].counts, fs[l].counts)
            assert fa[t][l].tau == fs[l].tau
        got, want = card.tenant_state_dict(t), lone[t].state_dict()
        for name in want:
            assert torch.equal(got[name], want[name]), (t, name)
    got, want = card.state_dict(), cpu.state_dict()
    for name in want:
        g, w = got[name].cpu().numpy(), want[name].numpy()
        if name in ("seed", "tau", "bk_seeds"):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
        elif name == "counts":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=4 * float(np.spacing(np.float32(2.1))),
                                       err_msg=name)
        else:
            assert np.array_equal(g, w), name


@pytest.mark.parametrize("tau", [np.inf, 0.5, 0.01, 1e-4])
@pytest.mark.parametrize("weighted", [False, True])
def test_capscore_agg_single_lane_fixed_tau(tau, weighted):
    """L = 1, the single sketch's aggregate: a finite tau with tau*l > 1
    (0.5 at l = 16) and < 1 (0.01, 1e-4), and the warm-up's inf."""
    _require_cuda()
    order, _, _ = _agg_case(2048, 1, 7 + weighted, 100)
    if not weighted:
        order = order._replace(ws=torch.ones_like(order.ws))
    ls = torch.tensor([16.0], device="cuda")
    taus = torch.tensor([tau], dtype=torch.float32, device="cuda")
    args = (order.ks, order.eids, order.ws, order.seg, ls, taus, SALT)
    before = cops.capscore_agg_cuda.launches
    got, again = cops.capscore_agg(*args), cops.capscore_agg(*args)
    torch.cuda.synchronize()
    assert cops.capscore_agg_cuda.launches == before + 2
    assert all(_same_bits(a, b) for a, b in zip(got, again)), "two launches differ"
    want = cops.capscore_agg_ref(*args)
    for i, name in ((1, "entered"), (3, "kb_min"), (4, "min_score")):
        assert torch.equal(got[i], want[i]), name
    for i, name in ((0, "w_total"), (2, "contrib")):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)
    if tau in (0.5, 0.01):  # both regimes gate some elements in and some out
        assert bool(got[1].any()) and not bool(got[1].all())


def _stream_case(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, n) % 3000).astype(np.int64)


def _agree_with_cpu(got, want, continuous):
    assert np.array_equal(got.keys, want.keys)
    if continuous:
        np.testing.assert_allclose(got.counts, want.counts, rtol=1e-5,
                                   atol=4 * float(np.spacing(np.float32(1.0))))
        assert got.tau == pytest.approx(want.tau, rel=1e-5)
    else:
        assert np.array_equal(got.counts, want.counts) and got.tau == want.tau


@pytest.mark.parametrize("mode,kind,evict_every", [
    ("fixed_k", "continuous", 1), ("fixed_k", "continuous", 4),
    ("fixed_tau", "continuous", 1), ("fixed_tau", "discrete", 1),
    ("fixed_tau", "distinct", 1), ("fixed_tau", "sh", 1)])
def test_single_sketch_step_on_the_card(mode, kind, evict_every):
    """``IncrementalSampler`` on the card: each fixed-k continuous chunk
    step launches one ``capscore_agg`` and one ``chunksort``; the chunk
    loop makes no host sync (E = 1); two runs are bit-identical and equal
    the one-shot sampler; against the same sampler on the CPU, keys exact
    and the rest under the rules above."""
    _require_cuda()
    from repro_torch.core import incremental as TI
    from repro_torch.core import vectorized as TV

    chunk, n = 512, 24 * 512 + 77
    l = {"continuous": 16.0, "discrete": 16, "distinct": 1, "sh": 1e9}[kind]
    kw = (dict(k=256, evict_every=evict_every) if mode == "fixed_k"
          else dict(tau=0.02, kind=kind, capacity=4096))
    keys = _stream_case(n, 3)
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        s = TI.IncrementalSampler(l, chunk=chunk, salt=SALT, device=device, **kw)
        s0, a0 = sops.sort_with_perm_cuda.launches, cops.capscore_agg_cuda.launches
        if device == "cuda" and evict_every == 1:
            kd = torch.from_numpy(keys[:16 * chunk].astype(np.int32)).cuda()
            wd = torch.ones(16 * chunk, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                s.state = TI.update(s.state, kd, wd, s.spec)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            s.observe(keys[16 * chunk:])
        else:
            s.observe(keys)
        steps = -(-n // chunk) - 1  # the remainder is flushed at finalize
        launched = (sops.sort_with_perm_cuda.launches - s0,
                    cops.capscore_agg_cuda.launches - a0)
        if device == "cuda":
            want = (steps, steps if kind == "continuous" else 0)
            assert launched == want, (launched, want)
        runs.append(s.finalize())
    a, b, cpu = runs
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.counts, b.counts)
    assert a.tau == b.tau
    _agree_with_cpu(a, cpu, kind == "continuous")
    if mode == "fixed_k" and evict_every == 1:
        one = TV.sample_fixed_k(keys, k=256, l=l, chunk=chunk, salt=SALT)
    elif mode == "fixed_tau":
        one = TV.sample_fixed_tau(keys, tau=0.02, l=l, kind=kind, chunk=chunk,
                                  capacity=4096, salt=SALT)
    else:
        assert len(a.keys) <= 256
        return
    assert np.array_equal(a.keys, one.keys) and np.array_equal(a.counts, one.counts)


@pytest.mark.parametrize("kind", ["continuous", "discrete", "distinct", "sh"])
def test_two_pass_on_the_card(kind):
    """``sample_two_pass`` on the card: ``capscore`` launched once per
    ``SCORE_BATCH`` elements for continuous (none for the hash-only kinds);
    equal to the CPU's (keys exact, tau within rtol 1e-5, exact weights
    equal to the stream's counts)."""
    _require_cuda()
    from repro_torch.core import distributed as TD
    from repro_torch.core import vectorized as TV

    l = {"continuous": 16.0, "discrete": 16, "distinct": 1, "sh": 1e9}[kind]
    keys = _stream_case(3 * TD.SCORE_BATCH // 2, 4)
    before = cops.capscore_cuda.launches
    got = TV.sample_two_pass(keys, k=512, l=l, kind=kind, salt=SALT)
    assert cops.capscore_cuda.launches - before == (2 if kind == "continuous" else 0)
    want = TV.sample_two_pass(keys, k=512, l=l, kind=kind, salt=SALT, device="cpu")
    assert np.array_equal(got.keys, want.keys)
    assert got.tau == pytest.approx(want.tau, rel=1e-5)
    ukeys, counts = np.unique(keys, return_counts=True)
    assert np.array_equal(got.counts, counts[np.searchsorted(ukeys, got.keys)])


def test_reference_multi_route_on_the_card():
    """``update_multi(reference=True)`` on the card: one ``capscore_multi``
    launch per chunk step; against the fused route on the card and the
    reference route on the CPU, keys and summaries exact, counts within
    rtol 1e-5 plus 4 ulp, taus within rtol 1e-5."""
    _require_cuda()
    from repro_torch.core import incremental as TI

    ls, k, chunk, n = (1.0, 16.0, 256.0, 4096.0), 256, 512, 12 * 512
    keys = torch.from_numpy(_stream_case(n, 5).astype(np.int32))
    w = torch.ones(n)
    out = {}
    for name, device, reference in (("ref", "cuda", True), ("fused", "cuda", False),
                                    ("cpu", "cpu", True)):
        st, spec = TI.init_multi_state(ls, k=k, chunk=chunk, salt=SALT, device=device)
        before = cops.capscore_multi_cuda.launches
        st = TI.update_multi(st, keys.to(device), w.to(device), spec, reference=reference)
        if name == "ref":
            assert cops.capscore_multi_cuda.launches - before == n // chunk
        out[name] = (TI.finalize_multi(st, spec, ls=ls), st.bk_keys.cpu(), st.bk_seeds.cpu())
    ref, _, _ = out["ref"]
    for other in ("fused", "cpu"):
        res, bkk, bks = out[other]
        for l in ls:
            _agree_with_cpu(ref[l], res[l], True)
        assert torch.equal(out["ref"][1], bkk)
        np.testing.assert_allclose(out["ref"][2].numpy(), bks.numpy(), rtol=1e-5)


def test_per_key_randomness_on_the_card():
    """f64 torch on the card against the numpy plain version: keys and hx
    exact, y within 2 f64 ulp; wx exact for unit weights, and for other
    weights within rtol 1e-12 (the card's ``index_add_`` adds a key's
    weights with atomics in any order, numpy in element order)."""
    _require_cuda()
    from repro_torch.core import multiobjective as TM

    keys = _stream_case(1 << 16, 6)
    w = np.random.default_rng(6).random(len(keys)) * 3 + 0.05
    for weights in (None, w):
        got = TM.per_key_randomness(keys, weights, SALT)
        want = TM.per_key_randomness_np(keys, weights, SALT)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.all(np.abs(got[2] - want[2]) <= 2 * np.spacing(np.abs(want[2])))
        if weights is None:
            assert np.array_equal(got[3], want[3])
        else:
            np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=0)
