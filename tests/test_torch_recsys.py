"""Parity of the port's recsys serving path with the reference, on the CPU.

Each model's reference ``smoke_config()`` and reference ``*_init(PRNGKey(0))``
parameters are carried into the port by ``convert.recsys_params_from_reference``;
both packages then serve the same ``impression_batch`` (array-equal in both
packages for the same seed).  Tolerance (``close``): rtol 1e-5 and atol
1e-5 * max|want|, because XLA:CPU and torch sum the matmuls, the pooling and
the softmaxes in different orders; top-k index sets are equal apart from
scores tied within that tolerance at the cut.  The hot/cold plan is held to
the same hot ids (or differences a deciding count pair within 4 ulp
explains), and the hot/cold lookup to the reference exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import MAX_ULP, RTOL, to_np, ulp_distance, x64_off
from repro.configs import registry as ref_registry
from repro.data import recsys_events as ref_events
from repro.data import streams as ref_streams
from repro.models import embedding_sharding as ref_es
from repro.models import recsys as ref_R
from repro.stats import service as ref_service
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import recsys_events, streams
from repro_torch.layers.common import dense_init
from repro_torch.models import embedding_sharding as es
from repro_torch.models import recsys as R
from repro_torch.stats import service as port_service

ARCHS = ["two-tower-retrieval", "din", "bst", "mind"]
REF_INIT = {"two-tower-retrieval": ref_R.twotower_init, "din": ref_R.din_init,
            "bst": ref_R.bst_init, "mind": ref_R.mind_init}
B, N_CAND = 6, 300


def close(got, want, what=""):
    """|got - want| <= 1e-5 * max|want| + 1e-5 * |want|."""
    got, want = np.asarray(to_np(got), np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


def _setup(arch, seed=0):
    rcfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    with x64_off():
        np_params = jax.tree.map(np.asarray, REF_INIT[arch](jax.random.PRNGKey(0), rcfg))
    params = convert.recsys_params_from_reference(np_params, arch, cfg, "cpu")
    batch = recsys_events.impression_batch(np.random.default_rng(seed), batch=B,
                                           seq_len=cfg.seq_len, n_items=cfg.n_items,
                                           n_users=getattr(cfg, "n_users", 1000))
    batch["candidates"] = np.random.default_rng(seed + 1).integers(
        0, cfg.n_items, N_CAND).astype(np.int32)
    return rcfg, cfg, np_params, params, batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("seed", [0, 7])
def test_impression_batch_is_array_equal(seed):
    kw = dict(batch=33, seq_len=9, n_items=500, n_users=70)
    ref = ref_events.impression_batch(np.random.default_rng(seed), **kw)
    port = recsys_events.impression_batch(np.random.default_rng(seed), **kw)
    assert set(ref) == set(port)
    for k in ref:
        assert ref[k].dtype == port[k].dtype and np.array_equal(ref[k], port[k]), k
    for a, b in zip(ref_events.impression_stream_elements(ref),
                    recsys_events.impression_stream_elements(port)):
        assert np.array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert np.array_equal(ref_streams.zipf_keys(rng_a, 1000, 1.2, 77),
                          streams.zipf_keys(rng_b, 1000, 1.2, 77))


@pytest.mark.parametrize("scale", [None, 0.01])
def test_dense_init_scales_in_place_bit_identically(scale):
    """The tables are scaled in place: the same f32 values as
    ``randn(...) * scale`` from the same generator state."""
    want = torch.randn((300, 24), generator=torch.Generator().manual_seed(4)) * (
        scale if scale is not None else 1.0 / np.sqrt(300))
    got = dense_init(torch.Generator().manual_seed(4), 300, 24, torch.float32, scale=scale)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_registry_lists_the_recsys_models():
    assert sorted(a for a in registry.ARCH_IDS if registry.family(a) == "recsys") == sorted(ARCHS)
    for arch in ARCHS:
        assert registry.get_config(arch).name == ref_registry.get_config(arch).name


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_exactly(arch):
    _, cfg, np_params, params, _ = _setup(arch)
    back = convert.recsys_params_to_reference(params)
    flat_a = jax.tree.leaves(np_params)
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own init draws the same tree of shapes
    own = R.ARCHS[arch][1](torch.Generator().manual_seed(0), cfg)
    convert.recsys_params_from_reference(convert.recsys_params_to_reference(own), arch,
                                         cfg, "cpu")


def test_convert_refuses_a_wrong_tree():
    _, cfg, np_params, _, _ = _setup("two-tower-retrieval")
    bad = dict(np_params, user_tower=np_params["user_tower"][:-1])
    with pytest.raises(KeyError, match="list of 3"):
        convert.recsys_params_from_reference(bad, "two-tower-retrieval", cfg, "cpu")
    bad = dict(np_params, items=np_params["items"][:-1])
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_params_from_reference(bad, "two-tower-retrieval", cfg, "cpu")


def test_history_pool_matches_masked_mean():
    rcfg, cfg, np_params, params, batch = _setup("two-tower-retrieval", seed=3)
    assert (batch["hist"] == 0).any()  # padding holes
    batch["hist"][0] = 0               # a row with no history at all
    with x64_off():
        want = ref_R.masked_mean(ref_R.embed_lookup(jnp.asarray(np_params["items"]),
                                                    jnp.asarray(batch["hist"])),
                                 jnp.asarray(batch["hist"]))
    got = R.history_pool(params["items"], torch.from_numpy(batch["hist"]))
    close(got, np.asarray(want), "pooled history")
    plain = R.masked_mean(R.embed_lookup(params["items"], torch.from_numpy(batch["hist"])),
                          torch.from_numpy(batch["hist"]))
    close(got, to_np(plain), "pooled history vs the port's masked_mean")
    assert not got[0].any()


SERVE = {
    "two-tower-retrieval": [(ref_R.twotower_serve, R.twotower_serve)],
    "din": [(ref_R.din_forward, R.din_forward)],
    "bst": [(ref_R.bst_forward, R.bst_forward)],
    "mind": [(ref_R.mind_point_serve, R.mind_point_serve), (ref_R.mind_serve, R.mind_serve)],
}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    rcfg, cfg, np_params, params, batch = _setup(arch)
    for ref_fn, port_fn in SERVE[arch]:
        with x64_off():
            want = np.asarray(ref_fn(jax.tree.map(jnp.asarray, np_params), rcfg,
                                     _ref_batch(batch)))
        got = port_fn(params, cfg, _port_batch(batch))
        assert got.dtype == torch.float32
        assert np.isfinite(to_np(got)).all()
        close(got, want, f"{arch} {port_fn.__name__}")


def _assert_topk_agree(got_vals, got_idx, want_vals, want_idx):
    got_vals, want_vals = to_np(got_vals), np.asarray(want_vals)
    close(got_vals, want_vals, "top-k scores")
    tol = RTOL * np.abs(want_vals).max() + RTOL * abs(want_vals[-1])
    got = dict(zip(to_np(got_idx).tolist(), got_vals.tolist()))
    want = dict(zip(np.asarray(want_idx).tolist(), want_vals.tolist()))
    for i in set(got) ^ set(want):
        # an index in one top-k only must score a tie with its side's cut
        score, cut = (got[i], got_vals[-1]) if i in got else (want[i], want_vals[-1])
        assert abs(score - cut) <= tol, (i, score, cut)


def test_twotower_retrieve_matches_reference():
    rcfg, cfg, np_params, params, batch = _setup("two-tower-retrieval")
    one = {k: v[:1] if k != "candidates" else v for k, v in batch.items()}
    with x64_off():
        want_vals, want_idx = ref_R.twotower_retrieve(jax.tree.map(jnp.asarray, np_params),
                                                      rcfg, _ref_batch(one))
    got_vals, got_idx = R.twotower_retrieve(params, cfg, _port_batch(one))
    assert tuple(got_vals.shape) == (100,) and got_idx.dtype == torch.int64
    _assert_topk_agree(got_vals, got_idx, want_vals, want_idx)
    # the plain pooling route gives the same top-k
    plain = lambda items, hist: R.masked_mean(R.embed_lookup(items, hist), hist)  # noqa: E731
    p_vals, p_idx = R.twotower_retrieve(params, cfg, _port_batch(one), pool=plain)
    _assert_topk_agree(got_vals, got_idx, to_np(p_vals), to_np(p_idx))


def _hot_set_differences_tie(ref_svc, port_svc, n_hot, ref_hot, port_hot):
    """Keys in one hot set only must tie the cut: their count in their own
    sketch is within 4 ulp of the other sketch's n_hot-th largest count."""
    diff = set(ref_hot.tolist()) ^ set(port_hot.tolist())
    for svc, other, hot in ((ref_svc, port_svc, ref_hot), (port_svc, ref_svc, port_hot)):
        res = svc.sketches()[max(svc.config.ls)]
        ores = other.sketches()[max(other.config.ls)]
        cut = np.sort(np.asarray(ores.counts, np.float32))[::-1][n_hot - 1]
        for key in diff & set(hot.tolist()):
            c = np.asarray(res.counts, np.float32)[np.asarray(res.keys) == key]
            d = int(ulp_distance(c, np.full_like(c, cut)).min())
            assert d <= MAX_ULP, (f"hot key {key} is in one plan only: count {c} vs the "
                                  f"other side's cut {cut} ({d} ulp)")
    return len(diff)


@pytest.mark.parametrize("n_hot", [16, 64])
def test_hot_cold_plan_and_lookup_match_reference(n_hot):
    cfg_kw = dict(k=64, ls=(1.0, 16.0, 256.0), chunk=256)
    batch = recsys_events.impression_batch(np.random.default_rng(5), batch=64, seq_len=20,
                                           n_items=3000, n_users=500)
    _, items = recsys_events.impression_stream_elements(batch)
    ref_svc = ref_service.StreamStatsService(ref_service.StatsConfig(**cfg_kw))
    port_svc = port_service.StreamStatsService(port_service.StatsConfig(**cfg_kw),
                                               device="cpu")
    ref_svc.observe(items)
    port_svc.observe(items)
    ref_plan = ref_es.plan_hot_cold(ref_svc, n_hot)
    plan = es.plan_hot_cold(port_svc, n_hot)
    assert len(plan.hot_ids_sorted) == n_hot
    _hot_set_differences_tie(ref_svc, port_svc, n_hot, ref_plan.hot_ids_sorted,
                             plan.hot_ids_sorted)
    assert plan.est_hot_traffic_frac == pytest.approx(ref_plan.est_hot_traffic_frac,
                                                      rel=RTOL)

    table = np.random.default_rng(6).normal(size=(3000, 8)).astype(np.float32)
    t = torch.from_numpy(table)
    hot_table, hot_ids = es.split_table(t, plan)
    got = es.hot_cold_lookup(t, hot_table, hot_ids, torch.from_numpy(batch["hist"]))
    with x64_off():
        r_hot, r_ids = ref_es.split_table(jnp.asarray(table), plan)
        want = ref_es.hot_cold_lookup(jnp.asarray(table), r_hot, r_ids,
                                      jnp.asarray(batch["hist"]))
    assert np.array_equal(to_np(got), np.asarray(want))
    assert torch.equal(got, R.embed_lookup(t, torch.from_numpy(batch["hist"])))
