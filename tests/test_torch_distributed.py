"""Port parity: the distributed two-pass path (``repro_torch.core.
distributed``) against the reference's ``repro.core.distributed``.

In process: the lossless bottom-k merges (exact: they only select and
min-merge the f32 seeds they are given) and the fixed-k merges with both
folds, on states both packages built from the same stream.  Across
processes: the two-pass programs — the reference on P fake host devices
(``tests/_distributed_ref_runner.py``), the port as P gloo ranks on the CPU
(``tests/_torch_distributed_runner.py``) — on the same shards
(``tests/_two_pass_case.py``), at P = 4 (butterfly) and P = 3 (the
all-gather fallback).

Tolerances (tests/_torch_ref.py): sampled key sets equal, unless a key is
explained by its seed lying within 4 ulp of the seed at the other
package's bottom-(k+1) cut; seeds within rtol 1e-5 (they derive from
``log1p``); pass-II weights exact (integer sums, exact in f32); fixed-k
merges: keys, step and overflow exact, counts rtol 1e-5 plus 4 ulp of the
largest pre-merge count sum, tau, kb and seeds rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
import _two_pass_case as case  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ref import (MAX_ULP, RTOL, assert_counts_close, assert_ulp_close,  # noqa: E402
                        merged_count_atol, to_np, ulp_distance)

from repro.core import distributed as RD  # noqa: E402
from repro.core import incremental as RI  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import incremental as TI  # noqa: E402
from repro_torch.core import vectorized as TV  # noqa: E402

EMPTY = 2**31 - 1
_RUNS: dict = {}  # (side, P) -> outputs, shared by the tests of this file


def reference_run(P, tmp_dir):
    if ("ref", P) not in _RUNS:
        _RUNS["ref", P] = case.run_reference_program(P, tmp_dir)
    return _RUNS["ref", P]


def port_run(P, tmp_dir):
    """Every rank's outputs of the port's programs: a list of P dicts."""
    if ("port", P) not in _RUNS:
        _RUNS["port", P] = case.run_port_program(P, tmp_dir)
    return _RUNS["port", P]


def _cut_gap(seed, other_seeds) -> int:
    """ulp distance from ``seed`` to the largest seed kept on the other side
    (the bottom-(k+1) cut there)."""
    fin = other_seeds[np.isfinite(other_seeds)]
    return int(ulp_distance(seed, fin.max())) if len(fin) else np.iinfo(np.int64).max


def assert_lane_agrees(tk, ts, tw, rk, rs, rw, label):
    """One lane of the two-pass output: (key-sorted keys, seeds, weights)."""
    tm, rm = tk != EMPTY, rk != EMPTY
    t_seed = dict(zip(tk[tm].tolist(), ts[tm]))
    r_seed = dict(zip(rk[rm].tolist(), rs[rm]))
    for x in set(t_seed) ^ set(r_seed):
        mine, other = ((t_seed[x], rs[rm]) if x in t_seed else (r_seed[x], ts[tm]))
        gap = _cut_gap(mine, other)
        assert gap <= MAX_ULP, (
            f"{label}: key {x} sampled by one package only, deciding pair: its "
            f"seed {mine!r} vs the other side's cut {other.max()!r} ({gap} ulp)")
    both = sorted(set(t_seed) & set(r_seed))
    ti = np.searchsorted(tk[tm], both)
    ri = np.searchsorted(rk[rm], both)
    np.testing.assert_allclose(ts[tm][ti], rs[rm][ri], rtol=RTOL, err_msg=label)
    assert np.array_equal(tw[tm][ti], rw[rm][ri]), f"{label}: pass-II weights"


# ---------------------------------------------------------------------------
# element scores and the pass-I step (in process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,l", [("continuous", 5.0), ("continuous", 3.3),
                                    ("discrete", 4.0), ("distinct", 1.0), ("sh", 1.0)])
def test_element_scores_and_pass1_step_match_reference(kind, l):
    """Scores exact for the hash-only kinds, within 4 ulp for continuous
    (log1p); a summary key set that differs is explained at the cut."""
    from repro.core import vectorized as RV

    keys, weights = case.stream(1)
    keys[::37] = EMPTY
    eids = (np.arange(case.SHARD, dtype=np.int64) * 2654435761 % 2**31).astype(np.int32)
    args_t = (torch.from_numpy(keys), torch.from_numpy(eids), torch.from_numpy(weights))
    args_r = tuple(jnp.asarray(a) for a in (keys, eids, weights))
    got = to_np(TV.element_scores(kind, *args_t, l, case.SALT))
    want = np.asarray(RV.element_scores(kind, *args_r, jnp.float32(l), np.uint32(case.SALT)))
    if kind == "continuous":
        assert_ulp_close(got, want, what="scores")
    else:
        assert np.array_equal(got, want)
    cap = case.K + 1
    tc = (torch.full((cap,), EMPTY, dtype=torch.int32), torch.full((cap,), np.inf))
    rc = (jnp.full((cap,), EMPTY, jnp.int32), jnp.full((cap,), jnp.inf, jnp.float32))
    for c in range(0, case.SHARD, case.CHUNK):
        sl = slice(c, c + case.CHUNK)
        tc = TV.pass1_step(tc, args_t[0][sl], args_t[2][sl], args_t[1][sl], l, case.SALT,
                           kind=kind, cap=cap)
        rc = RV.pass1_step(rc, args_r[0][sl], args_r[2][sl], args_r[1][sl],
                           jnp.float32(l), np.uint32(case.SALT), kind=kind, cap=cap)
    tk, ts = (to_np(a) for a in tc)
    rk, rs = (np.asarray(a) for a in rc)
    if kind != "continuous":
        assert np.array_equal(tk, rk) and np.array_equal(ts, rs)
    o_t, o_r = np.argsort(tk, kind="stable"), np.argsort(rk, kind="stable")
    zeros = np.zeros(cap, np.float32)
    assert_lane_agrees(tk[o_t], ts[o_t], zeros, rk[o_r], rs[o_r], zeros, kind)


# ---------------------------------------------------------------------------
# bottom-k merges (in process)
# ---------------------------------------------------------------------------


def _summary(rng, L, cap, n_live, n_keys, tie_seeds):
    """Seed-sorted bottom-cap summaries [L, cap] (EMPTY/inf padded)."""
    keys = np.full((L, cap), EMPTY, np.int32)
    seeds = np.full((L, cap), np.inf, np.float32)
    for j in range(L):
        kk = rng.choice(n_keys, n_live, replace=False).astype(np.int32)
        ss = (rng.integers(0, 8, n_live) / 8.0 if tie_seeds
              else rng.random(n_live)).astype(np.float32)
        o = np.argsort(ss, kind="stable")
        keys[j, :n_live], seeds[j, :n_live] = kk[o], ss[o]
    return keys, seeds


@pytest.mark.parametrize("L,cap,n_a,n_b,tie_seeds", [(3, 65, 65, 65, False),
                                                     (3, 65, 40, 65, True),
                                                     (1, 17, 5, 0, False),
                                                     (4, 33, 33, 20, True)])
def test_merge_bottomk_multi_matches_reference(L, cap, n_a, n_b, tie_seeds):
    rng = np.random.default_rng(cap + n_a + n_b)
    ka, sa = _summary(rng, L, cap, n_a, 120, tie_seeds)  # overlapping key ranges
    kb, sb = _summary(rng, L, cap, n_b, 120, tie_seeds)
    got = TD.merge_bottomk_multi(*(torch.from_numpy(a) for a in (ka, sa, kb, sb)),
                                 cap=cap)
    want = RD.merge_bottomk_multi(*(jnp.asarray(a) for a in (ka, sa, kb, sb)), cap=cap)
    for g, w, name in zip(got, want, ("keys", "seeds")):
        assert np.array_equal(to_np(g), np.asarray(w)), name
    folded = TD.merge_bottomk_multi_states(
        [(torch.from_numpy(ka), torch.from_numpy(sa)),
         (torch.from_numpy(kb), torch.from_numpy(sb)), got], cap=cap)
    assert all(torch.equal(f, g) for f, g in zip(folded, got)), "idempotent fold"


# ---------------------------------------------------------------------------
# fixed-k merges (in process), on states both packages built
# ---------------------------------------------------------------------------


def _host_samplers(n_hosts, weighted=True, trim=(0, 0, 0)):
    """Per host: the reference's MultiSampler over its shard (less
    ``trim[h % 3]`` trailing elements, left in the remainder buffer) and the
    port's loaded from the same state."""
    keys, weights = case.stream(n_hosts)
    refs, ports = [], []
    for h in range(n_hosts):
        n = case.SHARD - trim[h % 3]
        w = case.shard(weights, h)[:n] if weighted else None
        r = RI.MultiSampler(case.LS, k=case.K, chunk=case.CHUNK, salt=case.SALT,
                            host_id=h)
        r.observe(case.shard(keys, h)[:n], w)
        p = TI.MultiSampler(case.LS, k=case.K, chunk=case.CHUNK, salt=case.SALT,
                            host_id=h, device="cpu")
        p.load_state_dict(r.state_dict())
        refs.append(r)
        ports.append(p)
    return refs, ports, [(r.state.table.keys, r.state.table.counts) for r in refs]


def assert_tables_agree(t, r, host_tables, ls, label):
    assert np.array_equal(to_np(t.keys), np.asarray(r.keys)), f"{label}: keys"
    for name in ("step", "overflow"):
        assert np.array_equal(to_np(getattr(t, name)), np.asarray(getattr(r, name))), name
    atol = merged_count_atol(host_tables, ls, np.asarray(r.keys))
    for j, (a, b) in enumerate(zip(to_np(t.counts), np.asarray(r.counts))):
        assert_counts_close(a, b, atol[j], f"{label}: counts, lane {j}")
    for name in ("tau", "kb", "seed"):
        a, b = to_np(getattr(t, name)), np.asarray(getattr(r, name))
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), f"{label}: {name} finite"
        np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("fold", ["left", "tree"])
def test_merge_fixed_k_multi_matches_reference(fold):
    refs, ports, tables = _host_samplers(3)
    ls_r, ls_t = refs[0].state.l, ports[0].state.l
    got = TD.merge_fixed_k_multi_states([p.state.table for p in ports], ls_t,
                                        case.SALT, k=case.K, fold=fold)
    want = RD.merge_fixed_k_multi_states([r.state.table for r in refs], ls_r,
                                         case.SALT, k=case.K, fold=fold)
    assert_tables_agree(got, want, tables, case.LS, f"fold={fold}")
    pair = TD.merge_fixed_k_multi(ports[0].state.table, ports[1].state.table, ls_t,
                                  case.SALT, k=case.K)
    pair_r = RD.merge_fixed_k_multi(refs[0].state.table, refs[1].state.table, ls_r,
                                    case.SALT, k=case.K)
    assert_tables_agree(pair, pair_r, tables[:2], case.LS, "pair")


def test_merge_fixed_k_single_lane_matches_reference():
    refs, ports, tables = _host_samplers(3)
    j = 1  # lane l = 5
    lane = lambda table: type(table)(*(x[j] for x in table))  # noqa: E731
    got = TD.merge_fixed_k_states([lane(p.state.table) for p in ports], case.LS[j],
                                  case.SALT, k=case.K)
    want = RD.merge_fixed_k_states([lane(r.state.table) for r in refs],
                                   jnp.float32(case.LS[j]), case.SALT, k=case.K)
    assert_tables_agree(TV.TableState(*(x[None] for x in got)),
                        TV.TableState(*(np.asarray(x)[None] for x in want)),
                        [(k[j:j + 1], c[j:j + 1]) for k, c in tables], case.LS[j:j + 1],
                        "single lane")


def test_absorb_many_matches_reference():
    """Each host's remainder is flushed in its own id namespace, the tables
    fold left, the summaries min-merge."""
    refs, ports, _ = _host_samplers(3, trim=(0, 100, 333))
    tables = [(to_np(t.keys), to_np(t.counts))
              for t in (p.flushed_state().table for p in ports)]
    refs[0].absorb_many(refs[1:], k=case.K, merge_summaries=True)
    ports[0].absorb_many(ports[1:], k=case.K, merge_summaries=True)
    assert_tables_agree(ports[0].state.table, refs[0].state.table, tables, case.LS,
                        "absorb_many")
    rk, rs = refs[0].bottomk_summaries()
    pk, ps = ports[0].bottomk_summaries()
    assert np.array_equal(pk, rk)
    np.testing.assert_allclose(ps, rs, rtol=RTOL)
    assert ports[0].n_observed == refs[0].n_observed == 3 * case.SHARD - 433
    assert ports[0].state_dict()["n_seen"].item() == int(refs[0].state_dict()["n_seen"])


def test_absorb_many_equals_repeated_absorb():
    _, ports, _ = _host_samplers(3, weighted=False)
    _, twins, _ = _host_samplers(3, weighted=False)
    ports[0].absorb_many(ports[1:], k=case.K, merge_summaries=True)
    for t in twins[1:]:
        twins[0].absorb(t, k=case.K, merge_summaries=True)
    a, b = ports[0].state_dict(), twins[0].state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert ports[0].n_observed == 3 * case.SHARD


def test_pass2_accumulate_matches_reference():
    keys, weights = case.stream(2)
    lane_keys = [np.sort(np.unique(keys[j::5])[:40]) for j in range(3)]
    rk, racc = RI.init_pass2(lane_keys)
    tk, tacc = TI.init_pass2(lane_keys, device="cpu")
    assert np.array_equal(to_np(tk), np.asarray(rk))
    for lo in range(0, len(keys), 1500):  # ragged batches
        racc = RI.pass2_accumulate(rk, racc, keys[lo:lo + 1500], weights[lo:lo + 1500])
        tacc = TI.pass2_accumulate(tk, tacc, keys[lo:lo + 1500], weights[lo:lo + 1500])
    assert tacc.dtype == torch.float64
    assert np.array_equal(to_np(tacc), np.asarray(racc))


# ---------------------------------------------------------------------------
# the two-pass programs: P gloo ranks against P fake devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prog", ["multi", "single"])
@pytest.mark.parametrize("merge", case.MERGES)
@pytest.mark.parametrize("P", [4, 3])
def test_two_pass_program_matches_reference(P, merge, prog, tmp_path):
    ref = reference_run(P, tmp_path)
    port = port_run(P, tmp_path)[0]
    get = lambda d, name: np.atleast_2d(d[f"{prog}_{merge}_{name}"])  # noqa: E731
    tk, ts, tw = (get(port, n) for n in ("keys", "seeds", "weights"))
    rk, rs, rw = (get(ref, n) for n in ("keys", "seeds", "weights"))
    assert tk.shape == rk.shape == (len(case.LS) if prog == "multi" else 1, case.K + 1)
    for j in range(tk.shape[0]):
        assert_lane_agrees(tk[j], ts[j], tw[j], rk[j], rs[j], rw[j],
                           f"P={P} {prog} merge={merge} lane {j}")


@pytest.mark.parametrize("P", [4, 3])
def test_two_pass_program_is_replicated_and_merge_invariant(P, tmp_path):
    """Every rank holds the same result; the butterfly and the all-gather
    merges agree bit for bit (min-merge is associative); the single-l
    program equals the grid's lane at the same l."""
    ranks = port_run(P, tmp_path)
    for r in ranks[1:]:
        for name in ranks[0]:
            assert np.array_equal(ranks[0][name], r[name]), name
    out = ranks[0]
    for prog in ("multi", "single"):
        for name in ("keys", "seeds", "weights"):
            assert np.array_equal(out[f"{prog}_tree_{name}"],
                                  out[f"{prog}_allgather_{name}"]), (prog, name)
    j = case.LS.index(case.L_SINGLE)
    for name in ("keys", "seeds", "weights"):
        assert np.array_equal(out[f"single_tree_{name}"], out[f"multi_tree_{name}"][j])


def test_pass2_weights_are_the_exact_sums(tmp_path):
    keys, weights = case.stream(4)
    out = port_run(4, tmp_path)[0]
    for j in range(len(case.LS)):
        sk, sw = out["multi_tree_keys"][j], out["multi_tree_weights"][j]
        live = sk != EMPTY
        want = np.array([weights[keys == x].sum() for x in sk[live]], np.float32)
        assert np.array_equal(sw[live], want)
        assert np.all(sw[~live] == 0)


def test_program_rejects_bad_arguments():
    with pytest.raises(ValueError, match="unknown merge"):
        TD.make_distributed_two_pass_multi(ls=case.LS, salt=0, k=4, chunk=8,
                                           merge="ring", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.make_distributed_two_pass_multi(ls=case.LS, salt=0, k=4, chunk=8)


def test_pass1_loop_makes_no_tensor_from_host_values(monkeypatch, tmp_path):
    """On a card, a tensor made from host values inside the pass-I chunk
    loop is a host-to-device copy that waits for the stream; the loop makes
    none (a one-rank gloo group gives the rank)."""
    import torch.distributed as dist

    keys, weights = case.stream(1)
    kd, wd = torch.from_numpy(keys), torch.from_numpy(weights)
    ls = torch.tensor(case.LS, dtype=torch.float32)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        def refuse(*args, **kwargs):
            raise AssertionError("a tensor made from host values in the pass-I loop")

        with monkeypatch.context() as m:
            for name in ("tensor", "as_tensor", "from_numpy"):
                m.setattr(torch, name, refuse)
            skeys, _ = TD.pass1_local_multi(kd, wd, ls=ls, salt=case.SALT, k=case.K,
                                            chunk=case.CHUNK)
        assert skeys.shape == (len(case.LS), case.K + 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind,l", [("continuous", 5.0), ("discrete", 4.0), ("distinct", 1.0),
                                    ("sh", 1.0)])
def test_single_l_pass1_scores_in_batches(kind, l, monkeypatch, tmp_path):
    """The single-l pass I (``pass1_shard``) scores its shard in batches of
    whole chunks, ``SCORE_BATCH`` elements at most: ceil(n / SCORE_BATCH)
    calls of ``element_scores`` (the ``capscore`` kernel for continuous on
    a card).  ``SCORE_BATCH`` is cut here to 3 chunks, so a shard of 11
    chunks takes 4 calls, the last of 2 chunks.  Its summary equals, bit for
    bit, that of ``pass1_step`` chunk by chunk, and the reference's
    ``pass1_shard`` (on a one-device mesh): exactly for the hash-only kinds,
    and for continuous, whose ``log1p`` differs between the frameworks,
    under ``assert_lane_agrees``.  A one-rank gloo group gives the rank."""
    import jax
    import torch.distributed as dist

    n_chunks, chunk, cap = 11, 256, case.K + 1
    n = n_chunks * chunk
    rng = np.random.default_rng(11)
    keys = (rng.zipf(1.3, n) % 700).astype(np.int32)
    keys[::37] = EMPTY
    weights = rng.integers(1, 4, n).astype(np.float32)
    kd, wd = torch.from_numpy(keys), torch.from_numpy(weights)
    scorer, calls = TV.element_scores, []

    def spy(*args):
        calls.append(args[1].shape[0])
        return scorer(*args)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        with monkeypatch.context() as m:
            m.setattr(TD, "SCORE_BATCH", 3 * chunk)
            m.setattr(TV, "element_scores", spy)
            got = TD.pass1_shard(kd, wd, kind=kind, l=l, salt=case.SALT, k=case.K, chunk=chunk)
    finally:
        dist.destroy_process_group()
    assert calls == [3 * chunk] * 3 + [2 * chunk]

    eids = TV.shard_eids(0, torch.arange(n, dtype=torch.int64))
    carry = (torch.full((cap,), EMPTY, dtype=torch.int32), torch.full((cap,), np.inf))
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry = TV.pass1_step(carry, kd[sl], wd[sl], eids[sl], l, case.SALT, kind=kind, cap=cap)
    assert torch.equal(got[0], carry[0]), "summary keys"
    assert torch.equal(got[1], carry[1]), "summary seeds"

    program = RD.make_distributed_two_pass(jax.make_mesh((1,), ("data",)), kind=kind, l=l,
                                           salt=case.SALT, k=case.K, chunk=chunk)
    rk, rs, _ = (np.asarray(a)[0] for a in program(jnp.asarray(keys), jnp.asarray(weights)))
    tk, ts = (to_np(a) for a in got)
    o = np.argsort(tk, kind="stable")
    tk, ts = tk[o], ts[o]
    if kind != "continuous":
        assert np.array_equal(tk, rk) and np.array_equal(ts, rs)
    zeros = np.zeros(cap, np.float32)
    assert_lane_agrees(tk, ts, zeros, rk, rs, zeros, kind)
