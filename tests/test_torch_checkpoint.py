"""Port parity: checkpoints cross packages (``repro_torch.checkpoint.manager``
against ``repro.checkpoint.manager``).

A ``StreamStatsService`` cut mid-chunk is saved by one package and restored
by the other; both continue the same stream and agree under the rules of
``tests/_torch_ref.py`` (state-dict leaves and query answers, as
``test_torch_service.py`` holds the service).  The two packages write the
same manifest (leaf count, shapes, dtypes, treedef) for the same state.  A
bank checkpoint of either package restores one tenant into the other's
standalone service (``restore_slice``, the tenant handoff).  Port-only:
``latest_step`` skips a leftover ``.tmp``, ``keep_last`` retention,
``restore_extra``, and the durability order of ``save`` (file fsyncs, then
the directory's, the rename, the parent's).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL, assert_state_dicts_agree  # noqa: E402

from repro.checkpoint import manager as RM  # noqa: E402
from repro.core import freqfns as RF  # noqa: E402
from repro.core import segments as RG  # noqa: E402
from repro.stats import service as RS  # noqa: E402
from repro_torch.checkpoint import manager as TM  # noqa: E402
from repro_torch.core import freqfns as TF  # noqa: E402
from repro_torch.core import segments as TG  # noqa: E402
from repro_torch.stats import service as TS  # noqa: E402

CFG = dict(k=48, ls=(1.0, 8.0, 64.0), chunk=128, salt=0x5EED)


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % 700).astype(np.int64)
    weights = (rng.random(n) * 2 + 0.25).astype(np.float32)
    return keys, weights


def _queries(F, G):
    qs = []
    for seg in (None, G.HashBucket(4, 1, salt=3)):
        qs += [(F.cap(T), seg) for T in (1.0, 4.0, 8.0, 64.0)]
        qs += [(F.distinct(), seg), (F.total(), seg)]
    return qs


def _assert_answers_agree(port, ref):
    p = port.query_batch(_queries(TF, TG))
    r = ref.query_batch(_queries(RF, RG))
    assert np.array_equal(p.n_keys, r.n_keys)
    assert np.array_equal(p.lanes, r.lanes)
    np.testing.assert_allclose(p.estimates, r.estimates, rtol=RTOL)
    np.testing.assert_allclose(p.stderr, r.stderr, rtol=RTOL)


@pytest.mark.parametrize("evict_every", [1, 2])
@pytest.mark.parametrize("saver", ["port", "reference"])
def test_service_checkpoint_restores_in_the_other_package(tmp_path, saver, evict_every):
    """Cut mid-chunk, saved by one package, restored by the other's
    ``restore_checkpoint`` (the other's ``manager.restore`` underneath);
    saver and restorer continue the same stream and agree."""
    keys, w = _stream(9 * 128 + 71, seed=evict_every)
    cut = 4 * 128 + 37
    cfg = dict(CFG, evict_every=evict_every)
    ref = RS.StreamStatsService(RS.StatsConfig(**cfg))
    port = TS.StreamStatsService(TS.StatsConfig(**cfg), device="cpu")
    src, dst = ((port, RS.StreamStatsService(RS.StatsConfig(**cfg))) if saver == "port"
                else (ref, TS.StreamStatsService(TS.StatsConfig(**cfg), device="cpu")))
    src.observe(keys[:cut], w[:cut])
    src.save_checkpoint(tmp_path, 3)
    assert dst.restore_checkpoint(tmp_path) == 3
    assert dst.n_observed == cut
    # the restored state is the saved one, leaf for leaf
    assert_state_dicts_agree(*((dst.state_dict(), src.state_dict()) if saver == "reference"
                               else (src.state_dict(), dst.state_dict())),
                             what="restored")
    for svc in (src, dst):
        svc.observe(keys[cut:], w[cut:])
    p, r = (src, dst) if saver == "port" else (dst, src)
    assert_state_dicts_agree(p.state_dict(), r.state_dict(), max_weight=float(w.max()),
                             what="continued")
    _assert_answers_agree(p, r)


def test_both_packages_write_the_same_manifest(tmp_path):
    keys, w = _stream(3 * 128 + 5, seed=7)
    ref = RS.StreamStatsService(RS.StatsConfig(**CFG))
    port = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    for svc in (ref, port):
        svc.observe(keys, w)
    RM.save(tmp_path / "ref", 1, ref.state_dict())
    TM.save(tmp_path / "port", 1, port.state_dict())
    mr, mp = (json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())
              for d in ("ref", "port"))
    for field in ("step", "n_leaves", "shapes", "dtypes", "treedef"):
        assert mp[field] == mr[field], field
    # the salt leaf is uint32 on disk, the flag a bool, positions int32
    names = sorted(port.state_dict())
    with np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as data:
        got = {name: data[f"leaf_{i}"] for i, name in enumerate(names)}
    assert got["salt"].dtype == np.uint32 and int(got["salt"]) == CFG["salt"]
    assert got["exact_ok"].dtype == np.bool_
    assert got["n_seen"].dtype == np.int32 and got["n_real"].dtype == np.int64


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_bank_checkpoint_slices_into_the_other_package(tmp_path, saver):
    """A bank (``MultiTenantStats``) checkpoint of one package: each tenant
    restored by the other's ``restore_slice`` into a standalone service
    (the leave handoff), continued, agrees with the bank's tenant continued
    by the saver."""
    T = 3
    streams = [_stream(700 + 150 * t, seed=20 + t) for t in range(T)]
    RBank = RS.MultiTenantStats(RS.StatsConfig(**CFG), n_tenants=T)
    PBank = TS.MultiTenantStats(TS.StatsConfig(**CFG), n_tenants=T, device="cpu")
    bank = PBank if saver == "port" else RBank
    for t, (k, w) in enumerate(streams):
        bank.observe(t, k, w)
    bank.drain()
    bank.save_checkpoint(tmp_path, 2)
    more = _stream(333, seed=40)
    for t in range(T):
        if saver == "port":
            lone = RS.StreamStatsService(RS.StatsConfig(**CFG))
            example = lone._sampler.state_dict()
            blob = RM.restore_slice(tmp_path, 2, example, t)
        else:
            lone = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
            example = lone._sampler.state_dict()
            blob = TM.restore_slice(tmp_path, 2, example, t)
        lone.load_state_dict(blob)
        assert lone.n_observed == len(streams[t][0])
        # the twin: the saver's own standalone service of tenant t
        twin = (TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
                if saver == "port" else RS.StreamStatsService(RS.StatsConfig(**CFG)))
        twin.load_state_dict(bank.tenant_state_dict(t))
        for svc in (lone, twin):
            svc.observe(*more)
        p, r = (twin, lone) if saver == "port" else (lone, twin)
        max_w = max(float(streams[t][1].max()), float(more[1].max()))
        pd = dict(p.state_dict())
        rd = dict(r.state_dict())
        for d in (pd, rd):
            d.pop("exact_ok")  # bank rows carry 1-pass sketch state only
        assert_state_dicts_agree(pd, rd, max_weight=max_w, what=f"tenant {t}")
        _assert_answers_agree(p, r)


def test_restore_slice_rejects_a_mismatched_tree(tmp_path):
    bank = TS.MultiTenantStats(TS.StatsConfig(**CFG), n_tenants=2, device="cpu")
    bank.observe(0, *_stream(300, seed=1))
    bank.save_checkpoint(tmp_path, 1)
    svc = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="leaf count"):
        TM.restore_slice(tmp_path, 1, svc.state_dict(), 0)  # exact_ok is extra
    with pytest.raises(IndexError):
        TM.restore_slice(tmp_path, 1, svc._sampler.state_dict(), 2)


def test_latest_step_retention_and_extra(tmp_path):
    tree = {"b": np.arange(3, dtype=np.int32), "a": torch.ones(2), "c": [np.float32(2.5)]}
    assert TM.latest_step(tmp_path / "none") is None
    for step in (1, 2, 3, 4):
        TM.save(tmp_path, step, tree, extra={"cursor": step}, keep_last=2)
    (tmp_path / "step_00000009.tmp").mkdir()  # a save cut before its commit
    assert TM.latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.iterdir() if not p.name.endswith(".tmp"))
    assert kept == ["step_00000003", "step_00000004"]
    assert TM.restore_extra(tmp_path, 4) == {"cursor": 4}
    TM.save(tmp_path, 5, tree)
    assert TM.restore_extra(tmp_path, 5) == {}
    got = TM.restore(tmp_path, 4, tree)
    assert list(got) == ["b", "a", "c"]
    assert np.array_equal(got["b"], np.arange(3)) and np.array_equal(got["a"], np.ones(2))
    assert got["c"][0] == np.float32(2.5)
    # the reference reads the port's files into its own structure
    ref = RM.restore(tmp_path, 4, {"a": np.zeros(2, np.float32), "b": np.zeros(3, np.int32),
                                   "c": [np.float32(0)]})
    assert np.array_equal(ref["b"], np.arange(3))
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["treedef"] == "PyTreeDef({'a': *, 'b': *, 'c': [*]})"
    with pytest.raises(ValueError, match="shape mismatch"):
        TM.restore(tmp_path, 4, {"a": np.zeros(3), "b": np.zeros(3), "c": [0.0]})


def test_treedef_strings_match_jax():
    jax = pytest.importorskip("jax")
    trees = [{"b": 1, "a": None, "c": {"z": 1, "y": ()}}, [1, (2,), (3, 4)], {}, 5,
             {"x": [{"q": 1}, None]}]
    for tree in trees:
        flat, treedef = jax.tree.flatten(tree)
        assert f"PyTreeDef({TM._treedef(tree)})" == str(treedef)
        assert TM._flatten(tree) == flat


def test_save_fsyncs_files_then_dir_then_renames_then_parent(tmp_path, monkeypatch):
    events = []
    real_rename = type(tmp_path).rename
    monkeypatch.setattr(TM, "fsync_file", lambda p: events.append(("file", p.name)))
    monkeypatch.setattr(TM, "fsync_dir", lambda p: events.append(("dir", p.name)))

    def rename(self, target):
        events.append(("rename", self.name))
        return real_rename(self, target)

    monkeypatch.setattr(type(tmp_path), "rename", rename)
    TM.save(tmp_path / "ck", 7, {"a": np.zeros(2)}, extra={"x": 1})
    assert events == [("file", "arrays.npz"), ("file", "extra.json"),
                      ("file", "manifest.json"), ("dir", "step_00000007.tmp"),
                      ("rename", "step_00000007.tmp"), ("dir", "ck")]
    events.clear()
    TM.save(tmp_path / "ck", 8, {"a": np.zeros(2)}, fsync=False)
    assert events == [("rename", "step_00000008.tmp")]


def test_service_checkpoint_resumes_exactly_in_the_port(tmp_path):
    keys, w = _stream(6 * 128 + 40, seed=11)
    cut = 2 * 128 + 99
    a = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    a.observe(keys[:cut], w[:cut])
    a.save_checkpoint(tmp_path, 1)
    b = TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu")
    b.restore_checkpoint(tmp_path)
    for svc in (a, b):
        svc.observe(keys[cut:], w[cut:])
    for name, x in a.state_dict().items():
        assert torch.equal(x, b.state_dict()[name]), name
    assert np.array_equal(a.query_batch(_queries(TF, TG)).estimates,
                          b.query_batch(_queries(TF, TG)).estimates)
    with pytest.raises(FileNotFoundError):
        TS.StreamStatsService(TS.StatsConfig(**CFG), device="cpu").restore_checkpoint(
            tmp_path / "empty")
