"""Port parity: deterministic fault injection (``repro_torch.launch.faults``
against ``repro.launch.faults``), and the crash-mid-handoff case of the
reference's ``tests/test_fault_tolerance.py`` in the port.

A schedule is a pure function of its seed and the site registry, through
``hash_combine_np`` / ``uniform01_np``, which the port keeps bit for bit:
the same seed gives the same events in both packages, a schedule recorded
by one replays in the other, and both injectors fire the same events at
the same calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_ref  # noqa: E402,F401  (sets the reference's enable_x64 alias)
from _torch_ref import RTOL  # noqa: E402

from repro.checkpoint import manager as RM  # noqa: E402
from repro.core import hashing as RH  # noqa: E402
from repro.launch import faults as RFa  # noqa: E402
from repro.stats import service as RS  # noqa: E402
from repro_torch.checkpoint import manager as TM  # noqa: E402
from repro_torch.launch import faults as TFa  # noqa: E402
from repro_torch.stats import service as TS  # noqa: E402


def _events(schedule):
    return [(e.site, e.call_no, e.kind, e.param) for e in schedule.events]


def test_registries_match_reference():
    assert TFa.SITES == RFa.SITES
    assert TFa.KINDS == RFa.KINDS
    assert TFa.PROC_KINDS == RFa.PROC_KINDS


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 29, 12345])
@pytest.mark.parametrize("kinds", ["KINDS", "PROC_KINDS", "crash_stall_lost_reply"])
def test_same_seed_same_events_in_both_packages(seed, kinds):
    """``FaultSchedule.generate`` gives the same events in both packages,
    for the default kinds, the process kinds and a chosen subset (as the
    chip run's tier draws them)."""
    pick = {"KINDS": (TFa.KINDS, RFa.KINDS), "PROC_KINDS": (TFa.PROC_KINDS, RFa.PROC_KINDS),
            "crash_stall_lost_reply": (("crash", "stall", "lost_reply"),) * 2}[kinds]
    for n_shards, n_events in ((3, 12), (4, 8), (1, 40)):
        got = TFa.FaultSchedule.generate(seed, n_shards=n_shards, n_events=n_events,
                                         kinds=pick[0])
        want = RFa.FaultSchedule.generate(seed, n_shards=n_shards, n_events=n_events,
                                          kinds=pick[1])
        assert _events(got) == _events(want)
        assert got.seed == want.seed == seed
        assert got == TFa.FaultSchedule.generate(seed, n_shards=n_shards, n_events=n_events,
                                                 kinds=pick[0])
    assert got.events


def test_schedule_json_crosses_packages():
    """A schedule recorded by either package replays in the other."""
    for seed in (3, 11, 29):
        t = TFa.FaultSchedule.generate(seed, n_shards=3, n_events=12)
        r = RFa.FaultSchedule.generate(seed, n_shards=3, n_events=12)
        assert t.to_json() == r.to_json()
        assert _events(RFa.FaultSchedule.from_json(t.to_json())) == _events(t)
        assert TFa.FaultSchedule.from_json(r.to_json()) == t


def test_schedule_deterministic_and_replayable():
    a = TFa.FaultSchedule.generate(7, n_shards=3, n_events=10)
    assert a == TFa.FaultSchedule.generate(7, n_shards=3, n_events=10)
    assert TFa.FaultSchedule.from_json(a.to_json()).events == a.events
    assert a.events
    assert all(e.kind in TFa.KINDS for e in a.events)
    assert TFa.FaultSchedule.generate(8, n_shards=3, n_events=10) != a


def _drive(F, schedule, rounds):
    """Run every scheduled site ``rounds`` times through an injector on a
    virtual clock; returns what fired, the exception types and the clock."""
    inj = F.FaultInjector(schedule, F.VirtualClock())
    raised = []
    sites = sorted({e.site for e in schedule.events})
    for _ in range(rounds):
        for s in sites:
            try:
                with inj.site(s):
                    pass
                raised.append(None)
            except F.FaultError as e:
                raised.append((type(e).__name__, e.site))
    return [(e.site, e.call_no, e.kind) for e in inj.fired], raised, inj.clock.now(), inj.counts


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_injectors_fire_the_same_events(seed):
    """Both injectors fire the same events, raise the same fault types at
    the same calls, and advance their clocks alike."""
    t = TFa.FaultSchedule.generate(seed, n_shards=3, n_events=12, kinds=TFa.PROC_KINDS)
    r = RFa.FaultSchedule.generate(seed, n_shards=3, n_events=12, kinds=RFa.PROC_KINDS)
    got, want = _drive(TFa, t, 9), _drive(RFa, r, 9)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    assert got[2] == pytest.approx(want[2], rel=RTOL)
    assert len(got[0]) == len(t.events)


def test_injector_fires_on_nth_call_and_records():
    sched = TFa.FaultSchedule(events=(TFa.FaultEvent("s.op", 2, "lost_reply"),
                                      TFa.FaultEvent("s.op", 3, "slow", 1.5)))
    inj = TFa.FaultInjector(sched, TFa.VirtualClock())
    with inj.site("s.op"):
        pass
    with pytest.raises(TFa.InjectedLostReply):
        with inj.site("s.op"):
            pass
    t0 = inj.clock.now()
    with inj.site("s.op"):
        pass
    assert inj.clock.now() == t0 + 1.5
    assert [e.call_no for e in inj.fired] == [2, 3]
    assert inj.poll("other") is None and inj.counts["other"] == 1


def test_event_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        TFa.FaultEvent("s.op", 1, "meteor")
    with pytest.raises(ValueError, match="1-based"):
        TFa.FaultEvent("s.op", 0, "crash")
    TFa.FaultEvent("s.op", 1, "partition")  # process mode's kind is valid


def test_chaos_schedule_regression_roundtrip():
    """A failing seed commits as verbatim JSON; replaying the JSON drives
    the injector through the identical event sequence."""
    schedule = TFa.FaultSchedule.generate(3, n_shards=3, n_events=12)
    replayed = TFa.FaultSchedule.from_json(schedule.to_json())
    assert replayed.events == schedule.events
    a, b = TFa.FaultInjector(schedule), TFa.FaultInjector(replayed)
    sites = [e.site for e in schedule.events for _ in range(e.call_no)]
    for inj in (a, b):
        for s in sites:
            try:
                with inj.site(s):
                    pass
            except TFa.FaultError:
                pass
    assert a.fired == b.fired and len(a.fired) == len(schedule.events)


def test_wall_clock_sleeps():
    clock = TFa.WallClock()
    t0 = clock.now()
    clock.advance(0.01)
    assert clock.now() - t0 >= 0.01


@pytest.mark.parametrize("package", ["port", "reference"])
def test_crash_mid_handoff_recovers_from_committed_checkpoint(tmp_path, package):
    """The reference's crash-mid-handoff case, with the bank checkpoint of
    ``package`` and the handoff in the port: the mover dies between
    ``restore_slice`` and ``load_tenant_state_dict``; nothing is torn, the
    retried slice is identical, and the spliced tenant answers as the
    bank did (the reference's answer within rtol 1e-5)."""
    cfg = dict(k=64, ls=(1.0, 8.0), chunk=64)
    T = 3
    eids = np.arange(1200, dtype=np.int64)
    streams = [((RH.hash_combine_np(eids, np.int64(t)) % np.uint32(300)).astype(np.int64) + 1)
               for t in range(T)]
    if package == "port":
        bank = TS.MultiTenantStats(TS.StatsConfig(**cfg), n_tenants=T, device="cpu")
    else:
        bank = RS.MultiTenantStats(RS.StatsConfig(**cfg), n_tenants=T)
    for t in range(T):
        bank.observe(t, streams[t])
    bank.drain()
    want = bank.query_cap(1, 8.0)
    (RM if package == "reference" else TM).save(tmp_path, 1, bank.state_dict())

    example = TS.StreamStatsService(TS.StatsConfig(**cfg), device="cpu").state_dict()
    example.pop("exact_ok")
    blob = TM.restore_slice(tmp_path, 1, example, index=1)
    del blob  # the mover dies before the splice
    dest = TS.MultiTenantStats(TS.StatsConfig(**cfg), n_tenants=T, device="cpu")
    assert dest.n_observed(1) == 0
    blob_a = TM.restore_slice(tmp_path, 1, example, index=1)
    blob_b = TM.restore_slice(tmp_path, 1, example, index=1)
    assert set(blob_a) == set(blob_b)
    for key in blob_a:
        np.testing.assert_array_equal(np.asarray(blob_a[key]), np.asarray(blob_b[key]))
    dest.load_tenant_state_dict(1, blob_a)
    got = dest.query_cap(1, 8.0)
    if package == "port":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)
    again = TM.restore_slice(tmp_path, 1, example, index=1)
    for key in blob_a:
        np.testing.assert_array_equal(np.asarray(again[key]), np.asarray(blob_a[key]))
