"""Port parity, the fault layer: ``repro_torch.serve.faults`` and
``repro_torch.train.fault`` against ``repro``'s, and the single-device
scenarios of ``tests/test_chaos_serving.py`` on unsharded services of both
packages, each over a packed and an int32 plan.

The pure-Python pieces get the same calls on both sides and must give the
same answers: the injector's firing sequence and counters (scripted and
seeded random), backoff, breaker transitions, straggler flags and hedge
cutoffs over a seeded sequence of round-trip times, histogram merges. The
service scenarios run one fault script on both packages and require the
same outcome (which tickets fail, ``attempts``, ``retries``,
``failed_tickets``, ``pump_restarts``) and features equal to the
reference's bit for bit.

Kept steady: work is staged while the pump is paused where order
matters, every blocking call has a ``timeout=``, straggler strikes are
switched off (``straggler_min_s`` far above any round trip) where a test
does not count them, and breaker cooldowns are long enough that no
launch of the scenario can outlive one by host jitter.
"""
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serve as jserve
import repro.serve.faults as jfaults
import repro.train.fault as jtrain
import repro_torch.serve as tserve
import repro_torch.serve.faults as tfaults
import repro_torch.train.fault as ttrain
from repro.columnar import Table as JTable
from repro.core import (FeatureExecutor as JExecutor,
                        FeaturePlan as JPlan, FeatureSet as JFeatureSet)
from repro_torch.columnar import Table
from repro_torch.core import FeaturePlan, FeatureSet

PACKED = pytest.mark.parametrize("packed", [True, False],
                                 ids=["packed", "int32"])
# no straggler strikes: a round trip would have to take 100 s
CALM = {"straggler_min_s": 100.0}


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return {"age": rng.integers(18, 80, n),
            "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
            "income": rng.integers(20, 200, n) * 1000}


def _jplan(data, packed):
    fs = (JFeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return JPlan(JTable.from_data(data, imcu_rows=700), fs, packed=packed)


def _tplan(data, packed):
    fs = (FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return FeaturePlan(Table.from_data(data, imcu_rows=700), fs,
                       packed=packed, device="cpu")


def _jbreaker(svc):
    return svc._breakers[svc._executor.stream_token]


SIDES = (SimpleNamespace(name="repro", S=jserve, plan=_jplan,
                         breaker=_jbreaker),
         SimpleNamespace(name="repro_torch", S=tserve, plan=_tplan,
                         breaker=lambda svc: svc._breaker))


def _reference(requests, n=3000):
    """Fault-free ground truth: the reference's int32 executor."""
    ex = JExecutor(_jplan(_data(n), False))
    return [np.asarray(ex.batch(r)) for r in requests]


def _svc(side, packed, n=3000, policy=None, **kw):
    S = side.S
    pol = None if policy is None else S.FaultPolicy(**policy)
    return S.FeatureService(side.plan(_data(n), packed), buckets=(64,),
                            coalesce=1, fault_policy=pol, **kw)


def _both(run, *args):
    return [run(side, *args) for side in SIDES]


# -- faults.py and train/fault.py, call for call ------------------------------------
def _fire(inj, S, calls):
    """Replay (shard, stream, klass) launches; record what each did."""
    out = []
    for shard, stream, klass in calls:
        try:
            stall = inj.before_launch(shard, stream, klass=klass)
            out.append(("stall", stall) if stall else ("ok",))
        except S.InjectedFault as e:
            out.append(("fail", str(e)))
    return out, (inj.launches_seen, inj.faults_injected,
                 inj.delays_injected, inj.stalls_injected,
                 inj.device_faults)


def test_injector_scripts_fire_like_the_reference():
    rng = np.random.default_rng(3)
    calls = [(int(rng.integers(0, 3)), int(rng.integers(0, 3)),
              [None, "batch", "interactive"][int(rng.integers(0, 3))])
             for _ in range(120)]
    got = []
    for S in (jfaults, tfaults):
        inj = (S.FaultInjector()
               .fail_launches(2, shard=1)
               .delay_launches(0.0, 1, shard=0, after=1)
               .fail_launches(1, shard=0, stream=2, every=2)
               .stall_launches(0.25, 3, stream=1, every=3)
               .fail_launches(1 << 30, every=5, klass="batch")
               .stall_launches(0.5, 2, klass="interactive", after=4))
        got.append(_fire(inj, S, calls))
    assert got[0] == got[1]
    assert got[1][1][1] > 0 and got[1][1][3] > 0


@pytest.mark.parametrize("seed", [0, 7])
def test_injector_random_mode_seeded_like_the_reference(seed):
    calls = [(0, 0, None)] * 200
    got = []
    for S in (jfaults, tfaults):
        inj = S.FaultInjector(seed=seed).random_faults(
            p_fail=0.3, p_delay=0.2, delay_s=0.0, max_events=40)
        got.append(_fire(inj, S, calls))
    assert got[0] == got[1]
    assert got[1][1][1] + got[1][1][2] == 40        # capped by max_events


def test_injector_device_kill_like_the_reference():
    dev = object()
    got = []
    for S in (jfaults, tfaults):
        inj = S.FaultInjector().kill_device(dev)
        with pytest.raises(S.DeviceDown):
            inj.before_launch(0, 0, device=dev)
        inj.before_launch(0, 0, device=object())
        inj.revive_device(dev)
        inj.before_launch(0, 0, device=dev)
        got.append((inj.launches_seen, inj.device_faults))
    assert got[0] == got[1] == (3, 1)


def test_policy_backoff_and_validation_like_the_reference():
    for kw in ({"max_retries": -1}, {"backoff_s": -1.0},
               {"breaker_fails": 0}, {"breaker_cooldown_s": -1.0},
               {"device_fails": 0}, {"pump_restarts": -1},
               {"hedge_factor": 0.5}, {"hedge_min_s": -1.0}):
        for S in (jfaults, tfaults):
            with pytest.raises(ValueError):
                S.FaultPolicy(**kw)
    for kw in ({}, {"backoff_s": 0.01, "backoff_cap_s": 0.04},
               {"backoff_s": 0.003, "backoff_cap_s": 10.0}):
        j, t = jfaults.FaultPolicy(**kw), tfaults.FaultPolicy(**kw)
        assert vars(t) == vars(j)
        assert [t.backoff_for(a) for a in range(12)] == \
            [j.backoff_for(a) for a in range(12)]
    p = tfaults.FaultPolicy(backoff_s=0.01, backoff_cap_s=0.04)
    assert (p.backoff_for(1), p.backoff_for(2), p.backoff_for(5)) == \
        (0.01, 0.02, 0.04)


def test_breaker_transitions_like_the_reference():
    """The reference's breaker walk (trip on the 3rd, half-open after the
    cooldown, a failed probe re-opens without re-counting), then a seeded
    sequence of strikes, resets and checks on both."""
    b = tfaults.StreamBreaker()
    assert not b.strike(3, 1.0, now=0.0)
    assert not b.strike(3, 1.0, now=0.0)
    assert b.strike(3, 1.0, now=0.0)
    assert b.opened == 1
    assert b.is_open(3, now=0.5)
    assert not b.is_open(3, now=1.5)
    assert not b.strike(3, 1.0, now=2.0)
    assert b.is_open(3, now=2.5)
    b.reset()
    assert not b.is_open(3, now=2.5) and b.fails == 0
    rng = np.random.default_rng(11)
    ops = [(int(rng.integers(0, 5)), float(t))
           for t in np.cumsum(rng.uniform(0, 0.3, 300))]
    trace = []
    for S in (jfaults, tfaults):
        br, out = S.StreamBreaker(), []
        for op, now in ops:
            if op == 4:
                br.reset()
                out.append(None)
            elif op == 3:
                out.append(br.is_open(2, now))
            else:
                out.append(br.strike(2, 0.5, now))
        trace.append((out, br.fails, br.opened, br.open_until))
    assert trace[0] == trace[1]


def test_device_health_like_the_reference():
    got = []
    for S in (jfaults, tfaults):
        h = S.DeviceHealth()
        out = [h.strike(1, 2), h.strike(1, 2), h.strike(1, 2),
               h.is_down(1), h.mark_down(2), h.mark_down(2)]
        h.ok(3)
        h.strike(3, 2)
        h.ok(3)
        out += [h.strike(3, 2), h.lost, h.survivors([1, 2, 3, 4])]
        h.revive(1)
        out += [h.is_down(1), sorted(h.down), dict(h.trips)]
        got.append(out)
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_detector_like_the_reference(seed):
    """Flags, EWMA state and hedge cutoffs over a seeded round-trip
    sequence with outliers."""
    rng = np.random.default_rng(seed)
    dts = rng.lognormal(-6.0, 0.3, 400)
    spikes = rng.random(400) < 0.05
    dts[spikes] *= rng.uniform(3.0, 30.0, int(spikes.sum()))
    got = []
    for M in (jtrain, ttrain):
        det = M.StragglerDetector(alpha=0.1, threshold=3.0, warmup=5)
        cut0 = det.hedge_cutoff(4.0, 0.05)
        flags, cuts = [], []
        for i, dt in enumerate(dts.tolist()):
            flags.append(det.observe(i, dt))
            cuts.append(det.hedge_cutoff(4.0, 0.001))
        got.append((cut0, flags, cuts, det.mean, det.var, det.n,
                    det.flagged, det.straggler_fraction))
    assert got[0] == got[1]
    assert got[1][0] == 0.05 and any(got[1][1])


def test_histogram_merge_like_the_reference():
    rng = np.random.default_rng(4)
    a_s, b_s = rng.lognormal(-5, 1.5, 500), rng.lognormal(-3, 1.0, 300)
    got = []
    for S in (jserve, tserve):
        a, b = S.LatencyHistogram(), S.LatencyHistogram()
        for s in a_s.tolist():
            a.record(s)
        for s in b_s.tolist():
            b.record(s)
        a.merge(b)
        a.merge(S.LatencyHistogram())           # an empty one changes nothing
        with pytest.raises(ValueError):
            a.merge(S.LatencyHistogram(lo_s=1e-5))
        got.append((a.counts.copy(), a.count, a.total_s, a.min_s, a.max_s,
                    [a.percentile(q) for q in (0, 1, 50, 90, 99, 100)]))
    assert np.array_equal(got[0][0], got[1][0])
    assert got[0][1:] == got[1][1:]
    assert got[1][1] == 800


# -- retries against the reference ---------------------------------------------------
@PACKED
@pytest.mark.parametrize("n_faults,max_retries", [(2, 3), (4, 3), (1, 0)],
                         ids=["retried", "exhausted", "no-retries"])
def test_retries_with_backoff_like_the_reference(packed, n_faults,
                                                 max_retries):
    """A group failed by injected faults is re-launched after backoff and
    serves bit-exact while retries last; past ``max_retries`` its ticket
    resolves to a ServeError with ``attempts == max_retries + 1`` and the
    injected cause. Two tickets staged while paused: the first takes
    every fault, the second serves behind it."""
    reqs = [np.arange(0, 40), np.arange(700, 760)]
    want = _reference(reqs)

    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().fail_launches(n_faults)
        with _svc(side, packed, faults=inj,
                  policy=dict(max_retries=max_retries, backoff_s=0.002,
                              breaker_fails=100, **CALM)) as svc:
            svc.pause()
            tks = [svc.submit(r) for r in reqs]
            svc.resume()
            out = svc.collect(timeout=60)
        first = out[tks[0]]
        if isinstance(first, Exception):
            assert isinstance(first, S.ServeError)
            assert isinstance(first.__cause__, S.InjectedFault)
            first = ("error", first.attempts, first.ticket, first.shard)
        else:
            assert np.array_equal(first, want[0])
            first = "served"
        assert np.array_equal(out[tks[1]], want[1])
        st = svc.stats
        return (first, inj.faults_injected, st["retries"],
                st["failed_tickets"], st["launches"], st["completed"])
    ref, port = _both(run, packed)
    assert port == ref
    if n_faults <= max_retries:
        assert port[0] == "served" and port[2] == n_faults
    else:
        assert port[0] == ("error", max_retries + 1, 0, 0)


# -- the single-device scenarios of test_chaos_serving.py ----------------------------
@PACKED
def test_chaos_collect_mixes_results_and_errors(packed):
    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().fail_launches(3)
        with _svc(side, packed, faults=inj,
                  policy=dict(max_retries=2, backoff_s=0.001,
                              breaker_fails=100, **CALM)) as svc:
            svc.pause()
            t_bad = svc.submit(np.arange(700, 732))
            t_ok = svc.submit(np.arange(0, 32))
            svc.resume()
            out = svc.collect(timeout=60)
        assert isinstance(out[t_ok], np.ndarray)
        assert isinstance(out[t_bad], S.ServeError)
        np.testing.assert_array_equal(
            out[t_ok], _reference([np.arange(0, 32)])[0])
        return (out[t_bad].attempts, svc.stats["retries"],
                svc.stats["failed_tickets"], inj.faults_injected)
    ref, port = _both(run, packed)
    assert port == ref == (3, 2, 1, 3)


def _breaker_scenario(side, packed):
    """Two faults trip a 2-strike breaker; the retry serves through the
    open breaker (the one stream is forced) without closing it; after the
    cooldown the next launch is the probe and closes it."""
    S = side.S
    inj = S.FaultInjector().fail_launches(2)
    # a 1 s cooldown: the retry that serves right after the trip retires
    # far inside it, the probe after the sleep far outside it
    svc = _svc(side, packed, faults=inj,
               policy=dict(max_retries=5, backoff_s=0.001, breaker_fails=2,
                           breaker_cooldown_s=1.0, **CALM))
    with svc:
        svc.result(svc.submit(np.arange(0, 32)), timeout=60)
        trip = (svc.stats["unhealthy_shards"], svc.unhealthy)
        time.sleep(1.1)
        svc.result(svc.submit(np.arange(0, 32)), timeout=60)
        b = side.breaker(svc)
        return (trip, svc.stats["unhealthy_shards"], svc.unhealthy,
                b.opened, b.fails, svc.stats["retries"])


@PACKED
def test_breaker_probe_recovers_stream(packed):
    ref, port = _both(_breaker_scenario, packed)
    assert port == ref
    assert port[0] == (1, [0])
    assert port[2] == []


@PACKED
def test_unhealthy_shards_is_a_gauge(packed):
    ref, port = _both(_breaker_scenario, packed)
    assert port == ref
    assert port[0][0] == 1                 # open: the gauge holds
    assert port[1] == 0                    # closed by the probe
    assert port[3:5] == (1, 0)             # tripped once, fails reset


@PACKED
def test_deadline_expires_queued_ticket(packed):
    def run(side, packed):
        S = side.S
        with _svc(side, packed) as svc:
            with pytest.raises(ValueError):
                svc.submit(np.arange(8), deadline_ms=0)
            svc.pause()
            tk = svc.submit(np.arange(0, 32), deadline_ms=20)
            time.sleep(0.05)
            svc.resume()
            with pytest.raises(S.DeadlineExceeded) as ei:
                svc.result(tk, timeout=60)
            assert isinstance(ei.value, TimeoutError)
            assert ei.value.ticket == tk
            got = svc.result(svc.submit(np.arange(0, 32), deadline_ms=60_000),
                             timeout=60)
            np.testing.assert_array_equal(
                got, _reference([np.arange(0, 32)])[0])
            return (svc.stats["timeouts"], svc.stats["failed_tickets"],
                    svc.stats["completed"], svc.stats["launches"])
    ref, port = _both(run, packed)
    assert port == ref == (1, 1, 1, 1)


@PACKED
def test_result_and_drain_timeout_on_stuck_ticket(packed):
    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().delay_launches(0.6, 1, shard=0)
        with _svc(side, packed, faults=inj) as svc:
            tk = svc.submit(np.arange(0, 32))
            t0 = time.perf_counter()
            with pytest.raises(TimeoutError):
                svc.result(tk, timeout=0.05)
            with pytest.raises(TimeoutError):
                svc.drain(timeout=0.05)
            assert time.perf_counter() - t0 < 0.5
            np.testing.assert_array_equal(
                svc.result(tk, timeout=60),
                _reference([np.arange(0, 32)])[0])
            return svc.stats["completed"], inj.delays_injected
    ref, port = _both(run, packed)
    assert port == ref == (1, 1)


def _dying(side, packed, **kw):
    """A service with no restart budget whose pump control logic raises."""
    svc = _svc(side, packed, n=1400, policy=dict(pump_restarts=0), **kw)
    boom = RuntimeError("pump infrastructure fault")

    def die():
        raise boom
    return svc, boom, die


@PACKED
def test_pump_death_surfaces_from_every_entry_point(packed, monkeypatch):
    """With ``pump_restarts=0`` a pump-infrastructure error is terminal:
    every entry point reports it with the original error chained."""
    def run(side, packed):
        svc, boom, die = _dying(side, packed)
        monkeypatch.setattr(svc, "_pick_action", die)
        with svc._lock:
            svc._work.notify_all()
        svc._pump.join(timeout=10)
        assert not svc._pump.is_alive()
        for call in (lambda: svc.poll(0),
                     lambda: svc.submit(np.arange(8)),
                     lambda: svc.result(0, timeout=10),
                     lambda: svc.drain(timeout=10),
                     lambda: svc.collect(timeout=10),
                     svc.pause, svc.resume):
            with pytest.raises(RuntimeError) as ei:
                call()
            assert ei.value.__cause__ is boom
        return svc.stats["pump_restarts"]
    ref, port = _both(run, packed)
    assert port == ref == 0


@PACKED
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_pump_death_unblocks_concurrent_waiters(packed, monkeypatch):
    """Threads parked in result() and drain() wake with the chained error
    when the pump dies mid-wait (the injected delay holds the pump inside
    its first launch while they park)."""
    def run(side, packed):
        inj = side.S.FaultInjector().delay_launches(0.5, 1)
        svc, boom, die = _dying(side, packed, faults=inj)
        errs: dict[str, BaseException] = {}

        def waiter(name, fn):
            try:
                fn()
            except BaseException as e:
                errs[name] = e
        tk = svc.submit(np.arange(8, 16))
        threads = [threading.Thread(target=waiter, args=(
                       "result", lambda: svc.result(tk, timeout=30))),
                   threading.Thread(target=waiter, args=(
                       "drain", lambda: svc.drain(timeout=30)))]
        for th in threads:
            th.start()
        time.sleep(0.1)
        monkeypatch.setattr(svc, "_pick_action", die)
        for th in threads:
            th.join(timeout=20)
        assert not any(th.is_alive() for th in threads)
        assert set(errs) == {"result", "drain"}
        for e in errs.values():
            assert isinstance(e, RuntimeError) and e.__cause__ is boom
        svc.shutdown()
        return sorted(errs)
    ref, port = _both(run, packed)
    assert port == ref


@PACKED
def test_pump_restart_survives_infrastructure_crash(packed, monkeypatch):
    """ONE crash of the pump's control logic: the supervisor restarts the
    pump with the ledger intact and every ticket completes bit-exact."""
    rng = np.random.default_rng(23)
    requests = [rng.integers(0, 3000, rng.integers(8, 64))
                for _ in range(10)]
    want = _reference(requests)

    def run(side, packed):
        with _svc(side, packed) as svc:
            svc.result(svc.submit(np.arange(0, 32)), timeout=60)
            orig = svc._pick_action
            state = {"fired": False}

            def crash_once():
                if not state["fired"]:
                    state["fired"] = True
                    raise RuntimeError("injected pump-infrastructure crash")
                return orig()
            monkeypatch.setattr(svc, "_pick_action", crash_once)
            tickets = [svc.submit(r) for r in requests]
            got = [svc.result(tk, timeout=60) for tk in tickets]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            svc.drain(timeout=60)
            return (svc.stats["pump_restarts"], svc.stats["failed_tickets"],
                    svc.stats["completed"])
    ref, port = _both(run, packed)
    assert port == ref == (1, 0, 11)


@PACKED
def test_pump_restart_reenqueues_partially_retired_flight(packed,
                                                          monkeypatch):
    """A crash INSIDE _retire: the retire journal re-enqueues the
    unretired rest of the flight, the relaunch retires it, and every
    ticket resolves bit-exact."""
    rng = np.random.default_rng(29)
    requests = [rng.integers(0, 3000, rng.integers(8, 64))
                for _ in range(8)]
    want = _reference(requests)

    def run(side, packed):
        with _svc(side, packed) as svc:
            svc.result(svc.submit(np.arange(0, 32)), timeout=60)
            orig = svc._retire
            state = {"fired": False}

            def crash_once(arr, parts):
                if not state["fired"]:
                    state["fired"] = True
                    raise RuntimeError("injected crash mid-retire")
                return orig(arr, parts)
            monkeypatch.setattr(svc, "_retire", crash_once)
            tickets = [svc.submit(r) for r in requests]
            got = [svc.result(tk, timeout=60) for tk in tickets]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            return (svc.stats["pump_restarts"], svc.stats["failed_tickets"],
                    svc.stats["completed"])
    ref, port = _both(run, packed)
    assert port == ref == (1, 0, 9)


class _CrashOnAppend(deque):
    """An in-flight window whose first append raises: a pump crash after
    a launch was dispatched and before it was recorded in flight."""
    fired = False

    def append(self, x):
        if not self.fired:
            self.fired = True
            raise RuntimeError("injected crash mid-launch")
        super().append(x)


@PACKED
def test_pump_restart_relaunches_group_taken_mid_launch(packed):
    """The crash lands between the launch and its bookkeeping: the
    ``_pump_taken`` journal puts the group back at the head of the queue,
    the restarted pump launches it again, and staged tickets resolve
    bit-exact in order."""
    reqs = [np.arange(64 * i, 64 * i + 50) for i in range(5)]
    want = _reference(reqs)

    def run(side, packed):
        svc = _svc(side, packed)
        with svc:
            svc.pause()
            with svc._lock:
                if hasattr(svc, "_inflights"):
                    svc._inflights[0] = _CrashOnAppend(svc._inflights[0])
                else:
                    svc._inflight = _CrashOnAppend(svc._inflight)
            tks = [svc.submit(r) for r in reqs]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tks]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return (svc.stats["pump_restarts"], svc.stats["failed_tickets"],
                svc.stats["launches"], svc.stats["completed"])
    ref, port = _both(run, packed)
    assert port == ref == (1, 0, 5, 5)
