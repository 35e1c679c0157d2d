"""Port parity, chaos on sharded services: the sharded tests of
``tests/test_chaos_serving.py`` run on both packages, and the repair that
keys device loss by the device itself.

Each scenario runs once on ``repro`` (over its first CPU device: another
test of the process may have forced JAX to several host devices) and
once on ``repro_torch`` with ``devices=[torch.device("cpu")]``, from the
same seeds
and fault scripts. Every answer must equal the fault-free reference (the
reference's int32 executor) bit for bit, and the outcomes the reference's
test asserts — availability, which tickets fail and how, breaker and
replica state, ``devices_lost``, ``recoveries``, ``hedges``,
``hedge_wins``, tiers — must be equal between the packages.

Kept steady: no outcome rests on host speed. Breaker cooldowns are 1 s
where a scenario must see a breaker still open (the reference's 50 ms);
the breaker-and-monitor scenario, whose reference waits on a race against
its retry backoff, fails the primary stream for good so only the failover
replica can serve; the sweeps keep the reference's seeds and compare
answers and availability.
"""
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro_torch.columnar import Table

CPU = torch.device("cpu")
N_SEEDS = int(os.environ.get("CHAOS_SWEEP_SEEDS", 2))

SIDES = (SimpleNamespace(name="repro", C=jcore, S=jserve, Table=JTable,
                         plan=lambda t, fs, packed=True: jcore.FeaturePlan(
                             t, fs, packed=packed),
                         devices=lambda: jax.devices()[:1], key=id),
         SimpleNamespace(name="repro_torch", C=tcore, S=tserve, Table=Table,
                         plan=lambda t, fs, packed=True: tcore.FeaturePlan(
                             t, fs, packed=packed, device="cpu"),
                         devices=lambda: [CPU], key=lambda d: d))


def _both(run, *args):
    return [run(side, *args) for side in SIDES]


def _table(side, n=3000, imcu_rows=700, seed=0):
    rng = np.random.default_rng(seed)
    t = side.Table.from_data({
        "age": rng.integers(18, 80, n),
        "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
        "income": rng.integers(20, 200, n) * 1000,
    }, imcu_rows=imcu_rows)
    fs = (side.C.FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return t, fs


def _reference(requests, n=3000, imcu_rows=700, seed=0):
    """Fault-free ground truth: the reference's unsharded int32 executor."""
    t, fs = _table(SIDES[0], n, imcu_rows, seed)
    ex = jcore.FeatureExecutor(jcore.FeaturePlan(t, fs))
    return [np.asarray(ex.batch(r)) for r in requests]


def _service(side, plan, **kw):
    return side.S.FeatureService(plan, sharded=True,
                                 devices=side.devices(), **kw)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# -- the repair: device loss keyed by the device itself -------------------------------
def test_device_loss_keys_by_the_device_itself():
    """``kill_device`` of a fresh ``torch.device("cpu")`` object hits the
    streams of a service whose pool is ``[torch.device("cpu")]``: the next
    launch raises :class:`DeviceDown`, the device is lost, and the ticket
    is served from the host bit-exact."""
    side = SIDES[1]
    t, fs = _table(side)
    rows = np.arange(8, 56)
    inj = tserve.FaultInjector()
    pol = tserve.FaultPolicy(max_retries=8, backoff_s=0.001,
                             breaker_fails=100)
    with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                  faults=inj, fault_policy=pol) as svc:
        svc.result(svc.submit(np.arange(0, 32)), timeout=60)
        inj.kill_device(torch.device("cpu"))
        got = svc.result(svc.submit(rows), timeout=60)
        st = dict(svc.stats)
        assert svc._device_health.is_down(torch.device("cpu"))
    assert np.array_equal(got, _reference([rows])[0])
    assert inj.device_faults == 1
    assert st["devices_lost"] == 1 and st["host_gathers"] >= 1
    assert st["failed_tickets"] == 0


def test_kill_cuda_matches_cuda_0():
    """``cuda`` and ``cuda:0`` are one device to the injector and to
    :class:`DeviceHealth`, and a device string is the same key."""
    inj = tserve.FaultInjector().kill_device(torch.device("cuda"))
    with pytest.raises(tserve.DeviceDown):
        inj.before_launch(0, 0, device=torch.device("cuda", 0))
    inj.before_launch(0, 0, device=torch.device("cpu"))
    inj.revive_device("cuda:0")
    inj.before_launch(0, 0, device=torch.device("cuda"))
    assert (inj.launches_seen, inj.device_faults) == (3, 1)
    h = tserve.DeviceHealth()
    assert h.mark_down(torch.device("cuda"))
    assert h.is_down(torch.device("cuda", 0)) and h.is_down("cuda:0")
    assert not h.mark_down("cuda")
    assert h.survivors([torch.device("cuda", 0), CPU, "cpu"]) == [CPU,
                                                                 "cpu"]
    h.revive(torch.device("cuda:0"))
    assert not h.is_down("cuda") and h.lost == 1


def test_repeated_launch_errors_never_lose_the_device():
    """A deliberate difference from the reference: only :class:`DeviceDown`
    declares a device lost. Under the default policy, a launch that keeps
    raising any other error trips all three streams' breakers of one
    device (nine failures and more, past ``device_fails``) and ends in
    ServeErrors; nothing is served from the host and the device stays."""
    side = SIDES[1]
    t, fs = _table(side)
    requests = [np.arange(32 * i, 32 * i + 32) for i in range(6)]
    inj = tserve.FaultInjector().fail_launches(1000, shard=0)
    with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                  faults=inj) as svc:
        svc.add_replica(0)
        svc.add_replica(0)
        assert svc._sharded_ex.n_streams(0) == 3
        tickets = [svc.submit(r) for r in requests]
        out = svc.collect(timeout=60)
        st = dict(svc.stats)
        opened = sum(svc._breaker(ex).opened
                     for ex in svc._sharded_ex.stream_executors(0))
        down = set(svc._device_health.down)
    assert all(isinstance(out[tk], tserve.ServeError) for tk in tickets)
    cause = out[tickets[0]].__cause__
    assert isinstance(cause, RuntimeError)
    assert not isinstance(cause, tserve.DeviceDown)
    assert inj.faults_injected >= 9 and opened == 3
    assert st["failed_tickets"] == len(tickets)
    assert (st["devices_lost"], st["host_gathers"], down) == (0, 0, set())
    assert svc.replicas[0] == 2


# -- failover keeps availability at 1.0 (test_chaos_serving.py:114-204) -------------
def test_chaos_failover_bit_exact_availability_one():
    """>= 20 injected launch faults and 2 straggler episodes on a shard
    with 2 replicas: every ticket bit-exact, availability 1.0, failovers
    seen."""
    rng = np.random.default_rng(41)
    requests = [rng.integers(0, 700, rng.integers(8, 64))
                for _ in range(40)]
    requests += [np.arange(700 * s, 700 * s + 48) for s in (1, 2, 3)]
    want = _reference(requests)

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = (S.FaultInjector()
               .fail_launches(12, shard=0, stream=0)
               .fail_launches(8, shard=0, stream=1)
               .delay_launches(0.12, 1, shard=0, stream=2, after=6)
               .delay_launches(0.12, 1, shard=1))
        pol = S.FaultPolicy(max_retries=3, backoff_s=0.001,
                            breaker_fails=100, straggler_min_s=0.05,
                            straggler_warmup=3)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol) as svc:
            svc.add_replica(0)
            svc.add_replica(0)
            tickets = [svc.submit(r) for r in requests]
            got = [svc.result(tk, timeout=60) for tk in tickets]
        _equal(got, want)
        st = svc.throughput_stats(1.0)
        assert st["failovers"] > 0 and st["retries"] >= 20
        return (inj.faults_injected, inj.delays_injected, st["completed"],
                st["requests"], st["availability"], st["failed_tickets"])
    ref, port = _both(run)
    assert port == ref == (20, 2, 43, 43, 1.0, 0)


def test_chaos_no_replicas_isolates_faulted_shard():
    """Without replicas a failing shard resolves only its own tickets to
    ServeErrors (3 attempts, the injected cause); the other shards serve
    bit-exact, and the healed shard serves again."""
    reqs_ok = [np.arange(700 * s + 8, 700 * s + 40) for s in (0, 1, 3)]
    reqs_bad = [np.arange(1400 + 16 * i, 1400 + 16 * i + 16)
                for i in range(5)]
    again = np.arange(1400, 1464)
    want_ok, want_again = _reference(reqs_ok), _reference([again])[0]

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = S.FaultInjector().fail_launches(15, shard=2)
        pol = S.FaultPolicy(max_retries=2, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol) as svc:
            tickets_ok = [svc.submit(r) for r in reqs_ok]
            tickets_bad = [svc.submit(r) for r in reqs_bad]
            _equal([svc.result(tk, timeout=60) for tk in tickets_ok],
                   want_ok)
            errs = []
            for tk in tickets_bad:
                assert svc.poll(tk)
                with pytest.raises(S.ServeError) as ei:
                    svc.result(tk, timeout=60)
                assert isinstance(ei.value.__cause__, S.InjectedFault)
                errs.append((ei.value.shard, ei.value.attempts))
            failed = svc.stats["failed_tickets"]
            assert np.array_equal(svc.result(svc.submit(again), timeout=60),
                                  want_again)
        return errs, failed, inj.faults_injected
    ref, port = _both(run)
    assert port == ref == ([(2, 3)] * 5, 5, 15)


def test_chaos_collect_mixes_results_and_errors():
    want = _reference([np.arange(0, 32)])[0]

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = S.FaultInjector().fail_launches(3, shard=1)
        pol = S.FaultPolicy(max_retries=2, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol) as svc:
            t_ok = svc.submit(np.arange(0, 32))
            t_bad = svc.submit(np.arange(700, 732))
            out = svc.collect(timeout=60)
        assert np.array_equal(out[t_ok], want)
        assert isinstance(out[t_bad], S.ServeError)
        return out[t_bad].attempts, out[t_bad].shard, len(out)
    ref, port = _both(run)
    assert port == ref == (3, 1, 2)


# -- breaker / monitor integration (test_chaos_serving.py:207-256) -------------------
def test_breaker_opens_and_monitor_rereplicates():
    """Failures open the primary's breaker (the shard turns unhealthy);
    ``rebalance()`` grows a failover replica, the stuck ticket is served
    through it bit-exact, and a second rebalance stacks no failover
    replica and sheds none. The primary stream fails for good here, so
    only the replica can serve the ticket, whatever the host's speed."""
    rows = np.arange(0, 32)
    want = _reference([rows])[0]

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = S.FaultInjector().fail_launches(1 << 30, shard=0, stream=0)
        pol = S.FaultPolicy(max_retries=1 << 30, backoff_s=0.001,
                            backoff_cap_s=0.01, breaker_fails=3,
                            breaker_cooldown_s=30.0)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol, max_replicas=2) as svc:
            tk = svc.submit(rows)
            deadline = time.perf_counter() + 30
            while not svc.unhealthy and time.perf_counter() < deadline:
                time.sleep(0.005)
            seen = (svc.unhealthy, svc.stats["unhealthy_shards"])
            acts = svc.rebalance()
            replicas = svc.replicas[0]
            assert np.array_equal(svc.result(tk, timeout=60), want)
            assert svc.stats["failovers"] > 0
            acts2 = svc.rebalance()
            out = (seen, [s for s, _ in acts["failover_replicated"]],
                   replicas, acts2["failover_replicated"], acts2["dropped"],
                   svc.replicas[0] >= 1, svc.stats["failed_tickets"])
        return out
    ref, port = _both(run)
    assert port == ref == (([0], 1), [0], 1, [], [], True, 0)


def _probe_scenario(side):
    """Two faults trip a 2-strike breaker; the retry is served through the
    open breaker without closing it; after the cooldown the next launch
    is the probe and closes it. A 1 s cooldown: the retry retires far
    inside it, the probe after the sleep far outside."""
    S = side.S
    t, fs = _table(side)
    inj = S.FaultInjector().fail_launches(2, shard=0, stream=0)
    pol = S.FaultPolicy(max_retries=5, backoff_s=0.001, breaker_fails=2,
                        breaker_cooldown_s=1.0, straggler_min_s=100.0)
    with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                  faults=inj, fault_policy=pol) as svc:
        first = svc.result(svc.submit(np.arange(0, 32)), timeout=60)
        tripped = svc.stats["unhealthy_shards"]
        time.sleep(1.1)
        second = svc.result(svc.submit(np.arange(0, 32)), timeout=60)
        b = svc._breakers[svc._sharded_ex.executors[0].stream_token]
        return (first, second), (tripped, svc.unhealthy,
                                 svc.stats["unhealthy_shards"], b.opened,
                                 b.fails)


def test_breaker_probe_recovers_stream():
    want = _reference([np.arange(0, 32)])[0]
    (ref_out, ref), (port_out, port) = _both(_probe_scenario)
    _equal(port_out, [want, want])
    assert port == ref
    assert port[0] == 1 and port[1] == []


def test_unhealthy_shards_is_a_gauge():
    (_, ref), (_, port) = _both(_probe_scenario)
    assert port == ref
    assert port[0] == 1 and port[2] == 0 and port[3:] == (1, 0)


# -- device-loss recovery (test_chaos_serving.py:380-458) ----------------------------
def test_device_loss_serves_via_host_gather():
    """Every serving device killed: each shard's streams are evicted when
    the device's DeviceDown arrives, and with no survivor the pump serves
    the orphaned shards from the host words, bit-exact, availability 1.0;
    the breaker table keeps only live streams."""
    rng = np.random.default_rng(17)
    requests = [rng.integers(0, 3000, rng.integers(8, 64))
                for _ in range(12)]
    requests += [np.arange(700 * s, 700 * s + 48) for s in range(4)]
    want = _reference(requests)

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = S.FaultInjector()
        pol = S.FaultPolicy(max_retries=8, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol) as svc:
            svc.result(svc.submit(np.arange(0, 32)), timeout=60)
            for d in side.devices():
                inj.kill_device(d)
            tickets = [svc.submit(r) for r in requests]
            _equal([svc.result(tk, timeout=120) for tk in tickets], want)
            st = svc.throughput_stats(1.0)
            live = {ex.stream_token for s in range(svc.n_shards)
                    for ex in svc._sharded_ex.stream_executors(s)}
            assert set(svc._breakers) <= live
            assert st["host_gathers"] > 0
            return (st["availability"], st["failed_tickets"],
                    st["devices_lost"], st["recoveries"])
    ref, port = _both(run)
    assert port == ref == (1.0, 0, 1, 0)


def test_device_loss_rebuilds_shard_after_revival():
    """The stand-in for ``test_device_loss_rebuilds_shard_on_survivor``:
    one CPU device has no survivor to rebuild on, so the lost device is
    revived in the injector and in the service's DeviceHealth instead. The
    miss window is served from the host, the pump's rebuild arm commits
    every orphaned shard again (no admin call), launches resume, and
    every answer is bit-exact."""
    rows, again = np.arange(8, 56), np.arange(64, 128)
    want = _reference([rows, again])

    def run(side):
        S = side.S
        t, fs = _table(side)
        inj = S.FaultInjector()
        pol = S.FaultPolicy(max_retries=8, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                      faults=inj, fault_policy=pol) as svc:
            svc.result(svc.submit(np.arange(0, 32)), timeout=60)
            dead = svc._sharded_ex.devices[0]
            lost_ex = svc._sharded_ex.executors[0]
            inj.kill_device(dead)
            got = [svc.result(svc.submit(rows), timeout=60)]
            before = dict(svc.stats)
            inj.revive_device(dead)
            with svc._lock:
                svc._device_health.revive(side.key(dead))
                svc._work.notify_all()
            deadline = time.perf_counter() + 30
            while svc.stats["recoveries"] < svc.n_shards and \
                    time.perf_counter() < deadline:
                time.sleep(0.005)
            launches0 = svc.stats["launches"]
            got.append(svc.result(svc.submit(again), timeout=60))
            st = svc.throughput_stats(1.0)
            assert svc._sharded_ex.executors[0] is not lost_ex
            assert st["launches"] > launches0       # the device path is back
            assert before["host_gathers"] >= 1
        _equal(got, want)
        return (before["devices_lost"], before["recoveries"],
                st["devices_lost"], st["recoveries"], st["availability"])
    ref, port = _both(run)
    assert port == ref == (1, 0, 1, 5, 1.0)


# -- speculative hedged launches (test_chaos_serving.py:525-576) ---------------------
def _hedge_scenario(side, hedge: bool, stall: float):
    """A shard on two streams, warmed past the straggler warmup, then one
    stalled primary launch."""
    S = side.S
    t, fs = _table(side)
    inj = S.FaultInjector()
    pol = S.FaultPolicy(hedge=hedge, hedge_min_s=0.02, hedge_factor=2.0,
                        straggler_min_s=10.0, breaker_fails=100)
    rows = np.arange(0, 64)
    with _service(side, side.plan(t, fs), buckets=(64,), coalesce=1,
                  faults=inj, fault_policy=pol) as svc:
        svc.add_replica(0)
        for _ in range(10):
            svc.result(svc.submit(rows), timeout=60)
        completed0 = svc.stats["completed"]
        inj.stall_launches(stall, 1, shard=0)
        t0 = time.perf_counter()
        out = svc.result(svc.submit(rows), timeout=60)
        dt = time.perf_counter() - t0
        st = dict(svc.stats)
    return out, dt, (st["hedges"], st["hedge_wins"],
                     st["completed"] - completed0, st["failed_tickets"])


def test_hedged_launch_beats_stalled_primary():
    """The wait crosses the hedge cutoff, the duplicate on the other
    stream retires first and resolves the ticket bit-exact well under the
    stall; the primary's late copy is dropped without counting twice."""
    want = _reference([np.arange(0, 64)])[0]
    (ref_out, ref_dt, ref), (port_out, port_dt, port) = \
        _both(_hedge_scenario, True, 0.6)
    _equal([ref_out, port_out], [want, want])
    assert ref_dt < 0.5 and port_dt < 0.5
    assert port == ref == (1, 1, 1, 0)


def test_no_hedge_policy_rides_out_the_stall():
    want = _reference([np.arange(0, 64)])[0]
    (ref_out, ref_dt, ref), (port_out, port_dt, port) = \
        _both(_hedge_scenario, False, 0.3)
    _equal([ref_out, port_out], [want, want])
    assert ref_dt >= 0.28 and port_dt >= 0.28
    assert port == ref == (0, 0, 1, 0)


# -- refresh racing stream loss, breaker hygiene (test_chaos_serving.py:580-658) ----
def test_replica_lost_between_refresh_and_reput_resyncs_lazily():
    """A launch that fails between ``plan.refresh()`` and its stream's
    re-put fails over to a stream that puts first; the healed stream's
    own next launches re-sync lazily; all bit-exact against the refreshed
    reference."""
    rows = np.arange(8, 56)

    def run(side):
        S = side.S
        t, fs = _table(side, n=1400, imcu_rows=700)
        plan_p, plan_i = side.plan(t, fs), side.plan(t, fs, packed=False)
        pol = S.FaultPolicy(max_retries=4, backoff_s=0.001,
                            breaker_fails=100)
        inj = S.FaultInjector()
        with _service(side, plan_p, buckets=(64,), coalesce=1, faults=inj,
                      fault_policy=pol) as svc:
            svc.add_replica(0)
            for _ in range(4):
                svc.result(svc.submit(rows), timeout=60)
            new = {"age": t["age"].dictionary.add_rows(np.array([150])),
                   "state": t["state"].dictionary.add_rows(
                       np.array(["TX"])),
                   "income": t["income"].dictionary.add_rows(
                       np.array([1_234_000]))}
            plan_p.refresh(new)
            plan_i.refresh(new)
            inj.fail_launches(1, shard=0)
            want = np.asarray(side.C.FeatureExecutor(plan_i).batch(rows))
            got = [svc.result(svc.submit(rows), timeout=60)
                   for _ in range(5)]
            failovers = svc.stats["failovers"]
            assert failovers > 0
            _equal(got, [want] * 5)
            return got[0], svc.stats["failed_tickets"], plan_p.out_dim
    ref, port = _both(run)
    assert np.array_equal(ref[0], port[0])
    assert port[1:] == ref[1:]
    assert port[1] == 0


def test_drop_replica_discards_breaker_entry():
    def run(side):
        t, fs = _table(side, n=1400, imcu_rows=700)
        with _service(side, side.plan(t, fs), buckets=(64,),
                      coalesce=1) as svc:
            svc.add_replica(0)
            dropped_tok = svc._sharded_ex.replicas[0][-1].stream_token
            for _ in range(4):
                svc.result(svc.submit(np.arange(0, 32)), timeout=60)
            had = dropped_tok in svc._breakers
            svc.drop_replica(0)
            live = {ex.stream_token for s in range(svc.n_shards)
                    for ex in svc._sharded_ex.stream_executors(s)}
            return (had, dropped_tok in svc._breakers,
                    set(svc._breakers) <= live,
                    svc.stats["unhealthy_shards"])
    ref, port = _both(run)
    assert port == ref == (True, False, True, 0)


# -- seeded sweeps (test_chaos_serving.py:662-780) -----------------------------------
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_chaos_random_sweep_with_replicas_never_loses_a_ticket(seed):
    """Random faults and delays against a fully replicated shard set:
    every ticket completes bit-exact."""
    rng = np.random.default_rng(100 + seed)
    requests = [rng.integers(0, 2100, rng.integers(4, 80))
                for _ in range(30)]
    want = _reference(requests, n=2100, seed=seed)

    def run(side):
        S = side.S
        t, fs = _table(side, n=2100, seed=seed)
        inj = S.FaultInjector(seed=seed).random_faults(
            p_fail=0.25, p_delay=0.05, delay_s=0.01)
        pol = S.FaultPolicy(max_retries=6, backoff_s=0.001, breaker_fails=4,
                            breaker_cooldown_s=0.02)
        with _service(side, side.plan(t, fs), buckets=(64, 256), faults=inj,
                      fault_policy=pol) as svc:
            for s in range(svc.n_shards):
                svc.add_replica(s)
            tickets = [svc.submit(r) for r in requests]
            got = [svc.result(tk, timeout=120) for tk in tickets]
        _equal(got, want)
        assert inj.faults_injected > 0
        st = svc.throughput_stats(1.0)
        return st["availability"], st["failed_tickets"], svc.replicas
    ref, port = _both(run)
    assert port == ref
    assert port[:2] == (1.0, 0)


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_chaos_sweep_device_loss_mid_traffic(seed):
    """Random faults plus a device killed between two waves: the second
    wave rides eviction and host serving; no ticket is lost and every
    answer is bit-exact."""
    rng = np.random.default_rng(300 + seed)
    wave1 = [rng.integers(0, 2100, rng.integers(4, 80)) for _ in range(10)]
    wave2 = [rng.integers(0, 2100, rng.integers(4, 80)) for _ in range(15)]
    want = _reference(wave1 + wave2, n=2100, seed=seed)

    def run(side):
        S = side.S
        t, fs = _table(side, n=2100, seed=seed)
        inj = S.FaultInjector(seed=seed).random_faults(
            p_fail=0.1, p_delay=0.05, delay_s=0.01)
        pol = S.FaultPolicy(max_retries=8, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64, 256), faults=inj,
                      fault_policy=pol) as svc:
            got = [svc.result(svc.submit(r), timeout=120) for r in wave1]
            devs = svc._sharded_ex.devices
            inj.kill_device(devs[seed % len(devs)])
            tickets = [svc.submit(r) for r in wave2]
            got += [svc.result(tk, timeout=120) for tk in tickets]
        _equal(got, want)
        st = svc.throughput_stats(1.0)
        return st["availability"], st["failed_tickets"], st["devices_lost"]
    ref, port = _both(run)
    assert port == ref == (1.0, 0, 1)


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_chaos_tier_transitions_with_device_loss(seed):
    """Shards demoted down the ladder mid-traffic, a device killed, and
    promotions asked for while launches still carry faults: the demoted
    shards keep being served from the host (no rebuild), a promotion whose
    home device died stays warm (no survivor on one device), every ticket
    is bit-exact and the tier gauges add up."""
    rng = np.random.default_rng(700 + seed)
    wave1 = [rng.integers(0, 2100, rng.integers(4, 80)) for _ in range(8)]
    wave2 = [rng.integers(0, 2100, rng.integers(4, 80)) for _ in range(15)]
    again = rng.integers(0, 2100, 200)
    want = _reference(wave1 + wave2 + [again], n=2100, seed=seed)

    def run(side):
        S = side.S
        t, fs = _table(side, n=2100, seed=seed)
        inj = S.FaultInjector(seed=seed).random_faults(
            p_fail=0.1, p_delay=0.05, delay_s=0.01)
        pol = S.FaultPolicy(max_retries=8, backoff_s=0.001,
                            breaker_fails=100)
        with _service(side, side.plan(t, fs), buckets=(64, 256), faults=inj,
                      fault_policy=pol) as svc:
            got = [svc.result(svc.submit(r), timeout=120) for r in wave1]
            svc.demote(0, "cold")
            svc.demote(1, "warm")
            demoted = svc.tiers[:2]
            devs = svc._sharded_ex.devices
            inj.kill_device(devs[seed % len(devs)])
            tickets = [svc.submit(r) for r in wave2]
            # whether a launch has met the dead device before these run
            # is a race in both packages: their outcomes are not compared
            svc.promote(1)
            svc.promote(0)
            got += [svc.result(tk, timeout=120) for tk in tickets]
            got.append(svc.result(svc.submit(again), timeout=120))
            st = dict(svc.stats)
        _equal(got, want)
        avail = svc.throughput_stats(1.0)["availability"]
        assert st["tier_hot"] + st["tier_warm"] + st["tier_cold"] == \
            svc.n_shards
        assert st["demotions"] >= 2
        return (demoted, avail, st["failed_tickets"], st["devices_lost"],
                st["rehydrations"])
    ref, port = _both(run)
    assert port == ref == (["cold", "warm"], 1.0, 0, 1, 1)
