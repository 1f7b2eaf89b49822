"""The port's ``reliability/`` against ``paddle_tpu.reliability``: for the
same ``PADDLE_TPU_FAULTS`` strings, seeds and fake clocks, the fault
decisions, backoff schedules, breaker transitions and deadline arithmetic
are equal (exact: both are stdlib code over the same seeded streams)."""

import pytest

from paddle_tpu.reliability import faults as ref_faults
from paddle_tpu.reliability import policy as ref_policy
from paddle_tpu_torch.reliability import faults as t_faults
from paddle_tpu_torch.reliability import policy as t_policy

SITES = ("predictor.run", "serving.worker", "rpc.send", "rpc.recv",
         "router.dispatch", "worker.heartbeat", "swap.prepare",
         "swap.commit")

PLANS = [
    "predictor.run:error@1-3",
    "rpc.send:corrupt@2;rpc.recv:corrupt@1,4",
    "router.dispatch:hang(0.0)@1;worker.heartbeat:error@1-3,7",
    "serving.worker:error@2;swap.prepare:corrupt@1;swap.commit:error@3",
]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _decisions(mod, plan, n=12):
    """Each site's outcome on invocations 1..n under ``plan``: None,
    'corrupt' or 'error' (hangs return None after their sleep)."""
    out = {}
    with mod.fault_scope(plan):
        for site in SITES:
            got = []
            for _ in range(n):
                try:
                    got.append(mod.trip(site))
                except mod.InjectedFault as e:
                    assert e.site == site
                    got.append("error")
            out[site] = got
    return out, plan.counts()


@pytest.mark.parametrize("spec", PLANS)
def test_explicit_plans_decide_alike(spec):
    ref = _decisions(ref_faults, ref_faults.FaultPlan.from_spec(spec))
    port = _decisions(t_faults, t_faults.FaultPlan.from_spec(spec))
    assert port == ref
    assert any(v != [None] * 12 for v in port[0].values())
    assert repr(t_faults.FaultPlan.from_spec(spec)) == repr(
        ref_faults.FaultPlan.from_spec(spec))


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("kinds", [("error",), ("error", "corrupt")])
def test_chaos_plans_decide_alike(seed, kinds):
    kw = dict(seed=seed, rate=0.3, chaos_sites=SITES[:5],
              chaos_hang_s=0.0, chaos_kinds=kinds)
    ref = _decisions(ref_faults, ref_faults.FaultPlan(**kw), n=40)
    port = _decisions(t_faults, t_faults.FaultPlan(**kw), n=40)
    assert port == ref
    assert sum(v.count("error") for v in port[0].values()) > 0


@pytest.mark.parametrize("bad", ["predictor.run", "x:explode@1",
                                 "x:error@", "x:error@0"])
def test_bad_specs_refused_alike(bad):
    for mod in (ref_faults, t_faults):
        with pytest.raises(ValueError):
            mod.FaultPlan.from_spec(bad)


def test_env_install_and_corrupt_bytes_alike(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "rpc.send:error@2")
    for mod in (ref_faults, t_faults):
        plan = mod.FaultPlan.from_env()
        assert [s.site for s in plan.specs] == ["rpc.send"]
        assert sorted(plan.specs[0].invocations) == [2]
    for data in (b"", b"x", b"hello world"):
        assert t_faults.corrupt_bytes(data) == ref_faults.corrupt_bytes(data)


@pytest.mark.parametrize("kw", [
    dict(), dict(max_attempts=6, base_delay_s=0.01, seed=3),
    dict(max_attempts=8, base_delay_s=0.5, max_delay_s=1.0,
         multiplier=3.0, jitter=0.5, seed=99),
    dict(max_attempts=4, jitter=0.0)])
def test_retry_schedules_alike(kw):
    assert t_policy.RetryPolicy(**kw).delays() == \
        ref_policy.RetryPolicy(**kw).delays()


def test_retry_call_under_a_deadline_alike():
    """Both give up at the same attempt when the deadline cannot cover
    the next wait, sleeping the same waits before it."""
    def run(mod):
        clock = FakeClock()
        slept = []

        def sleep(s):
            slept.append(s)
            clock.advance(s)

        calls = []

        def fail():
            calls.append(clock())
            raise RuntimeError("down")

        pol = mod.RetryPolicy(max_attempts=6, base_delay_s=0.1, seed=5,
                              sleep=sleep)
        with pytest.raises(mod.RetryError) as ei:
            pol.call(fail, deadline=mod.Deadline(0.5, clock=clock))
        return ei.value.attempts, slept, calls

    assert run(t_policy) == run(ref_policy)


def _breaker_trace(mod):
    clock = FakeClock()
    b = mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=2.0,
                           clock=clock, name="w0")
    steps = []
    for ev in ("f", "f", "s", "f", "f", "f", "a", "t1", "a", "t2", "a",
               "f", "a", "t2", "a", "s", "a", "f"):
        if ev == "f":
            out = b.record_failure()
        elif ev == "s":
            out = b.record_success()
        elif ev == "a":
            out = b.allow()
        else:
            clock.advance(float(ev[1:]))
            out = None
        steps.append((ev, out, b.state, b.consecutive_failures))
    return steps


def test_breaker_transitions_alike():
    ref = _breaker_trace(ref_policy)
    assert _breaker_trace(t_policy) == ref
    assert {s[2] for s in ref} == {"closed", "open", "half-open"}


@pytest.mark.parametrize("budget", [None, 0.0, 0.25, 3.0])
def test_deadline_arithmetic_alike(budget):
    def run(mod):
        clock = FakeClock()
        d = mod.Deadline(budget, clock=clock)
        out = []
        for dt in (0.0, 0.1, 0.2, 5.0):
            clock.advance(dt)
            try:
                req = d.require("op")
            except mod.DeadlineExpired as e:
                req = str(e)
            out.append((d.remaining(), d.expired(), req))
        return out

    assert run(t_policy) == run(ref_policy)
