"""Port parity: the front door's scheduling policies.

``repro_torch.serving.scheduler`` is a copy of the reference's pure
host code; on seeded random queues and clocks both packages' policies
must pick the same entry, and the overload property of
``tests/test_scheduler.py`` (a discrete-event simulation at 2.5x
overload: anti-starvation, and deadline-aware admission + EDF never
missing more deadlines than FIFO) must hold for the port with outcomes
identical to the reference's. Choices are indices: compared exactly.
"""
import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serving import scheduler as ref  # noqa: E402
from repro_torch.serving import scheduler as port  # noqa: E402


def _queue(mod, rng, n):
    """n entries with distinct sequence numbers in random order, random
    arrivals and deadlines (some None, some tied)."""
    seqs = rng.permutation(np.arange(1, 4 * n + 1))[:n]
    out = []
    for s in seqs:
        arrival = float(rng.choice([0.0, 0.5, rng.uniform(0.0, 10.0)]))
        deadline = (None if rng.random() < 0.25
                    else float(rng.choice([4.0, rng.uniform(0.0, 20.0)])))
        out.append(mod.QueueEntry(payload=None, arrival_s=arrival,
                                  deadline_s=deadline, seq=int(s),
                                  cost=float(rng.uniform(0, 50))))
    return out


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 16),
       starvation_s=st.sampled_from([0.25, 1.0, 2.5, 8.0]))
def test_select_matches_reference(seed, n, starvation_s):
    rng = np.random.default_rng(seed)
    rq = _queue(ref, np.random.default_rng(seed), n)
    pq = _queue(port, np.random.default_rng(seed), n)
    for now in (0.0, float(rng.uniform(0.0, 30.0)), 1e6):
        assert (port.FifoPolicy().select(pq, now)
                == ref.FifoPolicy().select(rq, now))
        assert (port.SloPolicy(starvation_s).select(pq, now)
                == ref.SloPolicy(starvation_s).select(rq, now))
        assert (port.make_policy("slo", starvation_s=starvation_s)
                .select(pq, now)
                == ref.make_policy("slo", starvation_s=starvation_s)
                .select(rq, now))


def test_make_policy_matches_reference():
    assert isinstance(port.make_policy("fifo"), port.FifoPolicy)
    pol = port.make_policy("slo", starvation_s=2.5)
    assert isinstance(pol, port.SloPolicy) and pol.starvation_s == 2.5
    assert port.make_policy(pol) is pol
    assert ([p.name for p in (port.FifoPolicy(), port.SloPolicy())]
            == [p.name for p in (ref.FifoPolicy(), ref.SloPolicy())])
    for bad in ("lifo", "SLO", ""):
        with pytest.raises(ValueError) as want:
            ref.make_policy(bad)
        with pytest.raises(ValueError) as got:
            port.make_policy(bad)
        assert str(got.value) == str(want.value)


# -- the overload property of tests/test_scheduler.py -----------------------
SERVICE_S = 1.0
MAX_QUEUE = 12


def _simulate(mod, policy, arrivals, slos, *, admission):
    """Single-server discrete-event run at unit service time, with the
    package's own QueueEntry (``tests/test_scheduler.py``'s simulator)."""
    queue = []
    outcomes = []
    free_at, now, i = 0.0, 0.0, 0
    while i < len(arrivals) or queue:
        next_arr = arrivals[i] if i < len(arrivals) else math.inf
        if queue and free_at <= next_arr:
            start = max(free_at, now)
            e = queue.pop(policy.select(queue, start))
            free_at = start + SERVICE_S
            outcomes[e.seq].update(served=True, start=start,
                                   completion=free_at)
        else:
            now = next_arr
            deadline = now + slos[i]
            outcomes.append({"arrival": now, "deadline": deadline,
                             "admitted": False, "served": False})
            backlog = len(queue) * SERVICE_S + max(0.0, free_at - now)
            eta = now + backlog + SERVICE_S
            full = len(queue) >= MAX_QUEUE
            if not full and not (admission and eta > deadline):
                queue.append(mod.QueueEntry(payload=None, arrival_s=now,
                                            deadline_s=deadline, seq=i))
                outcomes[i]["admitted"] = True
            i += 1
    return outcomes


def _misses(outcomes):
    return sum(1 for o in outcomes
               if o["served"] and o["completion"] > o["deadline"])


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(30, 80),
       starvation_scale=st.sampled_from([2, 5, 10]))
def test_overload_properties_match_reference(seed, n, starvation_scale):
    rng = np.random.default_rng(seed)
    arrivals = list(np.cumsum(rng.exponential(SERVICE_S / 2.5, size=n)))
    slos = list(rng.choice([4.0, 8.0, 20.0], size=n))
    starvation_s = float(starvation_scale) * SERVICE_S
    runs = {}
    for name, mod in (("ref", ref), ("port", port)):
        runs[name] = (
            _simulate(mod, mod.SloPolicy(starvation_s=starvation_s),
                      arrivals, slos, admission=True),
            _simulate(mod, mod.FifoPolicy(), arrivals, slos,
                      admission=False))
    assert runs["port"] == runs["ref"]
    slo, fifo = runs["port"]
    for run in (slo, fifo):
        assert len(run) == n
        assert all(o["served"] == o["admitted"] for o in run)
    bound = starvation_s + (MAX_QUEUE + 2) * SERVICE_S
    for o in slo:
        if o["served"]:
            assert o["start"] - o["arrival"] <= bound, o
    assert _misses(slo) <= _misses(fifo)
