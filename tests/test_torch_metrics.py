"""Port parity: serving metrics (latencies, percentiles, summaries,
histograms and the Prometheus text snapshot).

``repro_torch.serving.metrics`` is a copy of the reference's host code:
on the same synthetic requests (stamps set by hand, each package's own
``Request``) every latency, percentile and summary must be EQUAL to the
reference's, ``render_prometheus`` must give the identical string and
``parse_prometheus`` equal dicts, raising on the same malformed lines
with the same message.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import metrics as ref  # noqa: E402
from repro_torch.serving import metrics as port  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402


def _requests(req_cls, seed, n):
    """Seeded synthetic trace: some requests rejected (no first token),
    some with one token (no TPOT), some still in flight (no retire)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = req_cls(rid=i, prompt=np.arange(4), max_tokens=8)
        r.t_submit = float(rng.uniform(0, 10))
        kind = rng.integers(0, 5)
        if kind == 0:  # rejected at admission
            r.t_retire = r.t_submit + float(rng.uniform(0, 1e-3))
            r.error = "queue_full: 64 waiting >= max_queue 64"
        else:
            r.t_admit = r.t_submit + float(rng.exponential(0.5))
            r.t_first_token = r.t_admit + float(rng.exponential(0.05))
            r.generated = list(range(1 if kind == 1 else
                                     int(rng.integers(2, 40))))
            if kind != 2:  # kind 2: still in flight
                r.t_retire = r.t_first_token + float(
                    rng.exponential(0.02)) * len(r.generated)
        out.append(r)
    return out


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(0, 40),
       slo=st.sampled_from([None, 0.05, 0.5, 2.0]))
def test_latencies_and_summaries_equal_reference(seed, n, slo):
    want = _requests(JRequest, seed, n)
    got = _requests(Request, seed, n)
    for fn in ("ttft_s", "tpot_s", "e2e_s"):
        assert ([getattr(port, fn)(r) for r in got]
                == [getattr(ref, fn)(r) for r in want])
    values = [port.e2e_s(r) for r in got if port.e2e_s(r) is not None]
    for q in (0, 1, 50, 90, 99, 100):
        assert port.percentile(values, q) == ref.percentile(values, q)
    assert port.summarize(got, slo_s=slo) == ref.summarize(want, slo_s=slo)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(0, 60),
       ladder=st.sampled_from(["default", "short"]))
def test_prometheus_snapshot_equals_reference(seed, n, ladder):
    rng = np.random.default_rng(seed)
    buckets = (port.DEFAULT_BUCKETS_S if ladder == "default"
               else (0.5, 0.01, 2.0))  # unsorted on purpose
    assert port.DEFAULT_BUCKETS_S == ref.DEFAULT_BUCKETS_S
    hists = {}
    for mod in (ref, port):
        hists[mod] = {name: mod.Histogram(buckets)
                      for name in ("samd_request_ttft_seconds",
                                   "samd_request_e2e_seconds")}
    for v in rng.exponential(0.3, size=n):
        for mod in (ref, port):
            for h in hists[mod].values():
                h.observe(float(v))
    counters = {"samd_server_completed_total": int(n),
                "samd_engine_decode_steps_total": int(rng.integers(0, 1e6)),
                "samd_server_rejected_slo_total": 0}
    gauges = {"samd_server_queue_depth": int(rng.integers(0, 64)),
              "samd_engine_pages_free": 1234567}
    for name in hists[port]:
        p, r = hists[port][name], hists[ref][name]
        assert (p.bounds, p.counts, p.inf_count, p.sum, p.count) == (
            r.bounds, r.counts, r.inf_count, r.sum, r.count)
    text = port.render_prometheus(counters, gauges, hists[port])
    assert text == ref.render_prometheus(counters, gauges, hists[ref])
    assert port.parse_prometheus(text) == ref.parse_prometheus(text)


@pytest.mark.parametrize("text", [
    "metric_without_value\n",
    "metric not_a_number\n",
    "x 1\n  lone\n",
    "a{le=\"0.5\"} 1e\n",
])
def test_parse_refuses_what_the_reference_refuses(text):
    with pytest.raises(ValueError) as want:
        ref.parse_prometheus(text)
    with pytest.raises(ValueError) as got:
        port.parse_prometheus(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", [
    "", "# TYPE x counter\n\nx 1\n", "x{le=\"+Inf\"} 3\n  y -2.5e-3  \n",
    "x nan\ny inf\n",
])
def test_parse_accepts_what_the_reference_accepts(text):
    got, want = port.parse_prometheus(text), ref.parse_prometheus(text)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] == want[k]) or (np.isnan(got[k]) and
                                       np.isnan(want[k]))
