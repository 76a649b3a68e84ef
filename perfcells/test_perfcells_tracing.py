"""The program's own records against the benchmark's wrappers, exactly:
a traced 1-s small cell of each mix with the program's tracer on over
the window (``program_spans``). Each decode call the wrappers time sits
in an ``engine.decode`` span of as many rows and keys; each admission
they record in an ``engine.prefill`` span of the same shared and
unshared tokens; over the profiled stretch the program counts as many
launches of each launcher, at the same bound time, as the wrappers; the
engine's padding counters give what the spans give.

The dense cells' feed-forward width is raised to 1024 so that its
weights are SAMD-packed (64 x 1024 values) and matmul launches are
counted (the small MoE's experts are dequantized, ``model.dequantize``)."""
import math
import time

import pytest

from perfcells import costs, harness, program_spans, smoke

CELLS = list(smoke.SMALL_MIX)
SEED = 2**31 + 9001


def _traced(name):
    cell = smoke.small_cell(name)
    if cell.config["family"] == "dense":
        cell.config["d_ff"] = 1024
    return program_spans.run(cell, SEED, 1.0, True, "cpu",
                             time.perf_counter())


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
    return _traced(request.param)


def test_decode_and_prefill_spans_are_the_wrappers_calls(traced):
    run, program, spans = traced
    assert run.result["correct"] is True, run.result["check"]
    by_id = {s["id"]: s for s in program["spans"]}
    assert spans.decode_pairs and spans.prefill_pairs
    assert len(spans.decode_pairs) == len(spans.decode)
    for span_id, i in spans.decode_pairs:
        s = by_id[span_id]
        contexts = spans.decode[i]["contexts"]
        assert s["name"] == "engine.decode"
        assert s["attrs"]["rows"] == len(contexts)
        assert s["attrs"]["context_tokens"] == sum(contexts)
    assert sum(b.stop - b.start for _, b in spans.prefill_pairs) == len(
        spans.admitted)
    for span_id, batch in spans.prefill_pairs:
        a = by_id[span_id]["attrs"]
        took = spans.admitted[batch]
        assert by_id[span_id]["name"] == "engine.prefill"
        assert len(a["rids"]) == len(took)
        assert a["shared"] == sum(start for start, _ in took)
        assert a["real"] == sum(n for _, n in took)
    # a dequantize runs inside a step's forward
    for s in program["spans"]:
        if s["name"] == "model.dequantize":
            assert by_id[s["parent"]]["name"] in ("engine.decode",
                                                  "engine.prefill")


def test_launch_counts_are_the_wrappers(traced):
    run, program, spans = traced
    wrapped = {cls: n for cls, (_, n) in spans.launches.items()}
    assert wrapped.get("paged_decode_attention")
    dense = spans.arch["family"] == "dense"
    assert bool(wrapped.get("samd_matmul_splitk")) == dense
    assert spans.stretch_launches == wrapped
    # each launch's operations and bytes are the yardstick's: a matmul's
    # by its shape, and the attention launches of the stretch's decode
    # steps bound as long as the wrappers' bound them
    t_on, t_off = spans.stretch_times
    t0 = {s["id"]: s["t0"] for s in program["spans"]}
    attention = 0.0
    for c in program["counts"]:
        launcher = c["key"][0]
        if launcher.startswith("samd_matmul"):
            assert (c["flops"], c["bytes"]) == costs.samd_matmul(
                *c["key"][1:])
        elif launcher == "paged_decode_attention_launch":
            if t_on <= t0[c["key"][1]] <= t_off:
                attention += c["count"] * costs.bound_s(c["flops"],
                                                        c["bytes"])
    assert math.isclose(attention, spans.launches["paged_decode_attention"][0],
                        rel_tol=1e-9)


def test_pad_share_counters_are_the_prefill_spans(traced):
    run, program, _ = traced
    read = program_spans.readings(program, run)
    stats = run.details["stats"]
    assert stats["prefill_tokens_computed"] > stats["prefill_tokens_real"]
    want = 100.0 * (1 - stats["prefill_tokens_real"]
                    / stats["prefill_tokens_computed"])
    assert math.isclose(read["prefill_pad_share"], want, rel_tol=1e-12)
    reader = harness.load_metric_reader("prefill_pad_share")
    assert math.isclose(reader({"stats": stats}), want, rel_tol=1e-12)
    waits = [s for s in program["spans"] if s["name"] == "request.queue"]
    assert len(waits) == len({s["attrs"]["rid"] for s in waits}) > 0
    assert read["queue_wait_ms"] >= 0.0
