"""The yardstick's arithmetic: operations and bytes at the two
configurations' shapes against hand-counted values, shared pages counted
once, and the end-to-end metrics over the whole window."""
import json
import math

import numpy as np
import pytest

from perfcells import costs, harness, traffic

CONFIGS = {n: json.loads((harness.HERE / f"configs/{n}.json").read_text())
           for n in ("olmoe-1b-7b", "nemotron-4-15b")}


def test_samd_matmul_counts():
    # nemotron-4-15b's wq at a 32-row decode, 4-bit (8 values a word)
    flops, nbytes = costs.samd_matmul(32, 6144, 6144, 8)
    assert flops == 2_415_919_104
    assert nbytes == 768 * 6144 * 4 + 6144 * 4 + 2 * 32 * 6144 * 2
    # olmoe-1b-7b's packed LM head
    flops, nbytes = costs.samd_matmul(32, 2048, 50304, 8)
    assert flops == 6_593_445_888
    assert nbytes == 55_063_040


def test_paged_attention_counts_shared_pages_once():
    flops, nbytes = costs.paged_decode_attention(
        [40, 20], [[5, 6, 7, -1], [5, 9, -1, -1]], 16, 48, 8, 128)
    assert flops == 4 * 48 * 128 * 60
    # pages 5, 6 whole, 7 half, 9 a quarter: 44 token slots of k and v
    assert nbytes == 44 * 8 * 128 * 2 * 2 + 2 * 2 * 48 * 128 * 2
    alone = costs.paged_decode_attention([40], [[5, 6, 7]], 16, 48, 8, 128)
    twice = costs.paged_decode_attention([40, 40], [[5, 6, 7]] * 2, 16,
                                         48, 8, 128)
    assert twice[1] - alone[1] == 48 * 128 * 2 * 2
    assert twice[0] == 2 * alone[0]


def test_model_flops_per_token():
    nem, olm = CONFIGS["nemotron-4-15b"], CONFIGS["olmoe-1b-7b"]
    assert costs.matmul_params_per_token(nem) == 14_055_112_704
    assert costs.matmul_params_per_token(olm) == 1_178_861_568
    assert costs.token_flops(nem, 0) == 2 * 14_055_112_704
    assert costs.token_flops(nem, 100) - costs.token_flops(nem, 0) == (
        4 * 32 * 48 * 128 * 100)
    # a prefill of 3 tokens after 5: contexts 6, 7, 8; the head once
    body = costs.matmul_params_per_token(nem, head=False)
    assert costs.prefill_flops(nem, 5, 3) == (
        2 * body * 3 + 2 * 6144 * 256000 + 4 * 32 * 48 * 128 * 21)


def test_bound_takes_the_larger_term():
    assert costs.bound_s(989e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert costs.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def _sent(times, t_send=0.0, max_tokens=None):
    r = traffic.Req(0, np.zeros(4, np.int32), max_tokens or len(times))
    s = harness.Sent(r, t_send, list(times))
    s.done = True
    return s


def test_rate_is_all_tokens_over_the_window():
    sent = [_sent(np.arange(1, 11) * 0.1), _sent(np.arange(1, 6) * 0.3)]
    m = harness.end_to_end(sent, 0.0, 2.0)
    assert m["tokens_per_s"] == pytest.approx(15 / 2.0)
    m = harness.end_to_end(sent, 0.0, 1.0)   # tokens after the close
    assert m["tokens_per_s"] == pytest.approx(13 / 1.0)


def test_tails_cover_every_sample_and_move_with_a_stall():
    steady = [_sent(np.arange(1, 101) * 0.1) for _ in range(4)]
    base = harness.end_to_end(steady, 0.0, 10.0)
    assert base["tpot_p95_ms"] == pytest.approx(100.0)
    assert base["ttft_p50_ms"] == pytest.approx(100.0)
    assert base["ttft_p85_ms"] == pytest.approx(100.0)
    stalled = [_sent(np.concatenate([np.arange(1, 51) * 0.1,
                                     2.0 + np.arange(51, 101) * 0.1]))
               for _ in range(4)]
    moved = harness.end_to_end(stalled, 0.0, 10.0)
    assert moved["tokens_per_s"] < base["tokens_per_s"]
    # one gap in 99 per request: above p95's rank, so the tail is the
    # stall only once more such gaps are counted
    assert moved["tpot_p95_ms"] == pytest.approx(100.0)
    many = [_sent(np.cumsum(np.where(np.arange(100) % 10 == 0, 0.5, 0.1)))
            for _ in range(4)]
    assert harness.end_to_end(many, 0.0, 100.0)["tpot_p95_ms"] == (
        pytest.approx(500.0))


def test_a_failed_request_counts_as_never_answered():
    ok = [_sent([0.1]) for _ in range(19)]
    bad = _sent([], max_tokens=1)
    bad.refused = "queue_full"
    assert harness.end_to_end(ok + [bad] * 3, 0, 1)["ttft_p85_ms"] == (
        pytest.approx(100.0))
    assert harness.end_to_end(ok + [bad] * 4, 0, 1)["ttft_p85_ms"] == (
        math.inf)
    assert harness.end_to_end(ok + [bad] * 4, 0, 1)["ttft_p50_ms"] == (
        pytest.approx(100.0))


def test_percentile_is_linear_over_all_values():
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    assert harness.percentile(list(range(101)), 95) == 95
    assert math.isnan(harness.percentile([], 95))


def _trace(**kw):
    t = {"arch": CONFIGS["nemotron-4-15b"], "decode": [], "prefill": [],
         "admitted": [], "stats": {"prefix_tokens_saved": 0}, "stretch": {},
         "launches": {}, "requests": []}
    t.update(kw)
    return t


def test_metric_readers():
    read = {n: harness.load_metric_reader(n) for n in (
        "decode_batch_mean", "decode_step_ms", "mfu.decode",
        "prefill_ms_per_ktok", "mfu.prefill", "prefix_hit_share",
        "moe_dequant_share", "device_idle_share",
        "samd_matmul_roofline.decode", "paged_attention_roofline",
        "admit_wait_ms")}
    empty = _trace()
    assert all(r(empty) is None for r in read.values())
    arch = CONFIGS["nemotron-4-15b"]
    ticks = [dict(ms=50.0, contexts=[100] * 32, dequant_ms=10.0),
             dict(ms=70.0, contexts=[200] * 16, dequant_ms=0.0)]
    calls = [dict(ms=400.0, spans=[(3584, 100), (0, 300)])]
    t = _trace(decode=ticks, prefill=calls,
               admitted=[(3584, 100), (0, 300)],
               stats={"prefix_tokens_saved": 3584},
               stretch={"busy_s": 3.0, "window_s": 4.0,
                        "kernels": {"samd_matmul_splitk": [0.2, 10],
                                    "paged_decode_attention": [0.1, 4]}},
               launches={"samd_matmul_splitk": [0.05, 10],
                         "paged_decode_attention": [0.01, 3]})
    assert read["decode_batch_mean"](t) == 24.0
    assert read["decode_step_ms"](t) == 60.0
    flops = (32 * costs.token_flops(arch, 100)
             + 16 * costs.token_flops(arch, 200))
    assert read["mfu.decode"](t) == pytest.approx(
        100 * flops / (0.12 * 989e12))
    assert read["prefill_ms_per_ktok"](t) == pytest.approx(1000.0)
    assert read["prefix_hit_share"](t) == pytest.approx(
        100 * 3584 / 3984)
    assert read["moe_dequant_share"](t) == pytest.approx(100 * 10 / 120)
    assert read["device_idle_share"](t) == pytest.approx(25.0)
    assert read["samd_matmul_roofline.decode"](t) == pytest.approx(25.0)
    # launches and kernels that do not pair up give no share
    assert read["paged_attention_roofline"](t) is None
