"""Port parity: the async front door over every model family's engine.

``tests/test_torch_server.py``'s front-door case, run over the
families' engines: olmoe-1b-7b (MoE, paged) and rwkv6-3b / zamba2-7b
(recurrent state, served on the ring). Both packages' engines run the
same raw weights under a counting clock, so refusals (codes and
details), counters, stamps, the snapshot text and the summary must be
EQUAL to the reference's, and streams agree by the greedy near-tie rule.

The refusals follow the engine's ``kv_mode``: a paged engine refuses the
request whose pages overflow the pool as infeasible; a ring has no page
pool to overflow, admits it, and its queue fills one request sooner.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_server import (  # noqa: E402
    SERVER, SERVER_ENGINE, SPECS, _record, _ref_snapshot, _serve,
    _shared_snapshot, _Ticks,
)
from test_torch_serving import _assert_greedy_parity, _pair  # noqa: E402

from repro.serving import AsyncServer as JAsyncServer  # noqa: E402
from repro.serving import RejectedRequest as JRejectedRequest  # noqa: E402
from repro_torch.serving import AsyncServer  # noqa: E402
from repro_torch.serving import RejectedRequest  # noqa: E402
from repro_torch.serving.metrics import parse_prometheus  # noqa: E402

REFUSALS = {
    "paged": [s[3] for s in SPECS if s[3] != "ok"],
    "ring": ["infeasible", "slo", "queue_full", "queue_full"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch, kv_mode", [
    ("olmoe-1b-7b", "paged"), ("rwkv6-3b", "ring"), ("zamba2-7b", "ring"),
])
def test_family_front_door_equals_reference(arch, kv_mode):
    jeng, teng = _pair(arch, None, **SERVER_ENGINE)
    assert teng.kv_mode == jeng.kv_mode == kv_mode
    results = []
    for eng, server_cls, rej_cls in ((jeng, JAsyncServer, JRejectedRequest),
                                     (teng, AsyncServer, RejectedRequest)):
        server = server_cls(eng, clock=_Ticks(), step_in_thread=False,
                            **SERVER)
        streamed, rejects = _serve(server, rej_cls)
        results.append((server, streamed, rejects))
    (jserver, jtoks, jrej), (server, toks, rej) = results
    assert rej == jrej
    assert [code for _, code, _ in rej] == REFUSALS[kv_mode]
    assert server.counters == jserver.counters
    assert server.counters["completed"] == len(toks) == 3
    assert server.counters["deadline_missed"] == 0
    assert _record(server.finished) == _record(jserver.finished)
    text = server.metrics_snapshot()
    assert _shared_snapshot(text, teng) == _ref_snapshot(jserver)
    snap = parse_prometheus(text)
    for k, v in server.counters.items():
        assert snap[f"samd_server_{k}_total"] == v
    assert server.summary() == jserver.summary()
    work = [(SPECS[rid][0], SPECS[rid][1]) for rid in sorted(toks)]
    _assert_greedy_parity(
        jeng, {i: jtoks[rid] for i, rid in enumerate(sorted(toks))},
        {i: toks[rid] for i, rid in enumerate(sorted(toks))}, work)
