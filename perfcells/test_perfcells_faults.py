"""A run with the timed path broken underneath comes out not correct, for
each fault a serving cell can have: a decode step that leaves its state
unchanged, half of the batch left out, a token altered where it is
produced. (The exchange between chips: no cell spans chips.)

At these sizes sound runs read gaps under half the limit the tests use
(the small MoE's route flips reach 0.16); each fault reads 1 or more."""
import time

import pytest
import torch

from perfcells import harness, smoke

CELLS = list(smoke.SMALL_MIX)
LIMIT = 0.5
SEED = 2**31 + 77


def _altered_token(eng):
    step = eng._decode_step

    def broken(*args):
        out = step(*args)
        return torch.where(out >= 0, (out + 1) % eng.cfg.vocab, out)

    eng._decode_step = broken


def _state_unchanged(eng):
    """The decode step writes no key or value into the pool."""
    from repro_torch.models import layers

    step, write = eng._decode_step, layers._paged_write

    def broken(*args):
        layers._paged_write = lambda *a, **k: None
        try:
            return step(*args)
        finally:
            layers._paged_write = write

    eng._decode_step = broken


def _half_batch(eng):
    """Rows in the upper half of the batch repeat their last token."""
    step = eng._decode_step

    def broken(params, tokens, *rest):
        out = step(params, tokens, *rest)
        half = out.shape[0] // 2
        last = tokens[half:, 0].to(out.dtype)
        out[half:] = torch.where(out[half:] >= 0, last, out[half:])
        return out

    eng._decode_step = broken


FAULTS = {"altered_token": _altered_token, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


def _run(name, fault=None, seconds=1.0):
    return harness.run_cell(smoke.small_cell(name, limit=LIMIT), SEED,
                            seconds, False, "cpu", time.perf_counter(),
                            fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    run = _run(name)
    assert run.result["correct"] is True
    assert run.result["check"]["logit_gap"]["value"] < LIMIT / 2


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    # 2 s: on a loaded machine a 1-s window may finish only requests that
    # no decode step served, and a decode fault then shows nowhere
    res = _run(name, FAULTS[fault], seconds=2.0).result
    assert res["correct"] is False
    assert res["check"]["logit_gap"]["value"] > LIMIT
