"""On the card: a small cell through the real kernels, traced, reads its
device metrics and comes out correct. Skips without a card."""
import time

import pytest

from perfcells import harness, smoke


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops

    ops.build_kernels()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    name = "nemotron-4-15b.shared-doc-decode"
    res = harness.run_cell(smoke.small_cell(name), 2**31 + 3, 2.0, True,
                           card, time.perf_counter()).result
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert "device_idle_share" in res["metrics"]
    assert len(res["breakdown"]["device_ops"]) <= 10
