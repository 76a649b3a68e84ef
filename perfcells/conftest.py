"""The benchmark's CPU tests import it as ``perfcells`` and the program
from ``src``."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads a test process here: the runs are small, and the
    suite's workers share the machine's cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
