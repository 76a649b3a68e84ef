"""The example twins (examples/*_torch.py) against the reference's
examples, on the CPU.

Each twin runs with ``device="cpu"`` beside the reference's ``main()``
in this process, and their printed lines are compared:

* quickstart: sections 1-3 line for line; section 4's size ratios
  exactly and its relative errors within 1e-3 (the twin feeds the matmul
  bf16 activations, the input the kernel takes on the card, where the
  reference's CPU path takes f32);
* serve_quantized: every line but the token lists and the tok/s figure
  (the weights are drawn from other generators). By design the port's
  page pool holds one scratch page past ``num_pages`` (where dropped
  writes land, ``models.model.init_paged_cache``), so its resident KV
  bytes are (num_pages + 1) / num_pages of the reference's; the rest of
  the KV line is equal;
* train_e2e: the parameter count and every packed-size line equal, the
  loss finite, and the checkpoint restores equal on the CPU.
"""
import math
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import quickstart as j_quickstart  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_quantized as j_serve  # noqa: E402
import serve_quantized_torch  # noqa: E402
import train_e2e as j_train  # noqa: E402
import train_e2e_torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(main, argv, monkeypatch, capsys):
    """The reference example's printed lines (it reads ``sys.argv``)."""
    monkeypatch.setattr(sys, "argv", ["example", *argv])
    capsys.readouterr()
    main()
    return capsys.readouterr().out.splitlines()


def _port(main, argv, capsys):
    capsys.readouterr()
    result = main(argv, device="cpu")
    return result, capsys.readouterr().out.splitlines()


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    want = _reference(j_quickstart.main, [], monkeypatch, capsys)
    got, lines = _port(quickstart_torch.main, [], capsys)
    assert len(lines) == len(want) == 15
    assert lines[:12] == want[:12]  # sections 1-3
    for line, ref, bits in zip(lines[12:], want[12:], (8, 4, 2)):
        pat = (rf"  {bits}-bit packed weights: ([\d.]+)x smaller than "
               r"bf16, rel-err ([\d.]+)")
        ratio, err = map(float, re.fullmatch(pat, ref).groups())
        assert re.fullmatch(pat, line)
        assert got[bits]["ratio"] == ratio
        assert abs(got[bits]["rel_err"] - err) <= 1e-3, (bits, got, err)


def _without_tokens(lines):
    """Lines with the token lists and the tok/s figure taken out."""
    out = []
    for line in lines:
        line = re.sub(r"in [\d.]+s \([\d.]+ tok/s on \w+\)", "in _", line)
        out.append(re.sub(r"-> \[[\d, ]*\]", "-> [...]", line))
    return out


def test_serve_quantized_matches_the_reference(monkeypatch, capsys):
    argv = ["--requests", "3", "--max-batch", "2"]
    want = _without_tokens(_reference(j_serve.main, argv, monkeypatch,
                                      capsys))
    eng, lines = _port(serve_quantized_torch.main, argv, capsys)
    got = _without_tokens(lines)
    kv = re.compile(r"  KV: paged \((\d+) pages x 16 tokens, ([\d.]+)MB "
                    r"resident, (\d+) mid-decode grants\)")
    (pages, ref_mb, grants), = (kv.fullmatch(x).groups() for x in want
                                if kv.fullmatch(x))
    assert int(pages) == eng.num_pages
    port_bytes = eng.kv_cache_bytes()
    assert port_bytes * eng.num_pages % (eng.num_pages + 1) == 0
    assert (f"{port_bytes * eng.num_pages / (eng.num_pages + 1) / 1e6:.2f}"
            == ref_mb)
    assert kv.fullmatch(got[3]).group(3) == grants
    assert got[:3] + got[4:] == want[:3] + want[4:]
    assert all(not r.truncated and r.error is None for r in eng.finished)
    assert len(eng.finished) == 3


def test_train_e2e_matches_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    argv = ["--steps", "3"]
    want = _reference(j_train.main, argv, monkeypatch, capsys)
    got, lines = _port(train_e2e_torch.main, argv, capsys)
    assert lines[0] == want[0]  # "arch ...: 4.3M params, 4L d=256"
    size = re.compile(r"  (\d)-bit: params ([\d.]+MB -> [\d.]+MB), ")
    sizes = [size.match(x).groups() for x in lines if size.match(x)]
    assert len(sizes) == 4
    assert sizes == [size.match(x).groups() for x in want if size.match(x)]
    step = re.compile(r"step +(\d+) loss ([\d.]+) lr ([\d.e+-]+)")
    assert ([step.match(x).group(1, 3) for x in lines if step.match(x)]
            == [step.match(x).group(1, 3) for x in want if step.match(x)])
    assert all(math.isfinite(v) for v in got["losses"].values())
    assert sorted(got["losses"]) == [0, 2]
    assert got["ckdir"] == str(tmp_path / "repro_torch_e2e_ckpt")
    tree, at, _ = CheckpointManager(got["ckdir"]).restore(
        {"params": got["params"], "opt": got["opt"]}, device="cpu")
    assert at == 3
    want_leaves = named_leaves({"params": got["params"], "opt": got["opt"]})
    got_leaves = named_leaves(tree)
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (name, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), name
