"""A configuration's model is a file of its own (``families/``).

The dispatched code gives, exactly, what the harness gave before the
families were split out: each drawn leaf, the reference's float32 logits
(with and without a shared prefix) and the model's operations, at the
small sizes of both configurations. A family in another directory,
which draws and packs a layer at a time, runs a small cell through the
harness with no other file changed. Spans stand on a ring-mode engine,
and a traced run hands the readers the program's records."""
import dataclasses
import hashlib
import json
import textwrap
import time

import pytest
import torch

from perfcells import (costs, families, harness, reference, smoke, spans,
                       weights)

SEED = 2**31 + 30
# recorded from the harness before this split, on the CPU (one thread)
GOLDEN = {
    "nemotron-4-15b": {
        "leaves": {
            "blocks.attn.wk": "9cfa310c3b3c39e70f43a8d89c55fdd9",
            "blocks.attn.wo": "25ede67912730a1919dffb950f519c5f",
            "blocks.attn.wq": "3fd01774fd71e94bda9385cba10c514d",
            "blocks.attn.wv": "041fe4c36fe8485f9a6f4132ef9076ec",
            "blocks.mlp.wd": "f4590428a1737d5a557ee967a7b4132f",
            "blocks.mlp.wu": "a3918088941b625056761fd05862e550",
            "embed": "3921321fff9023bd4e6a78469d4ccfb7",
            "lm_head": "f42676c15a7f37e6a9151f46cac951c6",
        },
        "logits": {
            "prefix": ["d1d5d3468e1172ae773432cdd8939f0d",
                       "cd7bbae84f87687a9739add9c4ddd746"],
            "alone": ["d96f989222b6c6da3ad7b1efa17e72f0",
                      "c46e50f62294017e56102657db49be92"],
            "packed": ["c0c12b3f15514a48ccf479ca972e019f",
                       "29935294e5ab7628ecf87c49c3e8cc9d"],
        },
        "costs": [14055112704, 12482248704, 29080682496.0,
                  19821578944512.0, 65536, 139776.0, 1094656.0],
    },
    "olmoe-1b-7b": {
        "leaves": {
            "blocks.attn.wk": "f0b9d625be52698a2a64c17f4d2326b4",
            "blocks.attn.wo": "25ede67912730a1919dffb950f519c5f",
            "blocks.attn.wq": "3fd01774fd71e94bda9385cba10c514d",
            "blocks.attn.wv": "e650e12a451b1f706fca6fc2b89b9890",
            "blocks.moe.router": "be7e185f91fc651d6105854bf430158a",
            "blocks.moe.w_down": "9ca1646596196337128608b80ae978f7",
            "blocks.moe.w_gate": "172b501fa91e8c897b053c70691bba91",
            "blocks.moe.w_up": "fe00d72045d35839b4ab226ef0eba11e",
            "embed": "3921321fff9023bd4e6a78469d4ccfb7",
            "lm_head": "f42676c15a7f37e6a9151f46cac951c6",
        },
        "logits": {
            "prefix": ["e6ee917e373dbf4ae3da40cf34d644df",
                       "a34e36fcca9a3d0bb9d454cf044a0f84"],
            "alone": ["39094746e6068f420c52ceb40aa7a948",
                      "1071323bf7cdbd9e168071b856019f47"],
            "packed": ["d0a82d8417fa15edf9575f16cdd32027",
                       "0ab9445c7482fd17653935138ef1d1db"],
        },
        "costs": [1178861568, 1075838976, 2519465984.0, 1742229602304.0,
                  189440, 387584.0, 3324928.0],
    },
}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:32]


def config(name: str) -> dict:
    return json.loads((harness.HERE / f"configs/{name}.json").read_text())


def small(name: str) -> dict:
    arch = config(name)
    arch.update(families.load(arch["family"]).SMALL, init_std=0.1)
    return arch


def reference_logits(arch: dict, shared: int) -> list:
    """Two segments of 10 and 16 fixed tokens, after ``shared`` tokens of
    a prefix they share; logits at every position of both."""
    toks = (torch.arange(40) * 37 + 11) % (arch["vocab"] - 1) + 1
    segs, rows, prefix = [], [], None
    if shared:
        prefix = reference.Segment(toks[:shared])
        segs.append(prefix)
    for n in (10, 16):
        seg = reference.Segment(toks[shared:shared + n], offset=shared,
                                prefix=prefix)
        segs.append(seg)
        rows.append((seg, torch.arange(n)))
    return reference.Reference(arch, SEED, "cpu").logits(segs, rows)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_weights_and_reference_as_before(name, one_thread):
    arch, want = small(name), GOLDEN[name]
    made = weights.make(arch, SEED, "cpu")
    assert {k: digest(v) for k, v in made.items()} == want["leaves"]
    for i, leaves in enumerate(weights.layers(arch, SEED, "cpu")):
        for kind, t in leaves.items():
            assert torch.equal(t, made[kind][i])
    # at this size no weight has min_values values: "packed" quantizes
    # every matmul weight of 1024 or more
    for label, shared, min_values in (("prefix", 24, None), ("alone", 0, None),
                                      ("packed", 24, 1024)):
        if min_values:
            arch["quant"] = dict(arch["quant"], min_values=min_values)
        got = [digest(x) for x in reference_logits(arch, shared)]
        assert got == want["logits"][label], label


@pytest.mark.parametrize("name", list(GOLDEN))
def test_costs_as_before(name):
    full, arch = config(name), small(name)
    got = [costs.matmul_params_per_token(full),
           costs.matmul_params_per_token(full, head=False),
           costs.token_flops(full, 1234), costs.prefill_flops(full, 300, 777),
           costs.matmul_params_per_token(arch), costs.token_flops(arch, 17),
           costs.prefill_flops(arch, 5, 9)]
    assert got == GOLDEN[name]["costs"]
    assert [type(v) for v in got] == [type(v) for v in GOLDEN[name]["costs"]]


def test_arch_config_takes_the_same_fields():
    for name in GOLDEN:
        cfg = harness.arch_config(config(name))
        got = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        for key, v in config(name).items():
            if key in got:
                assert got[key] == v, key
    # olmoe's norm_topk_prob is the reference's alone
    assert not hasattr(harness.arch_config(config("olmoe-1b-7b")),
                       "norm_topk_prob")


def test_an_unknown_family_says_so():
    with pytest.raises(ValueError, match="no model family"):
        families.load("no-such-family")


# A family of its own directory: the dense layer, every leaf drawn a
# layer at a time from a generator of its own, and an engine that packs
# each layer as it is drawn. It runs on the program's dense model.
TOY = '''
import torch

from perfcells import weights
from perfcells.families import _shared

SMALL = dict(n_layers=3, d_model=64, vocab=128, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128)
DRAWN = []          # (who, layer) of each layer drawn


def leaf_shapes(arch):
    out = _shared.attention_leaves(arch)
    d, f, std = arch["d_model"], arch["d_ff"], arch["init_std"]
    out["blocks.mlp.wu"] = ((d, f), torch.bfloat16, std)
    out["blocks.mlp.wd"] = ((f, d), torch.bfloat16, std)
    return out


def make(arch, seed, device, kinds=None):
    return {k: weights.draw(seed, (k,), *leaf_shapes(arch)[k], device)
            for k in kinds or ("embed", "lm_head")}


def layer(arch, seed, device, i, who):
    DRAWN.append((who, i))
    return {k: weights.draw(seed, (k, i), *spec, device)
            for k, spec in leaf_shapes(arch).items()
            if k.startswith("blocks.")}


def layers(arch, seed, device):
    for i in range(arch["n_layers"]):
        yield layer(arch, seed, device, i, "reference")


reference_layer = _shared.reference_layer


def mlp(ref, w, x):
    return ref.rnd(torch.relu(x @ w["wu"]) ** 2) @ w["wd"]


def block(ref, w, seg):
    _shared.block(ref, w, seg, mlp)


def matmul_params_per_token(arch, head=True):
    return _shared.matmul_params_per_token(
        arch, 2 * arch["d_model"] * arch["d_ff"], head)


def token_flops(arch, context):
    return _shared.token_flops(arch, context, matmul_params_per_token(arch))


def prefill_flops(arch, start, length):
    return _shared.prefill_flops(arch, start, length,
                                 matmul_params_per_token(arch, head=False))


def build_engine(config, mix, seed, device):
    from repro_torch.models.model import build_template
    from repro_torch.models.quantize import quantize_params

    from perfcells import harness

    program = dict(config, family="dense")
    template = build_template(harness.arch_config(program))
    qcfg = harness.quant_config(config)
    d = config["d_model"]

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    blocks = []
    for i in range(config["n_layers"]):
        tree = {}
        for kind, t in layer(config, seed, device, i, "program").items():
            _, part, leaf = kind.split(".")
            tree.setdefault(part, {"ln": ones(d)})[leaf] = t
        blocks.append(quantize_params(tree, template["blocks"][i], qcfg))
    top = make(config, seed, device)
    params = {"embed": top["embed"], "final_ln": ones(d), "blocks": blocks,
              "lm_head": quantize_params(top["lm_head"], template["lm_head"],
                                         qcfg)}
    return harness.serving_engine(program, mix, seed, device, params)
'''


@pytest.fixture
def toy_family(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(textwrap.dedent(TOY))
    monkeypatch.setattr(families, "DIR", tmp_path)
    return families.load("toy")


def test_a_new_family_is_a_file_of_its_own(toy_family):
    e2e, per_layer = harness.cell_metrics(harness.load_benchmark(),
                                          "nemotron-4-15b.long-prompt")
    cfg = dict(config("nemotron-4-15b"), name="toy", family="toy")
    # every matmul weight packed at the small size
    cfg["quant"] = dict(cfg["quant"], min_values=1024)
    cell = smoke.shrink(harness.Cell(
        "toy.long-prompt", cfg, harness.traffic_mod.load("long-prompt"), {},
        e2e, per_layer))
    assert cell.mix["clients"] == 4 and cell.mix["prompt"]["max"] == 192
    run = harness.run_cell(cell, 2**31 + 31, 1.0, True, "cpu",
                           time.perf_counter())
    assert run.result["correct"] is True, run.result["check"]
    assert run.result["check"]["compared_tokens"]["value"] > 0
    # the program and the reference each drew the layers one by one
    n = cfg["n_layers"]
    assert toy_family.DRAWN == ([("program", i) for i in range(n)]
                                + [("reference", i) for i in range(n)])
    # the family's operations reach the readers
    assert run.result["metrics"]["mfu.prefill"]["value"] > 0
    assert costs.token_flops(cfg, 0) == 2 * toy_family.matmul_params_per_token(
        cfg)


def test_spans_stand_on_a_ring_mode_engine():
    from repro_torch.configs.archs import smoke_config
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = smoke_config("rwkv6-3b")
    eng = ServingEngine(cfg, max_batch=2, max_len=32, device="cpu")
    assert eng.kv_mode == "ring" and not hasattr(eng, "_prefill_step")
    decode = eng._decode_step
    s = spans.Spans(eng, dataclasses.asdict(cfg), "cpu", time.perf_counter,
                    -1.0, 0.0)
    assert eng._decode_step != decode
    s.open_window(time.perf_counter() + 60.0)
    eng.submit(Request(rid=0, prompt=torch.arange(1, 9).numpy(),
                       max_tokens=4))
    eng.run_to_completion()
    s.window = False
    s.close()
    assert eng._decode_step is decode and not hasattr(eng, "_prefill_step")
    assert s.decode and not s.prefill
    assert len(s.timings()["decode"]) == len(s.decode)


def test_a_traced_run_hands_the_readers_the_programs_records(monkeypatch):
    seen = {}
    reader = harness.load_metric_reader

    def keep(name):
        read = reader(name)

        def wrapped(t):
            seen["t"] = t
            return read(t)
        return wrapped

    monkeypatch.setattr(harness, "load_metric_reader", keep)
    name = "nemotron-4-15b.long-prompt"
    run = harness.run_cell(smoke.small_cell(name), 2**31 + 32, 1.0, True,
                           "cpu", time.perf_counter())
    program = seen["t"]["program"]
    assert program is run.details["program"]
    names = {s["name"] for s in program["spans"]}
    assert {"request.queue", "engine.prefill", "engine.decode"} <= names
    assert run.result["metrics"]["queue_wait_ms"]["value"] >= 0.0
    from repro_torch import tracing

    assert tracing.on is False
