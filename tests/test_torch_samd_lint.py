"""tools/samd_lint_torch.py: the port's kernel contract linter.

The port's tree lints clean; each rule flags a seeded mutation of a copy
of the tree (written to tmp_path) with exactly its own id; ``--certify``
folds unsafe configurations in as CERT001; the exit codes are the
reference tool's (0 clean, 1 violations, 2 usage)."""
import importlib.util
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
TOOL = REPO / "tools" / "samd_lint_torch.py"


@pytest.fixture(scope="module")
def lint():
    spec = importlib.util.spec_from_file_location("samd_lint_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("samd_lint_torch", mod)
    spec.loader.exec_module(mod)
    return mod


def _mutated(tmp_path, rel, old, new):
    """A copy of the port's tree with ``old`` replaced by ``new`` (once)
    in the file ``rel``."""
    root = tmp_path / "repro_torch"
    shutil.copytree(PORT, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    path = root / rel
    text = path.read_text()
    assert text.count(old) == 1, (rel, old)
    path.write_text(text.replace(old, new))
    return root


def test_port_tree_is_clean(lint):
    violations, notes = lint.lint_paths([PORT], lint.DEFAULT_CONFIG)
    assert violations == [], [str(v) for v in violations]
    assert notes == []  # every mirror, launch site and plan decided


def test_every_launch_site_and_mirror_is_read(lint):
    """The checks see what they check: each source's launchers and launch
    sites (the five of the sources' kernels), and every mirror pair
    evaluates on both sides."""
    cu = {p.name: lint.CudaSource(p)
          for p in sorted((PORT / "kernels" / "csrc").glob("*.cu"))}
    checker = lint._Lint({}, cu, lint.DEFAULT_CONFIG)
    sites = {name: sorted(src.line(site[4])
                          for fns in src.functions.values() for fn in fns
                          for site in checker._launch_sites(src, fn))
             for name, src in cu.items()}
    assert sites == {"paged_attention.cu": [828],
                     "samd_conv.cu": [748, 752, 785, 1117, 1218],
                     "samd_matmul.cu": [430]}
    assert sorted(cu["samd_matmul.cu"].externs) == [
        "repro_cuda_error_string", "samd_matmul_smem_bytes",
        "samd_matmul_splitk_launch", "samd_matmul_tile_launch"]
    conv = cu["samd_conv.cu"].scope
    assert conv.lookup("THREADS") == 256  # C_THREADS + P_THREADS
    assert conv.eval("Step<4, 1>::KC") == 64  # ONE_TERM_MULT
    assert len(lint.DEFAULT_CONFIG["mirrors"]) == 21


def test_launch_sites_are_checked_at_each_instantiation(lint):
    """The functions that launch are templates: the checks run at the
    instantiations the sources' own calls give them, through the
    dispatch macros (one per lanes-per-word count) and overloads."""
    cu = {p.name: lint.CudaSource(p)
          for p in sorted((PORT / "kernels" / "csrc").glob("*.cu"))}
    got = {(name, fn["name"]): src.instantiations(fn)
           for name, src in cu.items() for fns in src.functions.values()
           for fn in fns if fn["name"] in ("launch_vpw", "launch_rt",
                                           "run_conv2d", "run_conv1d")}
    vpws = [1, 2, 3, 4, 5, 6, 8, 10, 16, 32]
    mm = got["samd_matmul.cu", "launch_vpw"]
    assert sorted({b["VPW"] for b in mm}) == vpws and len(mm) == 20
    assert {(b["WARPS"], b["NT"], b["MT"], b["STAGES"]) for b in mm} == {
        (2, 1, 4, 4), (4, 2, 8, 3)}  # the split-K and tile launchers
    assert len(got["paged_attention.cu", "launch_rt"]) == 12
    conv = got["samd_conv.cu", "run_conv2d"]
    assert len(conv) == 30 and {"bf16", "float"} == {b["XT"] for b in conv}
    assert [b["T"] for b in got["samd_conv.cu", "run_conv1d"]] == [
        "int8_t", "uint8_t", "int16_t", "int32_t", "long long"]


@pytest.mark.parametrize("rel, old, new", [
    # a dropped int argument
    ("kernels/samd_matmul.py", "[ctypes.c_int] * 9", "[ctypes.c_int] * 8"),
    # the conv1d launcher's stride (long long) retyped as int
    ("kernels/samd_conv.py", "CONV1D: [_P, _LL, _LL,",
     "CONV1D: [_P, _LL, _I,"),
], ids=["dropped", "retyped"])
def test_tl001_ctypes_argument_list(lint, tmp_path, rel, old, new):
    root = _mutated(tmp_path, rel, old, new)
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert violations and {v.rule for v in violations} == {"TL001"}
    assert {v.path for v in violations} == {str(root / rel)}


def test_tl001_unbound_launcher(lint, tmp_path):
    root = _mutated(tmp_path, "kernels/samd_conv.py",
                    " + [_P],\n     CHUNKS: [_P] * 3 + [_I] * 4 + [_P]},",
                    " + [_P]},")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [
        ("TL001", "samd_conv_chunks_launch")]


def test_tl002_step_words_off_by_one(lint, tmp_path):
    root = _mutated(tmp_path, "kernels/samd_matmul.py", "STEP_WORDS = 16",
                    "STEP_WORDS = 17")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [("TL002",
                                                       "STEP_WORDS")]
    assert "= 16" in violations[0].message


def test_tl002_constexpr_expression_and_template_struct(lint, tmp_path):
    """A source-side change reaches a Python dict mirror through a
    template struct's member (``Words<VPW>::SW``, one value per key)."""
    root = _mutated(tmp_path, "kernels/csrc/samd_conv.cu",
                    ": VPW == 8 ? 4 :", ": VPW == 8 ? 8 :")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert {(v.rule, v.func) for v in violations} == {("TL002",
                                                       "STEP_WORDS")}


def test_tl002_plan_cluster_over_max_splits(lint, tmp_path):
    """A source whose MAX_SPLITS falls under what the plan functions
    return: every mirror of it and each plan over the ladder."""
    root = _mutated(tmp_path, "kernels/csrc/paged_attention.cu",
                    "constexpr int MAX_SPLITS = 8;",
                    "constexpr int MAX_SPLITS = 4;")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert {v.rule for v in violations} == {"TL002"}
    assert {v.func for v in violations} == {"MAX_SPLITS",
                                            "attention_plan"}


def test_tl003_cp_async_without_zero_fill(lint, tmp_path):
    root = _mutated(tmp_path, "kernels/csrc/samd_matmul.cu",
                    '[%1], 16, %2;\\n" ::"r"(s),\n               "l"(gmem), '
                    '"r"(valid ? 16 : 0));',
                    '[%1], 16;\\n" ::"r"(s),\n               "l"(gmem));')
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [("TL003",
                                                       "samd_mma_kernel")]


def test_tl003_exemption(lint):
    """Without its exemption the attention kernel's copies (no src-size)
    are flagged."""
    config = dict(lint.DEFAULT_CONFIG, tl003_exempt=[])
    violations, _ = lint.lint_paths([PORT], config)
    assert [(v.rule, v.func) for v in violations] == [
        ("TL003", "paged_attention_kernel")]


def test_tl004_block_over_launch_bounds(lint, tmp_path):
    root = _mutated(tmp_path, "kernels/csrc/samd_conv.cu",
                    "stage_x_kernel<XT, TERMS><<<grid, dim3(32, 8),",
                    "stage_x_kernel<XT, TERMS><<<grid, dim3(32, 16),")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [("TL004",
                                                       "run_conv2d")]
    assert "256 over its __launch_bounds__(256)" in violations[0].message


def test_tl004_bounds_of_one_instantiation(lint, tmp_path):
    """Launch bounds that one instantiation alone breaks (the 32 lanes
    a word one, reached only through the dispatch macro) are flagged, at
    that instantiation; and the plans of a copy of the tree say which
    package they ran."""
    root = _mutated(tmp_path, "kernels/csrc/samd_matmul.cu",
                    "__launch_bounds__(WARPS * 32)",
                    "__launch_bounds__(VPW == 32 ? 32 : WARPS * 32)")
    violations, notes = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [("TL004",
                                                       "launch_vpw")]
    assert "96 over" in violations[0].message  # the tile launcher's 128
    assert "launch_vpw<VPW=32, WARPS=4" in violations[0].message
    assert notes == [f"TL002/TL004 plans ran the repro_torch of "
                     f"{PORT.resolve()}, not the linted {root}"]


def test_tl004_unopted_shared_memory(lint, tmp_path):
    """A launch with no opt-in attribute past 48 KB (the chunk kernel's
    staging at the ladder's 64 output lanes), and conv1d tiles past the
    source's C1D_MAX_SMEM."""
    root = _mutated(tmp_path, "kernels/csrc/samd_conv.cu",
                    "CHUNK_THREADS, CHUNK_THREADS * out_lanes * 4,",
                    "CHUNK_THREADS, CHUNK_THREADS * out_lanes * 8,")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [
        ("TL004", "samd_conv_chunks_launch")]
    root = _mutated(tmp_path / "b", "kernels/csrc/samd_conv.cu",
                    "C1D_MAX_SMEM = 48 * 1024;", "C1D_MAX_SMEM = 16 * 1024;")
    violations, _ = lint.lint_paths([root], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [
        ("TL004", "conv1d_smem_bytes")]


BARE_WIDE_READ = """
    from repro_torch.core import samd

    def product_lanes(prod, fmt, n):
        return samd.unpack_lanes_wide(prod, fmt, n)

    def corrected(prod, fmt, n):
        prod = samd.correct_signed_product(prod, fmt)
        return samd.unpack_lanes_wide(prod, fmt, n)
"""


def test_tl005_bare_signed_wide_read(lint, tmp_path):
    f = tmp_path / "wide.py"
    f.write_text(textwrap.dedent(BARE_WIDE_READ))
    violations, _ = lint.lint_paths([f], lint.DEFAULT_CONFIG)
    assert [(v.rule, v.func) for v in violations] == [("TL005",
                                                       "product_lanes")]


def test_cert001_through_certify(lint, tmp_path, monkeypatch, capsys):
    """--certify folds the sweep's unsafe verdicts in: serving rows whose
    weights meet 16-bit quantized activations overflow the f32
    accumulator at the bench model's depths."""
    import functools

    from repro_torch.analysis import certify
    from repro_torch.quant.config import QuantConfig

    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"rows": [{"name": "serving/paged_b4"}]}))
    f = tmp_path / "empty.py"
    f.write_text("")
    assert lint.main([str(f), "--certify", str(bench), "--json"]) == 0
    monkeypatch.setattr(certify, "QuantConfig",
                        functools.partial(QuantConfig, act_bits=16))
    capsys.readouterr()
    assert lint.main([str(f), "--certify", str(bench), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert {v["rule"] for v in out["violations"]} == {"CERT001"}
    assert any(v["func"].startswith("serving/paged_b4/weights_k")
               for v in out["violations"])


def test_exit_codes(tmp_path):
    bad = tmp_path / "wide.py"
    bad.write_text(textwrap.dedent(BARE_WIDE_READ))

    def run(*args):
        return subprocess.run([sys.executable, str(TOOL), *args],
                              capture_output=True, text=True, timeout=300,
                              cwd=REPO)

    clean = run("src/repro_torch", "--certify", "BENCH_serving.json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "samd-lint-torch: 0 violation(s)" in clean.stderr
    assert "configurations checked" in clean.stderr
    dirty = run(str(bad))
    assert dirty.returncode == 1 and "TL005" in dirty.stdout
    assert run(str(tmp_path / "missing")).returncode == 2
    assert run("--no-such-flag").returncode == 2
