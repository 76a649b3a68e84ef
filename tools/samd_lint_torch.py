#!/usr/bin/env python
"""samd-lint for the PyTorch/CUDA port: structural contract checker for
its hand-written kernels.

The port reaches its kernels through ``ctypes`` into the ``extern "C"``
launchers of ``kernels/csrc/*.cu``, which launch with
``cudaLaunchKernelEx`` or ``<<<>>>``. Nothing at run time checks that
the two sides agree: a ctypes argument list that does not match its
launcher is silent undefined behaviour, and a Python mirror of a
source's constant that drifts makes the host plan blocks the kernel was
not compiled for. This tool reads both sides (the sources as text, the
Python by its AST) and enforces, per rule of the reference's
``tools/samd_lint.py``:

  TL001 launcher-arity      every ``Kernel(name, source, {launcher:
                            argtypes})`` matches the launcher's ``extern
                            "C"`` parameter list: the same count and
                            pointer / int / long long / float in the same
                            order. Each named launcher exists, each
                            ``*_launch`` of a source is bound, each
                            ``lib.NAME.argtypes = [...]`` binding matches
                            NAME in every source that exports it, and
                            every ``*_smem_bytes`` query takes only ints
                            (``Kernel.query`` binds them so).
  TL002 mirrored-constant   every Python constant that restates a
                            source's ``constexpr`` (the ``mirrors`` of the
                            config) equals it, evaluated from the
                            source's ``constexpr int`` lines and its
                            template structs; and no plan function
                            (``samd_matmul.split_k``,
                            ``paged_attention.attention_plan``,
                            ``samd_conv.conv2d_plan``) returns a cluster
                            larger than its source's ``MAX_SPLITS`` over
                            the config's ``ladder`` of shapes.
  TL003 ragged-tail         every ``cp.async`` helper a kernel uses takes
                            the src-size (zero-fill) operand, so a copy
                            past the end of K fills zeros; otherwise the
                            kernel is listed in ``tl003_exempt`` with the
                            reason it masks its tail.
  TL004 smem-and-bounds     ``contracts.matmul_smem_bytes``,
                            ``conv2d_smem_bytes`` and
                            ``paged_attention.block_smem`` over the
                            ladder's plans stay within
                            ``contracts.SMEM_LIMIT_BYTES``;
                            ``conv1d_smem_bytes`` (a launch with no
                            opt-in attribute) within its source's
                            ``C1D_MAX_SMEM``; every launch site with no
                            opt-in attribute passes at most 48 KB; every
                            launch site's block has no more threads than
                            its kernel's ``__launch_bounds__`` (1024 with
                            none), at each instantiation the source's own
                            calls (macros expanded) give the function
                            that launches.
  TL005 signed-wide-read    every call to ``unpack_lanes_wide`` sits in a
                            function that also applies
                            ``correct_signed_product`` (or is
                            ``unpack_signed_product`` itself).

Run:  python tools/samd_lint_torch.py src/repro_torch [--json]
          [--config cfg.json] [--certify BENCH_serving.json]

``--certify`` also runs the port's lane-safety certification sweep
(:mod:`repro_torch.analysis.certify`) and folds unsafe configurations in
as CERT001 violations. A check that cannot be decided (an expression
that does not evaluate, a template with no instantiation) is a note, not
a violation. The plan functions run from the ``repro_torch`` the linted
sources belong to where it can be imported; where another copy is
already imported, a note says which one ran.

Exit status: 0 clean, 1 violations, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import itertools
import json
import re
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

KERNELS = "kernels/csrc/"
MM_PY, MM_CU = "kernels/samd_matmul.py", KERNELS + "samd_matmul.cu"
PA_PY, PA_CU = "kernels/paged_attention.py", KERNELS + "paged_attention.cu"
CV_PY, CV_CU = "kernels/samd_conv.py", KERNELS + "samd_conv.cu"
CONTRACTS = "analysis/contracts.py"
SPLITK, TILE = "samd_matmul_splitk_launch", "samd_matmul_tile_launch"


def _mirror(py, name, cu, expr, bind=None, over=None):
    return {"py": py, "name": name, "cu": cu, "expr": expr, "bind": bind,
            "over": over}


def _tile(launcher):
    """The matmul launcher's block (BN, BM), from the template arguments
    its ``extern "C"`` function gives ``launch<WARPS, NT, MT, STAGES>``."""
    return _mirror(MM_PY, f"BLOCK[{launcher!r}]", MM_CU,
                   "(Tile<1, W, NT, MT>::BN, Tile<1, W, NT, MT>::BM)",
                   bind=[launcher, "launch", ["W", "NT", "MT", "STAGES"]])


# Config. The ladder holds the shapes the plan functions are checked
# over: the published widths the port serves (qwen1.5-0.5b to qwen3-14b,
# vocabularies to 151936, contexts to 32k tokens), every lanes-per-word
# count, VGG-B's layers and the paper's conv plans.
DEFAULT_CONFIG = {
    "ladder": {
        "matmul_m": [1, 8, 24, 32, 33, 64, 1024, 8192],
        "matmul_k": [64, 512, 1024, 2816, 5120, 17408],
        "matmul_n": [8, 1024, 2816, 17408, 151936],
        "vpw": [1, 2, 3, 4, 5, 6, 8, 10, 16, 32],
        "attn_b": [1, 8, 64],
        "attn_hkv": [1, 8, 16],
        "attn_g": [1, 5, 8],
        "attn_dh": [8, 64, 128, 256],
        "attn_n_pp": [1, 32, 2048],
        "attn_ps": [16],
        "attn_s_r": [[1, 0], [1, 2], [1, 4], [3, 0], [5, 0]],
        "conv1d_n": [1, 1000, 3211264],
        "conv1d_bits": [2, 3, 4, 8],
        "conv1d_taps": [1, 3],
    },
    # [py file, Python expression over its module-level names, source,
    #  C++ expression over its constexprs, bind, over]: ``bind`` =
    # [extern "C" launcher, callee, names] binds names to the template
    # arguments of that launcher's call of the callee; ``over`` = a name
    # bound to each key of the Python dict in turn
    "mirrors": [
        _mirror(MM_PY, "STEP_WORDS", MM_CU, "STEP_WORDS"),
        _mirror(MM_PY, "MAX_SPLITS", MM_CU, "MAX_SPLITS"),
        _tile(SPLITK),
        _tile(TILE),
        _mirror(PA_PY, "THREADS", PA_CU, "THREADS"),
        _mirror(PA_PY, "MAX_SPLITS", PA_CU, "MAX_SPLITS"),
        _mirror(PA_PY, "BLOCKS_PER_SM", PA_CU, "BLOCKS_PER_SM"),
        _mirror(PA_PY, "MMA_ROWS", PA_CU, "MMA_ROWS"),
        _mirror(PA_PY, "(STEP_PAGES, STAGES)", PA_CU,
                "(STEP_PAGES, STAGES)"),
        _mirror(CV_PY, "(BLOCK_M, BLOCK_N)", CV_CU, "(BM, BN)"),
        _mirror(CV_PY, "STEP_WORDS", CV_CU, "Words<VPW>::SW", over="VPW"),
        _mirror(CV_PY, "ONE_TERM_MULT", CV_CU, "ONE_TERM_MULT"),
        _mirror(CV_PY, "MAX_SPLITS", CV_CU, "MAX_SPLITS"),
        _mirror(CV_PY, "C1D_BLOCKS_PER_SM", CV_CU, "C1D_BLOCKS_PER_SM"),
        *(_mirror(CONTRACTS, f"MATMUL_CONFIG[{fn!r}]", MM_CU,
                  "(W, NT, MT, STAGES)",
                  bind=[fn, "launch", ["W", "NT", "MT", "STAGES"]])
          for fn in (SPLITK, TILE)),
        _mirror(CONTRACTS, "(MATMUL_W_PAD, MATMUL_X_PAD)", MM_CU,
                "(W_PAD, X_PAD)"),
        _mirror(CONTRACTS, "(CONV2D_BM, CONV2D_BN, CONV2D_STAGES)", CV_CU,
                "(BM, BN, STAGES)"),
        _mirror(CONTRACTS, "(CONV2D_WPAD, CONV2D_SB, CONV2D_RED_STRIDE)",
                CV_CU, "(WPAD, SB, RED_STRIDE)"),
        _mirror(CONTRACTS, "CONV2D_PREPASS_BYTES['samd_conv2d_launch']",
                CV_CU, "shared(stage_x_kernel)"),
        _mirror(CONTRACTS,
                "CONV2D_PREPASS_BYTES['samd_conv2d_im2col_launch']",
                CV_CU, "shared(im2col_x_kernel)"),
    ],
    # [source suffix, kernel, the reason it needs no zero-fill copies]
    "tl003_exempt": [
        [PA_CU, "paged_attention_kernel",
         "copies whole pages the page table names and masks keys past "
         "each query's position (MASK_VALUE), as the reference's page "
         "loop does under pl.when"],
    ],
}
# dynamic shared memory a launch may pass without the opt-in attribute,
# and threads a block may have without __launch_bounds__ (sm_90)
UNOPTED_SMEM_BYTES = 48 * 1024
MAX_THREADS = 1024
# the most a launcher argument that sizes shared memory may be (the chunk
# launcher refuses out_lanes * L > 64 with L >= 1)
LAUNCH_ARGS = {"out_lanes": 64}


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    func: str
    message: str

    def to_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.func}] "
            f"{self.message}"
        )


class _Unknown(Exception):
    """An expression the evaluator cannot decide."""


# ---------------------------------------------------------------------------
# C++ side: an integer expression evaluator and a reader of one source's
# declarations
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<num>0[xX][0-9a-fA-F]+[uUlL]*|\d+\.\d*(?:[eE][+-]?\d+)?[fF]?
        |\d+[uUlL]*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op>::|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%()?:<>!~&|^,.\[\]])
  | (?P<ws>\s+)
""", re.X)

# binary operators: precedence (higher binds tighter)
_BINARY = {"||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
           "<": 7, ">": 7, "<=": 7, ">=": 7, "<<": 8, ">>": 8, "+": 9,
           "-": 9, "*": 10, "/": 10, "%": 10}
_CASTS = {"int", "unsigned", "size_t", "long", "uint32_t", "float", "bool"}


def _tokens(text):
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise _Unknown(f"cannot read {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup != "ws":
            out.append(m.group())
    return out


def _split_top(text, sep=","):
    """Split ``text`` at the ``sep`` characters outside brackets."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


class Scope:
    """Names an expression can read: bound values (ints, or a type's text
    for a ``typename`` template parameter), lazily evaluated expressions
    (struct members, local constexprs) and type aliases to template
    structs."""

    def __init__(self, src, parent=None):
        self.src = src
        self.parent = parent
        self.values = {}
        self.lazy = {}
        self.aliases = {}
        self._busy = set()

    def lookup(self, name):
        if name in self.values:
            return self.values[name]
        if name in self.lazy and name not in self._busy:
            self._busy.add(name)
            try:
                self.values[name] = self.eval(self.lazy[name])
            finally:
                self._busy.discard(name)
            return self.values[name]
        if self.parent is not None:
            return self.parent.lookup(name)
        raise _Unknown(name)

    def argument(self, text, is_type):
        """A template argument's value: the type's text for a ``typename``
        parameter (a bound type parameter replaced), else the integer."""
        if not is_type:
            return self.eval(text)
        try:
            v = self.lookup(text.strip())
        except _Unknown:
            return text.strip()
        return v if isinstance(v, str) else text.strip()

    def alias(self, name):
        if name in self.aliases:
            return self.aliases[name]
        return self.parent.alias(name) if self.parent else None

    def eval(self, text):
        """The value of one expression: an int, or a tuple of them."""
        parts = _split_top(text)
        if len(parts) == 1 and text.strip().startswith("(") \
                and len(_split_top(text.strip()[1:-1])) > 1:
            parts = _split_top(text.strip()[1:-1])
        if len(parts) > 1:
            return tuple(self.eval(p) for p in parts)
        parser = _Parser(_tokens(text), self)
        v = parser.expr(0)
        if parser.i != len(parser.toks):
            raise _Unknown(f"trailing {parser.toks[parser.i:]}")
        return v

    def member(self, struct, args, name):
        """``struct<args>::name`` (a template struct of the source)."""
        st = self.src.structs.get(struct)
        if st is None or len(args) != len(st["params"]):
            raise _Unknown(f"{struct}<...>::{name}")
        inner = Scope(self.src, self.src.scope)
        inner.values.update(zip(st["params"], args))
        inner.lazy.update(st["members"])
        inner.aliases.update(st["aliases"])
        return inner.lookup(name)


class _Parser:
    def __init__(self, toks, scope):
        self.toks, self.i, self.scope = toks, 0, scope

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def take(self, want=None):
        tok = self.peek()
        if tok is None or (want is not None and tok != want):
            raise _Unknown(f"expected {want}, got {tok}")
        self.i += 1
        return tok

    def expr(self, min_prec, in_template=False):
        left = self.unary(in_template)
        while True:
            op = self.peek()
            if op == "?" and min_prec == 0:
                self.take()
                a = self.expr(0, in_template)
                self.take(":")
                b = self.expr(0, in_template)
                left = a if left else b
                continue
            prec = _BINARY.get(op)
            if prec is None or prec <= min_prec or (in_template and
                                                    op == ">"):
                return left
            self.take()
            right = self.expr(prec, in_template)
            left = _binary(op, left, right)

    def unary(self, in_template):
        tok = self.peek()
        if tok in ("-", "!", "~", "+"):
            self.take()
            v = self.unary(in_template)
            return {"-": -v, "!": int(not v), "~": ~v, "+": v}[tok]
        return self.primary(in_template)

    def primary(self, in_template):
        tok = self.take()
        if tok == "(":
            if self.peek() in _CASTS and self.peek(1) == ")":
                self.i += 2  # a C cast of an integer
                return self.unary(in_template)
            v = self.expr(0)
            self.take(")")
            return v
        if re.match(r"\d", tok):
            if re.search(r"[.eE]", tok) and not tok.startswith("0x"):
                raise _Unknown(f"float {tok}")
            return int(tok.rstrip("uUlL"), 0)
        if tok in ("true", "false"):
            return int(tok == "true")
        if not re.match(r"[A-Za-z_]", tok):
            raise _Unknown(f"token {tok}")
        if tok == "shared" and self.peek() == "(":
            self.take("(")
            kern = self.take()
            self.take(")")
            return self.scope.src.static_shared(kern)
        if self.peek() == "<" and tok in self.scope.src.structs:
            self.take("<")
            args = [self.expr(0, True)]
            while self.peek() == ",":
                self.take()
                args.append(self.expr(0, True))
            self.take(">")
            self.take("::")
            return self.scope.member(tok, args, self.take())
        if self.peek() == "::":
            self.take()
            target = self.scope.alias(tok)
            if target is None:
                raise _Unknown(f"{tok}::")
            struct, arg_texts = target
            args = [self.scope.eval(a) for a in arg_texts]
            return self.scope.member(struct, args, self.take())
        if self.peek() == "(":
            raise _Unknown(f"call {tok}()")
        v = self.scope.lookup(tok)
        if isinstance(v, str):
            raise _Unknown(f"type {tok} = {v}")
        return v


def _binary(op, x, y):
    if op in ("/", "%"):
        if y == 0:
            raise _Unknown("division by zero")
        q = abs(x) // abs(y) * (1 if (x >= 0) == (y > 0) else -1)
        return q if op == "/" else x - q * y
    return int({"+": lambda: x + y, "-": lambda: x - y, "*": lambda: x * y,
        "<<": lambda: x << y, ">>": lambda: x >> y, "&": lambda: x & y,
        "|": lambda: x | y, "^": lambda: x ^ y, "==": lambda: x == y,
        "!=": lambda: x != y, "<": lambda: x < y, ">": lambda: x > y,
        "<=": lambda: x <= y, ">=": lambda: x >= y,
        "&&": lambda: bool(x) and bool(y), "||": lambda: bool(x) or bool(y),
    }[op]())


def _preprocess(text):
    """Comments and preprocessor lines blanked, newlines kept (so that
    offsets keep their line numbers); string literals kept; each
    invocation of a function-like macro the source defines replaced by
    its body on the invocation's line."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    lines = "".join(out).split("\n")
    macros, directive = {}, []
    for k, line in enumerate(lines):
        if directive or line.lstrip().startswith("#"):
            directive.append(line.rstrip().rstrip("\\"))
            lines[k] = ""
            if line.rstrip().endswith("\\"):
                continue
            d, directive = " ".join(directive), []
            m = re.match(r"\s*#\s*define\s+(\w+)\(([^)]*)\)(.*)", d)
            if m:
                macros[m[1]] = (_split_top(m[2]), m[3].strip())
            m = re.match(r"\s*#\s*undef\s+(\w+)", d)
            if m:
                macros.pop(m[1], None)
        elif macros:
            lines[k] = _expand(line, macros)
    return "\n".join(lines)


def _expand(line, macros):
    """``line`` with each invocation of ``macros`` (name -> (parameters,
    body)) replaced; an invocation that runs past the line is kept."""
    call = re.compile(rf"\b({'|'.join(map(re.escape, macros))})\s*\(")
    out, pos = [], 0
    while m := call.search(line, pos):
        try:
            end = _match(line, m.end() - 1, "(", ")")
        except ValueError:
            break
        params, body = macros[m[1]]
        sub = dict(zip(params, _split_top(line[m.end():end - 1])))
        out += [line[pos:m.start()],
                re.sub(r"\w+", lambda w: sub.get(w[0], w[0]), body)]
        pos = end
    return "".join(out) + line[pos:]


def _match(text, i, open_ch, close_ch):
    """Index just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_ch:
            depth += 1
        elif text[j] == close_ch:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError(f"unbalanced {open_ch} at {i}")


_C_KIND = {"int": "c_int", "long long": "c_longlong", "float": "c_float",
           "double": "c_double", "unsigned": "c_uint",
           "unsigned int": "c_uint", "size_t": "c_size_t"}
_SIZES = {"float": 4, "int": 4, "unsigned": 4, "uint32_t": 4, "u64": 8,
          "bf16": 2, "__nv_bfloat16": 2, "double": 8, "char": 1}


def _template_params(text):
    """['VPW', 'WARPS', ...] of ``template <int VPW, int WARPS, ...>``,
    and the set of those that are types (``typename T``)."""
    params = _split_top(text)
    return ([p.split()[-1] for p in params],
            {p.split()[-1] for p in params
             if p.split()[0] in ("typename", "class")})


class CudaSource:
    """One ``.cu`` file read as declarations: namespace-scope constexprs,
    template structs, functions (``extern "C"`` ones apart) with their
    template parameters, ``__launch_bounds__`` and bodies."""

    def __init__(self, path: Path):
        self.path = path
        self.text = _preprocess(path.read_text())
        self.consts = {}     # name -> expression text
        self.structs = {}    # name -> {params, members, aliases}
        self.functions = {}  # name -> [function dicts] (overloads)
        self.externs = {}    # name -> function dict
        self._instances = {}  # id(function dict) -> its instantiations
        self._walk(0, len(self.text), extern=False)
        self.scope = Scope(self)
        self.scope.lazy.update(self.consts)

    def line(self, offset):
        return self.text.count("\n", 0, offset) + 1

    def _walk(self, start, stop, extern):
        """Split ``text[start:stop]`` into statements and blocks at depth
        0, descending into namespaces and ``extern "C"`` blocks."""
        i, head = start, start
        while i < stop:
            ch = self.text[i]
            if ch == ";":
                self._statement(self.text[head:i])
                i = head = i + 1
            elif ch == "{":
                end = _match(self.text, i, "{", "}")
                header = self.text[head:i].strip()
                if re.match(r"namespace\b", header):
                    self._walk(i + 1, end - 1, extern)
                elif header == 'extern "C"':
                    self._walk(i + 1, end - 1, True)
                elif re.search(r"\bstruct\b", header):
                    self._struct(header, i, end)
                    end = self.text.index(";", end) + 1
                elif header.endswith(")") or header.endswith("const"):
                    self._function(header, head, i, end, extern)
                i = head = end
            else:
                i += 1

    def _statement(self, stmt):
        m = re.match(r"\s*(?:static\s+)?constexpr\s+(?:int|unsigned|bool)"
                     r"\s+(\w+)\s*=\s*(.+)$", stmt, re.S)
        if m:
            self.consts[m.group(1)] = m.group(2)

    def _struct(self, header, i, end):
        m = re.match(r"(?:template\s*<(.*)>\s*)?struct\s+(\w+)", header,
                     re.S)
        body = self.text[i + 1:end - 1]
        members = dict(re.findall(
            r"static\s+constexpr\s+(?:int|bool|unsigned)\s+(\w+)\s*=\s*"
            r"([^;]+);", body))
        aliases = {}
        for name, struct, args in re.findall(
                r"using\s+(\w+)\s*=\s*(\w+)\s*<([^;]*)>\s*;", body):
            aliases[name] = (struct, _split_top(args))
        self.structs[m.group(2)] = {
            "params": _template_params(m.group(1))[0] if m.group(1) else [],
            "members": members, "aliases": aliases}

    def _function(self, header, head, i, end, extern):
        template, types = [], set()
        m = re.match(r"template\s*<", header)
        if m:
            close = _match(header, m.end() - 1, "<", ">")
            template, types = _template_params(header[m.end():close - 1])
            header = header[close:]
        # the parameter list is the last top-level (...) of the header
        depth, j = 0, len(header) - 1
        while j >= 0:
            depth += {")": 1, "(": -1}.get(header[j], 0)
            if depth == 0 and header[j] == "(":
                break
            j -= 1
        name = re.search(r"(\w+)\s*$", header[:j])
        if name is None:
            return
        bounds = re.search(r"__launch_bounds__\s*\(", header)
        fn = {
            "name": name.group(1), "template": template, "types": types,
            "params": _split_top(header[j + 1:header.rindex(")")]),
            "global": "__global__" in header,
            "device": "__device__" in header and "__global__" not in header,
            "bounds": (_split_top(header[bounds.end():_match(
                header, bounds.end() - 1, "(", ")") - 1])
                if bounds else None),
            "line": self.line(head + len(self.text[head:i]) -
                              len(self.text[head:i].lstrip())),
            "body": (i + 1, end - 1), "extern": extern,
        }
        self.functions.setdefault(fn["name"], []).append(fn)
        if extern:
            self.externs[fn["name"]] = fn

    def body(self, fn):
        return self.text[fn["body"][0]:fn["body"][1]]

    def static_shared(self, kernel):
        """Bytes of a kernel's static ``__shared__`` arrays."""
        total = 0
        for fn in self.functions.get(kernel, []):
            for typ, dims in re.findall(
                    r"__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+\w+"
                    r"((?:\s*\[[^\]]+\])+)\s*;", self.body(fn)):
                n = _SIZES.get(typ)
                if n is None:
                    raise _Unknown(f"size of {typ}")
                for d in re.findall(r"\[([^\]]+)\]", dims):
                    n *= self.scope.eval(d)
                total += n
        return total

    def function_scope(self, fn, binding):
        """A scope for expressions in ``fn``'s body: its template
        parameters bound as ``binding`` says, its ``using`` aliases and
        local constexprs."""
        scope = Scope(self, self.scope)
        scope.values.update(binding)
        body = self.body(fn)
        for name, struct, args in re.findall(
                r"using\s+(\w+)\s*=\s*(\w+)\s*<([^;]*)>\s*;", body):
            scope.aliases[name] = (struct, _split_top(args))
        for name, text in re.findall(
                r"constexpr\s+(?:int|unsigned|bool)\s+(\w+)\s*=\s*([^;]+);",
                body):
            scope.lazy[name] = text
        return scope

    def instantiations(self, fn):
        """Each {template parameter: value} ``fn`` is instantiated with
        by the source's own calls of it, followed up to functions that
        are not templates; [{}] for a function that is not one. Raises
        _Unknown where a call's argument does not evaluate."""
        if not fn["template"]:
            return [{}]
        if id(fn) not in self._instances:
            self._instances[id(fn)] = []  # a recursive call adds none
            out = []
            for g in itertools.chain(*self.functions.values()):
                for args in self.calls(g, fn["name"]):
                    if len(args) != len(fn["template"]):
                        continue  # an overload of another arity
                    for binding in self.instantiations(g):
                        scope = self.function_scope(g, binding)
                        got = {p: scope.argument(a, p in fn["types"])
                               for p, a in zip(fn["template"], args)}
                        if got not in out:
                            out.append(got)
            self._instances[id(fn)] = out
        return self._instances[id(fn)]

    def calls(self, fn, callee):
        """The template argument texts of each call ``callee<...>(`` in
        ``fn``'s body."""
        body, out = self.body(fn), []
        for m in re.finditer(rf"\b{re.escape(callee)}\s*<", body):
            close = _match(body, m.end() - 1, "<", ">")
            if re.match(r"\s*\(", body[close:]):
                out.append(_split_top(body[m.end():close - 1]))
        return out


def _c_kind(param):
    """The ctypes type a C parameter needs ('c_void_p' for pointers)."""
    if "*" in param:
        return "c_void_p"
    words = param.replace("const ", " ").split()[:-1]
    return _C_KIND.get(" ".join(words), " ".join(words) or "?")


# ---------------------------------------------------------------------------
# Python side: module-level names evaluated from the AST alone
# ---------------------------------------------------------------------------

class PyModule:
    def __init__(self, path: Path, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.assigned = {}
        for node in tree.body:
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, ast.AnnAssign)
                       and node.value is not None else [])
            for t in targets:
                if isinstance(t, ast.Name):
                    self.assigned[t.id] = node.value
                elif (isinstance(t, ast.Tuple)
                      and isinstance(node.value, ast.Tuple)
                      and len(t.elts) == len(node.value.elts)):
                    for a, v in zip(t.elts, node.value.elts):
                        if isinstance(a, ast.Name):
                            self.assigned[a.id] = v
        self._cache = {}

    def eval(self, node):
        if isinstance(node, str):
            node = ast.parse(node, mode="eval").body
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in self._cache:
                if node.id not in self.assigned:
                    raise _Unknown(node.id)
                self._cache[node.id] = None  # a cycle reads as unknown
                self._cache[node.id] = self.eval(self.assigned[node.id])
            if self._cache[node.id] is None:
                raise _Unknown(node.id)
            return self._cache[node.id]
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                           ast.Name):
            return node.attr  # ctypes.c_int -> "c_int"
        if isinstance(node, (ast.List, ast.Tuple)):
            vals = [self.eval(e) for e in node.elts]
            return vals if isinstance(node, ast.List) else tuple(vals)
        if isinstance(node, ast.Dict):
            return {self.eval(k): self.eval(v)
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.BinOp):
            a, b = self.eval(node.left), self.eval(node.right)
            ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                   ast.Mult: lambda: a * b, ast.FloorDiv: lambda: a // b,
                   ast.Mod: lambda: a % b, ast.Pow: lambda: a ** b}
            if type(node.op) in ops:
                return ops[type(node.op)]()
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -self.eval(node.operand)
        if isinstance(node, ast.Subscript):
            return self.eval(node.value)[self.eval(node.slice)]
        raise _Unknown(ast.dump(node)[:60])

    def kernels(self):
        """(line, name, source file name, {launcher: argtypes}) of each
        module-level ``Kernel(...)``."""
        for node in self.tree.body:
            value = getattr(node, "value", None)
            if (isinstance(value, ast.Call)
                    and getattr(value.func, "id", None) == "Kernel"
                    and len(value.args) == 3):
                yield (node.lineno, *(self.eval(a) for a in value.args))

    def bindings(self):
        """(line, NAME, argtypes) of each ``x.NAME.argtypes = [...]``."""
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "argtypes"
                    and isinstance(node.targets[0].value, ast.Attribute)):
                try:
                    yield (node.lineno, node.targets[0].value.attr,
                           self.eval(node.value))
                except _Unknown:
                    continue


def _call_names(tree):
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            f = n.func
            out.add(f.attr if isinstance(f, ast.Attribute)
                    else getattr(f, "id", ""))
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

class _Lint:
    def __init__(self, py, cu, config):
        self.py = py    # path -> PyModule
        self.cu = cu    # path -> CudaSource
        self.config = config
        self.violations: list[Violation] = []
        self.notes: list[str] = []

    def emit(self, rule, path, line, func, msg):
        self.violations.append(Violation(rule, str(path), line, func, msg))

    def find(self, files, suffix):
        hits = [p for p in files if p.as_posix().endswith(suffix)]
        return files[hits[0]] if len(hits) == 1 else None

    # -- TL001 -------------------------------------------------------------
    def tl001(self):
        bound = {}
        for mod in self.py.values():
            for line, name, source, fns in mod.kernels():
                src = self.cu.get(mod.path.parent / "csrc" / source)
                if src is None:
                    self.notes.append(f"{mod.path}:{line}: TL001 skipped "
                                      f"{name} ({source} not linted)")
                    continue
                bound.setdefault(src.path, set()).update(fns)
                for fn, argtypes in fns.items():
                    self._signature(mod.path, line, fn, argtypes, src)
            for line, name, argtypes in mod.bindings():
                for src in self.cu.values():
                    if name in src.externs:
                        self._signature(mod.path, line, name, argtypes, src)
        for src in self.cu.values():
            for name, fn in src.externs.items():
                kinds = [_c_kind(p) for p in fn["params"]]
                if name.endswith("_launch") and name not in bound.get(
                        src.path, ()):
                    self.emit("TL001", src.path, fn["line"], name,
                              "extern \"C\" launcher bound by no "
                              "Kernel(...) of the package")
                if name.endswith("_smem_bytes") and set(kinds) - {"c_int"}:
                    self.emit("TL001", src.path, fn["line"], name,
                              f"query takes {kinds}; Kernel.query binds "
                              "every argument as c_int")

    def _signature(self, path, line, fn, argtypes, src):
        target = src.externs.get(fn)
        if target is None:
            self.emit("TL001", path, line, fn,
                      f"no extern \"C\" {fn} in {src.path.name}")
            return
        want = [_c_kind(p) for p in target["params"]]
        if list(argtypes) != want:
            diff = next((i for i, (a, b) in enumerate(zip(argtypes, want))
                         if a != b), min(len(argtypes), len(want)))
            self.emit("TL001", path, line, fn,
                      f"ctypes argtypes ({len(argtypes)}) differ from "
                      f"{src.path.name}:{target['line']} ({len(want)} "
                      f"parameters) from argument {diff}: "
                      f"{list(argtypes)[diff:diff + 3]} against "
                      f"{want[diff:diff + 3]}")

    # -- TL002 -------------------------------------------------------------
    def tl002(self):
        for m in self.config["mirrors"]:
            mod, src = self.find(self.py, m["py"]), self.find(self.cu,
                                                              m["cu"])
            if mod is None or src is None:
                continue
            where = f"{m['py']} {m['name']} = {m['cu']} {m['expr']}"
            try:
                got = mod.eval(m["name"])
            except (_Unknown, KeyError, IndexError, TypeError) as e:
                self.notes.append(f"TL002 skipped {where} (Python side "
                                  f"does not evaluate: {e})")
                continue
            try:
                want = self._source_value(src, m, got)
            except _Unknown as e:
                self.notes.append(f"TL002 skipped {where} (source side "
                                  f"does not evaluate: {e})")
                continue
            if got != want:
                self.emit("TL002", mod.path, self._line(mod, m["name"]),
                          m["name"], f"is {got!r}; {src.path.name} has "
                          f"{m['expr']} = {want!r}")

    def _source_value(self, src, m, got):
        scope = Scope(src, src.scope)
        if m["bind"]:
            fn, callee, names = m["bind"]
            if fn not in src.externs:
                raise _Unknown(f"no extern \"C\" {fn}")
            calls = src.calls(src.externs[fn], callee)
            if len(calls) != 1:
                raise _Unknown(f"{len(calls)} calls of {callee} in {fn}")
            for name, arg in zip(names, calls[0]):
                scope.values[name] = src.scope.eval(arg)
        if m["over"]:
            if not isinstance(got, dict):
                raise _Unknown("the Python side is not a dict")
            out = {}
            for key in got:
                scope.values[m["over"]] = key
                out[key] = Scope(src, scope).eval(m["expr"])
            return out
        return scope.eval(m["expr"])

    def _line(self, mod, name):
        head = re.match(r"\(?\s*(\w+)", name).group(1)
        node = mod.assigned.get(head)
        return getattr(node, "lineno", 0)

    # -- TL003 -------------------------------------------------------------
    def tl003(self):
        exempt = {(c, k) for c, k, _ in self.config["tl003_exempt"]}
        for src in self.cu.values():
            helpers = {}
            for name, fns in src.functions.items():
                for fn in fns:
                    body = src.body(fn)
                    for ins in re.findall(r'"(cp\.async\.c[ag]\.shared'
                                          r'\.global[^"]*)"', body):
                        fill = re.search(r"\],\s*\[%\d+\],\s*\d+,\s*%\d+",
                                         ins)
                        helpers[name] = bool(fill)
            users = self._device_callers(src, helpers)
            for name, fns in src.functions.items():
                for fn in fns:
                    if not fn["global"]:
                        continue
                    bare = sorted(h for h in users.get(name, ())
                                  if not helpers[h])
                    if not bare:
                        continue
                    if any(src.path.as_posix().endswith(c) and k == name
                           for c, k in exempt):
                        continue
                    self.emit("TL003", src.path, fn["line"], name,
                              f"uses cp.async helper(s) {bare} without the "
                              "src-size (zero-fill) operand: a copy past "
                              "the end of K reads garbage into the tile; "
                              "zero-fill, or list the kernel in "
                              "tl003_exempt with how it masks")

    def _device_callers(self, src, helpers):
        """{function: cp.async helpers it reaches through calls}."""
        reach = {}
        names = list(src.functions)
        for name in names:
            body = "".join(src.body(fn) for fn in src.functions[name])
            reach[name] = {h for h in helpers
                           if h != name and re.search(rf"\b{h}\s*[(<]",
                                                      body)}
            reach[name] |= {f for f in names if f != name and f not in
                            helpers and re.search(rf"\b{f}\s*[(<]", body)
                            and any(x["device"] for x in src.functions[f])}
        changed = True
        while changed:
            changed = False
            for name, got in reach.items():
                more = set().union(*(reach[f] for f in got
                                     if f in reach)) - got
                if more:
                    got |= more
                    changed = True
        return {n: {h for h in r if h in helpers} for n, r in reach.items()}

    # -- TL004 -------------------------------------------------------------
    def tl004(self):
        for src in self.cu.values():
            for fns in src.functions.values():
                for fn in fns:
                    for site in self._launch_sites(src, fn):
                        self._check_site(src, fn, site)

    def _launch_sites(self, src, fn):
        """(kernel, its template argument texts, block text, dynamic
        smem text, offset) of each launch in ``fn``."""
        body, base = src.body(fn), fn["body"][0]
        for m in re.finditer(r"(\w+)\s*(?:<([^<>;]*)>)?\s*<<<", body):
            cfg = _split_top(body[m.end():body.index(">>>", m.end())])
            yield (m.group(1), _split_top(m.group(2) or ""), cfg[1],
                   cfg[2] if len(cfg) > 2 else "0", base + m.start())
        for m in re.finditer(r"cudaLaunchKernelEx\s*\(", body):
            args = _split_top(body[m.end():_match(body, m.end() - 1, "(",
                                                  ")") - 1])
            cfg = args[0].lstrip("&")
            kern = re.search(rf"\b{args[1]}\s*=\s*(\w+)\s*(?:<([^;]*)>)?"
                             r"\s*;", body)
            block = re.search(rf"\b{cfg}\.blockDim\s*=\s*([^;]+);", body)
            smem = re.search(rf"\b{cfg}\.dynamicSmemBytes\s*=\s*([^;]+);",
                             body)
            if kern and block:
                yield (kern.group(1), _split_top(kern.group(2) or ""),
                       block.group(1), smem.group(1) if smem else "0",
                       base + m.start())
            else:
                self.notes.append(
                    f"{src.path}:{src.line(base + m.start())}: TL004 "
                    "skipped a cudaLaunchKernelEx whose kernel or blockDim "
                    "is not assigned in the same function")

    def _check_site(self, src, fn, site):
        """The site's block against its kernel's launch bounds, and its
        dynamic shared memory where it opts in to no more than 48 KB, at
        each instantiation of ``fn``; the worst instantiation is
        reported."""
        kernel, targs, block, smem, offset = site
        line, where = src.line(offset), f"{src.path}:{src.line(offset)}"
        kfn = next((k for k in src.functions.get(kernel, [])
                    if k["global"]), None)
        opted = "cudaFuncSetAttribute" in src.body(fn)
        guard = re.search(rf"if\s*\(\s*{re.escape(smem.strip())}\s*>\s*"
                          r"(\w+)\s*\)\s*return", src.body(fn))
        worst = {}  # what -> (excess, message)
        try:
            if kfn is None:
                raise _Unknown(f"no __global__ {kernel}")
            bindings = src.instantiations(fn)
            if not bindings:
                raise _Unknown(f"no instantiation of {fn['name']}")
            for binding in bindings:
                scope = src.function_scope(fn, binding)
                at = ", ".join(f"{k}={v}" for k, v in binding.items())
                at = f" at {fn['name']}<{at}>" if at else ""
                dims = re.fullmatch(r"\s*dim3\s*\((.*)\)\s*", block, re.S)
                threads = 1
                for d in _split_top(dims.group(1)) if dims else [block]:
                    threads *= scope.eval(d)
                if kfn["bounds"]:
                    kscope = Scope(src, src.scope)
                    kscope.values.update(
                        (p, scope.argument(a, p in kfn["types"]))
                        for p, a in zip(kfn["template"], targs))
                    bound = kscope.eval(kfn["bounds"][0])
                    msg = (f"launches {kernel} with a block of "
                           f"{block.strip()} threads, {threads - bound} "
                           f"over its __launch_bounds__({kfn['bounds'][0]})"
                           f"{at}")
                else:
                    bound = MAX_THREADS
                    msg = (f"launches {kernel} with {block.strip()} threads"
                           f"{at}, over the {MAX_THREADS} a block may have")
                worst["bounds"] = max(worst.get("bounds", (0, "")),
                                      (threads - bound, msg))
                if opted:
                    continue  # the ladder check of the plans bounds it
                scope.values.update(LAUNCH_ARGS)
                nbytes = scope.eval(guard.group(1) if guard else smem)
                worst["smem"] = max(worst.get("smem", (0, "")), (
                    nbytes - UNOPTED_SMEM_BYTES,
                    f"launches {kernel} with up to {nbytes} bytes of "
                    f"dynamic shared memory and no opt-in attribute "
                    f"(limit {UNOPTED_SMEM_BYTES}){at}"))
        except _Unknown as e:
            self.notes.append(f"{where}: TL004 launch of {kernel} "
                              f"undecided ({e})")
            return
        for excess, msg in worst.values():
            if excess > 0:
                self.emit("TL004", src.path, line, fn["name"], msg)

    # -- the plan functions over the ladder (TL002 clusters, TL004 bytes) --
    def plans(self):
        dirs = {p.parents[2] for p in self.cu if len(p.parents) > 2}
        here = _import_port(dirs)
        if dirs and here not in {d.resolve() for d in dirs}:
            self.notes.append(
                f"TL002/TL004 plans ran the repro_torch of {here}, not the "
                f"linted {', '.join(sorted(map(str, dirs)))}")
        from repro_torch.analysis import contracts

        ladder = self.config["ladder"]
        limit = contracts.SMEM_LIMIT_BYTES
        checks = ((MM_PY, MM_CU, self._matmul_plans),
                  (PA_PY, PA_CU, self._attention_plans),
                  (CV_PY, CV_CU, self._conv_plans))
        for py_suffix, cu_suffix, fn in checks:
            mod, src = self.find(self.py, py_suffix), self.find(self.cu,
                                                                cu_suffix)
            if mod is None or src is None:
                continue
            try:
                splits_max = src.scope.lookup("MAX_SPLITS")
            except _Unknown as e:
                self.notes.append(f"{src.path}: TL002 cluster bound "
                                  f"skipped (MAX_SPLITS: {e})")
                continue
            worst = {}  # rule -> (excess, plan function, shape, what)
            for rule, excess, plan_fn, shape, what in fn(ladder, src,
                                                         splits_max, limit):
                if excess > 0 and excess > worst.get(rule, (0,))[0]:
                    worst[rule] = (excess, plan_fn, shape, what)
            for rule, (_, plan_fn, shape, what) in sorted(worst.items()):
                self.emit(rule, mod.path, 0, plan_fn,
                          f"at {shape}: {what} (worst over the ladder)")

    def _matmul_plans(self, ladder, src, splits_max, limit):
        from repro_torch.analysis import contracts
        from repro_torch.kernels import samd_matmul as mm

        for m, k, n, vpw in itertools.product(
                ladder["matmul_m"], ladder["matmul_k"], ladder["matmul_n"],
                ladder["vpw"]):
            splits, _ = mm.split_k(m, n, k, vpw)
            shape = dict(m=m, n=n, k=k, vpw=vpw)
            yield ("TL002", splits - splits_max, "split_k", shape,
                   f"{splits} splits, over MAX_SPLITS = {splits_max}")
            launcher = mm.launcher_for(m)
            b = contracts.matmul_smem_bytes(launcher, m, vpw, splits)
            yield ("TL004", b - limit, "matmul_smem_bytes", shape,
                   f"{launcher} takes {b} bytes of shared memory, over "
                   f"{limit}")

    def _attention_plans(self, ladder, src, splits_max, limit):
        from repro_torch.kernels import paged_attention as pa

        for b, hkv, g, dh, n_pp, ps, (s, r), packed in itertools.product(
                ladder["attn_b"], ladder["attn_hkv"], ladder["attn_g"],
                ladder["attn_dh"], ladder["attn_n_pp"], ladder["attn_ps"],
                ladder["attn_s_r"], (False, True)):
            if packed and dh % 4:
                continue
            plan = pa.attention_plan(b, hkv, s * g, dh, n_pp, ps, s, r,
                                     packed)
            shape = dict(b=b, hkv=hkv, rows=s * g, dh=dh, n_pp=n_pp, ps=ps,
                         s=s, r=r, packed=packed)
            yield ("TL002", plan.splits - splits_max, "attention_plan",
                   shape, f"{plan.splits} splits, over MAX_SPLITS = "
                   f"{splits_max}")
            nb = pa.block_smem(plan.rt, dh, ps, n_pp, s, r, packed)
            yield ("TL004", nb - limit, "block_smem", shape,
                   f"a block takes {nb} bytes of shared memory, over "
                   f"{limit}")

    def _conv_plans(self, ladder, src, splits_max, limit):
        from repro_torch.analysis import contracts
        from repro_torch.configs.vggb import VGGB_LAYERS
        from repro_torch.core.conv import make_plan
        from repro_torch.kernels import samd_conv as cv

        for (name, c_in, c_out, h, w), vpw, x_bf16, launcher in \
                itertools.product(VGGB_LAYERS, ladder["vpw"], (False, True),
                                  (None, cv.DIRECT, cv.IM2COL)):
            cw = -(-c_in // vpw)
            plan = cv.conv2d_plan(c_in, cw, h, w, 3, 3, c_out, 1, vpw,
                                  x_bf16, launcher)
            shape = dict(layer=name, vpw=vpw, x_bf16=x_bf16,
                         launcher=plan.launcher)
            yield ("TL002", plan.splits - splits_max, "conv2d_plan", shape,
                   f"{plan.splits} splits, over MAX_SPLITS = {splits_max}")
            for wide in (False, True) if vpw <= 3 else (False,):
                nb = contracts.conv2d_smem_bytes(plan, vpw, wide)
                yield ("TL004", nb - limit, "conv2d_smem_bytes",
                       dict(shape, wide=wide), f"a block takes {nb} bytes "
                       f"of shared memory, over {limit}")
        try:
            c1d = src.scope.lookup("C1D_MAX_SMEM")
        except _Unknown as e:
            self.notes.append(f"{src.path}: TL004 conv1d skipped "
                              f"(C1D_MAX_SMEM: {e})")
            return
        for n, bits, taps, signed, dtype in itertools.product(
                ladder["conv1d_n"], ladder["conv1d_bits"],
                ladder["conv1d_taps"], (True, False), cv.INT_CODES):
            try:
                plan = make_plan(bits, taps, signed)
                plan.validate()
            except ValueError:
                continue
            p = cv.conv1d_plan(n, plan, dtype)
            nb = contracts.conv1d_smem_bytes(p, dtype.itemsize)
            yield ("TL004", nb - c1d, "conv1d_smem_bytes",
                   dict(n=n, bits=bits, taps=taps, signed=signed,
                        dtype=str(dtype)), f"a block takes {nb} bytes, over "
                   f"C1D_MAX_SMEM = {c1d} (launched with no opt-in)")

    # -- TL005 -------------------------------------------------------------
    def tl005(self):
        for mod in self.py.values():
            parents = {c: p for p in ast.walk(mod.tree)
                       for c in ast.iter_child_nodes(p)}
            for n in ast.walk(mod.tree):
                f = getattr(n, "func", None)
                if not (isinstance(n, ast.Call) and (
                        getattr(f, "attr", None) == "unpack_lanes_wide"
                        or getattr(f, "id", None) == "unpack_lanes_wide")):
                    continue
                scope = parents.get(n)
                while scope is not None and not isinstance(
                        scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope = parents.get(scope)
                name = getattr(scope, "name", "<module>")
                if name == "unpack_signed_product" or (
                        scope is not None
                        and "correct_signed_product" in _call_names(scope)):
                    continue
                self.emit("TL005", mod.path, n.lineno, name,
                          "raw unpack_lanes_wide without "
                          "correct_signed_product in scope: signed product "
                          "lanes above a negative lane read off by one "
                          "(Fig. 12); route through unpack_signed_product")


def _import_port(package_dirs=()):
    """Import ``repro_torch``: where no copy is imported yet, from the
    linted package (one of ``package_dirs``), else from this checkout's
    ``src``. Returns the directory it was imported from."""
    if "repro_torch" not in sys.modules:
        for d in [*sorted(package_dirs), REPO_ROOT / "src" / "repro_torch"]:
            if d.name == "repro_torch" and (d / "__init__.py").exists():
                sys.path.insert(0, str(d.parent))
                break
    import repro_torch

    return Path(repro_torch.__file__).resolve().parent


def lint_paths(paths: list[Path], config: dict):
    """(violations, notes) of the ``.py`` files and ``kernels/csrc/*.cu``
    sources under ``paths``."""
    violations, py, cu = [], {}, {}
    files = []
    for p in map(Path, paths):
        files.extend(sorted(p.rglob("*.py")) + sorted(p.rglob("*.cu"))
                     if p.is_dir() else [p])
    for f in files:
        if f.suffix == ".cu":
            cu[f] = CudaSource(f)
            continue
        try:
            py[f] = PyModule(f, ast.parse(f.read_text(), filename=str(f)))
        except SyntaxError as e:
            violations.append(Violation("TL000", str(f), e.lineno or 0,
                                        "<parse>", f"syntax error: {e.msg}"))
    lint = _Lint(py, cu, config)
    lint.violations.extend(violations)
    for rule in (lint.tl001, lint.tl002, lint.tl003, lint.tl004, lint.plans,
                 lint.tl005):
        rule()
    return lint.violations, lint.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SAMD contract lint for the port's CUDA kernels")
    ap.add_argument("paths", nargs="*", type=Path,
                    default=[REPO_ROOT / "src" / "repro_torch"])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--config", type=Path, default=None,
                    help="JSON overriding DEFAULT_CONFIG keys")
    ap.add_argument(
        "--certify", type=Path, metavar="BENCH_JSON", default=None,
        help="also run the repro_torch.analysis.certify sweep against "
             "this serving artifact")
    args = ap.parse_args(argv)
    missing = [str(p) for p in args.paths if not p.exists()]
    if missing:
        ap.error(f"no such path: {', '.join(missing)}")

    config = dict(DEFAULT_CONFIG)
    if args.config:
        config.update(json.loads(args.config.read_text()))

    violations, notes = lint_paths(args.paths, config)

    if args.certify is not None:
        _import_port()
        from repro_torch.analysis import certify

        entries, _ = certify.run(args.certify)
        for e in entries:
            if e["status"] != "safe":
                violations.append(
                    Violation("CERT001", str(args.certify), 0,
                              e["config"], e["detail"] or e["status"]))
        notes.append(f"certify: {len(entries)} configurations checked")

    if args.json:
        json.dump({"violations": [v.to_dict() for v in violations],
                   "notes": notes}, sys.stdout, indent=1)
        print()
    else:
        for v in violations:
            print(v)
        for n in notes:
            print(f"note: {n}", file=sys.stderr)
        print(f"samd-lint-torch: {len(violations)} violation(s)",
              file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
