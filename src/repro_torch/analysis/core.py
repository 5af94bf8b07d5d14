"""The port's static-analysis framework, its own copy of the reference's.

The port's correctness rests on contracts that no generic linter reads and
that fail only on the card, or not visibly at all: a ctypes ``argtypes``
list that drifts from its ``extern "C"`` signature, a block size above a
kernel's ``__launch_bounds__``, dynamic shared memory above 48 KiB without
its opt-in, a launch error that never reaches the wrapper, a host sync or
a clock read inside a CUDA-graph capture. This module is the machinery the
rule packs share:

  * ``Rule`` / ``@register`` — a registry of rules, each with a stable id
    (``PR01`` ... ``CG03``), grouped into packs (``protocol``,
    ``wrappers``, ``cuda``, ``capture``), each reading Python (``.py``) or
    CUDA C++ (``.cu``) files;
  * ``FileContext`` — one parsed Python file: source, AST, per-line
    ``# repro: noqa[RULE]`` suppressions and a constant folder seeded with
    its module-level numbers;
  * ``CudaContext`` — one ``.cu`` file: the source with comments stripped,
    its tokens, per-line ``// repro: noqa[RULE]`` suppressions, its
    functions, and a folder of its namespace-level ``constexpr`` integer
    bindings (``kThreads = 256``, ``kSmemBytes = kRingBytes + 128``).
    Anything that depends on a template parameter (``L::kSmem``,
    ``Layout<T>::kBytes``, ``smem_bytes<D>()``) folds to None: a rule then
    skips its numeric part and never guesses;
  * ``analyze_paths`` / ``main`` — directory traversal (fixtures under
    ``analysis_fixtures`` and generated ``build`` trees are left out of
    walks but analysable by explicit path), human and JSON output, exit
    code 1 exactly when findings remain.

Suppression syntax, on the offending line or on comment-only lines
immediately above it (the same as the reference's, so that one suppression
serves both analyzers on the shared protocol rules)::

    x = something_flagged()  # repro: noqa[CG01] reason why this is safe
    kernel<<<g, b, n, s>>>(...);  // repro: noqa[CU03] reason

Multiple ids separate with commas; the reason is free-form but required by
convention. Nothing here imports the port, the reference or JAX: every
file is read as text.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

NOQA_RE = re.compile(r"(?:#|//)\s*repro:\s*noqa\[([A-Za-z0-9_,\s]+)\]")

# directories never entered during tree walks (fixture snippets deliberately
# violate the rules; kernels' generated build trees are not sources); explicit
# file arguments bypass this
DEFAULT_EXCLUDED_DIRS = {"analysis_fixtures", "__pycache__", ".git", "build"}

REPO_ROOT = Path(__file__).resolve().parents[3]
# what ``python -m repro_torch.analysis`` reads with no paths: the port's tree,
# relative to the repository root (globs allowed)
PORT_TREE = (
    "src/repro_torch",
    "chip_smoke.py",
    "tests/test_torch_*.py",
    "tests/torch_*.py",
    "aggregate_variants.py",
    "decode_variants.py",
    "flash_variants.py",
    "scan_variants.py",
    "recurrent_ab.py",
    "train_depth_probe.py",
)
SOURCE_SUFFIXES = (".py", ".cu")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _noqa_lines(lines: Sequence[str]) -> Dict[int, set]:
    """line -> the rule ids suppressed there (upper-cased)."""
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = NOQA_RE.search(line)
        if m:
            out[i] = {s.strip().upper() for s in m.group(1).split(",") if s.strip()}
    return out


class _Suppressions:
    """The noqa lookup both contexts share: the finding's line, or the
    comment-only lines immediately above it (the only readable placement
    inside a multi-line construct)."""

    lines: List[str]
    noqa: Dict[int, set]
    comment_prefix: str

    def _noqa_matches(self, line: int, rule: str) -> bool:
        ids = self.noqa.get(line)
        return bool(ids) and (rule in ids or "ALL" in ids)

    def suppressed(self, finding: Finding) -> bool:
        rule = finding.rule.upper()
        if self._noqa_matches(finding.line, rule):
            return True
        i = finding.line - 1
        while 1 <= i <= len(self.lines) and self.lines[i - 1].lstrip().startswith(
            self.comment_prefix
        ):
            if self._noqa_matches(i, rule):
                return True
            i -= 1
        return False


class ConstEnv:
    """Best-effort constant folding over a module's top-level bindings.

    Resolves integer/float expressions built from literals, previously
    resolved module constants, and ``+ - * // % **`` / unary minus. Anything
    else (function parameters, shapes, calls) folds to None — rules must
    treat None as "unknown, skip the numeric part of the check" so the
    analyzer never guesses.
    """

    def __init__(self, tree: ast.Module):
        self.values: Dict[str, float] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    val = self.fold(node.value)
                    if val is not None:
                        self.values[tgt.id] = val

    def fold(self, node: ast.AST, local: Optional[Dict[str, float]] = None):
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            if isinstance(node.value, bool):
                return None
            return node.value
        if isinstance(node, ast.Name):
            if local and node.id in local:
                return local[node.id]
            return self.values.get(node.id)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = self.fold(node.operand, local)
            return None if v is None else -v
        if isinstance(node, ast.BinOp):
            lhs = self.fold(node.left, local)
            rhs = self.fold(node.right, local)
            if lhs is None or rhs is None:
                return None
            ops = {
                ast.Add: lambda a, b: a + b,
                ast.Sub: lambda a, b: a - b,
                ast.Mult: lambda a, b: a * b,
                ast.FloorDiv: lambda a, b: a // b,
                ast.Div: lambda a, b: a / b,
                ast.Mod: lambda a, b: a % b,
                ast.Pow: lambda a, b: a**b,
            }
            op = ops.get(type(node.op))
            try:
                return None if op is None else op(lhs, rhs)
            except (ZeroDivisionError, OverflowError, ValueError):
                return None
        return None


class FileContext(_Suppressions):
    """One Python source file as seen by every Python rule."""

    kind = "py"
    comment_prefix = "#"

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.consts = ConstEnv(tree)
        self.noqa = _noqa_lines(self.lines)
        # every node once (rules filter this list rather than walk the tree
        # again), and parent links to find enclosing functions
        self.nodes: List[ast.AST] = [tree]
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:  # grows as it goes: one breadth-first pass
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
                self.nodes.append(child)
        self._imports: Optional[Dict[str, str]] = None

    @property
    def imports(self) -> Dict[str, str]:
        """``imported_names`` of the module, computed once."""
        if self._imports is None:
            self._imports = imported_names(self.tree, self.nodes)
        return self._imports

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parent(cur)
        return None


# ---------------------------------------------------------------------------
# CUDA C++: comments, tokens, scopes, constant folding
# ---------------------------------------------------------------------------

_CPP_TOKEN = re.compile(
    r"""(?P<num>0[xX][0-9a-fA-F']+[uUlL]*|\d[\d']*(?:\.\d*)?(?:[eE][+-]?\d+)?[uUlLfF]*)
      |(?P<id>[A-Za-z_]\w*)
      |(?P<str>"(?:\\.|[^"\\\n])*"|'(?:\\.|[^'\\\n])*')
      |(?P<op><<<|>>>|<<=|>>=|<<|>>|::|->|\+\+|--|&&|\|\||[-+*/%&|^<>=!]=|[-+*/%&|^~!<>=?:;,.(){}\[\]])
    """,
    re.X,
)


def strip_comments(source: str) -> str:
    """``source`` with its ``//`` and ``/* */`` comments and its preprocessor
    lines blanked to spaces, newlines kept (so line numbers hold); string
    and character literals stay as they are."""
    out: List[str] = []
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if c == "/" and source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif c == "/" and source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " " for ch in source[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            out.append(source[i : j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    code = "".join(out)
    # preprocessor directives (#include, #pragma unroll, ...) carry no C++ tokens
    return re.sub(r"(?m)^[ \t]*#.*$", lambda m: " " * len(m.group(0)), code)


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # num | id | str | op
    text: str
    line: int


def tokenize(code: str) -> List[Token]:
    """The tokens of comment-stripped C++ ``code``, each with its line."""
    tokens: List[Token] = []
    line, last = 1, 0
    for m in _CPP_TOKEN.finditer(code):
        line += code.count("\n", last, m.start())
        last = m.start()
        tokens.append(Token(m.lastgroup, m.group(0), line))
    return tokens


def matching(tokens: Sequence[Token], i: int) -> int:
    """Index of the bracket that closes the one at ``i`` (``(``, ``[``,
    ``{`` or ``<<<``); -1 when it never closes."""
    pairs = {"(": ")", "[": "]", "{": "}", "<<<": ">>>"}
    opener = tokens[i].text
    closer = pairs[opener]
    depth = 0
    for j in range(i, len(tokens)):
        t = tokens[j].text
        if t == opener:
            depth += 1
        elif t == closer:
            depth -= 1
            if depth == 0:
                return j
    return -1


_TEMPLATE_ARG_TOKENS = {",", "::", "*", "&", "<", ">"}


def template_close(tokens: Sequence[Token], i: int) -> int:
    """Index of the ``>`` closing a template argument list that opens with
    the ``<`` at ``i`` after a name (``k<T, D>``); -1 where the ``<`` is not
    one (its span holds anything but names, numbers, ``,``, ``::``, ``*``,
    ``&`` and nested brackets)."""
    if i == 0 or tokens[i - 1].kind != "id":
        return -1
    depth = 0
    for j in range(i, len(tokens)):
        t = tokens[j]
        if t.text == "<":
            depth += 1
        elif t.text == ">":
            depth -= 1
            if depth == 0:
                return j
        elif t.kind not in ("id", "num") and t.text not in _TEMPLATE_ARG_TOKENS:
            return -1
    return -1


def split_args(tokens: Sequence[Token]) -> List[List[Token]]:
    """Comma-separated arguments of a bracketed list's inside, split at
    depth 0 of ``()``, ``[]``, ``{}`` and template argument lists."""
    args: List[List[Token]] = [[]]
    depth, i = 0, 0
    while i < len(tokens):
        t = tokens[i]
        if t.text == "<" and depth == 0 and template_close(tokens, i) >= 0:
            close = template_close(tokens, i)
            args[-1].extend(tokens[i : close + 1])
            i = close + 1
            continue
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        if t.text == "," and depth == 0:
            args.append([])
        else:
            args[-1].append(t)
        i += 1
    return [] if args == [[]] else args


def text_of(tokens: Sequence[Token]) -> str:
    """The tokens joined without spaces: a normalised spelling to compare."""
    return "".join(t.text for t in tokens)


# byte sizes of the scalar and vector types a kernel's shared arrays use
TYPE_BYTES = {
    "char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1,
    "short": 2, "int16_t": 2, "uint16_t": 2, "__nv_bfloat16": 2, "__half": 2, "half": 2,
    "int": 4, "unsigned": 4, "int32_t": 4, "uint32_t": 4, "float": 4,
    "int64_t": 8, "uint64_t": 8, "double": 8, "long": 8, "size_t": 8,
    "float2": 8, "int2": 8, "uint2": 8,
    "float4": 16, "int4": 16, "uint4": 16,
}
INTEGRAL_TYPES = {
    "int", "unsigned", "long", "short", "size_t",
    "int8_t", "uint8_t", "int16_t", "uint16_t", "int32_t", "uint32_t", "int64_t", "uint64_t",
}
_QUALIFIERS = {"const", "volatile", "signed", "unsigned", "struct"}


def type_bytes(type_tokens: Sequence[Token]) -> Optional[int]:
    """Size of a spelled type (``unsigned char``, ``const float``), None for
    anything else (a template parameter, a struct)."""
    words = [t.text for t in type_tokens if t.kind == "id"]
    core = [w for w in words if w not in _QUALIFIERS] or (["unsigned"] if "unsigned" in words
                                                           else [])
    if len(core) != 1 or len(words) != len(type_tokens):
        return None
    return TYPE_BYTES.get(core[0])


class _Unresolved(Exception):
    pass


class CppFolder:
    """Integer constant folding over C++ expression tokens: literals,
    names bound in ``env``, ``( )``, unary ``- + ~``, ``* / % + - << >> & ^
    |``, ``static_cast<integral>(x)`` and ``sizeof(type)`` of a spelled
    type. Anything else (a template parameter, ``L::kSmem``, a call, a
    comparison) folds to None."""

    def __init__(self, env: Dict[str, int]):
        self.env = env

    def fold(self, tokens: Sequence[Token]) -> Optional[int]:
        self.toks, self.i = list(tokens), 0
        if not self.toks:
            return None
        try:
            val = self._binary(0)
        except (_Unresolved, IndexError, ZeroDivisionError):
            return None
        return val if self.i == len(self.toks) else None

    _PREC = {"|": 1, "^": 2, "&": 3, "<<": 4, ">>": 4, "+": 5, "-": 5, "*": 6, "/": 6, "%": 6}

    def _peek(self) -> Optional[str]:
        return self.toks[self.i].text if self.i < len(self.toks) else None

    def _take(self, text: str) -> None:
        if self._peek() != text:
            raise _Unresolved(text)
        self.i += 1

    def _binary(self, min_prec: int) -> int:
        lhs = self._unary()
        while self._peek() in self._PREC and self._PREC[self._peek()] > min_prec:
            op = self._peek()
            self.i += 1
            rhs = self._binary(self._PREC[op])
            lhs = self._apply(op, lhs, rhs)
        return lhs

    @staticmethod
    def _apply(op: str, a: int, b: int) -> int:
        if op in "/%":
            q = abs(a) // abs(b) * (1 if (a >= 0) == (b >= 0) else -1)  # C++ truncates
            return q if op == "/" else a - q * b
        return {
            "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
            "<<": lambda: a << b, ">>": lambda: a >> b,
            "&": lambda: a & b, "^": lambda: a ^ b, "|": lambda: a | b,
        }[op]()

    def _unary(self) -> int:
        t = self._peek()
        if t in ("-", "+", "~"):
            self.i += 1
            v = self._unary()
            return -v if t == "-" else ~v if t == "~" else v
        return self._primary()

    def _primary(self) -> int:
        tok = self.toks[self.i]
        if tok.text == "(":
            self.i += 1
            v = self._binary(0)
            self._take(")")
            return v
        if tok.kind == "num":
            self.i += 1
            text = tok.text.replace("'", "").rstrip("uUlL")
            if "." in text or (("e" in text or "E" in text) and not text.lower().startswith("0x")):
                raise _Unresolved(tok.text)
            return int(text, 0) if not re.fullmatch(r"0\d+", text) else int(text, 8)
        if tok.text == "static_cast":
            self.i += 1
            self._take("<")
            start = self.i
            while self._peek() != ">":
                self.i += 1
            if not {t.text for t in self.toks[start : self.i]} <= INTEGRAL_TYPES | {"const"}:
                raise _Unresolved("static_cast to a non-integral type")
            self._take(">")
            self._take("(")
            v = self._binary(0)
            self._take(")")
            return v
        if tok.text == "sizeof":
            self.i += 1
            self._take("(")
            start = self.i
            while self._peek() != ")":
                self.i += 1
            size = type_bytes(self.toks[start : self.i])
            self._take(")")
            if size is None:
                raise _Unresolved("sizeof of an unknown type")
            return size
        if tok.kind == "id" and tok.text in self.env:
            self.i += 1
            if self._peek() in ("(", "<", "::", "["):
                raise _Unresolved(tok.text)
            return self.env[tok.text]
        raise _Unresolved(tok.text)


@dataclasses.dataclass
class CppFunction:
    """A function defined at namespace or class scope: its name, its head
    (the tokens from the previous statement's end to its ``{``), and its
    body's token range (exclusive of the braces)."""

    name: str
    head: List[Token]
    body_start: int
    body_end: int
    line: int

    @property
    def is_kernel(self) -> bool:
        return any(t.text == "__global__" for t in self.head)

    @property
    def is_device(self) -> bool:
        return any(t.text == "__device__" for t in self.head) and not self.is_kernel


def _constexpr_bindings(tokens: Sequence[Token], env: Dict[str, int]) -> Dict[str, int]:
    """Fold the integer ``[static] constexpr <integral type> NAME = expr;``
    statements among ``tokens`` (one statement each) in order into ``env``
    (which is returned, extended)."""
    i = 0
    while i < len(tokens):
        if tokens[i].text != "constexpr":
            i += 1
            continue
        j = i + 1
        while j < len(tokens) and tokens[j].text in INTEGRAL_TYPES | {"const"}:
            j += 1
        end = j
        while end < len(tokens) and tokens[end].text != ";":
            end += 1
        if (
            j > i + 1
            and j + 1 < len(tokens)
            and tokens[j].kind == "id"
            and tokens[j + 1].text == "="
        ):
            val = CppFolder(env).fold(tokens[j + 2 : end])
            if val is not None:
                env[tokens[j].text] = val
        i = end + 1
    return env


class CudaContext(_Suppressions):
    """One ``.cu`` file as seen by every CUDA rule: ``code`` is the source
    with comments and preprocessor lines blanked; ``functions`` the
    functions defined at namespace or class scope; ``consts`` the
    namespace-level integer ``constexpr`` bindings folded (a struct's
    ``static constexpr`` members, whose values depend on its template
    parameters, are not among them)."""

    kind = "cu"
    comment_prefix = "//"

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.noqa = _noqa_lines(self.lines)
        self.code = strip_comments(source)
        self.tokens = tokenize(self.code)
        self.functions: List[CppFunction] = []
        self.consts: Dict[str, int] = {}
        self._scan_scopes()

    def _scan_scopes(self) -> None:
        """One pass over the braces: namespace and ``extern "C"`` blocks keep
        namespace scope; a brace whose head ends in ``)`` (or ``) const``)
        at namespace or class scope opens a function body. Namespace-scope
        statements feed the constant folder."""
        toks = self.tokens
        stack: List[str] = []  # scope kinds: namespace | type | function | block
        stmt_start = 0
        namespace_stmts: List[Token] = []
        i = 0
        while i < len(toks):
            t = toks[i].text
            at_ns = all(k == "namespace" for k in stack)
            if t == "{":
                head = toks[stmt_start:i]
                kind = self._brace_kind(head, stack)
                if kind == "function":
                    end = matching(toks, i)
                    if end < 0:
                        raise SyntaxError(f"unbalanced braces from line {toks[i].line}")
                    self.functions.append(
                        CppFunction(self._function_name(head), head, i + 1, end, toks[i].line)
                    )
                    i, stmt_start = end + 1, end + 1
                    continue
                stack.append(kind)
                stmt_start = i + 1
            elif t == "}":
                if not stack:
                    raise SyntaxError(f"unbalanced '}}' at line {toks[i].line}")
                stack.pop()
                stmt_start = i + 1
            elif t == ";":
                if at_ns:
                    namespace_stmts.extend(toks[stmt_start : i + 1])
                stmt_start = i + 1
            i += 1
        if stack:
            raise SyntaxError("unbalanced braces: a scope never closes")
        _constexpr_bindings(namespace_stmts, self.consts)

    @staticmethod
    def _brace_kind(head: Sequence[Token], stack: Sequence[str]) -> str:
        words = [t.text for t in head]
        if words[:1] == ["namespace"] or (words[:1] == ["extern"] and len(words) == 2):
            return "namespace"
        if not all(k in ("namespace", "type") for k in stack):
            return "block"
        tail = words[:]
        while tail and tail[-1] in ("const", "noexcept", "override"):
            tail.pop()
        depth, top = 0, []  # the head's words outside brackets
        for w in words:
            depth += w in ("(", "[")
            depth -= w in (")", "]")
            if depth == 0:
                top.append(w)
        if tail and tail[-1] == ")" and "=" not in top:
            return "function"
        if any(w in ("struct", "class", "union", "enum") for w in words):
            return "type"
        return "block"

    @staticmethod
    def _function_name(head: Sequence[Token]) -> str:
        close = max(i for i, t in enumerate(head) if t.text == ")")
        depth = 0
        for i in range(close, -1, -1):
            if head[i].text == ")":
                depth += 1
            elif head[i].text == "(":
                depth -= 1
                if depth == 0:
                    return head[i - 1].text if i > 0 else ""
        return ""

    def body(self, fn: CppFunction) -> List[Token]:
        return self.tokens[fn.body_start : fn.body_end]

    def local_env(self, fn: CppFunction) -> Dict[str, int]:
        """The file's constants plus the integer ``constexpr`` bindings of
        ``fn``'s body (``constexpr int elem = sizeof(T)`` folds to
        nothing: T is a template parameter)."""
        return _constexpr_bindings(self.body(fn), dict(self.consts))

    def fold(self, tokens: Sequence[Token], env: Optional[Dict[str, int]] = None):
        return CppFolder(self.consts if env is None else env).fold(tokens)


def extern_c_signatures(source: str) -> Dict[str, Tuple[str, List[str]]]:
    """``extern "C"`` functions of a CUDA source: name -> (return type, the
    parameters' type spellings, names dropped)."""
    toks = tokenize(strip_comments(source))
    out: Dict[str, Tuple[str, List[str]]] = {}
    for i, t in enumerate(toks):
        if not (t.text == "extern" and i + 1 < len(toks) and toks[i + 1].text == '"C"'):
            continue
        j = i + 2
        while j < len(toks) and toks[j].text != "(":
            j += 1
        if j >= len(toks) or toks[j - 1].kind != "id":
            continue
        name = toks[j - 1].text
        ret = " ".join(x.text for x in toks[i + 2 : j - 1])
        close = matching(toks, j)
        params = []
        for arg in split_args(toks[j + 1 : close]):
            spelled = [x.text for x in arg]
            if spelled == ["void"]:
                continue
            # drop the parameter's name: the last identifier after a type word
            if len(arg) > 1 and arg[-1].kind == "id":
                spelled = spelled[:-1]
            params.append(" ".join(spelled))
        out[name] = (ret, params)
    return out


# ---------------------------------------------------------------------------
# registry and driver
# ---------------------------------------------------------------------------


class Rule:
    """Base class: subclasses set ``id``/``pack``/``title`` (and ``kinds``,
    the file kinds they read: ``py``, ``cu``) and implement ``check``;
    register with :func:`register`."""

    id: str = ""
    pack: str = ""
    title: str = ""
    kinds: Tuple[str, ...] = ("py",)

    def check(self, ctx, options: "Options") -> Iterator[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class Options:
    """Knobs shared by the CLI and the test harness."""

    select: Optional[set] = None  # rule ids; None = all


_REGISTRY: Dict[str, Rule] = {}
PACKS = ("rules_protocol", "rules_wrappers", "rules_cuda", "rules_capture")


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> Dict[str, Rule]:
    _load_packs()
    return dict(_REGISTRY)


_PACKS_LOADED = False


def _load_packs() -> None:
    # import for the @register side effects; deferred so core can be imported
    # by the rule modules themselves without a cycle
    global _PACKS_LOADED
    if _PACKS_LOADED:
        return
    _PACKS_LOADED = True
    for pack in PACKS:
        importlib.import_module(f"repro_torch.analysis.{pack}")


def analyze_source(path: str, source: str, options: Optional[Options] = None) -> List[Finding]:
    """Analyze one file's source text (a ``.cu`` path is read as CUDA C++,
    anything else as Python); returns findings after noqa filtering. A file
    that does not parse is a single ``SYNTAX`` finding rather than a crash,
    so a broken file fails the gate visibly."""
    options = options or Options()
    try:
        if str(path).endswith(".cu"):
            ctx = CudaContext(path, source)
        else:
            ctx = FileContext(path, source, ast.parse(source, filename=path))
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 1, f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in all_rules().values():
        if ctx.kind not in rule.kinds or (options.select and rule.id not in options.select):
            continue
        for f in rule.check(ctx, options):
            if not ctx.suppressed(f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_file(path, options: Optional[Options] = None) -> List[Finding]:
    p = Path(path)
    return analyze_source(str(p), p.read_text(), options)


def default_paths(root: Path = REPO_ROOT) -> List[Path]:
    """The port's tree under ``root`` (``PORT_TREE``), the paths that exist."""
    out: List[Path] = []
    for pattern in PORT_TREE:
        out.extend(sorted(root.glob(pattern)))
    return out


def iter_source_files(paths: Sequence) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_file():
            yield p  # explicit files bypass the excludes (fixture tests rely on this)
        elif p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix in SOURCE_SUFFIXES and not DEFAULT_EXCLUDED_DIRS.intersection(
                    f.relative_to(p).parts
                ):
                    yield f
        else:
            raise FileNotFoundError(raw)


def analyze_paths(paths: Sequence, options: Optional[Options] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_source_files(paths):
        findings.extend(analyze_file(f, options))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static analysis: kernel wrappers' contracts, CUDA "
        "launch and ctypes contracts, CUDA-graph capture hygiene, protocol invariants.",
    )
    parser.add_argument(
        "paths", nargs="*", help="files or directories (default: the port's tree)"
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument(
        "--select", default=None, help="comma-separated rule ids to run (default: all)"
    )
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalogue")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{rule.id}  [{rule.pack}]  {rule.title}")
        return 0

    options = Options(
        select={s.strip().upper() for s in args.select.split(",")} if args.select else None,
    )
    paths = args.paths or default_paths()
    findings = analyze_paths(paths, options)
    if args.json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        n_files = sum(1 for _ in iter_source_files(paths))
        print(
            f"repro_torch.analysis: {len(findings)} finding(s) in {n_files} file(s)",
            file=sys.stderr,
        )
    return 1 if findings else 0


# ---------------------------------------------------------------------------
# shared AST helpers used by the Python rule packs
# ---------------------------------------------------------------------------


def posix(path: str) -> str:
    """``path`` with forward slashes: the tables' path suffixes match it."""
    return path.replace("\\", "/")


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' when not a
    plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def tail_name(node: ast.AST) -> str:
    """Last attribute segment: 'launch' for _build.launch, the id for a Name."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def imported_names(tree: ast.Module, nodes: Optional[Sequence[ast.AST]] = None) -> Dict[str, str]:
    """Local name -> the dotted name it was imported as, for every import
    of the module (at any depth): ``from a.b import c as d`` gives
    ``d -> a.b.c``, ``import a.b as e`` gives ``e -> a.b``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree) if nodes is None else nodes:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name if a.asname else a.name.split(".")[0]
    return out
