"""CUDA kernel and ctypes contracts (pack ``cuda``), the counterpart of the
reference's Pallas pack.

Every kernel of the port is a ``.cu`` file with a plain C interface, loaded
with ``ctypes`` by a wrapper module (``kernels/<name>/ops.py``). The
contracts between the two, and between a host launcher and its kernel,
are written by hand and fail only on the card:

  * **CU01, the ctypes ABI** (PL01's counterpart: arity) — each
    ``lib.<entry>.argtypes`` list must match the ``extern "C"`` signature
    of ``<entry>`` in the source the module's ``_SRC`` names, in length and
    kind. A missing or extra argument shifts every later one: the stream
    pointer lands in an ``int``.
  * **CU02, the block size** — the block of every ``<<<g, b, ...>>>`` (and
    every ``cfg.blockDim`` before a ``cudaLaunchKernelEx``) is the launched
    kernel's ``__launch_bounds__`` maximum or folds to no more than it, and
    to at most 1,024 threads: a larger block is refused at launch.
  * **CU03, dynamic shared memory** (PL04's counterpart: the VMEM budget)
    — a dynamic byte count above 48 KiB (or one that does not fold) needs
    ``cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
    ...)`` in the same host function; and dynamic plus the kernel's static
    ``__shared__`` bytes may not pass the H100's 227 KiB opt-in maximum a
    block.
  * **CU04, the launch's error** — ``_build.launch`` raises only on the
    entry point's return value, so each ``<<<...>>>`` is followed by a
    return of ``cudaGetLastError()`` and each ``cudaLaunchKernelEx`` result
    is checked before the function returns.

Numbers come from the file's ``constexpr`` folder (``core.CudaContext``);
what depends on a template parameter folds to None and the numeric part
of a check is skipped. ``kernel_facts`` exposes what the pack resolved, so
that a run on the card can hold it against what ``nvcc`` built.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.analysis.core import (
    CudaContext,
    CppFunction,
    FileContext,
    Finding,
    Options,
    Rule,
    Token,
    dotted_name,
    extern_c_signatures,
    matching,
    register,
    split_args,
    text_of,
    type_bytes,
)

MAX_BLOCK_THREADS = 1024
DEFAULT_DYNAMIC_SMEM = 48 * 1024  # above this a kernel must opt in
OPTIN_SMEM_PER_BLOCK = 232448  # the H100's opt-in maximum a block (227 KiB)


@dataclasses.dataclass
class Kernel:
    """A ``__global__`` function: its ``__launch_bounds__`` maximum (tokens,
    and folded) and its static ``__shared__`` bytes (None where a size
    depends on a template parameter)."""

    bounds_tokens: Optional[List[Token]]
    bounds: Optional[int]
    static_smem: Optional[int]


@dataclasses.dataclass
class Launch:
    """One launch in a host function: ``<<<...>>>`` or
    ``cudaLaunchKernelEx``."""

    kind: str  # chevron | ex
    host: CppFunction
    kernel: str  # the launched expression, aliases resolved, normalised
    block: Optional[List[Token]]
    smem: Optional[List[Token]]
    line: int
    end: int  # token index of the launch statement's ';'
    call: int  # token index of the launch's first token


def _base(kernel_text: str) -> str:
    return kernel_text.split("<", 1)[0]


def _static_smem(ctx: CudaContext, fn: CppFunction) -> Optional[int]:
    """The kernel body's own ``__shared__`` arrays, in bytes, laid out as
    ptxas lays them: each at its alignment (``__align__``, else its element
    size up to 16), and the total rounded up to 16 bytes where an ``extern
    __shared__`` (dynamic) array follows them. None when a type or a
    dimension does not fold."""
    body = ctx.body(fn)
    total, dynamic = 0, False
    for i, t in enumerate(body):
        if t.text != "__shared__":
            continue
        if i and body[i - 1].text == "extern":
            dynamic = True
            continue
        j, align = i + 1, None
        decl: List[Token] = []
        while j < len(body) and body[j].text != ";":
            if body[j].text == "__align__":
                close = matching(body, j + 1)
                align = ctx.fold(body[j + 2 : close])
                j = close + 1
                continue
            decl.append(body[j])
            j += 1
        first_dim = next((k for k, d in enumerate(decl) if d.text == "["), len(decl))
        type_toks, name = decl[: first_dim - 1], decl[first_dim - 1 : first_dim]
        elem = type_bytes(type_toks) if name else None
        size, k = elem, first_dim
        while size is not None and k < len(decl) and decl[k].text == "[":
            close = matching(decl, k)
            dim = ctx.fold(decl[k + 1 : close])
            size = None if dim is None else size * dim
            k = close + 1
        if size is None:
            return None
        align = align or min(elem, 16)
        total = -(-total // align) * align + size
    return -(-total // 16) * 16 if dynamic else total


def kernels(ctx: CudaContext) -> Dict[str, Kernel]:
    """The file's ``__global__`` functions by name."""
    cached = getattr(ctx, "_kernels", None)
    if cached is not None:
        return cached
    out: Dict[str, Kernel] = {}
    for fn in ctx.functions:
        if not fn.is_kernel:
            continue
        bounds_toks = None
        for i, t in enumerate(fn.head):
            if t.text == "__launch_bounds__":
                args = split_args(fn.head[i + 2 : matching(fn.head, i + 1)])
                bounds_toks = args[0] if args else None
        out.setdefault(fn.name, Kernel(
            bounds_toks, ctx.fold(bounds_toks) if bounds_toks else None, _static_smem(ctx, fn)
        ))
    ctx._kernels = out
    return out


def _aliases(body: Sequence[Token]) -> Dict[str, List[Token]]:
    """``auto NAME = <expr>;`` bindings of a host function body."""
    out: Dict[str, List[Token]] = {}
    for i, t in enumerate(body):
        if t.text == "auto" and i + 2 < len(body) and body[i + 2].text == "=":
            end = i + 3
            while end < len(body) and body[end].text != ";":
                end += 1
            out[body[i + 1].text] = list(body[i + 3 : end])
    return out


def _resolve(expr: Sequence[Token], aliases: Dict[str, List[Token]]) -> str:
    toks = list(expr)
    if len(toks) == 1 and toks[0].text in aliases:
        toks = aliases[toks[0].text]
    return text_of(toks)


def _kernel_before(toks: Sequence[Token], k: int) -> List[Token]:
    """The kernel expression ending just before index ``k`` (``<<<``): a
    name, or a name with template arguments."""
    j = k - 1
    if toks[j].text == ">":
        depth = 0
        while j >= 0:
            depth += toks[j].text == ">"
            depth -= toks[j].text == "<"
            if depth == 0:
                break
            j -= 1
        j -= 1
    return list(toks[j:k])


def _field_before(body: Sequence[Token], var: str, field: str, end: int) -> Optional[List[Token]]:
    """The value of the last ``var.field = <expr>;`` before index ``end``."""
    found = None
    for i in range(min(end, len(body)) - 3):
        if (body[i].text, body[i + 1].text, body[i + 2].text, body[i + 3].text) == (
            var, ".", field, "="
        ):
            j = i + 4
            while j < len(body) and body[j].text != ";":
                j += 1
            found = list(body[i + 4 : j])
    return found


def launches(ctx: CudaContext) -> List[Launch]:
    """Every kernel launch of the file's host functions."""
    cached = getattr(ctx, "_launches", None)
    if cached is not None:
        return cached
    out: List[Launch] = []
    toks = ctx.tokens
    for fn in ctx.functions:
        if fn.is_kernel or fn.is_device:
            continue
        body = ctx.body(fn)
        aliases = _aliases(body)
        for i in range(fn.body_start, fn.body_end):
            t = toks[i]
            if t.text == "<<<":
                close = matching(toks, i)
                args = split_args(toks[i + 1 : close])
                end = close
                while end < fn.body_end and toks[end].text != ";":
                    end += 1
                kexpr = _kernel_before(toks, i)
                out.append(Launch(
                    "chevron", fn, _resolve(kexpr, aliases), args[1] if len(args) > 1 else None,
                    args[2] if len(args) > 2 else None, t.line, end, i - len(kexpr),
                ))
            elif t.text == "cudaLaunchKernelEx" and toks[i + 1].text == "(":
                close = matching(toks, i + 1)
                args = split_args(toks[i + 2 : close])
                if len(args) < 2:
                    continue
                cfg = text_of([a for a in args[0] if a.text != "&"])
                rel = i - fn.body_start
                end = close
                while end < fn.body_end and toks[end].text != ";":
                    end += 1
                out.append(Launch(
                    "ex", fn, _resolve(args[1], aliases), _field_before(body, cfg, "blockDim", rel),
                    _field_before(body, cfg, "dynamicSmemBytes", rel), t.line, end, i,
                ))
    ctx._launches = out
    return out


def block_threads(ctx: CudaContext, block: Sequence[Token], env) -> Optional[int]:
    """Threads of a block expression: a folded number, or ``dim3(x[, y[,
    z]])`` folded to the product."""
    toks = list(block)
    if toks and toks[0].text == "dim3" and len(toks) > 1 and toks[1].text == "(":
        total = 1
        for arg in split_args(toks[2 : matching(toks, 1)]):
            v = ctx.fold(arg, env)
            if v is None:
                return None
            total *= v
        return total
    return ctx.fold(toks, env)


def _single_dim(block: Sequence[Token]) -> List[Token]:
    """``dim3(x)`` -> ``x``; anything else as it is."""
    toks = list(block)
    if toks and toks[0].text == "dim3" and toks[1].text == "(":
        args = split_args(toks[2 : matching(toks, 1)])
        if len(args) == 1:
            return args[0]
    return toks


def kernel_facts(ctx: CudaContext) -> Dict[str, dict]:
    """What the pack resolved of each kernel of the file: its folded
    ``__launch_bounds__`` threads, its static ``__shared__`` bytes, and the
    folded dynamic shared memory of each of its launches ("unresolved"
    where a figure depends on a template parameter)."""
    facts: Dict[str, dict] = {}
    for name, k in kernels(ctx).items():
        facts[name] = {
            "launch_bounds_threads": k.bounds if k.bounds is not None else "unresolved",
            "static_smem_bytes": k.static_smem if k.static_smem is not None else "unresolved",
            "dynamic_smem_bytes": [],
        }
    for ln in launches(ctx):
        entry = facts.get(_base(ln.kernel))
        if entry is None:
            continue
        dyn = 0 if ln.smem is None else ctx.fold(ln.smem, ctx.local_env(ln.host))
        entry["dynamic_smem_bytes"].append(dyn if dyn is not None else "unresolved")
    return facts


@register
class CtypesAbi(Rule):
    """CU01: every ``lib.<entry>.argtypes`` of a wrapper module equals, in
    length and kind, the ``extern "C"`` signature of ``<entry>`` in the
    source its ``_SRC`` names (pointers and ``cudaStream_t`` ->
    ``c_void_p``, ``int`` -> ``c_int``, ``int64_t`` -> ``c_int64``,
    ``float`` -> ``c_float``, ``double`` -> ``c_double``); ``restype`` is
    ``c_int`` for an ``int`` return; and every entry the module names has
    both declared."""

    id = "CU01"
    pack = "cuda"
    title = "ctypes argtypes/restype differ from the extern \"C\" signature"

    C_KINDS = {"int": "c_int", "int32_t": "c_int", "int64_t": "c_int64", "float": "c_float",
               "double": "c_double", "void": None}
    PY_KINDS = {"c_void_p": "c_void_p", "c_int": "c_int", "c_int32": "c_int",
                "c_int64": "c_int64", "c_longlong": "c_int64", "c_float": "c_float",
                "c_double": "c_double"}

    @classmethod
    def c_kind(cls, spelled: str) -> Optional[str]:
        words = [w for w in spelled.split() if w not in ("const", "volatile")]
        if "*" in words or words in (["cudaStream_t"], ["CUstream"]):
            return "c_void_p"
        return cls.C_KINDS.get(" ".join(words), "?")

    @staticmethod
    def source_of(ctx: FileContext) -> Optional[Path]:
        """The path ``_SRC = Path(__file__)[.resolve()].parent / "a" / "b.cu"``
        names, None where the module has no such binding."""
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "_SRC"):
                continue
            parts: List[str] = []
            cur = node.value
            while isinstance(cur, ast.BinOp) and isinstance(cur.op, ast.Div):
                if not (isinstance(cur.right, ast.Constant) and isinstance(cur.right.value, str)):
                    return None
                parts.append(cur.right.value)
                cur = cur.left
            ups = 0
            while isinstance(cur, ast.Attribute) and cur.attr == "parent":
                ups += 1
                cur = cur.value
            if (isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute)
                    and cur.func.attr == "resolve"):
                cur = cur.func.value
            if not (isinstance(cur, ast.Call) and dotted_name(cur.func) in ("Path", "pathlib.Path")
                    and len(cur.args) == 1 and isinstance(cur.args[0], ast.Name)
                    and cur.args[0].id == "__file__" and ups >= 1):
                return None
            base = Path(ctx.path).parent
            for _ in range(ups - 1):
                base = base.parent
            return base.joinpath(*reversed(parts))
        return None

    def _aliases(self, ctx: FileContext) -> Dict[str, str]:
        """Local names bound to ctypes types anywhere in the module
        (``ptr, i32 = ctypes.c_void_p, ctypes.c_int``)."""
        out: Dict[str, str] = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt, val = node.targets[0], node.value
            pairs = (zip(tgt.elts, val.elts)
                     if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                     and len(tgt.elts) == len(val.elts) else [(tgt, val)])
            for t, v in pairs:
                tail = dotted_name(v).rsplit(".", 1)[-1]
                if isinstance(t, ast.Name) and tail in self.PY_KINDS:
                    out[t.id] = tail
        return out

    def _kind(self, node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
        """The ctypes kind an alias or ``ctypes.c_x`` names, None for any
        other expression."""
        name = aliases.get(node.id) if isinstance(node, ast.Name) else None
        return self.PY_KINDS.get(name or dotted_name(node).rsplit(".", 1)[-1])

    def _kinds(self, node: ast.AST, aliases: Dict[str, str]) -> Optional[List[str]]:
        """The kinds of an argtypes list expression (literals, ``+``, ``*``
        by an int), None where any part is unknown."""
        if isinstance(node, (ast.List, ast.Tuple)):
            kinds = [self._kind(el, aliases) for el in node.elts]
            return None if None in kinds else kinds
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a, b = self._kinds(node.left, aliases), self._kinds(node.right, aliases)
            return None if a is None or b is None else a + b
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for lst, n in ((node.left, node.right), (node.right, node.left)):
                if isinstance(n, ast.Constant) and isinstance(n.value, int):
                    a = self._kinds(lst, aliases)
                    return None if a is None else a * n.value
        return None

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        src = self.source_of(ctx)
        if src is None:
            return
        if not src.is_file():
            yield Finding(self.id, ctx.path, 1, f"_SRC names {src.name}, which does not exist")
            return
        sigs = extern_c_signatures(src.read_text())
        aliases = self._aliases(ctx)
        declared: Dict[str, Dict[str, ast.AST]] = {}
        decl_nodes = set()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if (isinstance(tgt, ast.Attribute) and tgt.attr in ("argtypes", "restype")
                    and isinstance(tgt.value, ast.Attribute)):
                declared.setdefault(tgt.value.attr, {})[tgt.attr] = node
                decl_nodes.add(tgt.value)
        for entry, decl in sorted(declared.items()):
            if entry not in sigs:
                node = next(iter(decl.values()))
                yield Finding(self.id, ctx.path, node.lineno,
                              f"'{entry}' is not an extern \"C\" function of {src.name}")
                continue
            ret, params = sigs[entry]
            if "argtypes" in decl:
                node = decl["argtypes"]
                got = self._kinds(node.value, aliases)
                want = [self.c_kind(p) for p in params]
                if got is not None and len(got) != len(want):
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"{entry}.argtypes has {len(got)} entries; {src.name} takes "
                                  f"{len(want)} arguments")
                elif got is not None:
                    bad = [f"#{i} {g} for '{p}'" for i, (g, w, p) in
                           enumerate(zip(got, want, params)) if w != "?" and g != w]
                    if bad:
                        yield Finding(self.id, ctx.path, node.lineno,
                                      f"{entry}.argtypes differ from {src.name}: " + ", ".join(bad))
            if "restype" in decl:
                node = decl["restype"]
                want_ret = self.c_kind(ret)
                void = isinstance(node.value, ast.Constant) and node.value.value is None
                got_ret = None if void else self._kind(node.value, aliases) or "?"
                if "?" not in (want_ret, got_ret) and got_ret != want_ret:
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"{entry}.restype is {got_ret}; {src.name} returns '{ret}'")
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Attribute) and node.attr in sigs and node not in decl_nodes
                    and set(declared.get(node.attr, {})) != {"argtypes", "restype"}):
                yield Finding(self.id, ctx.path, node.lineno,
                              f"'{node.attr}' is used without both argtypes and restype declared: "
                              "ctypes would pass every argument as a C int")


@register
class BlockSize(Rule):
    """CU02: the block of every launch is the kernel's ``__launch_bounds__``
    maximum, or folds to no more than it, and to at most 1,024 threads. A
    template launch ``k<T, D>`` finds its ``__global__`` definition."""

    id = "CU02"
    pack = "cuda"
    title = "launch block exceeds the kernel's __launch_bounds__ or 1,024 threads"
    kinds = ("cu",)

    def check(self, ctx: CudaContext, options: Options) -> Iterator[Finding]:
        ks = kernels(ctx)
        for ln in launches(ctx):
            if ln.block is None:
                continue
            k = ks.get(_base(ln.kernel))
            bounds = k.bounds if k else None
            if k and k.bounds_tokens and text_of(_single_dim(ln.block)) == text_of(k.bounds_tokens):
                threads = bounds
            else:
                threads = block_threads(ctx, ln.block, ctx.local_env(ln.host))
            if threads is None:
                continue
            if bounds is not None and threads > bounds:
                yield Finding(self.id, ctx.path, ln.line,
                              f"launch of {ln.kernel} with {threads} threads a block; its "
                              f"__launch_bounds__ allow {bounds}")
            elif threads > MAX_BLOCK_THREADS:
                yield Finding(self.id, ctx.path, ln.line,
                              f"launch of {ln.kernel} with {threads} threads a block; a block "
                              f"holds at most {MAX_BLOCK_THREADS}")


@register
class DynamicSharedMemory(Rule):
    """CU03: a nonzero dynamic shared-memory size that does not fold to at
    most 48 KiB has ``cudaFuncSetAttribute(kernel,
    cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` in the same host
    function (``kernel`` the launched kernel or an alias of it); where it
    folds, dynamic plus static ``__shared__`` bytes stay within the
    H100's 232,448 a block."""

    id = "CU03"
    pack = "cuda"
    title = "dynamic shared memory above 48 KiB without its opt-in, or above the SM's"
    kinds = ("cu",)

    @staticmethod
    def _opted_in(ctx: CudaContext, ln: Launch) -> bool:
        body = ctx.body(ln.host)
        aliases = _aliases(body)
        for i, t in enumerate(body):
            if t.text == "cudaFuncSetAttribute" and body[i + 1].text == "(":
                args = split_args(body[i + 2 : matching(body, i + 1)])
                if (len(args) >= 2 and text_of(args[1]) == "cudaFuncAttributeMaxDynamicSharedMemorySize"
                        and _resolve(args[0], aliases) == ln.kernel):
                    return True
        return False

    def check(self, ctx: CudaContext, options: Options) -> Iterator[Finding]:
        ks = kernels(ctx)
        for ln in launches(ctx):
            if ln.smem is None:
                continue
            dyn = ctx.fold(ln.smem, ctx.local_env(ln.host))
            if dyn == 0:
                continue
            if (dyn is None or dyn > DEFAULT_DYNAMIC_SMEM) and not self._opted_in(ctx, ln):
                size = "an unresolved size" if dyn is None else f"{dyn} bytes"
                yield Finding(self.id, ctx.path, ln.line,
                              f"{ln.kernel} is launched with {size} of dynamic shared memory and "
                              "no cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicShared"
                              "MemorySize, ...) in this function: above 48 KiB the launch fails")
            k = ks.get(_base(ln.kernel))
            static = k.static_smem if k and k.static_smem is not None else 0
            if dyn is not None and dyn + static > OPTIN_SMEM_PER_BLOCK:
                yield Finding(self.id, ctx.path, ln.line,
                              f"{ln.kernel} needs {dyn} dynamic + {static} static bytes of "
                              f"shared memory; a block may hold {OPTIN_SMEM_PER_BLOCK}")


@register
class LaunchErrorReturned(Rule):
    """CU04: after each ``<<<...>>>`` the function returns
    ``cudaGetLastError()``; a ``cudaLaunchKernelEx`` result is returned or
    checked before the function returns. ``_build.launch`` raises only on
    the entry point's return value: an error lost here surfaces, if at
    all, at some later synchronize."""

    id = "CU04"
    pack = "cuda"
    title = "a launch's error does not reach the function's return value"
    kinds = ("cu",)

    def check(self, ctx: CudaContext, options: Options) -> Iterator[Finding]:
        toks = ctx.tokens
        for ln in launches(ctx):
            nxt = ln.end + 1
            while nxt < ln.host.body_end and toks[nxt].text != "return":
                nxt += 1
            ret_end = nxt
            while ret_end < ln.host.body_end and toks[ret_end].text != ";":
                ret_end += 1
            returned = [t.text for t in toks[nxt:ret_end]]
            if ln.kind == "chevron":
                if "cudaGetLastError" not in returned:
                    yield Finding(self.id, ctx.path, ln.line,
                                  f"the launch of {ln.kernel} is not followed by a return of "
                                  "cudaGetLastError(): a refused launch goes unreported")
                continue
            start = ln.call - 1
            while start > ln.host.body_start and toks[start].text not in (";", "{", "}"):
                start -= 1
            stmt = [t.text for t in toks[start + 1 : ln.call]]
            if stmt[:1] == ["return"]:
                continue
            var = stmt[-2] if len(stmt) >= 2 and stmt[-1] == "=" else None
            between = [t.text for t in toks[ln.end + 1 : ret_end]]
            if var is None or var not in between:
                yield Finding(self.id, ctx.path, ln.line,
                              f"the cudaLaunchKernelEx of {ln.kernel} has its result "
                              "neither returned nor checked before the function returns")
