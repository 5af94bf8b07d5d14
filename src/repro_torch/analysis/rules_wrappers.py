"""Kernel-wrapper contracts (pack ``wrappers``).

Each kernel of the port has a wrapper (``kernels/<name>/ops.py``) whose
conventions keep the port honest on a host without a card and countable on
one with it. ``kernels/_build.py`` holds the machinery they share:
``build_library`` (``nvcc``, at first use), ``launch`` (the entry point on
PyTorch's stream; raises on its error), ``count_launch`` (the launch
counters that ``chip_smoke.py`` reads to show the main path ran the
kernels) and ``plain`` (a wrapper's CPU path, through which
``roofline/cost.py`` counts the call as the kernel's one pass):

  * **KW01, no fallback** — a CUDA tensor launches the kernel or raises; a
    ``try`` around a build or a launch whose handler carries on instead
    hides a broken kernel behind the plain version.
  * **KW02, launches counted** — every function that launches counts it,
    in a counter that exists.
  * **KW03, no ``nvcc`` at import** — the tests import every module on a
    host with no ``nvcc``; kernels build inside the function that launches
    them, and only ``kernels/_build.py`` runs ``nvcc``.
  * **KW04, the CPU branch goes through ``_build.plain``** — with a
    constant kernel name, and no direct call of the module's ``ref``
    functions there.

The ``_build`` names are found through the module's imports
(``from repro_torch.kernels._build import launch`` or ``from
repro_torch.kernels import _build``), never by a bare name alone.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.core import (
    FileContext,
    Finding,
    Options,
    Rule,
    dotted_name,
    posix,
    register,
    tail_name,
)

BUILD_MODULE = "repro_torch.kernels._build"
NVCC_EXEMPT = "repro_torch/kernels/_build.py"  # the one place that runs nvcc
SUBPROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output"}


class _Names:
    """What a module's imports make of ``_build``'s functions and of its
    kernels' ``ref`` modules."""

    def __init__(self, ctx: FileContext):
        imported = ctx.imports
        self.build_funcs: Dict[str, str] = {}  # local name -> _build function
        self.build_mods: Set[str] = set()  # local names of the _build module
        self.ref_funcs: Set[str] = set()  # names imported from a kernel's ref module
        self.ref_mods: Set[str] = set()  # local names of a kernel's ref module
        for local, full in imported.items():
            if full == BUILD_MODULE:
                self.build_mods.add(local)
            elif full.rsplit(".", 1)[0] == BUILD_MODULE:
                self.build_funcs[local] = full.rsplit(".", 1)[1]
            elif full.endswith(".ref"):
                self.ref_mods.add(local)
            elif full.rsplit(".", 1)[0].endswith(".ref"):
                self.ref_funcs.add(local)

    def build_func(self, call: ast.Call) -> Optional[str]:
        """The ``_build`` function ``call`` calls, if it calls one."""
        f = call.func
        if isinstance(f, ast.Name):
            return self.build_funcs.get(f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id in self.build_mods:
                return f.attr
        return None

    def is_ref_call(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in self.ref_funcs
        return (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in self.ref_mods)


def _names(ctx: FileContext) -> _Names:
    cached = getattr(ctx, "_wrapper_names", None)
    if cached is None:
        cached = ctx._wrapper_names = _Names(ctx)
    return cached


def _calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def _launching_functions(ctx: FileContext) -> List[ast.FunctionDef]:
    """The functions that call ``_build.launch`` (directly in their body)."""
    cached = getattr(ctx, "_launching", None)
    if cached is None:
        names = _names(ctx)
        cached = []
        if names.build_funcs or names.build_mods:
            for node in ctx.nodes:
                if isinstance(node, ast.Call) and names.build_func(node) == "launch":
                    fn = ctx.enclosing_function(node)
                    if fn is not None and fn not in cached:
                        cached.append(fn)
        ctx._launching = cached
    return cached


def _builds_or_launches(ctx: FileContext, node: ast.AST) -> bool:
    """Does ``node`` call ``build_library``, a wrapper's ``build()``,
    ``_build.launch`` or a ``lib.<entry>``?"""
    names = _names(ctx)
    for call in _calls(node):
        if names.build_func(call) in ("build_library", "launch"):
            return True
        if tail_name(call.func) == "build":
            return True
        f = call.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id.lstrip("_") == "lib"):
            return True
    return False


@register
class NoFallback(Rule):
    """KW01: no ``try`` whose body builds or launches a kernel and whose
    handler does not end in ``raise``: a CUDA tensor launches the kernel or
    raises, and nothing falls back to the plain version."""

    id = "KW01"
    pack = "wrappers"
    title = "a kernel build or launch inside a try that does not re-raise"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not isinstance(node, ast.Try) or not node.handlers:
                continue
            if not any(_builds_or_launches(ctx, stmt) for stmt in node.body):
                continue
            for h in node.handlers:
                if not (h.body and isinstance(h.body[-1], ast.Raise)):
                    yield Finding(self.id, ctx.path, h.lineno,
                                  "a handler around a kernel build or launch carries on: a "
                                  "broken kernel would hide behind a fallback (end it in raise)")


@register
class LaunchesCounted(Rule):
    """KW02: a function that calls ``_build.launch`` also calls
    ``count_launch(f[, counter])`` with ``f`` a function of the module and
    every counter (a string, or either branch of a constant conditional)
    set to 0 at module level as ``f.<counter> = 0``."""

    id = "KW02"
    pack = "wrappers"
    title = "a kernel launch not counted in an existing launch counter"

    @staticmethod
    def _counters(call: ast.Call) -> Optional[List[str]]:
        if len(call.args) < 2:
            kw = [k.value for k in call.keywords if k.arg == "counter"]
            if not kw:
                return ["LAUNCHES"]
            arg = kw[0]
        else:
            arg = call.args[1]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return [arg.value]
        if (isinstance(arg, ast.IfExp) and isinstance(arg.body, ast.Constant)
                and isinstance(arg.orelse, ast.Constant)
                and isinstance(arg.body.value, str) and isinstance(arg.orelse.value, str)):
            return [arg.body.value, arg.orelse.value]
        return None

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        names = _names(ctx)
        module_funcs = {n.name for n in ctx.tree.body if isinstance(n, ast.FunctionDef)}
        zeroed: Set[str] = set()
        for node in ctx.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Constant) and node.value.value == 0):
                zeroed.add(dotted_name(node.targets[0]))
        for fn in _launching_functions(ctx):
            counts = [c for c in _calls(fn) if names.build_func(c) == "count_launch"]
            if not counts:
                yield Finding(self.id, ctx.path, fn.lineno,
                              f"'{fn.name}' launches a kernel but never calls count_launch: "
                              "the main path's launch counts would miss it")
            for c in counts:
                target = c.args[0] if c.args else None
                if not (isinstance(target, ast.Name) and target.id in module_funcs):
                    yield Finding(self.id, ctx.path, c.lineno,
                                  "count_launch's wrapper must be a function of this module")
                    continue
                counters = self._counters(c)
                if counters is None:
                    yield Finding(self.id, ctx.path, c.lineno,
                                  "count_launch's counter must be a constant string (or a "
                                  "conditional between two)")
                    continue
                for counter in counters:
                    if f"{target.id}.{counter}" not in zeroed:
                        yield Finding(self.id, ctx.path, c.lineno,
                                      f"counter '{target.id}.{counter}' is never set to 0 at "
                                      "module level")


@register
class NoNvccAtImport(Rule):
    """KW03: no ``build_library`` or wrapper ``build()`` call at module or
    class level, in a default argument or in a decorator (the tests import
    every module on a host without ``nvcc``); no ``subprocess`` call
    naming nvcc outside ``kernels/_build.py``."""

    id = "KW03"
    pack = "wrappers"
    title = "nvcc run at import, or outside kernels/_build.py"

    def _is_build(self, ctx: FileContext, call: ast.Call) -> bool:
        return _names(ctx).build_func(call) == "build_library" or tail_name(call.func) == "build"

    def _import_time_exprs(self, ctx: FileContext) -> Iterator[ast.AST]:
        """Expressions evaluated when the module is imported: module- and
        class-level statements (not function bodies), default arguments and
        decorators."""
        stack: List[ast.AST] = list(ctx.tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from node.decorator_list
                yield from node.args.defaults
                yield from (d for d in node.args.kw_defaults if d is not None)
            elif isinstance(node, ast.ClassDef):
                yield from node.decorator_list
                stack.extend(node.body)
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For, ast.While)):
                for field in ("test", "iter", "items"):
                    val = getattr(node, field, None)
                    if isinstance(val, list):
                        yield from val
                    elif val is not None:
                        yield val
                for field in ("body", "orelse", "finalbody"):
                    stack.extend(getattr(node, field, []))
                for h in getattr(node, "handlers", []):
                    stack.extend(h.body)
            else:
                yield node

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        for expr in self._import_time_exprs(ctx):
            for call in _calls(expr):
                if self._is_build(ctx, call):
                    yield Finding(self.id, ctx.path, call.lineno,
                                  f"'{dotted_name(call.func)}()' runs at import: nvcc would run "
                                  "wherever the module is imported (build inside the launching "
                                  "function)")
        if posix(ctx.path).endswith(NVCC_EXEMPT):
            return
        for call in (n for n in ctx.nodes if isinstance(n, ast.Call)):
            name = dotted_name(call.func)
            if not (name.startswith("subprocess.") and name.rsplit(".", 1)[1] in SUBPROCESS_CALLS):
                continue
            for sub in ast.walk(call):
                text = (sub.value if isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                        else sub.id if isinstance(sub, ast.Name)
                        else sub.attr if isinstance(sub, ast.Attribute) else "")
                if "nvcc" in text:
                    yield Finding(self.id, ctx.path, call.lineno,
                                  "a subprocess runs nvcc outside kernels/_build.py: build "
                                  "through _build.build_library (one cache, one set of flags)")
                    break


def _is_cpu_test(test: ast.AST) -> bool:
    """``<t>.device.type == "cpu"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and dotted_name(test.left).endswith(".device.type")
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


@register
class CpuBranchThroughPlain(Rule):
    """KW04: in a function that calls ``_build.launch``, the branch that
    returns for a CPU tensor (``if <t>.device.type == "cpu": ... return``)
    runs the plain version as ``plain("<name>", fn, ...)`` with a constant
    name, and calls none of the module's ``ref`` functions directly: that
    is the hook through which ``roofline/cost.py`` counts the call as the
    kernel's one pass."""

    id = "KW04"
    pack = "wrappers"
    title = "a wrapper's CPU branch bypasses _build.plain"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        names = _names(ctx)
        for fn in _launching_functions(ctx):
            for node in ast.walk(fn):
                if not (isinstance(node, ast.If) and _is_cpu_test(node.test)
                        and node.body and isinstance(node.body[-1], ast.Return)):
                    continue
                plains = []
                for stmt in node.body:
                    for call in _calls(stmt):
                        if names.build_func(call) == "plain":
                            plains.append(call)
                        elif names.is_ref_call(call):
                            yield Finding(self.id, ctx.path, call.lineno,
                                          f"the CPU branch of '{fn.name}' calls "
                                          f"'{dotted_name(call.func)}' directly: run it as "
                                          "plain(\"<kernel>\", fn, ...) so hooks see the call")
                if not plains:
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"the CPU branch of '{fn.name}' never calls _build.plain")
                for call in plains:
                    if not (call.args and isinstance(call.args[0], ast.Constant)
                            and isinstance(call.args[0].value, str)):
                        yield Finding(self.id, ctx.path, call.lineno,
                                      "plain()'s kernel name must be a constant string")
