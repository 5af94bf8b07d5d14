"""CUDA-graph capture hygiene (pack ``capture``), the counterpart of the
reference's JAX tracer-hygiene pack.

A CUDA graph records the device work of one run of its capture region and
replays it: the Python in the region runs once, at capture. What JX01-JX03
guard under ``jit`` has exact counterparts here:

  * **CG01** (JX01) — a host sync (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``, or
    ``int()``/``float()``/``bool()`` of a tensor) is an error during
    capture, and the value it would read is the capture's forever;
  * **CG02** (JX03) — host randomness or a clock read runs once at capture
    and is frozen into every replay;
  * **CG03** (JX02) — a Python ``if``/``while``/``assert``/conditional on a
    tensor keeps the branch taken at capture.

**Captured code.** The bodies of ``with <x>.capture(...)`` (a
``kernels/_build.Graph``) and ``with torch.cuda.graph(...)``, and the
functions of ``CAPTURED_ROOTS``: path suffix -> the functions (qualified
``Class.method`` / ``outer.inner``) that a capture region in another
module calls. Reachability is closed over module-local calls by name and
``self.<method>`` of the same class, as the reference's JX reachability
is.

**Taint never guesses.** A value is a tensor when it is a parameter
annotated ``torch.Tensor``, the result of a ``torch.*`` operation (not a
``torch.cuda.*`` query, a ``torch.is_*`` predicate or the like), or the
result of an operator, subscript or method on a tensor. ``.shape``,
``.dtype``, ``.device``, ``.ndim``, ``.dim()``, ``.size()``,
``.numel()``, ``.data_ptr()``, ``.is_contiguous()`` and ``len()`` do not
taint, and anything unknown is not a tensor. This departs on purpose
from JX's "positional parameters taint": PyTorch has no tracer type, and a
false positive would only teach noqa.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

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

# Functions captured into a CUDA graph from a capture region of another
# module, read off each capture site and closed over the port functions that
# captured code calls through an import (tests/test_torch_analysis.py holds
# the table closed):
#   * launch/steps.py DecodeGraph.step's `with g.capture()` runs self._run:
#     model.decode_step (TransformerLM for every decoder-only family,
#     WhisperModel) and the step's `after`, serve_lm.greedy's;
#   * fl/vectorized.py _capture's `with graph.capture(...)` runs self._round:
#     the aggregation and codec wrappers, the int8 wire's rows, the MLP's
#     evaluation and the norm metrics;
#   * chip_smoke.py's decode graph captures the flash-decode wrapper.
CAPTURED_ROOTS: Dict[str, Set[str]] = {
    "repro_torch/models/transformer.py": {"TransformerLM.decode_step"},
    "repro_torch/models/whisper.py": {"WhisperModel.decode_step"},
    "repro_torch/serve_lm.py": {"greedy.after"},
    "repro_torch/models/layers.py": {
        "_cross_q", "_decode_attention_cp", "_out_proj", "_span", "apply_mlp", "apply_moe",
        "attn_cache_len", "decode_attention", "decode_attention_local",
        "decode_cross_attention", "decode_mla", "embed", "embed_vocab_parallel", "layer_norm",
        "merge_over", "rms_norm",
    },
    "repro_torch/models/ssm.py": {
        "apply_rwkv6_channel", "apply_rwkv6_channel_tp", "decode_mamba2", "decode_mamba2_tp",
        "decode_rwkv6_time", "decode_rwkv6_time_tp",
    },
    "repro_torch/models/sharding_hooks.py": {
        "cache_layout", "context_parallel", "gather_model", "gather_seq", "once_over_model",
        "reduce_parts", "scatter_seq", "sum_model", "sum_parts", "tensor_parallel", "to_parts",
        "whole_in",
    },
    "repro_torch/models/mlp_mnist.py": {"evaluate"},
    "repro_torch/core/sharded.py": {"all_gather_dim", "mesh_axis_size", "model_size"},
    "repro_torch/core/partition.py": {"unflatten_params"},
    "repro_torch/core/wire.py": {"qdq_rows", "quantize_rows"},
    "repro_torch/tree.py": {"tree_map"},
    "repro_torch/telemetry/device.py": {"metric_pair"},
    "repro_torch/kernels/_build.py": {"build_library", "count_launch", "forbid_grad", "launch",
                                      "plain"},
    "repro_torch/kernels/decode_attention/ops.py": {"decode", "merge_partials"},
    "repro_torch/kernels/flash_attention/ops.py": {"check_attention_args"},
    "repro_torch/kernels/ipls_aggregate/ops.py": {"aggregate_batched", "aggregate_batched_q"},
    "repro_torch/kernels/quantize/ops.py": {"dequantize", "quantize"},
    "repro_torch/kernels/quantize/ref.py": {"num_blocks"},
}

STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad", "layout",
                "is_leaf", "grad_fn", "names"}
STATIC_METHODS = {"dim", "size", "numel", "data_ptr", "is_contiguous", "element_size",
                  "stride", "nelement", "storage_offset", "get_device", "is_floating_point",
                  "is_complex", "item", "tolist", "numpy", "type"}
NON_TENSOR_TORCH = ("torch.cuda.", "torch.distributed.", "torch.backends.", "torch.is_",
                    "torch.get_", "torch.set_", "torch.are_", "torch.use_", "torch.jit.",
                    "torch.profiler.", "torch.utils.data.", "torch.testing.", "torch._")
NON_TENSOR_TORCH_CALLS = {
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode", "torch.device", "torch.dtype",
    "torch.Size", "torch.finfo", "torch.iinfo", "torch.Generator", "torch.manual_seed",
    "torch.seed", "torch.initial_seed", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.compile", "torch.Stream", "torch.Event",
}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
FROZEN_PREFIXES = ("numpy.random.", "random.", "time.")
FROZEN_CALLS = {"datetime.now", "datetime.datetime.now", "os.urandom", "torch.manual_seed",
                "torch.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
COERCIONS = {"int", "float", "bool", "complex"}


def _own_nodes(node: ast.AST) -> Iterator[ast.AST]:
    """``node``'s subtree without the bodies of nested functions, lambdas
    and classes (code that runs only when called)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(sub))


class CaptureIndex:
    """The module's captured code: capture regions (their statements, and
    the function holding them) and the functions reachable from them or
    from the module's ``CAPTURED_ROOTS``."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.imports = ctx.imports
        self.defs: Dict[str, ast.AST] = {}  # qualified name -> def
        self.regions: List[Tuple[str, List[ast.stmt]]] = []  # (holder's qualified name, body)
        self.captured: Set[str] = set()
        p = posix(ctx.path)
        declared = set().union(*(n for s, n in CAPTURED_ROOTS.items() if p.endswith(s)))
        withs = [n for n in ctx.nodes if isinstance(n, ast.With)
                 and any(self._is_capture(item.context_expr) for item in n.items)]
        if not (declared or withs):
            return
        for node in ctx.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(self._qual_of(node, node.name), node)
        for node in withs:
            self.regions.append((self._qual_of(node), node.body))
        roots = {n for n in declared if n in self.defs}
        for qual, body in self.regions:
            roots |= self._callees((n for stmt in body for n in ast.walk(stmt)), qual)
        captured: Set[str] = set()
        frontier = sorted(roots)
        while frontier:
            name = frontier.pop()
            if name in captured:
                continue
            captured.add(name)
            frontier.extend(self._callees(_own_nodes(self.defs[name]), name) - captured)
        self.captured = captured

    def _qual_of(self, node: ast.AST, name: str = "") -> str:
        """Qualified name of ``name`` defined where ``node`` is (with no
        name: of the function holding ``node``, "" at module level)."""
        parts = [name] if name else []
        cur = self.ctx.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(cur.name)
            cur = self.ctx.parent(cur)
        qual = ".".join(reversed(parts))
        while not name and qual and qual not in self.defs:  # a region in a class body
            qual = qual.rpartition(".")[0]
        return qual

    def resolve(self, name: str) -> str:
        """A dotted name with its first part replaced by what it was
        imported as (``np.random.rand`` -> ``numpy.random.rand``)."""
        head, _, rest = name.partition(".")
        full = self.imports.get(head, head)
        return f"{full}.{rest}" if rest else full

    def _is_capture(self, expr: ast.AST) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        name = self.resolve(dotted_name(expr.func))
        return tail_name(expr.func) == "capture" or name == "torch.cuda.graph"

    def _callees(self, nodes: Iterable[ast.AST], qual: str) -> Set[str]:
        """Defined functions that ``nodes`` (code of ``qual``) call: a bare
        name, resolved in the enclosing functions' scopes outward, or
        ``self.<m>`` of the class that ``qual`` lies in."""
        scopes = qual.split(".") if qual else []
        cls = next((scopes[: i + 1] for i in range(len(scopes))
                    if ".".join(scopes[: i + 1]) not in self.defs), None)
        out: Set[str] = set()
        for sub in nodes:
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Name):
                for i in range(len(scopes), -1, -1):
                    cand = ".".join(scopes[:i] + [f.id])
                    if cand in self.defs:
                        out.add(cand)
                        break
            elif (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                  and f.value.id == "self" and cls):
                cand = ".".join(cls + [f.attr])
                if cand in self.defs:
                    out.add(cand)
        return out

    def units(self) -> Iterator[Tuple[str, ast.AST, List[ast.AST]]]:
        """(name, the function whose parameters and assignments give the
        taint, the nodes to check) for every piece of captured code."""
        for name in sorted(self.captured):
            fn = self.defs[name]
            yield name, fn, list(_own_nodes(fn))
        for qual, body in self.regions:
            nodes: List[ast.AST] = []
            for stmt in body:
                nodes.append(stmt)
                nodes.extend(_own_nodes(stmt))
            yield f"capture in '{qual or '<module>'}'", self.defs.get(qual, self.ctx.tree), nodes

    def imported_callees(self) -> Set[Tuple[str, str]]:
        """(module, name) of every function of another module that captured
        code here calls through an import: the candidates of that module's
        ``CAPTURED_ROOTS`` entry."""
        out: Set[Tuple[str, str]] = set()
        for _, _, nodes in self.units():
            for sub in nodes:
                if isinstance(sub, ast.Call):
                    full = self.resolve(dotted_name(sub.func))
                    if full.startswith("repro_torch.") and dotted_name(sub.func):
                        mod, _, fn = full.rpartition(".")
                        out.add((mod, fn))
        return out


def capture_index(ctx: FileContext) -> CaptureIndex:
    idx = getattr(ctx, "_capture_index", None)
    if idx is None:
        idx = ctx._capture_index = CaptureIndex(ctx)
    return idx


class Taint:
    """The tensor-valued names of one function (see the module docstring),
    grown over its assignments to a fixpoint."""

    def __init__(self, idx: CaptureIndex, fn: ast.AST):
        self.idx = idx
        self.names: Set[str] = set()
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                if self._tensor_annotation(p.annotation):
                    self.names.add(p.arg)
        assigns = [n for n in _own_nodes(fn)
                   if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For,
                                     ast.NamedExpr))]
        changed = True
        while changed:
            changed = False
            for n in assigns:
                value = n.iter if isinstance(n, ast.For) else n.value
                if value is None or not self.tensor(value):
                    continue
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                for tgt in targets:
                    for name in _bound_names(tgt):
                        if name not in self.names:
                            self.names.add(name)
                            changed = True

    @staticmethod
    def _tensor_annotation(ann: Optional[ast.AST]) -> bool:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.strip() in ("torch.Tensor", "Tensor")
        return dotted_name(ann) in ("torch.Tensor", "Tensor") if ann is not None else False

    def _torch_op(self, call: ast.Call) -> bool:
        name = self.idx.resolve(dotted_name(call.func))
        return (name.startswith("torch.") and name not in NON_TENSOR_TORCH_CALLS
                and not name.startswith(NON_TENSOR_TORCH)
                and not name.rpartition(".")[2].startswith("_"))  # private: unknown

    def tensor(self, node: ast.AST) -> bool:
        """Is ``node`` tensor-valued?"""
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            return node.attr not in STATIC_ATTRS and self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and self.tensor(f.value):
                return f.attr not in STATIC_METHODS
            return self._torch_op(node)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            if any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                   for c in [node.left, *node.comparators]):
                return False
            return any(self.tensor(c) for c in [node.left, *node.comparators])
        return False


def _bound_names(target: ast.AST) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            yield from _bound_names(el)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _units(ctx: FileContext) -> Iterator[Tuple[str, Taint, List[ast.AST]]]:
    idx = capture_index(ctx)
    taints: Dict[int, Taint] = {}
    for name, fn, nodes in idx.units():
        taint = taints.get(id(fn))
        if taint is None:
            taint = taints[id(fn)] = Taint(idx, fn)
        yield name, taint, nodes


@register
class CapturedHostSync(Rule):
    """CG01: a host sync in captured code — ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
    or ``int()``/``float()``/``bool()`` of a tensor — is an error during
    capture, and the value it reads would be the capture's at every
    replay."""

    id = "CG01"
    pack = "capture"
    title = "host sync in code captured into a CUDA graph"

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        if tail_name(call.func) != "to" or not isinstance(call.func, ast.Attribute):
            return False
        args = list(call.args[:1]) + [k.value for k in call.keywords if k.arg == "device"]
        return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        idx = capture_index(ctx)
        for name, taint, nodes in _units(ctx):
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                what = None
                if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_METHODS:
                    what = f".{f.attr}()"
                elif self._to_cpu(node):
                    what = '.to("cpu")'
                elif idx.resolve(dotted_name(f)) == "torch.cuda.synchronize":
                    what = "torch.cuda.synchronize()"
                elif (isinstance(f, ast.Name) and f.id in COERCIONS and node.args
                      and taint.tensor(node.args[0])):
                    what = f"{f.id}() of a tensor"
                if what:
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"{what} in {name}, which is captured into a CUDA graph: a "
                                  "host sync fails the capture and its value would be frozen")


@register
class FrozenHostState(Rule):
    """CG02: ``numpy.random``/``random``/``time``/``datetime.now``/
    ``os.urandom``/``torch.manual_seed`` in captured code run once, at
    capture: every replay repeats the capture's draw or clock reading."""

    id = "CG02"
    pack = "capture"
    title = "host randomness or clock read frozen into a CUDA graph"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        idx = capture_index(ctx)
        for name, _, nodes in _units(ctx):
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                full = idx.resolve(dotted_name(node.func))
                if full in FROZEN_CALLS or full.startswith(FROZEN_PREFIXES):
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"'{full}' in {name} runs once, at capture: every replay of "
                                  "the graph repeats its value")


@register
class CapturedBranchOnTensor(Rule):
    """CG03: a Python ``if``/``while``/``assert``/conditional expression on a
    tensor in captured code is decided once, at capture (and syncs the
    host): the graph keeps the branch taken then. Branch on the device
    (``torch.where``) or on host values."""

    id = "CG03"
    pack = "capture"
    title = "Python control flow on a tensor in code captured into a CUDA graph"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        for name, taint, nodes in _units(ctx):
            for node in nodes:
                kind = ("assert" if isinstance(node, ast.Assert)
                        else "conditional expression" if isinstance(node, ast.IfExp)
                        else type(node).__name__.lower()
                        if isinstance(node, (ast.If, ast.While)) else None)
                if kind and taint.tensor(node.test):
                    yield Finding(self.id, ctx.path, node.lineno,
                                  f"Python {kind} on a tensor in {name}: the CUDA graph keeps "
                                  "the branch taken at capture")
