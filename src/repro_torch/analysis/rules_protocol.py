"""IPLS protocol-invariant rules (pack ``protocol``), the reference's PR01-PR04
ported with the port's own tables.

The port's scalar pubsub engine (``p2p/ipfs_sim.py`` + ``fl/rounds.py``)
and its batched engine (``fl/vectorized.py``) are kept equivalent by
conventions that nothing type-checks:

  * **Keyed fates** — every message fate is drawn from the counter-based
    stream keyed by the full tuple ``(channel, round, agent, part[, peer])``.
    A draw site that omits part of the key collapses distinct messages onto
    one fate and silently desynchronizes the engines.
  * **Counter symmetry** — every site that bumps a traffic counter
    (``messages_sent`` / ``messages_dropped`` / byte totals) must have a
    declared counterpart in the other engine, recorded in the ``SYMMETRY``
    table below. An undeclared increment is a counter the equivalence tests
    can drift on; a stale declaration is a site someone deleted without
    updating the mirror.
  * **Dtype-derived wire bytes** — byte accounting must come from the
    payload's dtype/size (``core.wire.wire_size``, ``.nbytes``), never an
    element count times a literal width: the quantized (int8) wire makes
    ``n * 4`` wrong for every compressed transfer.
  * **Metric-schema symmetry** — every telemetry emission site speaks the
    shared schema (``telemetry.schema``).

The tables are keyed by the port's paths (``repro_torch/...``), so that a
run over ``src/`` does not apply them to the reference's engines, whose
sites the reference's own tables declare. When adding an accounting site,
add it here together with its counterpart (``tests/test_torch_analysis.py``
asserts the table stays two-sided and names functions that exist).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from repro_torch.analysis.core import Finding, FileContext, Options, Rule, posix, register

FATE_DRAW_METHODS = {"draw", "draw_one", "draw_window"}
# (channel, round, agent, part) — peer optional for point-to-point channels
MIN_KEY_ARITY = 4

# traffic counters, as they appear as attribute/subscript targets
COUNTERS = {
    "messages_sent",
    "messages_dropped",
    "bytes_total",
    "_bytes_total",
    "bytes_sent",
    "bytes_recv",
}

# Declared-symmetry table: path suffix -> function -> counters it bumps.
# The scalar block and the vectorized block mirror each other; the port's
# engine-equivalence tests rely on both sides counting the same events.
SYMMETRY: Dict[str, Dict[str, Set[str]]] = {
    # scalar engine: per-message accounting in the pubsub transport
    "repro_torch/p2p/ipfs_sim.py": {
        "publish": {"messages_sent", "messages_dropped", "bytes_sent"},
        "send": {"messages_sent", "messages_dropped", "bytes_sent"},
        "tick": {"messages_dropped", "bytes_recv"},
    },
    # vectorized engine: per-round bulk accounting from the device counters,
    # plus the churn re-snapshot boundary crossings that move pubsub state
    # between the oracle and the dense planes (the port's churn
    # re-snapshot) — they mirror the scalar tick's delivery accounting
    "repro_torch/fl/vectorized.py": {
        "_run_round_lossy": {"messages_sent", "messages_dropped", "_bytes_total"},
        "_run_window_lossy": {"messages_sent", "messages_dropped", "_bytes_total"},
        "_perfect_traffic": {"messages_sent", "_bytes_total"},
        "_init_lossy": {"bytes_recv"},
        "_harvest_pubsub": {"bytes_recv"},
        "_device_to_scalar": {"bytes_sent", "bytes_recv"},
    },
}

# engine side of each declared file, used by the table self-check
ENGINE_SIDE = {
    "repro_torch/p2p/ipfs_sim.py": "scalar",
    "repro_torch/fl/vectorized.py": "vectorized",
}

# -- PR04: telemetry metric-schema symmetry ---------------------------------
# Hardcoded mirrors of repro_torch.telemetry.schema.FINISH_KEYS / CHANNELS.
# tests/test_torch_analysis.py cross-checks these against the live schema
# module, so drift between the rule and the schema is itself a test failure.
METRIC_FINISH_KEYS = (
    "round",
    "active",
    "contrib",
    "eps",
    "delta_normsq",
    "value_normsq",
    "accs",
    "bytes_total",
    "msgs_total",
    "drops_total",
)
METRIC_CHANNELS = (
    "fetch",
    "fetch_reply",
    "update",
    "update_reply",
    "replica",
    "member",
)

# Declared emitters: path suffix -> the function holding that engine's ONE
# finish_round emission site. A file matching the suffix that defines the
# function without a finish_round call inside it lost its emission site; a
# partial file (fixture) omitting the function is skipped, like SYMMETRY.
EMITTER_FUNCS: Dict[str, str] = {
    "repro_torch/fl/rounds.py": "_tel_finish",
    "repro_torch/fl/vectorized.py": "_emit_row",
}

_FAMILY = {
    "messages_sent": "messages_sent",
    "messages_dropped": "messages_dropped",
    "bytes_total": "bytes",
    "_bytes_total": "bytes",
    "bytes_sent": "bytes",
    "bytes_recv": "bytes",
}


def symmetry_is_balanced() -> Dict[str, Set[str]]:
    """Counter families present per engine side; a balanced table has the
    same families on both sides. Exposed for the meta-test."""
    sides: Dict[str, Set[str]] = {"scalar": set(), "vectorized": set()}
    for suffix, funcs in SYMMETRY.items():
        side = ENGINE_SIDE[suffix]
        for counters in funcs.values():
            sides[side].update(_FAMILY[c] for c in counters)
    return sides


def _counter_target(node: ast.AST) -> Optional[str]:
    """Base counter name of an AugAssign target, unwrapping subscripts."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in COUNTERS:
        return node.attr
    if isinstance(node, ast.Name) and node.id in COUNTERS:
        return node.id
    return None


def _declared_for(path: str) -> Optional[Dict[str, Set[str]]]:
    p = posix(path)
    for suffix, funcs in SYMMETRY.items():
        if p.endswith(suffix):
            return funcs
    return None


@register
class FateKeyTuple(Rule):
    """PR01: a ``.draw()``/``.draw_one()``/``.draw_window()`` call on the
    fate stream must pass the full key — at least (channel, round, agent,
    part); peer-addressed channels add the peer. Fewer arguments means two
    distinct messages share one fate draw and the scalar/vectorized engines
    diverge under loss."""

    id = "PR01"
    pack = "protocol"
    title = "fate draw missing part of the key tuple"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in FATE_DRAW_METHODS
            ):
                continue
            if any(isinstance(a, ast.Starred) for a in node.args):
                continue  # arity unknowable statically
            arity = len(node.args) + len([k for k in node.keywords if k.arg])
            if arity < MIN_KEY_ARITY:
                yield Finding(
                    self.id,
                    ctx.path,
                    node.lineno,
                    f".{node.func.attr}() called with {arity} key argument(s);"
                    " the fate key is (channel, round, agent, part[, peer])"
                    " — a partial key aliases distinct messages onto one fate",
                )


def _contains_size_ref(node: ast.AST) -> bool:
    """True if the subtree references an element count: a ``.size``
    attribute or any identifier containing ``size`` (``sizes``,
    ``_wsizes``, ...)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and "size" in sub.attr:
            return True
        if isinstance(sub, ast.Name) and "size" in sub.id:
            return True
    return False


def _hardcoded_width_mults(expr: ast.AST) -> Iterator[ast.BinOp]:
    """Mult nodes where one side is a bare int literal and the other side
    references an element count — i.e. ``n_elements * 4``-style byte math
    that bakes in an f32 wire width."""
    for sub in ast.walk(expr):
        if not (isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult)):
            continue
        for const, other in ((sub.left, sub.right), (sub.right, sub.left)):
            if (
                isinstance(const, ast.Constant)
                and isinstance(const.value, int)
                and not isinstance(const.value, bool)
                and _contains_size_ref(other)
            ):
                yield sub
                break


@register
class WireBytesFromDtype(Rule):
    """PR03: wire-byte accounting — ``nbytes=`` arguments of
    ``publish()``/``send()`` and assignments to ``*bytes*`` counters — must
    derive from the payload's dtype/size (``.nbytes``, ``.itemsize``,
    ``core.wire.wire_size``), never from an element count times a hardcoded
    integer width. A literal ``* 4`` silently assumes the f32 wire format
    and misaccounts every quantized (int8) transfer."""

    id = "PR03"
    pack = "protocol"
    title = "wire bytes hardcode an element width instead of the payload dtype"

    _MSG = (
        "byte accounting multiplies an element count by a hardcoded width "
        "{w} — derive it from the payload (.nbytes/.itemsize or "
        "core.wire.wire_size) so non-f32 wire modes stay accounted"
    )

    def _width(self, mult: ast.BinOp) -> int:
        for side in (mult.left, mult.right):
            if isinstance(side, ast.Constant) and isinstance(side.value, int):
                return side.value
        return 0  # unreachable: _hardcoded_width_mults guarantees a literal

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        sinks: list = []
        for node in ctx.nodes:
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "nbytes":
                        sinks.append(kw.value)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in {"publish", "send"}
                    and node.args
                ):
                    sinks.append(node.args[-1])
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in targets:
                    base = tgt
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    name = (
                        base.attr if isinstance(base, ast.Attribute)
                        else base.id if isinstance(base, ast.Name)
                        else ""
                    )
                    if "bytes" in name:
                        sinks.append(node.value)
                        break
        seen = set()
        for expr in sinks:
            for mult in _hardcoded_width_mults(expr):
                key = (mult.lineno, mult.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    self.id,
                    ctx.path,
                    mult.lineno,
                    self._MSG.format(w=self._width(mult)),
                )


@register
class MetricSchemaSymmetry(Rule):
    """PR04: telemetry emission sites must speak the shared metric schema.
    A ``finish_round(...)`` call must pass every schema key, as keywords,
    and nothing else — a positional argument, an unknown key, or a
    ``**kwargs`` splat is a row the byte-equality tests cannot pin; an
    ``on_channel(...)`` call naming a channel outside the schema's channel
    set creates traffic keys only one engine emits. Files declared in
    ``EMITTER_FUNCS`` that define their emitter function must still contain
    the emission call inside it."""

    id = "PR04"
    pack = "protocol"
    title = "telemetry emission site diverges from the shared metric schema"

    def _check_finish(self, ctx: FileContext, node: ast.Call) -> Iterator[Finding]:
        if node.args:
            yield Finding(
                self.id,
                ctx.path,
                node.lineno,
                "finish_round() takes schema keys as keywords only — a "
                "positional argument bypasses the schema check",
            )
        passed = set()
        for kw in node.keywords:
            if kw.arg is None:
                yield Finding(
                    self.id,
                    ctx.path,
                    node.lineno,
                    "finish_round(**kwargs) hides the emitted keys from the "
                    "schema check — pass each schema key explicitly",
                )
                return
            if kw.arg not in METRIC_FINISH_KEYS:
                yield Finding(
                    self.id,
                    ctx.path,
                    node.lineno,
                    f"finish_round() passes '{kw.arg}', which is not in the "
                    "telemetry schema (telemetry.schema.FINISH_KEYS) — one "
                    "engine would emit a row shape the others don't",
                )
            passed.add(kw.arg)
        missing = [k for k in METRIC_FINISH_KEYS if k not in passed]
        if missing:
            yield Finding(
                self.id,
                ctx.path,
                node.lineno,
                "finish_round() omits schema key(s) "
                + ", ".join(f"'{k}'" for k in missing)
                + " — every engine emits the full row every round",
            )

    def _check_channel(self, ctx: FileContext, node: ast.Call) -> Iterator[Finding]:
        cands = []
        if len(node.args) >= 2:
            cands.append(node.args[1])
        cands += [kw.value for kw in node.keywords if kw.arg == "channel"]
        for arg in cands:
            if (
                isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)
                and arg.value not in METRIC_CHANNELS
            ):
                yield Finding(
                    self.id,
                    ctx.path,
                    node.lineno,
                    f"on_channel() names unknown channel '{arg.value}' — "
                    "traffic keys come from telemetry.schema.CHANNELS so "
                    "both engines emit the same columns",
                )

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        finish_fns: Set[str] = set()
        for node in ctx.nodes:
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            if node.func.attr == "finish_round":
                fn = ctx.enclosing_function(node)
                if fn is not None:
                    finish_fns.add(fn.name)
                yield from self._check_finish(ctx, node)
            elif node.func.attr == "on_channel":
                yield from self._check_channel(ctx, node)

        p = posix(ctx.path)
        for suffix, fn_name in EMITTER_FUNCS.items():
            if not p.endswith(suffix):
                continue
            defined = any(
                isinstance(n, ast.FunctionDef) and n.name == fn_name
                for n in ctx.nodes
            )
            if defined and fn_name not in finish_fns:
                yield Finding(
                    self.id,
                    ctx.path,
                    1,
                    f"'{fn_name}' is the declared telemetry emitter for this "
                    "engine but contains no finish_round() call — the metric "
                    "stream lost its emission site",
                )


@register
class CounterSymmetry(Rule):
    """PR02: every ``+=`` on a traffic counter must be a declared site in
    the ``SYMMETRY`` table (with its counterpart in the other engine), and
    every declared site must still exist. Flags both undeclared increments
    and stale declarations (function present, declared counter gone)."""

    id = "PR02"
    pack = "protocol"
    title = "traffic-counter site not declared in the symmetry table"

    def check(self, ctx: FileContext, options: Options) -> Iterator[Finding]:
        declared = _declared_for(ctx.path) or {}

        # actual sites: function -> counters bumped (plus finding positions)
        actual: Dict[str, Set[str]] = {}
        for node in ctx.nodes:
            if not isinstance(node, ast.AugAssign):
                continue
            counter = _counter_target(node.target)
            if counter is None:
                continue
            fn = ctx.enclosing_function(node)
            fn_name = fn.name if fn is not None else "<module>"
            actual.setdefault(fn_name, set()).add(counter)
            if counter not in declared.get(fn_name, set()):
                yield Finding(
                    self.id,
                    ctx.path,
                    node.lineno,
                    f"'{counter} +=' in '{fn_name}' is not declared in "
                    "rules_protocol.SYMMETRY — declare it together with its "
                    "counterpart in the other engine",
                )

        # stale declarations: function still exists but a declared counter
        # site is gone (a wholly absent function is treated as a partial
        # file, e.g. a fixture, and skipped)
        fn_defs = {
            n.name: n for n in ctx.nodes if isinstance(n, ast.FunctionDef)
        }
        for fn_name, counters in declared.items():
            fn = fn_defs.get(fn_name)
            if fn is None:
                continue
            for counter in sorted(counters - actual.get(fn_name, set())):
                yield Finding(
                    self.id,
                    ctx.path,
                    fn.lineno,
                    f"SYMMETRY declares '{counter} +=' in '{fn_name}' but no "
                    "such site exists — update the table (and its mirror in "
                    "the other engine)",
                )
