"""repro_torch.analysis — the port's own static analysis.

Four rule packs over the port's invariants, run as ``python -m
repro_torch.analysis [paths] [--json] [--list-rules] [--select IDS]``
(exit 1 exactly when findings remain; with no paths, the port's tree:
``core.PORT_TREE``). Python files are read as ASTs and ``.cu`` files by a
small C++ tokenizer; nothing of the port, the reference or JAX is
imported to analyse a file.

======  ========  ===========================================  ==========
id      pack      checks                                       reference
======  ========  ===========================================  ==========
PR01    protocol  fate draws pass the full key tuple           PR01
PR02    protocol  traffic-counter sites declared in SYMMETRY    PR02
PR03    protocol  wire bytes from the payload's dtype           PR03
PR04    protocol  emission sites speak the metric schema        PR04
KW01    wrappers  no try around a build or launch that
                  carries on (no fallback)                     —
KW02    wrappers  every launch counted in an existing counter   —
KW03    wrappers  no nvcc at import, none outside _build.py     —
KW04    wrappers  a wrapper's CPU branch goes through plain()   —
CU01    cuda      ctypes argtypes/restype = extern "C" ABI      PL01
CU02    cuda      block size within __launch_bounds__, 1,024    —
CU03    cuda      dynamic shared memory opted in above 48 KiB,
                  within 227 KiB with the static bytes         PL04
CU04    cuda      a launch's CUDA error reaches the return      —
CG01    capture   no host sync in CUDA-graph-captured code      JX01
CG02    capture   no host randomness/clock frozen at capture    JX03
CG03    capture   no Python branch on a tensor in captured code JX02
======  ========  ===========================================  ==========

The reference's PL02, PL03 and PL05 (Pallas grids, tiles and index maps),
JX04 (``lax.scan`` carries) and JX05 (``lax.cond`` branches) read
constructs the port does not have, so they have no counterpart here.

Suppress a finding with a reason on its line, or on comment lines just
above it: ``# repro: noqa[CG01] reason`` in Python, ``// repro:
noqa[CU03] reason`` in CUDA C++ — the reference's syntax, so one
suppression serves both analyzers on the shared protocol rules.
"""
from repro_torch.analysis.core import (
    Finding,
    Options,
    Rule,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    default_paths,
    main,
    register,
)

__all__ = [
    "Finding",
    "Options",
    "Rule",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "default_paths",
    "main",
    "register",
]
