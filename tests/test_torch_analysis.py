"""Tests for the port's static analysis (``repro_torch.analysis``).

Four layers: fixture tests (every rule fires on its fire fixture and on
nothing else; every pack has a no-fire twin under
``tests/analysis_fixtures/torch/``), the live port tree (clean modulo
suppressions, the ctypes ABI of all five kernel libraries read and equal,
the constant folder's figures, the declared tables two-sided and naming
code that exists), the reference (the port's PR01-PR04 give the reference
analyzer's findings on the reference's own protocol fixtures), and the CLI
(exit codes, JSON, the catalogue, no JAX or reference import).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (
    Options,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    default_paths,
    rules_capture,
    rules_cuda,
    rules_protocol,
)
from repro_torch.analysis.core import CudaContext, FileContext, extern_c_signatures
from repro_torch.kernels import _build
from repro_torch.kernels.ipls_aggregate import ops as agg_ops
from repro_torch.kernels.quantize import ops as q_ops

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis_fixtures"
TORCH_FIXTURES = FIXTURES / "torch"
KERNELS = REPO / "src" / "repro_torch" / "kernels"
LIBRARIES = ("decode_attention", "flash_attention", "ipls_aggregate", "linear_scan", "quantize")

# fixture (relative to analysis_fixtures) -> the one rule it must fire; the
# protocol pack fires on the reference's own fixtures, which the port's
# rules must read as the reference's do (test_protocol_rules_match_reference)
FIRE_CASES = {
    "pr01_fire.py": "PR01",
    "pr02_fire.py": "PR02",
    "pr03_fire.py": "PR03",
    "pr04_fire.py": "PR04",
    "torch/kw01_fire.py": "KW01",
    "torch/kw02_fire.py": "KW02",
    "torch/kw03_fire.py": "KW03",
    "torch/kw04_fire.py": "KW04",
    "torch/cu01_fire.py": "CU01",
    "torch/cu02_fire.cu": "CU02",
    "torch/cu03_fire.cu": "CU03",
    "torch/cu04_fire.cu": "CU04",
    "torch/cg01_fire.py": "CG01",
    "torch/cg02_fire.py": "CG02",
    "torch/cg03_fire.py": "CG03",
}
# each pack's no-fire twin, and the suppression fixtures
OK_CASES = {
    "protocol": ["protocol_ok.py", "torch/repro_torch/fl/vectorized.py"],
    "wrappers": ["torch/wrappers_ok.py"],
    "cuda": ["torch/csrc/cuda_ok.cu", "torch/wrappers_ok.py"],
    "capture": ["torch/capture_ok.py"],
}
NOQA_CASES = ["torch/noqa_ok.py", "torch/noqa_ok.cu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions here are small: run them on one thread, as
    every port test file does, and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def live_findings():
    """The port's tree analysed once, for the tests that read it."""
    return analyze_paths(default_paths(REPO))


def _rules(findings):
    return {f.rule for f in findings}


def _cuda(path: Path) -> CudaContext:
    return CudaContext(str(path), path.read_text())


def _python(path: Path) -> FileContext:
    src = path.read_text()
    return FileContext(str(path), src, ast.parse(src))


@pytest.mark.parametrize("name,rule", sorted(FIRE_CASES.items()))
def test_rule_fires_on_known_bad_fixture(name, rule):
    findings = analyze_file(FIXTURES / name)
    assert _rules(findings) == {rule}, f"{name}: expected only {rule}, got {findings}"


@pytest.mark.parametrize(
    "name", sorted({n for names in OK_CASES.values() for n in names} | set(NOQA_CASES))
)
def test_no_fire_on_known_good_fixture(name):
    findings = analyze_file(FIXTURES / name)
    assert findings == [], f"{name}: expected clean, got {findings}"


def test_every_rule_has_a_fire_fixture():
    assert set(FIRE_CASES.values()) == set(all_rules())
    assert len(all_rules()) == 15


def test_every_pack_has_fire_and_no_fire_coverage():
    packs = {r.pack for r in all_rules().values()}
    assert packs == set(OK_CASES)
    for pack, oks in OK_CASES.items():
        assert any(all_rules()[r].pack == pack for r in FIRE_CASES.values())
        assert all((FIXTURES / ok).is_file() for ok in oks)


def test_live_tree_clean_modulo_suppressions(live_findings):
    assert live_findings == [], "\n".join(f.render() for f in live_findings)


def test_live_tree_covers_the_port():
    paths = {p.relative_to(REPO).as_posix() for p in default_paths(REPO)}
    assert {"src/repro_torch", "chip_smoke.py", "tests/test_torch_analysis.py",
            "aggregate_variants.py", "train_depth_probe.py"} <= paths
    assert any(p.startswith("tests/torch_") for p in paths)


@pytest.mark.parametrize("suffix,comment", [(".py", "#"), (".cu", "//")])
def test_noqa_requires_matching_rule_id(suffix, comment):
    if suffix == ".py":
        src = (
            "def body(g, x):\n"
            "    with g.capture():\n"
            "        y = x.item()  {c} repro: noqa[CG03] wrong id does not suppress\n"
        )
        rule = "CG01"
    else:
        src = (
            "__global__ void __launch_bounds__(64) k(float* o) {{ o[0] = 1.0f; }}\n"
            "extern \"C\" int f(float* o, cudaStream_t s) {{\n"
            "  k<<<1, 128, 0, s>>>(o);  {c} repro: noqa[CU04] wrong id does not suppress\n"
            "  return static_cast<int>(cudaGetLastError());\n"
            "}}\n"
        )
        rule = "CU02"
    src = src.format(c=comment)
    assert _rules(analyze_source(f"f{suffix}", src)) == {rule}
    wrong = "CG03" if suffix == ".py" else "CU04"
    assert analyze_source(f"f{suffix}", src.replace(f"noqa[{wrong}]", f"noqa[{rule}]")) == []


def test_select_option_filters_rules():
    assert analyze_file(TORCH_FIXTURES / "cu02_fire.cu", Options(select={"CU03"})) == []
    assert _rules(analyze_file(TORCH_FIXTURES / "cg03_fire.py", Options(select={"CG03"}))) == {
        "CG03"}


@pytest.mark.parametrize("name,src", [("broken.py", "def f(:\n"),
                                      ("broken.cu", "int f() { return 0;\n")])
def test_syntax_error_is_a_finding(name, src):
    assert _rules(analyze_source(name, src)) == {"SYNTAX"}


# -- the live tree's CUDA contracts ------------------------------------------


def test_ctypes_abi_of_every_library_read_and_equal():
    """CU01's parser reads the 10 extern "C" entries of the five libraries
    and every argtypes list of their wrappers, and finds them equal."""
    rule = rules_cuda.CtypesAbi()
    entries = {}
    for lib in LIBRARIES:
        ctx = _python(KERNELS / lib / "ops.py")
        src = rule.source_of(ctx)
        assert src == KERNELS / lib / "csrc" / f"{lib}.cu"
        sigs = extern_c_signatures(src.read_text())
        aliases = rule._aliases(ctx)
        declared = {}
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "argtypes"):
                declared[node.targets[0].value.attr] = rule._kinds(node.value, aliases)
        assert set(declared) == set(sigs), lib
        for entry, (ret, params) in sigs.items():
            assert ret == "int"
            assert declared[entry] == [rule.c_kind(p) for p in params], entry
        entries.update(sigs)
    assert len(entries) == 10
    # the stream is every launching entry's last argument, a pointer
    launching = [e for e in entries if not e.endswith("_smem_bytes")]
    assert len(launching) == 8
    assert all(entries[e][1][-1] == "cudaStream_t" for e in launching)


def test_ctypes_abi_catches_a_shifted_argument():
    """A live wrapper with one int dropped from its argtypes fires CU01."""
    path = KERNELS / "quantize" / "ops.py"
    src = path.read_text().replace("[ptr] * 5 + [i64, ptr]", "[ptr] * 5 + [ptr]")
    findings = analyze_source(str(path), src, Options(select={"CU01"}))
    assert [f.line for f in findings] == [src.splitlines().index(
        "        lib.quantize_f32_int8.argtypes = [ptr] * 5 + [ptr]") + 1]


def test_folder_resolves_decode_and_leaves_templates_unresolved():
    decode = _cuda(KERNELS / "decode_attention" / "csrc" / "decode_attention.cu")
    assert decode.consts["kSmemBytes"] == 3 * 2 * 16384 + 128 == 98432
    assert rules_cuda.kernel_facts(decode)["decode_attn"] == {
        "launch_bounds_threads": 256, "static_smem_bytes": "unresolved",
        "dynamic_smem_bytes": [98432]}
    flash = rules_cuda.kernel_facts(_cuda(KERNELS / "flash_attention" / "csrc" /
                                          "flash_attention.cu"))
    # L::kSmem and smem_bytes<D>() depend on the template parameter D
    assert flash["flash_fwd_wgmma"]["dynamic_smem_bytes"] == ["unresolved"]
    assert flash["flash_fwd"]["dynamic_smem_bytes"] == ["unresolved"]
    assert flash["flash_fwd_wgmma"]["launch_bounds_threads"] == 384


def test_every_kernel_resolves_its_launch_bounds():
    """Every __global__ of the five libraries has __launch_bounds__ that
    fold, and every launch is found."""
    kernels = {}
    for lib in LIBRARIES:
        ctx = _cuda(KERNELS / lib / "csrc" / f"{lib}.cu")
        facts = rules_cuda.kernel_facts(ctx)
        assert all(isinstance(f["launch_bounds_threads"], int) for f in facts.values()), lib
        assert all(f["dynamic_smem_bytes"] for f in facts.values()), lib
        kernels.update(facts)
    assert sorted(kernels) == sorted([
        "decode_attn", "flash_fwd", "flash_fwd_wgmma", "ipls_aggregate_batched_kernel",
        "ipls_aggregate_batched_q_kernel", "rwkv6_scan_kernel", "quantize_kernel",
        "dequantize_kernel"])
    # static shared memory as ptxas reported it for these sources on an H100:
    # the codec's two float arrays, 40 bytes; the scan's 24 bytes of
    # mbarriers rounded to 32, where its dynamic array starts 16-byte aligned
    assert kernels["quantize_kernel"]["static_smem_bytes"] == 8 * 4 + 2 * 4
    assert kernels["rwkv6_scan_kernel"]["static_smem_bytes"] == 32


# -- declared tables ----------------------------------------------------------


def test_symmetry_table_is_two_sided():
    sides = rules_protocol.symmetry_is_balanced()
    assert sides["scalar"], "scalar engine has no declared accounting sites"
    assert sides["scalar"] == sides["vectorized"], sides


def test_protocol_tables_name_port_functions():
    for suffix, funcs in rules_protocol.SYMMETRY.items():
        assert suffix.startswith("repro_torch/")
        text = (REPO / "src" / suffix).read_text()
        for fn in funcs:
            assert f"def {fn}(" in text, f"{suffix}: declared '{fn}' not found"
    for suffix, fn in rules_protocol.EMITTER_FUNCS.items():
        assert suffix.startswith("repro_torch/")
        assert f"def {fn}(" in (REPO / "src" / suffix).read_text(), suffix


def test_pr04_schema_mirror_matches_live_schema():
    from repro_torch.telemetry import schema

    assert rules_protocol.METRIC_FINISH_KEYS == schema.FINISH_KEYS
    assert rules_protocol.METRIC_CHANNELS == schema.CHANNELS


def _qualified_defs(path: Path):
    out = set()

    def walk(node, prefix):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.ClassDef)):
                if isinstance(sub, ast.FunctionDef):
                    out.add(prefix + sub.name)
                walk(sub, prefix + sub.name + ".")
            else:
                walk(sub, prefix)

    walk(ast.parse(path.read_text()), "")
    return out


def test_captured_roots_exist_and_are_closed_over_imports():
    """Every declared captured function exists, and every port function
    that captured code calls through an import is declared: the table
    misses no code a capture reaches."""
    roots = rules_capture.CAPTURED_ROOTS
    for suffix, names in roots.items():
        missing = names - _qualified_defs(REPO / "src" / suffix)
        assert not missing, f"{suffix}: {missing}"
    reached = set()
    for path in default_paths(REPO):
        for f in [path] if path.is_file() else path.rglob("*.py"):
            if f.suffix != ".py":
                continue
            for mod, fn in rules_capture.capture_index(_python(f)).imported_callees():
                src = REPO / "src" / Path(*mod.split("."))
                src = src.with_suffix(".py") if src.with_suffix(".py").is_file() else (
                    src / "__init__.py")
                if src.is_file() and fn in _qualified_defs(src):
                    reached.add((src.relative_to(REPO / "src").as_posix(), fn))
    undeclared = {(s, fn) for s, fn in reached if fn not in roots.get(s, set())}
    assert not undeclared, undeclared
    assert ("repro_torch/kernels/ipls_aggregate/ops.py", "aggregate_batched") in reached


# -- held to the reference ----------------------------------------------------

PROTOCOL_FIXTURES = ["pr01_fire.py", "pr02_fire.py", "pr03_fire.py", "pr04_fire.py",
                     "protocol_ok.py"]
PROTOCOL_RULES = {"PR01", "PR02", "PR03", "PR04"}


@pytest.mark.parametrize("name", PROTOCOL_FIXTURES)
def test_protocol_rules_match_reference(name):
    """The port's PR01-PR04 give the reference analyzer's (rule, line)
    findings on the reference's own protocol fixtures."""
    from repro.analysis import Options as RefOptions
    from repro.analysis import analyze_file as ref_analyze_file

    ref = ref_analyze_file(FIXTURES / name, RefOptions(select=PROTOCOL_RULES))
    port = analyze_file(FIXTURES / name, Options(select=PROTOCOL_RULES))
    assert [(f.rule, f.line) for f in port] == [(f.rule, f.line) for f in ref]
    assert (name == "protocol_ok.py") == (ref == [])


def test_protocol_tables_differ_from_reference_only_by_path_keys():
    """The stated difference: the tables are keyed by the port's paths, so
    the reference's fixture at ``fl/vectorized.py`` (declared for the
    reference's engine) is undeclared for the port, and the port's twin at
    ``repro_torch/fl/vectorized.py`` is declared for both."""
    from repro.analysis import analyze_file as ref_analyze_file

    ref_fixture = FIXTURES / "fl" / "vectorized.py"
    assert ref_analyze_file(ref_fixture) == []
    port = analyze_file(ref_fixture, Options(select={"PR02"}))
    assert [f.line for f in port] == [14, 15, 16]
    twin = TORCH_FIXTURES / "repro_torch" / "fl" / "vectorized.py"
    assert ref_analyze_file(twin) == [] and analyze_file(twin) == []


# -- the repaired CPU branches ------------------------------------------------


def test_protocol_kernels_cpu_branches_go_through_plain():
    """The four protocol wrappers' CPU branches reach _build.plain under
    their kernels' names, and return what their plain versions return,
    bit for bit."""
    rng = np.random.default_rng(35)
    K, R, S = 2, 3, 2050
    w = torch.from_numpy(rng.standard_normal((K, S), dtype=np.float32))
    deltas = torch.from_numpy(rng.standard_normal((K, R, S), dtype=np.float32))
    mask = torch.from_numpy((rng.random((K, R)) < 0.7).astype(np.float32))
    eps = torch.from_numpy(rng.random(K, dtype=np.float32))
    nb = -(-S // 1024)
    q = torch.from_numpy(rng.integers(-127, 128, (K, R, S), dtype=np.int8))
    qs = torch.from_numpy((2.0 ** rng.integers(-9, -1, (K, R, nb))).astype(np.float32))
    own_mask = torch.from_numpy(np.array([1.0, 0.0], dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal(S, dtype=np.float32))
    codes, scales, _ = q_ops.ref.quantize(x, torch.zeros_like(x))
    calls = [
        ("ipls_aggregate_batched", agg_ops.aggregate_batched, (w, deltas, mask, eps),
         agg_ops.ipls_aggregate_batched_ref),
        ("ipls_aggregate_batched_q", agg_ops.aggregate_batched_q,
         (w, w * 0.5, q, qs, mask, own_mask, eps),
         agg_ops.ipls_aggregate_batched_q_ref),
        ("quantize", q_ops.quantize, (x, x * 0.5), q_ops.ref.quantize),
        ("dequantize", q_ops.dequantize, (codes, scales), q_ops.ref.dequantize),
    ]
    seen = []

    def hook(name, fn, args, kwargs):
        seen.append(name)
        return fn(*args, **kwargs)

    _build.plain_hooks.append(hook)
    try:
        got = [wrapper(*args) for _, wrapper, args, _ in calls]
    finally:
        _build.plain_hooks.remove(hook)
    assert seen == [name for name, *_ in calls]
    for (name, _, args, plain_fn), out in zip(calls, got):
        want = plain_fn(*args)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int8 if a.dtype == torch.int8 else torch.int32),
                b.view(torch.int8 if b.dtype == torch.int8 else torch.int32)), name


# -- the CLI -------------------------------------------------------------------


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)


@pytest.mark.parametrize("name,rule", [("torch/cu02_fire.cu", "CU02"),
                                       ("torch/kw04_fire.py", "KW04")])
def test_cli_exits_nonzero_on_known_bad_fixture(name, rule):
    proc = _run_cli(str(FIXTURES / name))
    assert proc.returncode == 1
    assert f" {rule} " in proc.stdout


def test_cli_exits_zero_on_the_port_tree():
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr


def test_cli_json_and_catalogue():
    proc = _run_cli(str(TORCH_FIXTURES / "cg02_fire.py"), "--json")
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload and {f["rule"] for f in payload} == {"CG02"}
    assert {"rule", "path", "line", "message"} <= set(payload[0])
    listed = _run_cli("--list-rules")
    assert listed.returncode == 0
    assert [line.split()[0] for line in listed.stdout.splitlines()] == sorted(all_rules())


def test_analysis_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "from repro_torch.analysis import analyze_file\n"
        f"found = analyze_file({str(TORCH_FIXTURES / 'cu03_fire.cu')!r})\n"
        "assert {f.rule for f in found} == {'CU03'}, found\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
