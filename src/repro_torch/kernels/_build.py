"""Build a kernel source with ``nvcc`` into a shared library, load it, launch.

Every kernel of the port is a ``.cu`` file with a plain C interface under
its module's ``csrc/``, compiled at first use (never at import) into
``build/`` beside it and loaded with ``ctypes``. The library is named by a
hash of its source and flags, so an edited source is rebuilt and a stale
one never loaded. Each wrapper counts its launches in its ``LAUNCHES`` (a
form of a kernel that only some callers take, in a counter of its own)
through ``count_launch``; kernels captured into a CUDA graph are counted at
every replay of a ``Graph``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Tuple, Union

import torch

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory per kernel, into the build log
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(src: Path) -> Path:
    """Where ``build_library`` puts the library of ``src``; its ``nvcc``
    output (ptxas's per-kernel resource lines) lies beside it, ``.log``."""
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src.parent.parent / "build" / f"lib{src.stem}-{tag}.so"


def build_library(src: Path) -> ctypes.CDLL:
    """Compile ``src`` (once per source hash) into ``<module>/build/`` and
    load it. Safe to call from several threads or processes at once: each
    compiles to its own temporary file and renames it into place."""
    so = library_path(src)
    if not so.exists():
        so.parent.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        tmp.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp.with_suffix(".log"), so.with_suffix(".log"))
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return ctypes.CDLL(str(so))


def launch(name: str, fn, *args, device: torch.device) -> None:
    """Call a library entry point with PyTorch's current stream on ``device``
    as its last argument; raise if it reports a CUDA error (a refused launch
    never runs, and a later synchronize would not say so)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


_capturing: List["Graph"] = []  # the Graph being captured, innermost last
# hooks that run a wrapper's plain version in their place, innermost last:
# (name, fn, args, kwargs) -> fn's result (``roofline/cost.py`` counts the
# call as the kernel's one pass)
plain_hooks: List[Callable] = []


def plain(name: str, fn: Callable, *args, **kwargs):
    """A kernel wrapper's plain version on CPU tensors, ``fn(*args,
    **kwargs)``, through the innermost ``plain_hooks`` entry if any."""
    if plain_hooks:
        return plain_hooks[-1](name, fn, args, kwargs)
    return fn(*args, **kwargs)


def forbid_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call of a forward-only wrapper:
    grad mode on and an input that requires grad. Its output has no
    ``grad_fn`` (the kernels write into fresh tensors, and the plain
    versions must behave as the kernels do), so the inputs' gradients would
    silently be zero. Training takes the plain differentiable path
    (``models.layers.apply_attention``); serving runs under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (its kernel has no backward) but an input requires grad: "
            "call it under torch.no_grad(), or train through the plain differentiable path"
        )


def count_launch(wrapper: Callable, counter: str = "LAUNCHES") -> None:
    """Count one launch of ``wrapper``'s kernel in its attribute ``counter``
    (``LAUNCHES``, or the counter of one form of the kernel). A call under
    CUDA-graph capture launches nothing: it is recorded in the ``Graph``
    being captured, whose every replay counts it."""
    if not torch.cuda.is_current_stream_capturing():
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    elif _capturing:
        key = wrapper if counter == "LAUNCHES" else (wrapper, counter)
        tally = _capturing[-1].launches
        tally[key] = tally.get(key, 0) + 1
    else:
        raise RuntimeError(
            f"{wrapper.__name__} captured outside a _build.Graph: its replays would go uncounted"
        )


class Graph:
    """A CUDA graph that counts the kernel launches it replays: the
    wrappers called under ``capture()`` record their kernels in
    ``launches`` (wrapper, or (wrapper, counter) for a form's own counter,
    -> launches per replay), and each ``replay()`` adds those to the
    wrappers' counters."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[Union[Callable, Tuple[Callable, str]], int] = {}
        self.replays = 0

    @contextmanager
    def capture(self, pool=None):
        """``torch.cuda.graph`` over this graph (``pool``: a memory pool to
        share with graphs replayed one after another on one stream)."""
        _capturing.append(self)
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                yield
        finally:
            _capturing.pop()

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for key, n in self.launches.items():
            wrapper, counter = key if isinstance(key, tuple) else (key, "LAUNCHES")
            setattr(wrapper, counter, getattr(wrapper, counter) + n)
