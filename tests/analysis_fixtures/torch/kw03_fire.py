"""KW03 fire: a library built when the module is imported, and nvcc run by
hand outside kernels/_build.py."""
import subprocess
from pathlib import Path

from repro_torch.kernels._build import build_library

_lib = build_library(Path(__file__).with_name("kernel.cu"))


def compile_variant(src: Path) -> None:
    subprocess.run(["nvcc", "-shared", "-o", str(src.with_suffix(".so")), str(src)], check=True)
