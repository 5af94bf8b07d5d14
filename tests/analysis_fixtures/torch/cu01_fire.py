"""CU01 fire: argtypes one int short of csrc/cuda_ok.cu's scale_rows (the
stream would land in an int), a float where copy_rows takes an int64_t, and
an entry used with no declarations at all."""
import ctypes
from pathlib import Path

from repro_torch.kernels._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "cuda_ok.cu"
_lib = None


def build() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.scale_rows.argtypes = [ptr] * 2 + [i32] + [ptr]
        lib.scale_rows.restype = ctypes.c_int
        lib.copy_rows.argtypes = [ptr, ptr, ctypes.c_float, ptr]
        lib.copy_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes() -> int:
    return build().cuda_ok_smem_bytes()
