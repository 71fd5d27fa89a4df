"""Builds and loads the port's native code: the hand-written CUDA kernels
(``csrc/*.cu``, ``load()``) and the host C library (``csrc/rle.c`` and
``csrc/contours.c``, ``host()``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together) and linked into one shared library with a
plain C interface; the host library is compiled by the host's C compiler.
Each is built at first use into ``build/nuhtc_tpu_torch/`` at the root of
the checkout (a directory ``.gitignore`` lists), under a name that carries a
hash of its sources, so an edited source builds anew. Nothing here runs at
import time: this package is imported on hosts without a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Callable, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nuhtc_tpu_torch")
SOURCES = ("window_block.cu", "component_stats.cu", "roi_align.cu", "vit_attention.cu")
HEADERS = ("wgmma_sm90.cuh",)  # included by window_block.cu and vit_attention.cu
# -Xptxas -v: registers, spills and shared memory of each kernel go to the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("rle.c", "contours.c")
_COMPILERS = ("cc", "gcc", "clang")  # the first one installed builds the host library

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types (pointers, ints, the stream last)
_SIGNATURES = {
    "window_block_launch": [_P] * 16 + [_I] * 7 + [_F, _I, _P],
    "window_attention_launch": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "roi_align_sum_launch": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 6 + [_P],
    "roi_align_sum_backward_launch": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_P],
    "component_stats_launch": [_P] * 6 + [_I] * 4 + [_P],
    "component_stats_strips": [_I, _I],  # returns a size, not an error code
    "vit_attention_launch": [_P] * 4 + [_I] * 5 + [_L] * 4 + [_F, _P],
}
# the host library's functions: (return type, argument types)
_HOST_SIGNATURES = {
    "rle_encode": (_L, [_P, _L, _L, _P, _L]),
    "rle_decode": (None, [_P, _L, _P, _L]),
    "rle_iou": (None, [_P, _P, _P, _L, _P, _P, _P, _L, _P, _P]),
    "rle_string_encode": (_L, [_P, _L, ctypes.c_char_p, _L]),
    "rle_string_decode": (_L, [ctypes.c_char_p, _L, _P, _L]),
    "contours_find": (_L, [_P, _L, _L, ctypes.c_int32, ctypes.c_int32, _P, _L]),
    "mask_extents": (None, [_P, _L, _L, _L, _P, _P]),
    "mask_pair_inter": (None, [_P, _L, _L, _P, _P, _P, _L, _P]),
    "rle_encode_crop": (_L, [_P] + [_L] * 7 + [_P, _L]),
}


def _path(prefix: str, names: Sequence[str], salt: str = "") -> str:
    """``BUILD_DIR/<prefix>_<digest>.so``, the digest that of the files
    ``names`` under csrc/ and of ``salt``."""
    h = hashlib.sha256()
    for name in names:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(salt.encode())
    return os.path.join(BUILD_DIR, f"{prefix}_{h.hexdigest()[:16]}.so")


def _build(path: str, compile_to: Optional[Callable[[str, str], None]]) -> Optional[str]:
    """``path`` once the library is there: unless it exists,
    ``compile_to(out, tmp)`` writes it at ``out`` in a temporary directory
    ``tmp`` beside it and it is moved into place whole. None where it does
    not exist and there is nothing to build it with (``compile_to`` None)."""
    if os.path.exists(path):
        return path
    if compile_to is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        compile_to(out, tmp)
        os.replace(out, path)
    return path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> str:
    return _path("libnuhtc_kernels", SOURCES + HEADERS, " ".join(NVCC_FLAGS))


def _nvcc_compile(out: str, tmp: str) -> None:
    nvcc = _nvcc()
    objects = [os.path.join(tmp, os.path.splitext(s)[0] + ".o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objects)]
    logs = [(s, p.communicate()[0], p.returncode) for s, p in zip(SOURCES, procs)]
    failed = [f"{s} ({rc}):\n{log}" for s, log, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objects],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    with open(log_path(), "w") as f:
        f.write("".join(log for _, log, _ in logs))


def build() -> str:
    """Compiles the kernels unless a library for these sources exists."""
    return _build(library_path(), _nvcc_compile)


def log_path() -> str:
    """nvcc's output of the build that made the library (ptxas -v lines)."""
    return os.path.splitext(library_path())[0] + ".log"


def resource_usage() -> list[dict]:
    """Per kernel of the built library, from the build log: demangled-enough
    name, registers, spill bytes (stores + loads) and static shared memory."""
    with open(log_path()) as f:
        text = f.read()
    rows = []
    pat = re.compile(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill "
                     r"loads.*?Used (\d+) registers(?:, (\d+) bytes smem)?", re.S)
    for name, st, ld, regs, smem in pat.findall(text):
        m = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+|[a-z0-9_]+)E)?", name)
        short = name if m is None else m.group(1) + (
            "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">" if m.group(2) else "")
        rows.append(dict(kernel=short, registers=int(regs), spill_bytes=int(st) + int(ld),
                         static_smem=int(smem or 0)))
    return rows


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call; later calls return it."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def host() -> Optional[ctypes.CDLL]:
    """The host C library, built on first call by the first of ``_COMPILERS``
    installed and loaded once; None where the library is not built and no C
    compiler is installed (the callers then run their Python versions). A
    compiler that is there and fails raises with its output: a broken build
    is never passed over."""
    cc = next((c for c in map(shutil.which, _COMPILERS) if c), None)
    srcs = [os.path.join(CSRC, name) for name in HOST_SOURCES]

    def compile_to(out: str, tmp: str) -> None:
        res = subprocess.run([cc, "-O2", "-shared", "-fPIC", *srcs, "-o", out],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cc} failed to build {', '.join(srcs)} ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")

    path = _build(_path("libhost", HOST_SOURCES), compile_to if cc else None)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} (cudaError_t)")
