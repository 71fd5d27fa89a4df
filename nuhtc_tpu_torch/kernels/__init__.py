"""Builds and loads the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together) and linked into one shared library with a
plain C interface, at first use, into ``build/nuhtc_tpu_torch/`` at the root
of the checkout (a directory ``.gitignore`` lists). The library's name
carries a hash of the sources, so an edited source builds anew. Nothing here
runs at import time: this package is imported on hosts without a GPU.
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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nuhtc_tpu_torch")
SOURCES = ("window_block.cu", "component_stats.cu", "roi_align.cu")
HEADERS = ("wgmma_sm90.cuh",)  # included by window_block.cu
# -Xptxas -v: registers, spills and shared memory of each kernel go to the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers, ints, the stream last)
_SIGNATURES = {
    "window_block_launch": [_P] * 16 + [_I] * 7 + [_F, _I, _P],
    "window_attention_launch": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "roi_align_sum_launch": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 6 + [_P],
    "roi_align_sum_backward_launch": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_P],
    "component_stats_launch": [_P] * 6 + [_I] * 4 + [_P],
    "component_stats_strips": [_I, _I],  # returns a size, not an error code
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnuhtc_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compiles the kernels unless a library for these sources exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, os.path.splitext(s)[0] + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objects)]
        logs = [(s, p.communicate()[0], p.returncode) for s, p in zip(SOURCES, procs)]
        failed = [f"{s} ({rc}):\n{out}" for s, out, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        with open(log_path(), "w") as f:
            f.write("".join(out for _, out, _ in logs))
        os.replace(lib, path)
    return path


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


def check(code: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} (cudaError_t)")
