"""
Build and load the port's kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded with ctypes. The build runs at
first use, from the sources in this directory only, into `build/` (listed in
.gitignore). Library names carry a hash of every source and of the flags, so a
changed source builds anew and a stale library is never loaded. All missing
libraries compile at once, one nvcc process per source.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# source stem -> (C function, its argtypes); restype is int (a cudaError_t)
_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
FUNCTIONS = {
    "fused_bias_noise_lrelu": (
        "gance_fused_bias_noise_lrelu", [_P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P]
    ),
    "upsample2x_blur": (
        "gance_upsample2x_blur", [_P, _P, _L, _I, _I, _F, _F, _F, _F, _I, _P]
    ),
    "blur4_separable": (
        "gance_blur4_separable_pad11", [_P, _P, _L, _I, _I, _I, _F, _F, _F, _F, _I, _P]
    ),
    "phase_conv1_torgb": (
        "gance_phase_conv1_torgb", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    ),
    "stencil_blur4_valid": (
        "gance_stencil_blur4_valid", [_P, _P, _L, _I, _I, _I, _I, _FP, _I, _P]
    ),
    "filtered_lrelu": (
        "gance_filtered_lrelu",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    ),
}
# a library's further C functions: name -> (source stem, C function, argtypes)
ENTRY_POINTS = {
    "blur4_separable_phases": (
        "blur4_separable", "gance_blur4_separable_pad11_phases",
        [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _F, _P],
    ),
}

# --fmad=false: no multiply-add contraction, so each kernel rounds after every
# operation in the order its plain twin does, and the two agree bit for bit.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> float:
    """
    Compile every library that is missing, all nvcc processes at once. Writes
    each compiler's output (register and shared-memory use) to
    `build/<name>.log`. Returns the seconds spent; raises on a failed build.
    """
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List = []
    for name in FUNCTIONS:
        target = library_path(name)
        if target.is_file():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        output, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(output)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{output.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def load(name: str) -> Callable[..., int]:
    """The C function `name` (a library of FUNCTIONS, or one of ENTRY_POINTS),
    building the libraries if needed."""
    if name not in _LOADED:
        if name in FUNCTIONS:
            stem, (symbol, argtypes) = name, FUNCTIONS[name]
        else:
            stem, symbol, argtypes = ENTRY_POINTS[name]
        target = library_path(stem)
        if not target.is_file():
            build_all()
        fn = getattr(ctypes.CDLL(str(target)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return _LOADED[name]
