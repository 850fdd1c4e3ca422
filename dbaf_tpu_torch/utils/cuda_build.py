"""Build the port's native sources on first use and load them with ctypes.

CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface; the host edge scheduler, the
repo's ``native/graphops.cpp`` built as it is, with ``g++``.  Outputs go to
``dbaf_tpu_torch/_build`` (listed in ``.gitignore``), named by a hash of the
source so an edited source is rebuilt.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = osp.abspath(osp.join(osp.dirname(__file__), ".."))
CSRC = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "_build")
GRAPHOPS_SRC = osp.join(osp.dirname(_PKG), "native", "graphops.cpp")

KERNELS = ("corr_fused_xy", "corr_lookup", "fg_linearize")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "corr_fused_xy": {
        "corr_fused_xy_launch": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
        "corr_fused_xy_int8_launch": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                      _VP],
        "corr_fused_xy_raw_launch": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    },
    "corr_lookup": {
        "corr_lookup_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    },
    "fg_linearize": {
        "fg_linearize_launch": [_VP, _I, _I, _I, _I, _I, _I, _VP],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if osp.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _lib_path(name: str, src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return osp.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _nvcc_cmd(src: str, out: str) -> List[str]:
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src,
    ]


def build_kernels(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, str]:
    """Compile every named kernel source not yet built, one ``nvcc`` per
    source, all started together.  Returns {name: library path}; raises
    with the compiler's output if any build fails.  ``verbose`` prints
    ``-Xptxas -v``'s register and shared-memory report."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    for name in names:
        src = osp.join(CSRC, f"{name}.cu")
        out = _lib_path(name, src)
        paths[name] = out
        if not osp.isfile(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                _nvcc_cmd(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"[build {name}]\n{log}", flush=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``.  The first use builds every
    kernel of ``KERNELS`` not yet built, all at once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = build_kernels(KERNELS)[name]
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def load_graphops() -> ctypes.CDLL:
    """The host edge scheduler ``native/graphops.cpp``, built with ``g++``
    into ``BUILD_DIR``.  Its edge order feeds slot order and age eviction,
    so the port runs the very source the reference runs."""
    lib = _libs.get("graphops")
    if lib is not None:
        return lib
    with _lock:
        if "graphops" not in _libs:
            os.makedirs(BUILD_DIR, exist_ok=True)
            src = GRAPHOPS_SRC
            if not osp.isfile(src):
                raise RuntimeError(f"graphops source not found: {src}")
            out = _lib_path("graphops", src)
            if not osp.isfile(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                res = subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                    capture_output=True, text=True,
                )
                if res.returncode != 0:
                    raise RuntimeError(f"graphops build failed:\n{res.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            lp = ctypes.POINTER(ctypes.c_long)
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.select_proximity_edges.restype = ctypes.c_int
            lib.select_proximity_edges.argtypes = [
                dp, lp, lp, ctypes.c_int, ctypes.c_int,
                lp, lp, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_int,
                lp, lp, ctypes.c_int,
            ]
            lib.dedup_edges.restype = ctypes.c_int
            lib.dedup_edges.argtypes = [lp, lp, ctypes.c_int, lp, lp, ctypes.c_int, ip]
            _libs["graphops"] = lib
    return _libs["graphops"]
