"""Build the CUDA kernels of `csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled on its own
by ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/<name>-<hash>.so`` beside the
package, at first use.  A kernel body shared by two element types lives in
a `csrc/*.cuh` header that each type's source includes.  The hash covers
the source, every header of `csrc/` and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  All
sources compile in parallel, one nvcc process each.  Importing this module
builds nothing; nothing here runs without nvcc (the CPU path never calls it).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
# C signature of each kernel's launcher: pointers and the stream as void*,
# sizes as int; every launcher returns the cudaError_t of its launch
SIGNATURES = {
    "fixed_point": ("mho_fixed_point_f32",
                    [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p]),
    "minplus": ("mho_minplus_square_f32",
                [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]),
    "chebconv": ("mho_chebconv_propagate_f32",
                 [_c_void_p] * 7 + [_c_int] * 4 + [_c_void_p]),
    "chebconv_ragged": ("mho_ragged_index",
                        [_c_void_p] * 7 + [_c_int] * 3 + [_c_void_p]),
    "coo_apsp": ("mho_coo_weights_f32",
                 [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]),
    "blocked_fw": ("mho_blocked_fw_f32", [_c_void_p] + [_c_int] * 2 + [_c_void_p]),
    # K2's backward: the VJP of one squaring (stack, slice, lead, s, g, gd,
    # m, w, B, N, stream)
    "minplus_bwd": ("mho_minplus_square_bwd_f32",
                    [_c_void_p, ctypes.c_longlong, _c_void_p, _c_int] + [_c_void_p] * 4
                    + [_c_int] * 2 + [_c_void_p]),
    # the bf16 leg of the precision policy (K2, K6's build, K4's forward; K4's
    # transposed walk is `mho_chebconv_transpose_bf16` of the same library;
    # K3); K2's and K3's bf16 sources instantiate the float32 kernels' bodies
    # (`csrc/minplus.cuh`, `csrc/blocked_fw.cuh`) on bf16
    "minplus_bf16": ("mho_minplus_square_bf16",
                     [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]),
    "coo_apsp_bf16": ("mho_coo_weights_bf16",
                      [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]),
    "chebconv_bf16": ("mho_chebconv_propagate_bf16",
                      [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p]),
    "blocked_fw_bf16": ("mho_blocked_fw_bf16", [_c_void_p] + [_c_int] * 2 + [_c_void_p]),
}

_loaded: dict = {}   # (name, symbol) -> bound ctypes function, one load per process
build_log: dict = {}  # name -> {"seconds", "ptxas", "cached"} of this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(src: str) -> str:
    h = hashlib.sha256()
    for path in (src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every `csrc/*.cu` whose library is missing, all in parallel.
    Returns {name: path}.  Raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        name = os.path.splitext(os.path.basename(src))[0]
        out = _target(src)
        paths[name] = out
        if os.path.isfile(out):
            build_log.setdefault(name, {"seconds": 0.0, "ptxas": "",
                                        "cached": True})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log, "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def kernel(name: str):
    """The bound C launcher of `csrc/<name>.cu`, building at first use."""
    return symbol(name, *SIGNATURES[name])


def symbol(name: str, symbol_name: str, argtypes: list):
    """C function `symbol_name` (returning int) of `csrc/<name>.cu`'s
    library, building at first use."""
    fn = _loaded.get((name, symbol_name))
    if fn is None:
        fn = getattr(ctypes.CDLL(build_all()[name]), symbol_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[(name, symbol_name)] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError_t {err}")
