"""Build, load and call the hand-written CUDA kernels in csrc/.

The counterpart of utils/native_build.py for the GPU kernels.  At first use
``library()`` compiles each csrc/*.cu to an object file, one nvcc process per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c

(no --use_fast_math; -fmad=false keeps each kernel's mul+add chains in the
two-rounding form its plain PyTorch version computes; -Xptxas -v reports
registers and spills in the build log), links them into ONE shared library
with a plain C interface (nvcc -shared), writes it to build/torch_kernels/
beside the package, named by a hash of the sources and flags, and loads it
with ctypes.  A library that already exists under that name is reused.  The
toolkit is found through CUDA_HOME, then PATH, then /usr/local/cuda.  A
failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argument types.  Each returns cudaGetLastError().
SIGNATURES = {
    # pos, nrm, uv, mesh_id, mvp, model, T, M, W, H, cull, packed, aabb, stream
    "setup_triangles_launch": (P, P, P, P, P, P, I, I, F, F, I, P, P, P),
    # pos, mesh_id, mvp, T, M, W, H, cull, packed, aabb, stream
    "setup_depth_launch": (P, P, P, I, I, F, F, I, P, P, P),
    # counts, offs, records, lights, n_lights, mats, n_mats, uniforms, nty,
    # ntx, tile_h, tile_w, light_ids, light_counts, slots, vis, inv_gamma,
    # bump, strength, 2 pi freq, hdr_out, aux, color, tile_overflow, stream
    "fused_tiles_launch": (P, P, P, P, I, P, I, P, I, I, I, I, P, P, I, P, F, I, F, F, I, I, P, P, P),
    # counts, offs, records, nty, ntx, tile_h, tile_w, planes, stream
    "raster_tiles_launch": (P, P, P, I, I, I, I, P, P),
    # counts, offs, records, rows, nty, ntx, tile_h, tile_w, records a block, depth, stream
    "raster_depth_launch": (P, P, P, I, I, I, I, I, I, P, P),
    # planes, n_planes, lights, n_rows, ids, lk, counts, uniforms, nty, ntx,
    # tile_h, tile_w, gamma, hdr, stream
    "shade_tiles_launch": (P, I, P, I, P, I, P, P, I, I, I, I, F, P, P),
    # planes, uniforms, nty, ntx, tile_h, tile_w, strength, 2 pi freq, out, stream
    "bump_tiles_launch": (P, P, I, I, I, I, F, F, P, P),
    # planes, vis, mats, n_mats, uniforms, Hp, Wp, hdr, stream
    "directional_resolve_launch": (P, P, P, I, P, I, I, P, P),
    # idx, val, n, out, stream
    "row_scatter_launch": (P, P, I, P, P),
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


class BuildInfo:
    """What the last build of this process did: path, seconds, compiler log."""

    path = ""
    seconds = 0.0
    log = ""
    cached = False


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' shared library."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            digest.update(os.path.basename(s).encode() + fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libkernels_{digest.hexdigest()[:16]}.so")
    BuildInfo.path = path
    BuildInfo.cached = os.path.exists(path)
    if not BuildInfo.cached:
        nvcc, cu = _nvcc(), [s for s in srcs if s.endswith(".cu")]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                     for s, o in zip(cu, objs)]
            logs = [f"== {os.path.basename(s)}\n{p.communicate()[0]}" for s, p in zip(cu, procs)]
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs],
                                      capture_output=True, text=True)
                logs.append(f"== link\n{link.stdout}{link.stderr}")
                if link.returncode == 0:
                    os.replace(os.path.join(tmp, "lib.so"), path)
            BuildInfo.seconds = time.perf_counter() - t0
            BuildInfo.log = "".join(logs)
        if not os.path.exists(path):
            raise RuntimeError(f"nvcc failed:\n{BuildInfo.log}")
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def raise_on_error(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_tensors(device: torch.device, **specs) -> None:
    """Each spec is name=(tensor, dtype, shape) with None for a free
    dimension; every tensor must be contiguous and on `device`."""
    for name, (t, dtype, shape) in specs.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)
        ):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
