"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. Building this way takes
seconds; ``torch.utils.cpp_extension.load`` compiles PyTorch's headers and
takes minutes. The library goes to ``build/vangan_torch/`` at the
root of the checkout (git-ignored), named by a hash of the sources and the
headers they share (``csrc/*.cuh``), so an edit of either rebuilds it and an
unchanged checkout reuses it. Any build or load failure
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vangan_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_COUNT = ctypes.POINTER(ctypes.c_int)  # kernel launches made, added to by the entry
_SIGNATURES = {
    # x, w, bias, y, dtype, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz,
    # sx, sy, sz, px, py, pz, reflect, route, co_tile, stream
    "vg_conv3d_fwd": [_P, _P, _P, _P] + [_I] * 22 + [_P],
    # x, g, dw, ws, dtype, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy,
    # sz, px, py, pz, reflect, route, co_tile, tap_warps, split, ws_bytes,
    # stream
    "vg_conv3d_wgrad": [_P, _P, _P, _P] + [_I] * 24 + [ctypes.c_longlong, _P],
    # g, w, dx, buf, dtype, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx,
    # sy, sz, lx, ly, lz, hx, hy, hz, reflect, order, fold, route, ci_tile,
    # shared_halo, smem_bytes, buf_bytes, stream
    "vg_conv3d_dgrad": [_P, _P, _P, _P] + [_I] * 23 + [_P, _P] + [_I] * 4
                       + [ctypes.c_longlong, _P],
    # x, gamma, beta, y, ab, dtype, BC, C, N, route, cluster, threads, rpt,
    # vecs_per_block, smem_vecs, eps, act, alpha, stream, launched
    "vg_instnorm_fwd": [_P] * 5 + [_I, _I, _I, ctypes.c_longlong] + [_I] * 6
                       + [ctypes.c_float, _I, ctypes.c_float, _P, _COUNT],
    # x, g, ab, partial, sums, dx, dtype, BC, N, route, vec, vpt, nsplit, act,
    # alpha, stream
    "vg_instnorm_bwd": [_P] * 6 + [_I, _I, ctypes.c_longlong] + [_I] * 5 + [ctypes.c_float,
                                                                           _P],
    # img, skel_prev, skel_out, img_next, B, X, Y, Z, first, stream
    "vg_skeleton_round_fwd": [_P] * 4 + [_I] * 5 + [_P],
    # img, e, skel_prev, d_e_next, d_skel, d_img, d_skel_prev, B, X, Y, Z,
    # first, stream, launched
    "vg_skeleton_round_bwd": [_P] * 7 + [_I] * 5 + [_P, _COUNT],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def sources() -> list:
    """The files nvcc compiles, one object each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvangan_kernels_{h.hexdigest()[:12]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands in parallel; wait for all; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless an up-to-date library exists; return its path.

    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills of each kernel).
    """
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        reports = _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                             "-c", "-o", obj, str(src)]
                            for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        if verbose:
            print("".join(reports))
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vg_error_string.argtypes = [ctypes.c_int]
        lib.vg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a refused argument or a CUDA error."""
    if status == 1000:
        raise ValueError(f"{name}: arguments outside what the kernel takes")
    if status == 1001:
        raise RuntimeError(f"{name}: no thread-block cluster of this size and shared memory "
                           "is schedulable on this card")
    if status != 0:
        msg = library().vg_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
