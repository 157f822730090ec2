"""Build and load the port's CUDA kernels (``hgtpu_torch/csrc/*.cu``).

nvcc compiles each source to an object, one process per source, all
started together, and links them into ONE shared library with a plain C
interface for ``sm_90a``, loaded with ctypes: seconds to build, where a
PyTorch extension that includes torch's headers takes minutes.  The
build runs at first use, never at import, into ``build/hgtpu_torch/``
beside the package; the library's name carries a hash of the sources and
flags, so an edited source never loads a stale build.  Each launcher
returns the ``cudaError_t`` of its launch and the wrappers raise on it.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hgtpu_torch")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pwm, n_rows, reads, N, m, out, P1, stream
    "hgtpu_torch_placement_scores": (_VP, _I, _VP, _I, _I, _VP, _I, _VP),
    # links, V1, W, pitch, vars, H, K, out, opitch, ws, stream
    "hgtpu_torch_and_reduce_slab": (_VP, _I, _I, _I, _VP, _I, _I, _VP, _I,
                                    _I, _VP),
    # links, V1, W, pitch, vars, H, K, out, opitch, stream
    "hgtpu_torch_and_reduce_wide": (_VP, _I, _I, _I, _VP, _I, _I, _VP, _I,
                                    _VP),
    # planes, n_planes, words, table, rows, reads, E, W, lens, starts, P,
    # max_novel, del_mask, ins_mask, cost, over, stream
    "hgtpu_torch_banded_dp_bits": (_VP, _I, _I, _VP, _I, _VP, _I, _I, _VP,
                                   _VP, _I, _I, _I, _I, _VP, _VP, _VP),
    # table, rows, reads, E, W, lens, starts, P, max_novel, del_mask,
    # ins_mask, cost, over, stream
    "hgtpu_torch_banded_dp_warp": (_VP, _I, _VP, _I, _I, _VP, _VP, _I, _I,
                                   _I, _I, _VP, _VP, _VP),
    # codes, n_rows, L, mask, T, entries, E, cap, out, stream
    "hgtpu_torch_proposal_bound": (_VP, _I, _I, _VP, _I, _VP, _I, _I, _VP,
                                   _VP),
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        "libhgtpu_torch_%s.so" % h.hexdigest()[:16])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the hgtpu_torch CUDA kernels "
                           "need the CUDA toolkit")
    return found


def build() -> str:
    """Compile the kernels unless this exact build exists; returns the
    library path.  nvcc's output (ptxas register and shared-memory
    report) is kept beside it as ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    nvcc, srcs = _nvcc(), sources()
    objs = ["%s.%d.o" % (tmp, i) for i in range(len(srcs))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
            for o, src in zip(objs, srcs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]                 # every source at once
    runs = [(c, *p.communicate(), p.returncode) for c, p in zip(cmds, procs)]
    if all(rc == 0 for *_, rc in runs):
        link = [nvcc, *NVCC_FLAGS[:3], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.stdout, proc.stderr, proc.returncode))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    with open(path + ".log", "w") as f:
        for c, out, err, _rc in runs:
            f.write(" ".join(c) + "\n" + out + err)
    for c, _out, err, rc in runs:
        if rc != 0:
            raise RuntimeError("nvcc failed (%d): %s\n%s"
                               % (rc, " ".join(c[-2:]), err[-4000:]))
    os.replace(tmp, path)    # atomic: no process loads a half-written file
    return path


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError_t %d" % (name, err))
