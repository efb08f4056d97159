"""Build and load the CUDA kernels of ``pypmc_tpu_torch/csrc``.

The kernels are plain-C entry points compiled by ``nvcc`` for ``sm_90a``
into one shared library and loaded with ``ctypes``.  The library is built at
first use into ``build/`` beside the package, under a name keyed by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is loaded as it is.

This module also states the dense kernels' size limit.  Each thread keeps
one particle's coordinates in registers, unrolled to at most
:data:`D_MAX`; each block keeps the mixture operands and, for the
statistics kernels, a tile of per-particle rows in shared memory, which must
fit :data:`SMEM_LIMIT`.  A mixture past either limit is refused with the
limit named; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["D_MAX", "SMEM_LIMIT", "THREADS", "smem_bytes", "check_limits",
           "load", "build_info"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

D_MAX = 32             # register arrays are unrolled to 8, 16 or 32
SMEM_LIMIT = 232448    # bytes of shared memory one H100 block may use
THREADS = 128          # csrc/common.cuh kThreads
_TILE_STRIDE = THREADS + 1

_lib = None
build_info = {}


def _eval_floats(K, D):
    """Floats of a packed mixture's evaluation part (``MixLayout::L()``)."""
    return K * D + K * D * D + 4 * K


def _full_floats(K, D):
    """Floats of a whole packed mixture (``MixLayout::size()``)."""
    return _eval_floats(K, D) + K * D * D + K


def smem_bytes(kernel, K, D, Kt=0):
    """Shared memory one block of ``kernel`` asks for; mirrors the
    launchers in ``csrc/*.cu`` (``Kt`` is the target's component count)."""
    if kernel == "fused_logq":
        return 4 * _eval_floats(K, D)
    if kernel == "fused_propose_logq":
        return 4 * (_full_floats(K, D) + (_eval_floats(Kt, D) if Kt else 0))
    if kernel == "fused_pmc_stats":
        params = _eval_floats(K, D)
    elif kernel == "fused_is_pmc_step":
        params = _full_floats(K, D) + _eval_floats(Kt, D)
    else:
        raise ValueError("unknown kernel %r" % kernel)
    rows = K * D + 3 * K + 3
    entries = K * (3 + D + D * (D + 1) // 2) + 3
    acc_offset = (4 * (params + rows * _TILE_STRIDE) + 7) // 8 * 8
    return acc_offset + entries * (8 + 3 * 2)


def check_limits(kernel, K, D, Kt=0):
    """Raise ``ValueError`` naming the limit if a (K, D) mixture (with a
    Kt-component target) does not fit the dense kernel."""
    if not 1 <= D <= D_MAX:
        raise ValueError("%s: dimension %d is outside the dense kernels' "
                         "limit 1 <= D <= %d" % (kernel, D, D_MAX))
    need = smem_bytes(kernel, K, D, Kt)
    if need > SMEM_LIMIT:
        raise ValueError(
            "%s: K=%d, K_target=%d, D=%d needs %d bytes of shared memory a "
            "block; the dense kernel's limit is %d (the K-blocked kernels are "
            "not ported yet)" % (kernel, K, Kt, D, need, SMEM_LIMIT))


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / ("libpypmc_kernels_%s.so" % h.hexdigest()[:16])
    build_info.update(path=str(lib_path), built=False, seconds=0.0)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    lib_path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (exit %d):\n%s" % (proc.returncode, log))
    os.replace(tmp, lib_path)   # atomic: a concurrent build never sees a partial file
    build_info.update(built=True, seconds=seconds, log=log)
    return lib_path


def _declare(lib):
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    sigs = {
        # xT, mix, out, N, K, D, student_t, n_blocks, stream
        "pmc_fused_logq": [P, P, P, L, I, I, I, I, P],
        # s0, s1, mix, tmix, xT, latent, log_q, log_p, N, K, Kt, D,
        # student_t, t_student_t, n_blocks, stream
        "pmc_fused_propose_logq": [U, U, P, P, P, P, P, P, L, I, I, I, I, I,
                                   I, P],
        # xT, w, mix, partial, stats, N, K, D, student_t, dof_stats,
        # n_blocks, stream
        "pmc_fused_pmc_stats": [P, P, P, P, P, L, I, I, I, I, I, P],
        # s0, s1, mix, tmix, xT, latent, w, partial, stats, N, K, Kt, D,
        # student_t, t_student_t, dof_stats, n_blocks, stream
        "pmc_fused_is_pmc_step": [U, U, P, P, P, P, P, P, P, L, I, I, I, I,
                                  I, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmc_stats_smem_bytes.argtypes = [I, I, I, I]
    lib.pmc_stats_smem_bytes.restype = ctypes.c_longlong
    return lib


def load():
    """The kernel library, built on first use.  Raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(_build())))
    return _lib
