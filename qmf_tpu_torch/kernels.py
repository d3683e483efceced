"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``qmf_tpu_torch/csrc/`` have a plain C interface. At first
use each is compiled with ``nvcc`` for ``sm_90a``, all at once in parallel,
and the objects are linked into ``qmf_tpu_torch/_build/libqmf_kernels.so``,
which is loaded with ``ctypes``. The build runs under a file lock and is
cached by a hash of the sources, the shared headers and the flags, so
concurrent processes build once and a changed file rebuilds.
Nothing here runs at import time: this module is imported on machines with no
CUDA toolkit, where :func:`available` is False.

If the build fails the error carries nvcc's stderr; nothing falls back to a
plain PyTorch version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("csrc/chol_solve.cu", "csrc/build_solve.cu")
HEADERS = ("csrc/chol_core.cuh",)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libqmf_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Opt-in shared memory per block on sm_90 (csrc/chol_core.cuh kMaxSmemBytes).
MAX_SMEM_BYTES = 232448
# csrc/build_solve.cu: register tile edge and reduction rows staged per step.
_BS_TILE, _BS_STAGE = 4, 32

_lib = None  # the loaded library, once per process
build_log = ""  # nvcc's output of the build this process ran (ptxas -v)


def nvcc_path() -> str | None:
    """The CUDA toolkit's nvcc, or None where there is no toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    return None


def available() -> bool:
    """True where a CUDA device and nvcc are both present."""
    return torch.cuda.is_available() and nvcc_path() is not None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in SOURCES + HEADERS:
        with open(os.path.join(_PKG_DIR, rel), "rb") as f:
            h.update(rel.encode())
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels if the cached library is missing or stale.

    Returns the library path. Raises RuntimeError with nvcc's stderr if the
    compiler is missing or fails.
    """
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _source_hash()
    stamp = LIB_PATH + ".sha256"
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(LIB_PATH) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    return LIB_PATH
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc not found (set "
                "CUDA_HOME or put nvcc on PATH)"
            )
        tmp = LIB_PATH + f".tmp{os.getpid()}"
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", os.path.join(_PKG_DIR, src),
                 "-o", obj] for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]
        for cmd, proc, (out, err) in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}"
                )
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}"
            )
        for obj in objs:
            os.remove(obj)
        build_log = "".join(out + err for out, err in outs)
        os.replace(tmp, LIB_PATH)
        with open(stamp, "w") as f:
            f.write(digest)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in ("qmf_chol_solve_f32", "qmf_chol_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ll, ci, ll, ll, ll, ll, ll, ll, ll,
                           ci, vp]
            fn.restype = ci
        for name in ("qmf_build_solve_f32", "qmf_build_solve_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 9 + [ll, ci, ci, ci, ci, vp]
            fn.restype = ci
        lib.qmf_cuda_error_string.argtypes = [ci]
        lib.qmf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def chol_solve_max_k(dtype: torch.dtype) -> int:
    """Largest k whose system fits one block's shared memory."""
    item = torch.empty((), dtype=dtype).element_size()
    k = 1
    while ((k + 1) * ((k + 1) | 1) + 2 * (k + 1)) * item <= MAX_SMEM_BYTES:
        k += 1
    return k


def launch_chol_solve(a: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor) -> None:
    """Launch csrc/chol_solve.cu on the current stream: x[i] = A[i]^-1 b[i].

    a (B, k, k), b (B, k) and x (B, k) are CUDA tensors of one float dtype
    with any strides (a batch-last buffer arrives as a permuted view). Does
    not synchronise. Raises on a refused launch.
    """
    lib = load()
    fn = {torch.float32: lib.qmf_chol_solve_f32,
          torch.float64: lib.qmf_chol_solve_f64}[a.dtype]
    bsz, k = b.shape
    err = fn(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, k,
        *a.stride(), *b.stride(), *x.stride(),
        a.device.index if a.device.index is not None else 0,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        raise RuntimeError(
            f"chol_solve launch failed (B={bsz}, k={k}, {a.dtype}): "
            f"CUDA error {err}: {msg}"
        )


def build_solve_max_k() -> int:
    """Largest k whose build+solve block fits shared memory (f32 A plus
    the staged rows of csrc/build_solve.cu)."""

    def smem(k: int) -> int:
        head = (k * (k | 1) + 2 * k + 3) // 4 * 4
        kp = -(-k // _BS_TILE) * _BS_TILE
        return (head + 2 * _BS_STAGE * kp + 2 * _BS_STAGE) * 4

    k = 1
    while smem(k + 1) <= MAX_SMEM_BYTES:
        k += 1
    return k


def launch_build_solve(yg: torch.Tensor, w: torch.Tensor, conf: torch.Tensor,
                       ytyl: torch.Tensor, w_a: torch.Tensor | None,
                       w_b: torch.Tensor | None, y_hot: torch.Tensor | None,
                       x: torch.Tensor, b: torch.Tensor) -> None:
    """Launch csrc/build_solve.cu on the current stream.

    All tensors contiguous on one CUDA device: yg (N, D, k) bf16 or f32;
    w, conf (N, D), ytyl (k, k), x and b (N, k) f32; with the hot head,
    w_a and w_b (N, H) and y_hot (H, k) of yg's dtype (None without it).
    Does not synchronise. Raises on a refused launch.
    """
    lib = load()
    fn = {torch.float32: lib.qmf_build_solve_f32,
          torch.bfloat16: lib.qmf_build_solve_bf16}[yg.dtype]
    n, d, k = yg.shape
    h = 0 if y_hot is None else y_hot.shape[0]
    hot_ptrs = ((None, None, None) if y_hot is None
                else (w_a.data_ptr(), w_b.data_ptr(), y_hot.data_ptr()))
    err = fn(
        yg.data_ptr(), w.data_ptr(), conf.data_ptr(), ytyl.data_ptr(),
        *hot_ptrs, x.data_ptr(), b.data_ptr(), n, d, k, h,
        yg.device.index if yg.device.index is not None else 0,
        torch.cuda.current_stream(yg.device).cuda_stream,
    )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        raise RuntimeError(
            f"build_solve launch failed (N={n}, D={d}, k={k}, H={h}, "
            f"{yg.dtype}): CUDA error {err}: {msg}"
        )
