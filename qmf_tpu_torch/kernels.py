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

Every launch and device query runs under ``torch.cuda.device`` of its
tensor's device: the library sets the CUDA runtime's current device to the
one it launches on, and the guard gives the caller's back afterwards, so a
launch on ``cuda:N`` leaves PyTorch's current device as it was.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Callable, NamedTuple

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
# (source, extra nvcc flags) of each translation unit. chol_solve.cu's
# instantiations (one kernel per 32-row slot count) take nvcc the longest, so
# it is compiled once per dtype, side by side.
UNITS = (
    ("csrc/chol_solve.cu", ("-DQMF_CHOL_DTYPE=32",)),
    ("csrc/chol_solve.cu", ("-DQMF_CHOL_DTYPE=64",)),
    ("csrc/build_solve.cu", ()),
    ("csrc/gather.cu", ()),
    ("csrc/stamp.cu", ()),
    ("csrc/exclude_seen.cu", ()),
)
HEADERS = ("csrc/chol_core.cuh",)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libqmf_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Opt-in shared memory per block on sm_90 (csrc/chol_core.cuh kMaxSmemBytes),
# named in the kernels' errors.
MAX_SMEM_BYTES = 232448

_lib = None  # the loaded library, once per process
build_log = ""  # nvcc's output of the build this process ran (ptxas -v)

# The wrappers' launch counters, which each wrapper's module registers when
# it is imported: (namespace, name, key) reads ``namespace[name]``, or
# ``namespace[name][key]`` for a dict of counts. A wrapper ticks its counter
# in Python where it launches; a CUDA graph replays the launches without
# passing through the wrapper, so ops/graphs.py reads and sets every
# registered counter around a capture and a replay.
_counters: list = []


def register_counter(namespace: dict, name: str, key=None) -> None:
    """Register ``namespace[name]`` (``namespace[name][key]`` with a key)
    as a launch counter; ``namespace`` is the wrapper module's globals()."""
    _counters.append((namespace, name, key))


def counter_names() -> list[str]:
    """The registered counters, as ``module.name`` or ``module.name[key]``."""
    return [f"{ns['__name__'].rsplit('.', 1)[-1]}.{name}"
            + ("" if key is None else f"[{key}]")
            for ns, name, key in _counters]


def read_counters() -> list[int]:
    """The registered counters' values, in registration order."""
    return [ns[name] if key is None else ns[name][key]
            for ns, name, key in _counters]


def write_counters(values) -> None:
    """Set the registered counters to ``values`` (as read_counters)."""
    values = list(values)
    if len(values) != len(_counters):
        raise ValueError(f"{len(values)} values for {len(_counters)} "
                         f"registered counters")
    for (ns, name, key), n in zip(_counters, values):
        if key is None:
            ns[name] = n
        else:
            ns[name][key] = n


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
    for rel, flags in UNITS + tuple((rel, ()) for rel in HEADERS):
        with open(os.path.join(_PKG_DIR, rel), "rb") as f:
            h.update(" ".join((rel, *flags)).encode())
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
        objs = [f"{tmp}.{i}.o" for i in range(len(UNITS))]
        cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c",
                 os.path.join(_PKG_DIR, src), "-o", obj]
                for (src, flags), obj in zip(UNITS, objs)]
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
        for name in ("qmf_chol_solve_f32", "qmf_chol_solve_f64",
                     "qmf_chol_solve_t_f32", "qmf_chol_solve_t_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ll, ci, ll, ll, ll, ll, ll, ll, ll,
                           ci, vp]
            fn.restype = ci
        for name in ("qmf_build_solve_f32", "qmf_build_solve_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 13 + [ll] + [ci] * 6 + [vp]
            fn.restype = ci
        lib.qmf_build_solve_limits.argtypes = [ci, ctypes.POINTER(ci)]
        lib.qmf_build_solve_limits.restype = None
        for name in ("qmf_chol_solve_limits_f32",
                     "qmf_chol_solve_limits_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ci, ctypes.POINTER(ci)]
            fn.restype = ci
        lib.qmf_gather.argtypes = [vp, vp, vp, ll, ll, ll] + [ci] * 8 + [
            vp, ctypes.POINTER(ll)]
        lib.qmf_gather.restype = ci
        lib.qmf_l2_reset.argtypes = [ci, vp, ctypes.POINTER(ll)]
        lib.qmf_l2_reset.restype = ci
        lib.qmf_stamp.argtypes = [vp, vp, ll, ll, ci, vp]
        lib.qmf_stamp.restype = ci
        lib.qmf_exclude_seen.argtypes = [vp, ll, ll, ci, vp, vp, vp, ll, ci,
                                         vp]
        lib.qmf_exclude_seen.restype = ci
        lib.qmf_cuda_error_string.argtypes = [ci]
        lib.qmf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class CholSolveLimits(NamedTuple):
    """What csrc/chol_solve.cu takes for one dtype at one k: the largest k
    (one system's triangle in one block's shared memory), and at this k the
    systems each block holds (from shared memory and the kernel's
    registers) and one system's shared bytes (0 where k is above the
    largest). Then the same three for the batch-last entry, whose systems
    also keep b and x in shared memory, padded apart."""

    max_k: int
    systems_per_block: int
    system_bytes: int
    max_k_t: int
    systems_per_block_t: int
    system_bytes_t: int


@functools.lru_cache(maxsize=None)
def chol_solve_limits(dtype: torch.dtype, k: int = 1) -> CholSolveLimits:
    """The factor+solve kernel's limits for ``dtype`` at ``k``, as the
    library reports them."""
    lib = load()
    out = (ctypes.c_int * len(CholSolveLimits._fields))()
    fn = {torch.float32: lib.qmf_chol_solve_limits_f32,
          torch.float64: lib.qmf_chol_solve_limits_f64}[dtype]
    err = fn(k, out)
    if err != 0:
        raise RuntimeError(
            f"chol_solve limits (k={k}, {dtype}): CUDA error {err}: "
            f"{lib.qmf_cuda_error_string(err).decode()}")
    return CholSolveLimits(*out)


def chol_solve_max_k(dtype: torch.dtype, batch_last: bool = False) -> int:
    """Largest k the factor+solve kernel takes for ``dtype``, through its
    batch-first or its batch-last entry."""
    limits = chol_solve_limits(dtype)
    return limits.max_k_t if batch_last else limits.max_k


def launch_chol_solve(a: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor) -> None:
    """Launch csrc/chol_solve.cu on the current stream: x[i] = A[i]^-1 b[i].

    a (B, k, k), b (B, k) and x (B, k) are CUDA tensors of one float dtype
    with any strides; each warp loads its own system, which suits a batch
    stride of k*k. Does not synchronise. Raises on a refused launch.
    """
    lib = load()
    fn = {torch.float32: lib.qmf_chol_solve_f32,
          torch.float64: lib.qmf_chol_solve_f64}[a.dtype]
    bsz, k = b.shape
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, k,
            *a.stride(), *b.stride(), *x.stride(), _index(a.device),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        raise RuntimeError(
            f"chol_solve launch failed (B={bsz}, k={k}, {a.dtype}): "
            f"CUDA error {err}: {msg}"
        )


def launch_chol_solve_t(a_t: torch.Tensor, b_t: torch.Tensor,
                        x_t: torch.Tensor) -> None:
    """Launch csrc/chol_solve.cu's batch-last entry on the current stream:
    x_t[:, i] = A_t[:, :, i]^-1 b_t[:, i].

    a_t (k, k, B), b_t (k, B) and x_t (k, B) are CUDA tensors of one float
    dtype, read and written where they lie: a block loads its systems
    together, neighbours along B side by side, which suits a batch stride
    of 1 (other strides are still right). Does not synchronise. Raises on a
    refused launch.
    """
    lib = load()
    fn = {torch.float32: lib.qmf_chol_solve_t_f32,
          torch.float64: lib.qmf_chol_solve_t_f64}[a_t.dtype]
    k, bsz = b_t.shape
    sa_r, sa_c, sa_b = a_t.stride()
    (sb_r, sb_b), (sx_r, sx_b) = b_t.stride(), x_t.stride()
    with torch.cuda.device(a_t.device):
        err = fn(
            a_t.data_ptr(), b_t.data_ptr(), x_t.data_ptr(), bsz, k,
            sa_b, sa_r, sa_c, sb_b, sb_r, sx_b, sx_r, _index(a_t.device),
            torch.cuda.current_stream(a_t.device).cuda_stream,
        )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        raise RuntimeError(
            f"chol_solve batch-last launch failed (B={bsz}, k={k}, "
            f"{a_t.dtype}): "
            f"CUDA error {err}: {msg}"
        )


class BuildSolveLimits(NamedTuple):
    """What csrc/build_solve.cu takes for one stream dtype: the largest k
    (bounded by the row block's shared memory: its A, 1/diag and b, then
    the stream stage), the widest H slice of the hot head's GEMM (bounded
    by its Z tile), and that GEMM's rows and output columns per unit."""

    max_k: int
    hot_max_slice: int
    hot_tile_rows: int
    hot_tile_cols: int


@functools.lru_cache(maxsize=None)
def build_solve_limits(dtype: torch.dtype) -> BuildSolveLimits:
    """The build+solve kernels' limits for a ``dtype`` stream, as the
    library reports them."""
    out = (ctypes.c_int * len(BuildSolveLimits._fields))()
    load().qmf_build_solve_limits(int(dtype == torch.bfloat16), out)
    return BuildSolveLimits(*out)


def build_solve_max_k(dtype: torch.dtype) -> int:
    """Largest k the build+solve kernels take for a ``dtype`` stream."""
    return build_solve_limits(dtype).max_k


def _index(device: torch.device) -> int:
    """The CUDA device's ordinal (a bare "cuda" is the current device)."""
    return torch.cuda.current_device() if device.index is None \
        else device.index


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    with torch.cuda.device(device):
        return torch.cuda.get_device_properties(device).multi_processor_count


def launch_build_solve(yg: torch.Tensor, w: torch.Tensor, conf: torch.Tensor,
                       ytyl: torch.Tensor, w_a: torch.Tensor | None,
                       w_b: torch.Tensor | None, y_hot: torch.Tensor | None,
                       x: torch.Tensor, b: torch.Tensor, h_slices: int = 1,
                       n_slices: int = 1) -> None:
    """Launch csrc/build_solve.cu on the current stream.

    All tensors contiguous on one CUDA device: yg (N, D, k) bf16 or f32;
    w, conf (N, D), ytyl (k, k), x and b (N, k) f32; with the hot head,
    w_a and w_b (N, H) and y_hot (H, k) of yg's dtype (None without it).
    ``h_slices`` > 1 splits the hot head's GEMM over H, ``n_slices`` > 1
    each row's stream over D, over that many blocks. The kernels' scratch
    (the hot head's a0/b0, the split's partials) is allocated here, on the
    current stream. Does not synchronise. Raises on a refused launch.
    """
    lib = load()
    fn = {torch.float32: lib.qmf_build_solve_f32,
          torch.bfloat16: lib.qmf_build_solve_bf16}[yg.dtype]
    n, d, k = yg.shape
    h = 0 if y_hot is None else y_hot.shape[0]
    pairs = k * (k + 1) // 2

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=yg.device)

    hot_ptrs = [None] * 5
    if h:
        a0, b0 = scratch(n, h_slices, pairs), scratch(n, h_slices, k)
        hot_ptrs = [w_a.data_ptr(), w_b.data_ptr(), y_hot.data_ptr(),
                    a0.data_ptr(), b0.data_ptr()]
    ws_ptrs = [None, None]
    if n_slices > 1:
        ws_a, ws_b = scratch(n, n_slices, pairs), scratch(n, n_slices, k)
        ws_ptrs = [ws_a.data_ptr(), ws_b.data_ptr()]
    with torch.cuda.device(yg.device):
        err = fn(
            yg.data_ptr(), w.data_ptr(), conf.data_ptr(), ytyl.data_ptr(),
            *hot_ptrs, *ws_ptrs, x.data_ptr(), b.data_ptr(), n, d, k, h,
            h_slices, n_slices, _index(yg.device),
            torch.cuda.current_stream(yg.device).cuda_stream,
        )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        raise RuntimeError(
            f"build_solve launch failed (N={n}, D={d}, k={k}, H={h}, "
            f"H slices {h_slices}, D slices {n_slices}, {yg.dtype}): "
            f"CUDA error {err}: {msg}"
        )


# The access shapes of csrc/gather.cu, by the number qmf_gather knows them
# by.
GATHER_VARIANTS = {"vec": 0, "warp": 1, "tile": 2}


def launch_gather(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                  variant: str, fill: bool, l2_window: bool, width: int,
                  tile_rows: int = 0, tile_stages: int = 0) -> None:
    """Launch csrc/gather.cu on the current stream: out[r] = table[idx[r]].

    table (rows, k) and out (R, k) contiguous CUDA tensors of one dtype, idx
    (R,) int32 or int64 on the same device. ``width`` is the vector width in
    bytes (16, 8, 4 or 2) and must divide a row's bytes and both base
    pointers. Variant "tile" also takes its plan: ``tile_rows`` rows a
    tile and ``tile_stages`` tiles a warp. ``fill`` (variant "vec" only)
    gives zero rows for indices that are out of range after one wrap of the
    negatives. ``l2_window`` pins the
    table in L2 for this launch; :func:`reset_l2_persistence` gives the
    persisting carve-out back afterwards. Does not synchronise. Raises on a
    refused launch, and where the device refuses the window or grants less
    persisting L2 than the table takes.
    """
    lib = load()
    row_bytes = table.shape[1] * table.element_size()
    granted = ctypes.c_longlong(0)
    with torch.cuda.device(table.device):
        err = lib.qmf_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), out.shape[0],
            table.shape[0], row_bytes, width, int(idx.dtype == torch.int64),
            GATHER_VARIANTS[variant], int(fill), tile_rows, tile_stages,
            int(l2_window), _index(table.device),
            torch.cuda.current_stream(table.device).cuda_stream,
            ctypes.byref(granted),
        )
    if err != 0:
        msg = lib.qmf_cuda_error_string(err).decode()
        tile = (f", {tile_rows} rows x {tile_stages} tiles" if tile_rows
                else "")
        window = (f", L2 window of {table.shape[0] * row_bytes} bytes, "
                  f"persisting carve-out {granted.value} bytes"
                  if l2_window else "")
        raise RuntimeError(
            f"gather launch failed (R={out.shape[0]}, rows={table.shape[0]}, "
            f"row bytes {row_bytes}, width {width}, {idx.dtype}, {variant}"
            f"{tile}{', fill' if fill else ''}{window}): CUDA error {err}: "
            f"{msg}"
        )


def reset_l2_persistence(device: torch.device) -> int:
    """Wait for the current stream, return every persisting L2 line to
    normal and the persisting carve-out to 0, after launches with
    ``l2_window``. Returns the carve-out in bytes afterwards."""
    lib = load()
    limit = ctypes.c_longlong(-1)
    with torch.cuda.device(device):
        err = lib.qmf_l2_reset(
            _index(device), torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(
            f"L2 reset failed: CUDA error {err}: "
            f"{lib.qmf_cuda_error_string(err).decode()}")
    return limit.value


def stamp_launcher(ring: torch.Tensor,
                   count: torch.Tensor) -> Callable[[int], None]:
    """A function ``launch(tag)`` that launches csrc/stamp.cu on the
    current stream: (tag, the device's nanosecond clock) into
    ``ring[count % len(ring)]``, then ``count`` + 1.

    ring (entries, 2) int64 and count (1,) int64 on one CUDA device, both
    contiguous, kept alive by the caller. A captured launch is a graph node
    that stamps at every replay. The pointers and the device are read here
    once, and the library gives the caller's current device back itself,
    so no device guard is taken: a stamp costs the host its launch. Does
    not synchronise. Raises on a refused launch.
    """
    fn = load().qmf_stamp
    index = _index(ring.device)
    head = (ring.data_ptr(), count.data_ptr(), ring.shape[0])
    # the current stream's raw handle, without making a Stream object
    stream = torch._C._cuda_getCurrentRawStream

    def launch(tag: int) -> None:
        err = fn(*head, tag, index, stream(index))
        if err != 0:
            raise RuntimeError(
                f"stamp launch failed (tag {tag}): CUDA error {err}: "
                f"{load().qmf_cuda_error_string(err).decode()}")

    return launch


# The score dtypes csrc/exclude_seen.cu writes -inf into, by the number
# qmf_exclude_seen knows them by.
EXCLUDE_SEEN_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def launch_exclude_seen(scores: torch.Tensor, indptr: torch.Tensor,
                        items: torch.Tensor, users: torch.Tensor) -> None:
    """Launch csrc/exclude_seen.cu on the current stream: scores[b, j] =
    -inf for every j in items[indptr[users[b]] : indptr[users[b] + 1]]
    that lies in [0, scores.shape[1]).

    scores (B, I) contiguous, of a dtype in :data:`EXCLUDE_SEEN_DTYPES`;
    indptr (U + 1,), items and users (B,) int32; all contiguous on one CUDA
    device. The library gives the caller's current device back itself, so
    no device guard is taken. Does not synchronise. Raises on a refused
    launch.
    """
    lib = load()
    index = _index(scores.device)
    err = lib.qmf_exclude_seen(
        scores.data_ptr(), scores.shape[0], scores.shape[1],
        EXCLUDE_SEEN_DTYPES[scores.dtype], indptr.data_ptr(),
        items.data_ptr(), users.data_ptr(), indptr.shape[0] - 1, index,
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"exclude_seen launch failed (B={scores.shape[0]}, "
            f"I={scores.shape[1]}, {scores.dtype}): "
            f"CUDA error {err}: {lib.qmf_cuda_error_string(err).decode()}")
