"""Where ``csrc/chol_solve.cu`` spends its time, on a CUDA card.

    python -m qmf_tpu_torch.tools.chol_phases [--batch 138493] [--k 64]

Builds copies of the kernel's source with one phase cut out, each with nvcc
into its own library under the kernels' build directory, and times them
beside the whole kernel on the same well-conditioned f32 systems, taking
turns (CUDA events, median of 7 rounds):

- ``full``: the kernel as it is;
- ``no_trailing``: without the trailing update of each panel;
- ``no_subst``: without the two substitutions;
- ``load_store``: only the load of the triangle and b and the store of x.

A cut copy computes wrong answers: its time only says what the phase it
lacks costs (``full`` minus ``no_trailing`` is the trailing update's time).
Prints the card's name and power limit, then one line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import torch

from qmf_tpu_torch import kernels

_SOURCE = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                       "chol_solve.cu")
_X_STORE = ("#pragma unroll\n  for (int t = 0; t < KT; ++t) {\n"
            "    const int i = lane + 32 * t;\n    if (i < k) x[")
# variant -> (first line cut, first line kept after the cut)
CUTS = {
    "no_trailing": ("      // Trailing update,",
                    "      __syncwarp();\n    }\n  }\n\n  // Forward"),
    "no_subst": ("  // Forward: L z = b", _X_STORE),
    "load_store": ("  // Factor, PW pivots per panel", _X_STORE),
}


def variant_sources(k: int) -> dict:
    """name -> source text; the kernel is instantiated only for k's slot
    count, so that nvcc stays short."""
    with open(_SOURCE) as f:
        src = f.read()
    src = src.replace('#include "chol_core.cuh"',
                      f'#include "{os.path.dirname(_SOURCE)}/chol_core.cuh"')
    slots = "constexpr int kMaxSlots = 11;"
    if slots not in src:
        raise RuntimeError(f"{_SOURCE} no longer declares {slots!r}")
    src = src.replace(slots, f"constexpr int kMaxSlots = {-(-k // 32)};")
    out = {"full": src}
    for name, (start, end) in CUTS.items():
        i = src.find(start)
        j = src.find(end, i)
        if i < 0 or j < 0:
            raise RuntimeError(f"{name}: {_SOURCE} has no {start!r} ... "
                               f"{end!r} to cut")
        out[name] = src[:i] + src[j:]
    return out


def build(k: int) -> dict:
    """name -> loaded library of each variant, built in parallel."""
    nvcc = kernels.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out_dir = os.path.join(kernels.BUILD_DIR, "chol_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variant_sources(k).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.qmf_chol_solve_f32.argtypes = [vp, vp, vp, ll, ci, ll, ll, ll,
                                           ll, ll, ll, ll, ci, vp]
        lib.qmf_chol_solve_f32.restype = ci
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=138_493)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chol_phases needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(args.k)
    bsz, k = args.batch, args.k
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(42)
    m = torch.randn(bsz, k, k, generator=g, device=dev)
    a = torch.baddbmm(torch.eye(k, device=dev), m, m.transpose(1, 2),
                      alpha=1.0 / k)
    del m
    b = torch.randn(bsz, k, generator=g, device=dev)
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        err = lib.qmf_chol_solve_f32(a.data_ptr(), b.data_ptr(),
                                     x.data_ptr(), bsz, k, *a.stride(),
                                     *b.stride(), *x.stride(), 0, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    times = {name: [] for name in libs}
    for lib in libs.values():
        launch(lib)
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for name, lib in libs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(lib)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, t in times.items():
        print(f"chol_phases B={bsz} k={k} f32 {name}: median_ms="
              f"{statistics.median(t)} min_ms={min(t)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
