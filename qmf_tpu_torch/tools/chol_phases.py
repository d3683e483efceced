"""Where ``csrc/chol_solve.cu`` spends its time, on a CUDA card.

    python -m qmf_tpu_torch.tools.chol_phases [--batch 138493] [--k 64]
        [--layout nat|t] [--systems S ...] [--beside OTHER.cu ...]

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
``--layout t`` times the batch-last entry on a resident (k, k, B) buffer
(its block-wide load and store are then what ``load_store`` times), once
for each S given with ``--systems``: the copies are then built with the
source's ``kBatchLastStep`` set to S, so that a block holds a multiple of S
systems (0, the default: the source as it is). ``--beside`` names other
versions of ``chol_solve.cu`` (an earlier commit's, say): the whole kernel of
each is timed in the same turns, which is how two versions are compared on
one card in one run. Prints the card's name and power limit, then one line
per variant and count.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

from qmf_tpu_torch import kernels

_SOURCE = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                       "chol_solve.cu")
_CORE_END = "}  // warp_factor_solve"
# variant -> (first line cut, first line kept after the cut)
CUTS = {
    "no_trailing": ("      // Trailing update,",
                    "      __syncwarp();\n    }\n  }\n\n  // Forward"),
    "no_subst": ("  // Forward: L z = b", _CORE_END),
    "load_store": ("  // Factor, PW pivots per panel", _CORE_END),
}


_SLOTS = "constexpr int kMaxSlots = 11;"
_STEP = "constexpr int kBatchLastStep = 8;"


def _set(src: str, path: str, decl: str, value: int) -> str:
    if decl not in src:
        raise RuntimeError(f"{path} no longer declares {decl!r}")
    return src.replace(decl, decl[:decl.index("=") + 2] + f"{value};")


def whole_source(k: int, path: str = _SOURCE) -> str:
    """The source at ``path`` with the kernel instantiated only for k's
    slot count, so that nvcc stays short."""
    with open(path) as f:
        src = f.read()
    src = src.replace('#include "chol_core.cuh"',
                      f'#include "{os.path.dirname(_SOURCE)}/chol_core.cuh"')
    return _set(src, path, _SLOTS, -(-k // 32))


def variant_sources(k: int, step: int = 0) -> dict:
    """name -> source text of the whole kernel and of each cut; ``step`` > 0
    sets the batch-last entry's ``kBatchLastStep``."""
    src = whole_source(k)
    if step:
        src = _set(src, _SOURCE, _STEP, step)
    out = {"full": src}
    for name, (start, end) in CUTS.items():
        i = src.find(start)
        j = src.find(end, i)
        if i < 0 or j < 0:
            raise RuntimeError(f"{name}: {_SOURCE} has no {start!r} ... "
                               f"{end!r} to cut")
        out[name] = src[:i] + src[j:]
    return out


def build(sources: dict) -> dict:
    """name -> loaded library of each source text, built in parallel."""
    nvcc = kernels.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out_dir = os.path.join(kernels.BUILD_DIR, "chol_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
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
        # ptxas -v: each kernel's name, then its registers (stderr)
        for ln in err.splitlines():
            if "Compiling entry" in ln or "Used" in ln:
                print(f"  {name}: {ln.split('info    : ')[-1].strip()}",
                      file=sys.stderr, flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for entry in ("qmf_chol_solve_f32", "qmf_chol_solve_t_f32"):
            fn = getattr(lib, entry, None)  # an earlier version has one
            if fn is not None:
                fn.argtypes = [vp, vp, vp, ll, ci, ll, ll, ll, ll, ll, ll,
                               ll, ci, vp]
                fn.restype = ci
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=138_493)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--layout", choices=("nat", "t"), default="nat")
    ap.add_argument("--systems", type=int, nargs="*", default=[0],
                    help="kBatchLastStep of the copies (--layout t; 0: the "
                         "source's)")
    ap.add_argument("--beside", nargs="*", default=[], metavar="OTHER.cu",
                    help="other versions of chol_solve.cu, timed whole")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chol_phases needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    counts = args.systems if args.layout == "t" else [0]
    sources = {f"{name}@{n}" if n else name: text for n in counts
               for name, text in variant_sources(args.k, n).items()}
    for i, path in enumerate(args.beside):
        sources[f"beside{i}"] = whole_source(args.k, path)
    libs = build(sources)
    bsz, k = args.batch, args.k
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(42)
    m = torch.randn(bsz, k, k, generator=g, device=dev)
    a = torch.baddbmm(torch.eye(k, device=dev), m, m.transpose(1, 2),
                      alpha=1.0 / k)
    del m
    b = torch.randn(bsz, k, generator=g, device=dev)
    if args.layout == "t":  # the resident batch-last buffers, viewed (B, ..)
        a = a.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        b = b.t().contiguous().t()
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream

    entry = ("qmf_chol_solve_t_f32" if args.layout == "t"
             else "qmf_chol_solve_f32")

    def launch(name):
        err = getattr(libs[name], entry)(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, k, *a.stride(),
            *b.stride(), *x.stride(), 0, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

    times = {name: [] for name in libs}
    for name in times:
        launch(name)
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for name, t in times.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(name)
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end))
    for name, t in times.items():
        print(f"chol_phases B={bsz} k={k} f32 {args.layout} {name}: "
              f"median_ms={statistics.median(t)} min_ms={min(t)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
