"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. With ``--trace 0`` the line holds the cell's end-to-end metrics
over a window of ``--seconds``; with ``--trace 1`` its per-layer metrics
over a few whole calls under the profiler, with ``busy_s``, ``window_s``
and a ``breakdown``. Both check the timed path's output against the plain
reference (``portbench/reference/``) once the window has closed and print
each number compared beside its limit, last on stderr and last in the line.

Exits 2 without the cards, 3 if the program loaded JAX, the JAX package,
the TPU benchmarks or the root bench; it then prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qmf_tpu", "benchmarks",
                       "bench"})
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``qmf_tpu_torch`` is not ``qmf_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def set_cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and the
    port's log quiet; ``transformers``-style JAX loading off."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("QMF_TPU_LOGLEVEL", "WARNING")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    from portbench import harness, spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": result.metrics,
            "device": {**result.device,
                       "power_limit_w": power_limit_w()}}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = result.checks
    for name, c in result.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_limit_w():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
