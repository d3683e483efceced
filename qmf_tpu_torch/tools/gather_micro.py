"""Row-gather idiom sweep on a CUDA card, with the hand-written kernels.

    python -m qmf_tpu_torch.tools.gather_micro [N D ...] [--device=cpu]

The counterpart of benchmarks/gather_micro.py: the same table (26744 x 64,
seed 0, f32 and its bf16 rounding), the same default index shapes
(14336, 64) and (11520, 256), the flat index padded to a multiple of 512.
A WALS epoch gathers about 2 nnz factor rows of 128 to 512 bytes; this sweep
times the ways to write that gather on one class shape:

  base      y.to(bf16)[col]                  (the build's idiom)
  f32       y[col]                           (gather wider rows)
  flat      y.to(bf16).index_select(0, col.ravel()).reshape(...)
  take      torch.nn.functional.embedding(col, y_bf16)
  split4    four gathers of n/4 rows each, concatenated
  sorted    base on sorted indices (a locality probe: the result is
            permuted, timing only)
  isel      torch.index_select(y_bf16, 0, flat padded index)
  cuda_vec  ops.gather.gather_rows, variant "vec", on isel's inputs
  cuda_warp the same, variant "warp"

Each line gives the median ms (CUDA events around 10 calls, 7 rounds, the
idioms taking turns, after one warm-up call each), ns per row, GB/s of bf16
output, and the share of the bound: the least time for the table read once
plus the indices read and the rows written, over 3.35 TB/s. A second bound
reads every gathered row from device memory too. Then both kernels are held
bit for bit against isel: ``max |diff|`` must print 0, anything else raises.

It runs on the card unless ``--device=cpu`` is given; there the times are
the host's (said on every line) and the kernel lines are left out.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from qmf_tpu_torch.ops import gather

K = 64
N_ITEMS = 26744
DEFAULT_SPECS = ((14336, 64), (11520, 256))
PAD = 512
HBM_BPS = 3.35e12  # H100 SXM, NVIDIA's data sheet
ROUNDS, CALLS = 7, 10


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fns: dict, device: torch.device, rounds: int = ROUNDS,
              calls: int = CALLS) -> dict:
    """name -> median ms of one call, over ``rounds`` samples of ``calls``
    calls each, the callables taking turns, after one warm-up call each.
    CUDA events on a card, the host's clock on the CPU."""
    on_card = device.type == "cuda"
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(calls):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / calls)
            else:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                times[name].append(1e3 * (time.perf_counter() - t0) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def gather_bounds(table: torch.Tensor, idx: torch.Tensor) -> tuple:
    """(bound ms, every-row-from-memory ms) of ``table[idx]`` at 3.35 TB/s:
    the table read once plus the indices read and the rows written; and
    each gathered row read from device memory as well as written."""
    rows = idx.numel()
    row_bytes = table.shape[1] * table.element_size()
    least = (table.numel() * table.element_size()
             + rows * (idx.element_size() + row_bytes))
    every = rows * (2 * row_bytes + idx.element_size())
    return 1e3 * least / HBM_BPS, 1e3 * every / HBM_BPS


def tables(device: torch.device) -> tuple:
    """(rng, y, y_bf16): the (26744, 64) f32 table of seed 0 and its bf16
    rounding on ``device``, and the generator, ready for :func:`indices`."""
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.normal(0, 0.1, (N_ITEMS, K)),
                        dtype=torch.float32).to(device)
    return rng, y, y.to(torch.bfloat16)


def indices(rng, n: int, d: int, device: torch.device) -> tuple:
    """(col (n, d), its raveled form padded with zeros to a multiple of
    512), int32 on ``device``, drawn from ``rng``."""
    col = torch.as_tensor(rng.integers(0, N_ITEMS, (n, d)),
                          dtype=torch.int32).to(device)
    flat = col.reshape(-1)
    return col, torch.nn.functional.pad(flat, (0, (-flat.numel()) % PAD))


def sweep(specs=DEFAULT_SPECS, device: str | torch.device = "cuda",
          rounds: int = ROUNDS, calls: int = CALLS) -> list:
    """Times every idiom on each (N, D) spec and checks the kernels; prints
    a line per idiom and returns a dict per spec: ``spec``, ``rows``, ``ms``
    by idiom, ``bound_ms`` and ``every_row_ms``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    where = "" if on_card else "  [host clock, cpu]"
    rng, y, yb = tables(device)
    results = []
    for n, d in specs:
        col, flatp = indices(rng, n, d, device)
        rows = n * d
        col_sorted = col.reshape(-1).sort().values.reshape(col.shape)
        bound_ms, every_ms = gather_bounds(yb, flatp)
        print(f"--- ({n}, {d}): {rows / 1e6:.2f}M rows, {flatp.numel()} "
              f"padded; bound {bound_ms:.4f} ms, every row from memory "
              f"{every_ms:.4f} ms (at 3.35 TB/s)", flush=True)

        def split4(y, c):
            q = c.shape[0] // 4
            return torch.cat([y.to(torch.bfloat16)[c[i * q:(i + 1) * q]]
                              for i in range(4)])

        fns = {
            "base": lambda: y.to(torch.bfloat16)[col],
            "f32": lambda: y[col],
            "flat": lambda: y.to(torch.bfloat16).index_select(
                0, col.reshape(-1)).reshape(*col.shape, K),
            "take": lambda: torch.nn.functional.embedding(col, yb),
            "split4": lambda: split4(y, col),
            "sorted": lambda: y.to(torch.bfloat16)[col_sorted],
            "isel": lambda: torch.index_select(yb, 0, flatp),
        }
        if on_card:
            fns["cuda_vec"] = lambda: gather.gather_rows(yb, flatp, "vec")
            fns["cuda_warp"] = lambda: gather.gather_rows(yb, flatp, "warp")
        ms = median_ms(fns, device, rounds, calls)
        for name, t in ms.items():
            print(f"  {name:10s} {t:9.4f} ms  {t / rows * 1e6:7.3f} ns/row  "
                  f"{rows * K * 2 / t / 1e6:8.1f} GB/s(bf16)  "
                  f"{100 * bound_ms / t:5.1f}% of bound{where}", flush=True)
        if on_card:
            ref = torch.index_select(yb, 0, flatp)
            for variant in ("vec", "warp"):
                got = gather.gather_rows(yb, flatp, variant)
                torch.cuda.synchronize()
                diff = float((got.float() - ref.float()).abs().max())
                print(f"  cuda_{variant} max |diff| = {diff}", flush=True)
                if diff != 0.0 or not torch.equal(got, ref):
                    raise AssertionError(
                        f"cuda_{variant} differs from index_select on "
                        f"({n}, {d}): max |diff| = {diff}")
        else:
            print("  cuda_vec, cuda_warp: left out (--device=cpu; the "
                  "kernels run only on a CUDA device)", flush=True)
        results.append({"spec": (n, d), "rows": rows, "ms": ms,
                        "bound_ms": bound_ms, "every_row_ms": every_ms})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int,
                    help="N D pairs (default: 14336 64 11520 256)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.shape) % 2:
        ap.error("shapes come in N D pairs")
    specs = tuple(zip(args.shape[::2], args.shape[1::2])) or DEFAULT_SPECS
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("gather_micro needs a CUDA device (or "
                             "--device=cpu for the host's idioms alone)")
        print(card_line(), flush=True)
    sweep(specs, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
