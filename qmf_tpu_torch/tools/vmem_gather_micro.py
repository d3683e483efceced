"""Gather from a factor table kept in the card's L2, against the same gather
left to the cache's own policy and against ``index_select``.

    python -m qmf_tpu_torch.tools.vmem_gather_micro [n_rows_log2] [--device=cpu]

The counterpart of benchmarks/vmem_gather_micro.py, which asks whether a
gather from a table held in on-chip memory beats the gather from device
memory. 2^22 rows by default from a (65536, 64) bf16 table (8.4 MB), seed 0,
int32 indices. An SM's shared memory cannot hold that table; the 50 MB L2
can, so "kept on chip" here is an access-policy window that marks the
table's lines persisting (``l2_window``). Timed on the same indices (median
ms over 7 rounds of 10 calls, CUDA events), the three without a window
taking turns first, then the two with it:

  isel            torch.index_select (the baseline)
  cuda_vec        ops.gather.gather_rows, variant "vec"
  cuda_fill       the same with jnp.take's fill_value=0 bound check
  cuda_vec_l2     cuda_vec with the table pinned in L2
  cuda_fill_l2    cuda_fill with the table pinned in L2

each with ns per row and its share of the bound (the table read once, the
indices read, the rows written, over 3.35 TB/s). Then the first 1000 rows
are held against the table's rows as the original's spot check does, and
the whole output bit for bit against ``index_select``. The persisting
carve-out is given back before the tool returns.

It runs on the card unless ``--device=cpu`` is given; there only ``isel``
is timed, on the host's clock, and the kernel lines are left out.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import gather
from qmf_tpu_torch.tools.gather_micro import (
    CALLS, ROUNDS, card_line, gather_bounds, median_ms)

K = 64
TABLE_ROWS = 65536  # 65536 x 64 x bf16 = 8.4 MB
DEFAULT_LOG2 = 22


def inputs(n_rows_log2: int, device: torch.device) -> tuple:
    """(table (65536, 64) bf16, idx (2^n_rows_log2,) int32) of seed 0 on
    ``device``, drawn in the original's order."""
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(
        rng.integers(0, TABLE_ROWS, 1 << n_rows_log2).astype(np.int32))
    table = torch.as_tensor(
        rng.normal(0, 0.1, (TABLE_ROWS, K)).astype(np.float32))
    return table.to(device).to(torch.bfloat16), idx.to(device)


def sweep(n_rows_log2: int = DEFAULT_LOG2,
          device: str | torch.device = "cuda", rounds: int = ROUNDS,
          calls: int = CALLS) -> dict:
    """Times the gathers of 2^n_rows_log2 rows and checks the kernels;
    prints a line each and returns ``rows``, ``ms`` by name, ``bound_ms``,
    ``every_row_ms`` and, on a card, the persisting carve-out after the
    reset (``l2_limit_after``)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    n = 1 << n_rows_log2
    table, idx = inputs(n_rows_log2, device)
    bound_ms, every_ms = gather_bounds(table, idx)
    print(f"--- {n} rows from ({TABLE_ROWS}, {K}) bf16: bound "
          f"{bound_ms:.4f} ms, every row from memory {every_ms:.4f} ms "
          f"(at 3.35 TB/s)", flush=True)
    fns = {"isel": lambda: torch.index_select(table, 0, idx)}
    if on_card:
        for fill in (False, True):
            for window in (False, True):
                name = (f"cuda_{'fill' if fill else 'vec'}"
                        f"{'_l2' if window else ''}")
                fns[name] = (lambda fill=fill, window=window:
                             gather.gather_rows(table, idx, "vec", fill,
                                                window))
    out = {"rows": n, "bound_ms": bound_ms, "every_row_ms": every_ms}
    try:
        # the windowed launches leave persisting lines behind: the
        # others are timed first, among themselves
        ms = median_ms({k: f for k, f in fns.items() if "_l2" not in k},
                       device, rounds, calls)
        ms.update(median_ms({k: f for k, f in fns.items() if "_l2" in k},
                            device, rounds, calls))
        where = "" if on_card else "  [host clock, cpu]"
        for name, t in ms.items():
            print(f"  {name:13s} {t:9.4f} ms  {t / n * 1e6:7.3f} ns/row  "
                  f"{100 * bound_ms / t:5.1f}% of bound{where}", flush=True)
        out["ms"] = ms
        if on_card:
            ref = torch.index_select(table, 0, idx)
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                spot = torch.allclose(got[:1000].float(),
                                      table[idx[:1000].long()].float())
                diff = float((got.float() - ref.float()).abs().max())
                print(f"  {name} correct={spot} max |diff| = {diff}",
                      flush=True)
                if not spot or diff != 0.0 or not torch.equal(got, ref):
                    raise AssertionError(f"{name} differs from "
                                         f"index_select: max |diff| {diff}")
        else:
            print("  cuda_vec, cuda_fill (with and without the L2 window): "
                  "left out (--device=cpu; the kernels run only on a CUDA "
                  "device)", flush=True)
    finally:
        if on_card:
            out["l2_limit_after"] = kernels.reset_l2_persistence(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows_log2", nargs="?", type=int, default=DEFAULT_LOG2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("vmem_gather_micro needs a CUDA device (or "
                             "--device=cpu for index_select alone)")
        print(card_line(), flush=True)
    sweep(args.n_rows_log2, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
