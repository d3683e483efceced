"""Batched SPD solve variants at the WALS hot shape, on a CUDA card.

    python -m qmf_tpu_torch.tools.solver_micro [B ...] [--device=cpu]

The counterpart of benchmarks/solver_micro.py: k = 64, batch sizes 512 and
2048 by default, the same systems (seed 0, m m^T + 10 I in f32, drawn
through numpy in the same order). For each B it times

  solve_spd         ops.spd_solve.solve_spd, batch-first in and out
  solve_spd_t       solve_spd(layout="t"): the same with the batch moved
                    last by a copy of A and b, the wrapper's own
  kernel_only       ops.spd_solve.cholesky_solve_t on operands that already
                    lie batch-last (the copy is outside the timed call)
  linalg_solve      torch.linalg.solve, in the place of the XLA blocked
                    Cholesky the original compares with (the port has no
                    counterpart of it by design): one library call for the
                    same function, called nowhere else

and prints one line: the median ms of each (CUDA events around 10 calls, 7
rounds, the four taking turns, after one warm-up call each) and the
microseconds a system. The card's name and power limit come first. Both
kernel entries are then held against float64 numpy on the same systems
(normwise 2e-4), and anything else raises.

It runs on the card unless ``--device=cpu`` is given; there the solves are
the plain PyTorch version and the times the host's (said on every line).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from qmf_tpu_torch.ops import spd_solve
from qmf_tpu_torch.tools.gather_micro import card_line, median_ms

K = 64
DEFAULT_SIZES = (512, 2048)
TOL = 2e-4  # f32 kernel against float64, over max(1, the system's max |x|)


def systems(rng, bsz: int, device: torch.device) -> tuple:
    """(a (B, K, K), b (B, K)) f32 on ``device``, drawn from ``rng`` as the
    original draws them."""
    m = rng.normal(size=(bsz, K, K)).astype(np.float32)
    a = m @ m.transpose(0, 2, 1) + 10 * np.eye(K, dtype=np.float32)
    b = rng.normal(size=(bsz, K)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def sweep(sizes=DEFAULT_SIZES, device: str | torch.device = "cuda",
          rounds: int = 7, calls: int = 10) -> list:
    """Times the four variants at each batch size and checks both kernel
    entries; prints a line per size and returns a dict per size: ``batch``,
    ``ms`` by variant, ``max_scaled_err``."""
    device = torch.device(device)
    where = "" if device.type == "cuda" else "  [host clock, cpu]"
    rng = np.random.default_rng(0)
    results = []
    for bsz in sizes:
        a, b = systems(rng, bsz, device)
        a_t, b_t = a.permute(1, 2, 0).contiguous(), b.t().contiguous()
        fns = {
            "solve_spd": lambda: spd_solve.solve_spd(a, b),
            "solve_spd_t": lambda: spd_solve.solve_spd(a, b, layout="t"),
            "kernel_only": lambda: spd_solve.cholesky_solve_t(a_t, b_t),
            "linalg_solve": lambda: torch.linalg.solve(a, b),
        }
        ms = median_ms(fns, device, rounds, calls)
        want = np.linalg.solve(a.cpu().numpy().astype(np.float64),
                               b.cpu().numpy().astype(np.float64)[..., None])
        want = torch.from_numpy(want[..., 0])
        scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
        worst = 0.0
        for name, got in (("solve_spd", fns["solve_spd"]()),
                          ("kernel_only", fns["kernel_only"]().t())):
            err = float(((got.cpu().double() - want).abs() / scale).max())
            if not err <= TOL:
                raise AssertionError(f"B={bsz}: {name} is {err} from numpy "
                                     f"float64 (normwise), above {TOL}")
            worst = max(worst, err)
        print(f"B={bsz}: " + "  ".join(f"{n}={t:.4f}ms" for n, t in ms.items())
              + f"  (per solve: solve_spd {ms['solve_spd'] / bsz * 1e3:.3f}us,"
              f" kernel_only {ms['kernel_only'] / bsz * 1e3:.3f}us; max "
              f"normwise err {worst:.2e}){where}", flush=True)
        results.append({"batch": bsz, "ms": ms, "max_scaled_err": worst})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="*", type=int,
                    help="batch sizes (default: 512 2048)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("solver_micro needs a CUDA device (or "
                             "--device=cpu for the plain version on the "
                             "host's clock)")
        print(card_line(), flush=True)
    sweep(tuple(args.batch) or DEFAULT_SIZES, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
