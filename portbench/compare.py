"""The numbers that decide ``correct`` for a training cell, taken from the
factors the program's calls left after each of the first steps and the
reference's after the same steps from the same start.

A leaf is one factor matrix. Each number is the worst leaf's:

- ``change1``, ``change3``: the gap between the norm of the program's
  change of the leaf from the start, after step 1 or 3, and the
  reference's, over the reference's;
- ``drift3``: the norm of the difference between the program's leaf and
  the reference's after step 3, over the reference's change;
- ``loss``: the largest gap between a step's loss and the reference's, over
  the reference's (infinite where a step reported none).

Leaves whose change in the reference is under a thousandth of the median
leaf's are left out (none in these cells).
"""

from __future__ import annotations

import numpy as np
import torch


def rows_in_order(factors: torch.Tensor, ids: np.ndarray,
                  want: np.ndarray) -> torch.Tensor:
    """The rows of ``factors`` (labelled ``ids``) in the order of ``want``."""
    order = np.argsort(ids)
    at = order[np.searchsorted(ids, want, sorter=order)]
    if not np.array_equal(ids[at], want):
        raise ValueError("the program's ids are not the reference's")
    return factors[torch.from_numpy(at).to(factors.device)]


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def training_numbers(start, program, reference, prog_losses, ref_losses):
    """``start``: the leaves before step 1; ``program`` and ``reference``:
    the leaves after steps 1..3, lists of equal-length tuples of tensors in
    the reference's row order; the losses after each step."""
    changes = [_norm(r - s) for r, s in zip(reference[-1], start)]
    med = sorted(changes)[len(changes) // 2]
    keep = [i for i, c in enumerate(changes) if c >= 1e-3 * med]
    out = {}
    for step, name in ((0, "change1"), (len(reference) - 1, "change3")):
        out[name] = max(
            abs(_norm(program[step][i] - start[i])
                - _norm(reference[step][i] - start[i]))
            / _norm(reference[step][i] - start[i]) for i in keep)
    out["drift3"] = max(_norm(program[-1][i] - reference[-1][i]) / changes[i]
                        for i in keep)
    out["loss"] = float("inf") if len(prog_losses) != len(ref_losses) \
        else max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    return out
