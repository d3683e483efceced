"""The WALS reference's bucketing and solve against a per-row solve."""

import numpy as np
import torch

from portbench.reference import wals as ref


def test_buckets_are_powers_of_two_that_hold_every_rating():
    deg = torch.arange(1, 1 << 17, dtype=torch.int64)
    width = ref.bucket_widths(deg)
    assert torch.all(width >= deg)
    assert torch.all(width & (width - 1) == 0)
    assert torch.all(width < 2 * deg.clamp(min=1))
    exact = 1 << torch.arange(17)
    assert torch.equal(ref.bucket_widths(exact), exact)


def test_solve_side_equals_a_per_row_solve_at_powers_of_two():
    rng = np.random.default_rng(3)
    degrees = [1, 2, 3, 4, 5, 8, 63, 64, 65, 256, 257]
    n_fixed, k, alpha, lam = 300, 6, 40.0, 0.05
    rows = np.repeat(np.arange(len(degrees)), degrees)
    cols = np.concatenate([rng.choice(n_fixed, d, replace=False)
                           for d in degrees])
    vals = rng.integers(1, 11, len(rows)) * 0.5
    side = ref.Side(rows, cols, vals, len(degrees), "cpu")
    fixed = rng.normal(size=(n_fixed, k))
    x, _ = ref.solve_side(torch.from_numpy(fixed), side, alpha, lam,
                          "float64", chunk_entries=64)
    for r in range(len(degrees)):
        y, v = fixed[cols[rows == r]], vals[rows == r]
        a = fixed.T @ fixed + (y * (alpha * v)[:, None]).T @ y \
            + lam * np.eye(k)
        b = ((1 + alpha * v)[:, None] * y).sum(0)
        np.testing.assert_allclose(x[r].numpy(), np.linalg.solve(a, b),
                                   rtol=1e-10, atol=1e-12)
