"""Deterministic-init seed file generator (copy of qmf_tpu/data/gen_uniform.py).

Equivalent of the reference's ``gen_uniform`` binary
(reference qmf/gen_uniform.cpp:7-30): writes N uniform(-0.01, 0.01) doubles,
one per line at fixed 9-decimal precision, to a file consumed later via
``--distribution_file`` so independent runs (and independent implementations)
start from identical item factors — the reference's golden cross-check
technique (reference examples/README.md:4-13).
"""

from __future__ import annotations

import numpy as np


def gen_uniform(
    count: int = 1_000_000,
    out_file: str = "uniform.dat",
    bound: float = 0.01,
    seed: int | None = None,
) -> str:
    """Write ``count`` uniform(-bound, bound) samples, one per line."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-bound, bound, size=count)
    with open(out_file, "w") as f:
        f.writelines(f"{v:.9f}\n" for v in vals)
    return out_file
