"""Seeded synthetic ratings at a configuration's scale, made on the device.

The distribution is the ml20m preset's of the port's generator
(``qmf_tpu_torch/tools/datagen.py``, itself a copy of
``benchmarks/datagen.py``), frozen here so that no program change moves
the benchmark's data: lognormal user degrees (sigma 1.1) with a floor,
oversampled 2.5 times and capped at 80% of the catalog, zipf item
popularity (exponent 1.1), duplicate (user, item) pairs dropped, a random
subset of ``target_nnz`` pairs kept, ratings 0.5 to 5.0 in steps of 0.5.
The draws run in torch on the device (one generator seeded with the run's
seed, a few large calls), so a seed gives the same ratings on the same kind
of device; the data are the same distribution as the numpy original, not
the same numbers.
"""

from __future__ import annotations

import torch

OVERSAMPLE = 2.5
SIGMA = 1.1
ZIPF_A = 1.1


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int up to 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def generate(n_users: int, n_items: int, target_nnz: int, seed: int,
             device, min_degree: int = 20):
    """(users, items, values) as numpy int64, int64, float64, ids from 1,
    sorted by (user, item); every user has at least one rating."""
    dev = torch.device(device)
    g = generator(seed, dev)
    raw = torch.empty(n_users, dtype=torch.float64, device=dev)
    raw.log_normal_(0.0, SIGMA, generator=g)
    degrees = torch.clamp(raw / raw.mean() * (OVERSAMPLE * target_nnz
                                              / n_users), min=min_degree)
    degrees = torch.clamp(degrees, max=n_items * 0.8).to(torch.int64)
    users = torch.repeat_interleave(
        torch.arange(n_users, dtype=torch.int64, device=dev), degrees)
    ranks = torch.arange(1, n_items + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks ** (-ZIPF_A), 0)
    cdf /= cdf[-1].clone()
    u01 = torch.rand(users.shape[0], dtype=torch.float64, device=dev,
                     generator=g)
    items = torch.clamp(torch.searchsorted(cdf, u01), max=n_items - 1)
    keys = torch.unique(users * n_items + items)  # sorted, deduplicated
    if keys.shape[0] > target_nnz:
        pick = torch.randperm(keys.shape[0], device=dev, generator=g)
        keys = torch.sort(keys[pick[:target_nnz]]).values
    values = torch.randint(1, 11, (keys.shape[0],), device=dev,
                           generator=g).to(torch.float64) * 0.5
    users, items = keys // n_items, keys % n_items
    return ((users + 1).cpu().numpy(), (items + 1).cpu().numpy(),
            values.cpu().numpy())

