"""Top-n recommendation, plainly: score every item for each user by the dot
product of their factors, drop the items the user has rated, and take the n
best, the lower item index first among equal scores."""

from __future__ import annotations

import torch

from portbench.reference import matmul, storage_dtype


def seen_mask(users: torch.Tensor, seen_keys: torch.Tensor, n_items: int):
    """(B, n_items) bool: whether users[b] rated item i, from the sorted
    keys user * n_items + item of the ratings."""
    lo = torch.searchsorted(seen_keys, users.to(torch.int64) * n_items)
    hi = torch.searchsorted(seen_keys, (users.to(torch.int64) + 1) * n_items)
    mask = torch.zeros((users.shape[0], n_items), dtype=torch.bool,
                       device=users.device)
    counts = hi - lo
    row = torch.repeat_interleave(torch.arange(users.shape[0],
                                               device=users.device), counts)
    start = torch.repeat_interleave(lo, counts)
    offset = torch.arange(row.shape[0], device=users.device) - \
        torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    mask[row, seen_keys[start + offset] % n_items] = True
    return mask


def scores(user_factors, item_factors, users, seen_keys, precision: str):
    """(B, n_items) scores of ``users`` in ``precision``, -inf at the items
    they rated."""
    dtype = storage_dtype(precision)
    s = matmul(user_factors[users].to(dtype), item_factors.to(dtype).T,
               precision)
    return s.masked_fill(seen_mask(users, seen_keys, item_factors.shape[0]),
                         -torch.inf)


def top_n(s: torch.Tensor, n: int):
    """(items, scores) of the n best of each row, descending, the lower
    index first among equal scores."""
    top, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :n], top[:, :n]
