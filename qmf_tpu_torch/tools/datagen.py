"""Deterministic synthetic MovieLens-like ratings generation.

A copy of benchmarks/datagen.py (``generate``, ``write_ratings``,
``PRESETS``, ``ensure_dataset``, ``load_npz``), so that the port's tools and
chip_smoke.py import nothing outside the package; tests/test_torch_host.py
holds it against the original. One difference: the cache of
``ensure_dataset`` and ``load_npz`` defaults to ``qmf_tpu_torch/_build/data``
(git-ignored) rather than a directory outside the checkout. One addition:
``write_ratings_parallel``, ``write_ratings``' bytes written by several
processes.

The presets stand in for the MovieLens sets with seeded synthetic data of
their scale and shape statistics:

- ml100k: 943 users x 1,682 items, ~100k ratings (every user >= 20)
- ml20m: 138,493 users x 26,744 items, ~20M ratings, power-law degrees
"""

from __future__ import annotations

import os

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "data")


def _zipf_item_probs(n_items: int, a: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def generate(
    n_users: int,
    n_items: int,
    target_nnz: int,
    seed: int = 0,
    min_degree: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Power-law user degrees, zipf item popularity, 0.5..5.0 ratings."""
    rng = np.random.default_rng(seed)
    # user degrees: lognormal, clipped, oversampled to survive dedup of
    # with-replacement zipf sampling, then trimmed back to target_nnz
    oversample = 2.5
    raw = rng.lognormal(mean=0.0, sigma=1.1, size=n_users)
    degrees = np.maximum(
        min_degree, raw / raw.mean() * (oversample * target_nnz / n_users)
    )
    degrees = np.minimum(degrees, n_items * 0.8).astype(np.int64)

    item_p = _zipf_item_probs(n_items)
    users = np.repeat(np.arange(n_users, dtype=np.int64), degrees)
    items = rng.choice(n_items, size=len(users), p=item_p)
    # dedup (user, item) pairs
    keys = users * np.int64(n_items) + items
    _, first = np.unique(keys, return_index=True)
    if len(first) > target_nnz:
        first = rng.choice(first, size=target_nnz, replace=False)
    first.sort()
    users, items = users[first], items[first]
    values = rng.integers(1, 11, size=len(users)) * 0.5
    return users + 1, items + 1, values


def write_ratings(path: str, users, items, values) -> None:
    """Write the reference text format fast via one big formatted buffer."""
    arr = np.stack(
        [users.astype(np.float64), items.astype(np.float64), values], axis=1
    )
    with open(path, "w") as f:
        np.savetxt(f, arr, fmt=["%d", "%d", "%.1f"])


def write_ratings_parallel(path: str, users, items, values,
                           parts: int = 8) -> None:
    """:func:`write_ratings`' bytes, its ``parts`` slices written by as
    many processes side by side and then joined (one np.savetxt of ml20m's
    20M rows takes about a minute)."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    cuts = np.linspace(0, len(users), parts + 1).astype(int)
    names = [f"{path}.part{k}" for k in range(parts)]
    # a worker that dies raises here (BrokenProcessPool) instead of hanging
    with ProcessPoolExecutor(parts, multiprocessing.get_context(
            "spawn")) as pool:
        for done in [pool.submit(write_ratings, name, users[a:b],
                                 items[a:b], values[a:b])
                     for name, a, b in zip(names, cuts[:-1], cuts[1:])]:
            done.result(timeout=600)
    with open(path, "wb") as out:
        for name in names:
            with open(name, "rb") as part:
                shutil.copyfileobj(part, out)
            os.remove(name)


PRESETS = {
    "ml100k": dict(n_users=943, n_items=1682, target_nnz=100_000),
    "ml1m": dict(n_users=6040, n_items=3706, target_nnz=1_000_000),
    "ml20m": dict(n_users=138_493, n_items=26_744, target_nnz=20_000_000),
    # large-catalog BPR scale check: the 200k x 100k id space puts the
    # exact positive bitmap at 2.5 GB (>> the 1 GiB budget), forcing the
    # blocked-Bloom membership path (ops/bpr_ops.py PosBloom)
    "synth100k": dict(n_users=200_000, n_items=100_000, target_nnz=20_000_000),
}


def ensure_dataset(preset: str, cache_dir: str = CACHE_DIR) -> str:
    """Generate (once) and return the path of a preset dataset file."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{preset}.txt")
    npz = os.path.join(cache_dir, f"{preset}.npz")
    if not os.path.exists(path):
        users, items, values = generate(**PRESETS[preset], seed=42)
        write_ratings(path, users, items, values)
        np.savez(npz, users=users, items=items, values=values)
    return path


def load_npz(preset: str, cache_dir: str = CACHE_DIR):
    ensure_dataset(preset, cache_dir)
    d = np.load(os.path.join(cache_dir, f"{preset}.npz"))
    return d["users"], d["items"], d["values"]


if __name__ == "__main__":
    import sys

    preset = sys.argv[1] if len(sys.argv) > 1 else "ml100k"
    p = ensure_dataset(preset)
    print(p)
