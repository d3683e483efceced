"""The frozen generator against the preset it freezes."""

import json
import os

import numpy as np
import pytest

from portbench import data
from qmf_tpu_torch.tools import datagen

from conftest import PKG


@pytest.mark.parametrize("config", ["wals_ml20m_k64", "bpr_ml20m_k30"])
def test_configs_hold_the_ml20m_preset(config):
    with open(os.path.join(PKG, "configs", config + ".json")) as f:
        sizes = json.load(f)["data"]
    assert {k: sizes[k] for k in ("n_users", "n_items", "target_nnz")} == \
        datagen.PRESETS["ml20m"]
    assert sizes["min_degree"] == 20  # datagen.generate's default


def test_sizes_and_format():
    u, i, v = data.generate(943, 1682, 100_000, seed=2**40 + 3,
                            device="cpu")
    # dense catalogs lose pairs to the deduplication, as the original does
    assert len(u) == len(i) == len(v) <= 100_000
    assert u.min() == 1 and u.max() == 943 and len(np.unique(u)) == 943
    assert i.min() >= 1 and i.max() <= 1682
    keys = u * 1682 + i
    assert np.all(np.diff(keys) > 0)  # sorted, no duplicate pair
    assert set(np.unique(v)) <= {0.5 * s for s in range(1, 11)}


def test_same_seed_same_data_and_other_seed_other_data():
    a = data.generate(300, 200, 6000, seed=7, device="cpu")
    b = data.generate(300, 200, 6000, seed=7, device="cpu")
    c = data.generate(300, 200, 6000, seed=8, device="cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def stats(users: np.ndarray, items: np.ndarray, n_items: int) -> dict:
    """Counts, the spread of user degrees, and the share of ratings on the
    1% most popular items."""
    deg_u = np.bincount(users)
    deg_u = deg_u[deg_u > 0]
    deg_i = np.bincount(items, minlength=n_items + 1)[1:]
    top = np.sort(deg_i)[::-1][: max(1, n_items // 100)]
    return {"nnz": int(len(users)), "users": int(len(deg_u)),
            "items": int((deg_i > 0).sum()),
            "user_degree_cv": float(deg_u.std() / deg_u.mean()),
            "top1pct_item_share": float(top.sum() / len(items))}


def test_statistics_match_the_numpy_preset():
    preset = datagen.PRESETS["ml1m"]
    ours = stats(*data.generate(**preset, seed=11, device="cpu")[:2],
                      preset["n_items"])
    theirs = stats(*datagen.generate(**preset, seed=11)[:2],
                        preset["n_items"])
    assert ours["nnz"] == pytest.approx(theirs["nnz"], rel=0.01)
    assert ours["users"] == theirs["users"]
    assert ours["items"] == pytest.approx(theirs["items"], rel=0.02)
    assert ours["user_degree_cv"] == pytest.approx(theirs["user_degree_cv"],
                                                   rel=0.1)
    assert ours["top1pct_item_share"] == pytest.approx(
        theirs["top1pct_item_share"], rel=0.05)
