"""The port's packing copy is array-identical to qmf_tpu.ops.packing."""

import numpy as np
import pytest
import torch

from qmf_tpu.ops import packing as jax_packing
from qmf_tpu_torch.ops import packing

torch.set_num_threads(1)


def _coo(seed=0, n_rows=300, n_cols=80, nnz=4000):
    rng = np.random.default_rng(seed)
    # power-law-ish row degrees so several width classes appear
    rows = np.minimum(rng.zipf(1.6, nnz) - 1, n_rows - 1)
    cols = rng.integers(0, n_cols, nnz)
    key = np.unique(rows * n_cols + cols)
    return key // n_cols, key % n_cols, rng.uniform(0.5, 5.0, len(key)), n_rows


def _assert_same_buckets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("row_ids", "col_idx", "values", "mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("grid", ["pow2", "pow2_15", "pow2_q"])
@pytest.mark.parametrize("max_classes", [0, 4])
def test_width_classes_identical(grid, max_classes):
    rows, cols, vals, n = _coo()
    kw = dict(batch_rows=64, row_multiple=8, width_grid=grid,
              max_classes=max_classes)
    got = packing.pack_width_classes(rows, cols, vals, n, **kw)
    want = jax_packing.pack_width_classes(rows, cols, vals, n, **kw)
    _assert_same_buckets(got, want)
    assert len(got) > 1
    assert packing.chunks_for_classes(got, 64) == (
        jax_packing.chunks_for_classes(want, 64)
    )
    np.testing.assert_array_equal(
        packing.pad_widths(np.arange(1, 600), width_grid=grid),
        jax_packing.pad_widths(np.arange(1, 600), width_grid=grid),
    )


def test_buckets_and_stats_identical():
    rows, cols, vals, n = _coo(seed=3)
    got = packing.pack_buckets(rows, cols, vals, n, batch_rows=32)
    want = jax_packing.pack_buckets(rows, cols, vals, n, batch_rows=32)
    _assert_same_buckets(got, want)
    assert packing.packed_stats(got) == jax_packing.packed_stats(want)


def test_module_source_is_a_verbatim_copy():
    """Beyond the header comment, the port's file is the original's text."""
    import inspect

    port = inspect.getsource(packing)
    orig = inspect.getsource(jax_packing)
    assert port.endswith(orig)
    assert all(
        line.startswith("#") for line in port[: -len(orig)].splitlines()
    )
