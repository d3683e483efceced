"""Degree-class packing on the device (port of qmf_tpu/ops/device_pack.py).

The host packer (ops/packing.py) sorts the COO arrays in numpy and builds
the padded (col_idx, values, mask) arrays of every width class before they
are copied to the card; at ml20m its sort alone takes seconds. Here the raw
COO triple goes to the card once, and there

- each side's (row, col)-sorted CSR comes from one stable sort on the int64
  key ``row << 32 | col`` (torch has no multi-key sort; duplicate (row,
  col) pairs keep their input order, as numpy's stable sort keeps them on
  the host path), with ``indptr`` from ``torch.searchsorted``, and
- every width class's padded arrays come from one gather pass a class.

Only per-row degrees (one ``np.bincount`` a side) stay on the host, to plan
the classes' static shapes. The plan is metadata and splits the classes as
``pack_width_classes`` does, so device-packed and host-packed engines hold
the same classes element for element (tests/test_torch_device_pack.py).

``plan_width_classes``, ``plan_stats`` and ``ClassPlan`` are host numpy,
copied from qmf_tpu; the sorts and gathers are plain torch ops (qmf_tpu's
module is plain XLA and reaches no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from qmf_tpu_torch.ops.packing import (
    Bucket,
    _round_up,
    coalesce_widths,
    pad_widths,
    width_class_chunk,
)

# rows (row + n_rows for a hot entry) and cols share one int64 sort key
_COL_BITS = 32


@dataclasses.dataclass
class ClassPlan:
    """Host-side metadata for one width class (static shapes only)."""

    row_ids: np.ndarray  # (n_pad,) int32; padding rows hold n_rows
    d_width: int
    chunk_b: int


def plan_width_classes(
    degrees: np.ndarray,
    n_rows: int,
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    width_grid: str = "pow2",
    active_mask: np.ndarray | None = None,
    max_classes: int = 0,
    min_class_nnz_frac: float = 0.0,
) -> List[ClassPlan]:
    """Plan width classes from per-row degrees alone (no COO sort needed).

    Replicates ``pack_width_classes``'s splitting: active rows stable-sorted
    by padded width, split at width boundaries, row count padded to a chunk
    multiple with the ``n_rows`` sentinel.

    ``active_mask`` overrides which rows must appear in some class: the
    hot/cold split build (ops/hot.py) packs only COLD entries, but a row
    whose entries are all hot (cold degree 0) still needs its solve slot —
    it lands in the min-width class with a fully-masked signal list.
    """
    active = np.nonzero(
        degrees > 0 if active_mask is None else active_mask
    )[0]
    if len(active) == 0:
        return []
    widths = pad_widths(degrees[active], min_width, width_grid)
    widths = coalesce_widths(
        widths, degrees[active], max_classes, min_class_nnz_frac
    )
    order = np.argsort(widths, kind="stable")
    active, widths = active[order], widths[order]

    plans: List[ClassPlan] = []
    boundaries = np.nonzero(np.diff(widths))[0] + 1
    for cls_rows, d_width in zip(
        np.split(active, boundaries),
        widths[np.concatenate([[0], boundaries])],
    ):
        d_width = int(d_width)
        chunk_b = width_class_chunk(
            d_width, batch_rows, min_width, row_multiple, n_rows=len(cls_rows)
        )
        n_pad = _round_up(len(cls_rows), chunk_b)
        row_ids = np.full(n_pad, n_rows, dtype=np.int32)
        row_ids[: len(cls_rows)] = cls_rows
        plans.append(ClassPlan(row_ids, d_width, chunk_b))
    return plans


def plan_stats(plans: List[ClassPlan], nnz: int) -> dict:
    """Padding-efficiency stats from the metadata plan (mirrors
    packing.packed_stats without touching device arrays)."""
    padded = sum(len(p.row_ids) * p.d_width for p in plans)
    shapes = sorted({(len(p.row_ids), p.d_width) for p in plans})
    return {
        "nnz": nnz,
        "padded_elems": padded,
        "fill_ratio": nnz / max(padded, 1),
        "num_buckets": len(plans),
        "distinct_shapes": shapes,
    }


def _sort_by_row_col(keys: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor):
    """Stable sort of (keys, cols, vals) by (key, col): returns the sorted
    keys, cols and vals."""
    if len(keys) and (int(keys.max()) >= 1 << (63 - _COL_BITS)
                      or int(cols.max()) >= 1 << _COL_BITS):
        raise ValueError("row or column index too large for the device "
                         "pack's int64 sort key")
    packed, order = torch.sort((keys << _COL_BITS) | cols, stable=True)
    return packed >> _COL_BITS, cols[order], vals[order]


def _indptr(sorted_rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    return torch.searchsorted(
        sorted_rows, torch.arange(n_rows + 1, dtype=sorted_rows.dtype,
                                  device=sorted_rows.device), side="left")


def sorted_csr(
    rows: torch.Tensor,  # (nnz,) int64 dense row indices
    cols: torch.Tensor,  # (nnz,) int64 dense col indices
    vals: torch.Tensor,  # (nnz,) f32/f64
    n_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable (row, col) sort + CSR indptr, all on the device.

    Returns (cols_sorted, vals_sorted, indptr (n_rows+1,)). Matches the host
    ``group_rows`` ordering (reference sortDataset order,
    qmf/wals/WALSEngine.cpp:152-163) including duplicate-pair stability.
    """
    rows_s, cols_s, vals_s = _sort_by_row_col(rows, cols, vals)
    return cols_s, vals_s, _indptr(rows_s, n_rows)


def split_sorted_csr(
    rows: torch.Tensor,  # (nnz,) int64 dense row indices
    cols: torch.Tensor,  # (nnz,) int64 dense col indices
    vals: torch.Tensor,  # (nnz,) f32/f64
    is_hot: torch.Tensor,  # (nnz,) bool: the entry's column is hot
    n_rows: int,
    cold_nnz: int,  # host-counted size of the cold block
):
    """One sort that yields BOTH halves of the hot/cold split (ops/hot.py).

    Folding the hot flag into the row key (row + n_rows * is_hot) makes one
    stable (key, col) sort give the cold entries as a (row, col)-sorted
    prefix, sliced at the host-known ``cold_nnz``, and the hot entries as
    the suffix. Returns ``((cold cols_s, vals_s, indptr), (hot rows, cols,
    vals))``; the cold triple feeds ``pack_width_classes_device(presorted=
    ...)`` unchanged.
    """
    keys, cols_s, vals_s = _sort_by_row_col(
        rows + n_rows * is_hot.to(rows.dtype), cols, vals)
    return (cols_s[:cold_nnz], vals_s[:cold_nnz],
            _indptr(keys[:cold_nnz], n_rows)), (
        keys[cold_nnz:] - n_rows, cols_s[cold_nnz:], vals_s[cold_nnz:])


def pack_width_classes_device(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_rows: int,
    degrees: np.ndarray,  # host (n_rows,), from np.bincount
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    width_grid: str = "pow2",
    active_mask: np.ndarray | None = None,
    presorted=None,  # optional (cols_s, vals_s, indptr) from split_sorted_csr
    max_classes: int = 0,
    min_class_nnz_frac: float = 0.0,
) -> Tuple[List[Bucket], List[ClassPlan]]:
    """Device-packed equivalent of ``packing.pack_width_classes``.

    Returns ``(classes, plans)``: per class a ``Bucket`` of tensors on
    ``vals``'s device, laid out as the engine's copy of a host-packed class
    (int64 row_ids and col_idx, values in ``vals``'s dtype, bool mask), and
    the host-side plans (chunk sizes, stats).
    """
    plans = plan_width_classes(
        degrees, n_rows, batch_rows, min_width, row_multiple, width_grid,
        active_mask=active_mask, max_classes=max_classes,
        min_class_nnz_frac=min_class_nnz_frac,
    )
    if not plans:
        return [], plans
    dev = vals.device
    if presorted is not None:
        cols_s, vals_s, indptr = presorted
    else:
        cols_s, vals_s, indptr = sorted_csr(rows, cols, vals, n_rows)
    if cols_s.shape[0] == 0:
        # every entry was hot: keep one masked sentinel so the padded
        # gathers below have a valid (fully ignored) source element
        cols_s = torch.zeros(1, dtype=cols_s.dtype, device=dev)
        vals_s = torch.zeros(1, dtype=vals_s.dtype, device=dev)
    # sentinel entry at index n_rows: degree 0, start 0
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    starts = torch.cat([indptr[:-1], zero])
    degrees_ext = torch.cat([torch.from_numpy(
        np.asarray(degrees, dtype=np.int64)).to(dev), zero])
    last = cols_s.shape[0] - 1
    classes = []
    for p in plans:
        row_ids = torch.from_numpy(p.row_ids.astype(np.int64)).to(dev)
        offsets = torch.arange(p.d_width, device=dev)[None, :]
        mask = offsets < degrees_ext[row_ids][:, None]
        flat = (starts[row_ids][:, None] + offsets).clamp_(0, last)
        classes.append(Bucket(
            row_ids,
            torch.where(mask, cols_s[flat], 0),
            torch.where(mask, vals_s[flat], 0),
            mask,
        ))
    return classes, plans
