# Verbatim copy of qmf_tpu/ops/packing.py (numpy only). The port cannot import
# the original because qmf_tpu/ops/__init__.py imports jax;
# tests/test_torch_packing.py holds the two array-identical.
"""Host-side grouping and degree-bucketed packing of COO ratings.

Replaces the reference's ``groupSignals`` (sort + run-length grouping into
per-user ``SignalGroup`` vectors, reference qmf/wals/WALSEngine.cpp:130-163)
with a layout XLA can consume: the ratings of each row (user or item) are
padded to a power-of-two width ``D`` and rows of similar degree are batched
together, so each device step is a fixed-shape batched einsum + Cholesky
solve over ``B`` rows at once.

Why degree buckets: real ratings data is power-law. Padding every user to the
global max degree would inflate FLOPs by ~50x on MovieLens-scale data; padding
within a bucket of similar-degree rows bounds the waste at <2x while keeping
shapes static (a handful of distinct ``(B, D)`` shapes => a handful of XLA
compilations, all cached).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Bucket:
    """A fixed-shape batch of same-width padded rows.

    row_ids: (B,) int32 — dense row indices; padding rows hold ``n_rows``
        (out of range, dropped by scatter with mode="drop").
    col_idx: (B, D) int32 — padded column indices (0 where masked).
    values:  (B, D) f32/f64 — rating values (0 where masked).
    mask:    (B, D) bool — True for real entries.
    """

    row_ids: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray
    mask: np.ndarray

    @property
    def shape(self) -> Tuple[int, int]:
        return self.col_idx.shape


def group_rows(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO by (row, col) and compute per-row degree (CSR-style).

    Returns (sorted cols, sorted vals, indptr (n_rows+1,), degrees (n_rows,)).
    Mirrors the reference's sortDataset + grouping order
    (qmf/wals/WALSEngine.cpp:152-163) so per-row signal order matches.
    """
    # lexsort-by-(rows, cols) via a single fused-key radix argsort when the
    # key space fits (numpy kind="stable" is radix for integers): 2.2x faster
    # than np.lexsort's per-key mergesort at MovieLens-20M scale. Falls back
    # to a chained stable argsort for huge id spaces.
    n_cols_max = int(cols.max()) + 1 if len(cols) else 1
    if n_rows * n_cols_max <= 1 << 32:
        key = rows.astype(np.uint32) * np.uint32(n_cols_max) + cols.astype(
            np.uint32
        )
        order = np.argsort(key, kind="stable")
    elif n_rows * n_cols_max <= 1 << 63:
        order = np.argsort(rows * np.int64(n_cols_max) + cols, kind="stable")
    else:
        o1 = np.argsort(cols, kind="stable")
        order = o1[np.argsort(rows[o1], kind="stable")]
    rows_s = rows[order]
    degrees = np.bincount(rows_s, minlength=n_rows).astype(np.int64)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    return cols[order], vals[order], indptr, degrees


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int, minimum: int = 8) -> int:
    d = minimum
    while d < x:
        d *= 2
    return d


def pad_widths(
    degrees: np.ndarray, min_width: int = 8, width_grid: str = "pow2"
) -> np.ndarray:
    """Vectorized padded width per row: smallest grid width >= degree.

    width_grid "pow2" uses 8,16,32,… (fill ~0.70 on MovieLens-20M power-law
    degrees); "pow2_15" interleaves 1.5x points — 8,12,16,24,32,48,… —
    raising fill to ~0.83 at ~2x the class count (2x the compiled einsum
    shapes, same scan-chunk rule); "pow2_q" interleaves quarter points —
    8,10,12,14,16,20,24,28,32,… — fill ~0.92 at ~4x the class count. The
    build's gather stream costs ~3.4 ns per padded ROW regardless of width
    (benchmarks/gather_micro.py), so fill directly buys epoch time; the
    price is more compiled einsum shapes in the fused epoch program.
    """
    deg = np.maximum(np.asarray(degrees, dtype=np.int64), 1)
    p2 = np.int64(1) << np.ceil(np.log2(deg)).astype(np.int64)  # >= deg
    w = np.maximum(min_width, p2)
    if width_grid == "pow2_15":
        w34 = (3 * w) // 4  # the 1.5*pow2 point below each pow2
        w = np.where(w34 >= deg, np.maximum(w34, min_width), w)
    elif width_grid == "pow2_q":
        # smallest of {5/8, 3/4, 7/8, 1}*p2 still >= deg (descending
        # tries); below p2=8 the //8 would floor to off-grid widths
        # (deg=3 -> 21//8=2), so quarter points only apply from p2 >= 8
        for num in (7, 6, 5):
            wq = (num * p2) // 8
            w = np.where((wq >= deg) & (p2 >= 8),
                         np.maximum(wq, min_width), w)
    elif width_grid != "pow2":
        raise ValueError(f"unknown width_grid: {width_grid}")
    return w


def coalesce_widths(
    widths: np.ndarray,
    degrees: np.ndarray,
    max_classes: int = 0,
    min_nnz_frac: float = 0.0,
) -> np.ndarray:
    """Bound the number of width classes by merging sparse ones upward.

    Every distinct width is a compiled program shape (and through a remote
    compile service, ~30-140 s of warmup each — BENCH_r03 measured 665 s of
    ml20m warmup at 43 classes). Two rules, both merging a class into the
    NEXT LARGER width (rows may always pad wider, never narrower):

    - any class covering < ``min_nnz_frac`` of the side's nnz merges
      unconditionally (its padding cost is bounded by its tiny nnz share);
    - while more than ``max_classes`` remain (0 = no cap), merge the
      ascending-adjacent pair whose extra padding (rows * width gap) is
      smallest.

    Returns the adjusted per-row widths (same order as ``widths``).
    """
    widths = np.asarray(widths)
    if max_classes <= 0 and min_nnz_frac <= 0:
        return widths
    uniq, inv = np.unique(widths, return_inverse=True)
    if len(uniq) <= 1:
        return widths
    deg = np.asarray(degrees, dtype=np.float64)
    cls = [
        # [width, nnz, rows, member uniq-indices]
        [int(w), float(deg[inv == i].sum()), int((inv == i).sum()), [i]]
        for i, w in enumerate(uniq)
    ]
    total = sum(c[1] for c in cls)

    def merge_up(i):
        cls[i + 1][1] += cls[i][1]
        cls[i + 1][2] += cls[i][2]
        cls[i + 1][3].extend(cls[i][3])
        del cls[i]

    i = 0
    while i < len(cls) - 1:
        if cls[i][1] < min_nnz_frac * total:
            merge_up(i)
        else:
            i += 1
    while max_classes > 0 and len(cls) > max_classes:
        costs = [
            cls[i][2] * (cls[i + 1][0] - cls[i][0])
            for i in range(len(cls) - 1)
        ]
        merge_up(int(np.argmin(costs)))

    new_width = np.empty(len(uniq), dtype=widths.dtype)
    for c in cls:
        for m in c[3]:
            new_width[m] = c[0]
    return new_width[inv]


def pack_buckets(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    dtype=np.float64,
) -> List[Bucket]:
    """Pack COO ratings into degree-bucketed padded batches.

    ``batch_rows`` bounds rows per bucket at the smallest width; wider buckets
    shrink ``B`` to keep per-call work roughly constant. ``row_multiple``
    additionally pads ``B`` for sublane alignment and so bucket batches can be
    sharded evenly over a device mesh (callers pass the device count).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    cols_s, vals_s, indptr, degrees = group_rows(rows, cols, vals, n_rows)

    # Rows ordered by degree; group rows whose padded width is equal.
    active = np.nonzero(degrees > 0)[0]
    order = active[np.argsort(degrees[active], kind="stable")]
    target_elems = batch_rows * min_width

    buckets: List[Bucket] = []
    i = 0
    while i < len(order):
        d_width = _next_pow2(int(degrees[order[i]]), min_width)
        # rows per call shrinks as width grows (constant work per call)
        cap = max(row_multiple, min(batch_rows, target_elems // d_width))
        j = i
        while (
            j < len(order)
            and j - i < cap
            and _next_pow2(int(degrees[order[j]]), min_width) == d_width
        ):
            j += 1
        chunk = order[i:j]
        b_pad = _round_up(len(chunk), row_multiple)

        row_ids = np.full(b_pad, n_rows, dtype=np.int32)
        row_ids[: len(chunk)] = chunk
        # Vectorized padded gather: flat positions indptr[r] + [0, D) per row,
        # clamped and masked where beyond the row's degree.
        deg = degrees[chunk]
        offsets = np.arange(d_width, dtype=np.int64)[None, :]
        mask_c = offsets < deg[:, None]
        flat_pos = np.minimum(indptr[chunk][:, None] + offsets, len(cols_s) - 1)
        col_c = np.where(mask_c, cols_s[flat_pos], 0)
        val_c = np.where(mask_c, vals_s[flat_pos], 0.0)

        col_idx = np.zeros((b_pad, d_width), dtype=np.int32)
        values = np.zeros((b_pad, d_width), dtype=dtype)
        mask = np.zeros((b_pad, d_width), dtype=bool)
        col_idx[: len(chunk)] = col_c
        values[: len(chunk)] = val_c
        mask[: len(chunk)] = mask_c
        buckets.append(Bucket(row_ids, col_idx, values, mask))
        i = j
    return buckets


def pack_width_classes(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    dtype=np.float64,
    width_grid: str = "pow2",
    active_mask: np.ndarray | None = None,
    max_classes: int = 0,
    min_class_nnz_frac: float = 0.0,
) -> List[Bucket]:
    """Pack COO ratings into ONE padded array set per width class.

    Like :func:`pack_buckets` but rows of equal padded width stay together in
    a single (N_w, D) array (padded so ``N_w`` is a multiple of the chunk
    size the device program scans over). This keeps host->device transfers
    and compiled programs per width class at exactly one each — at
    MovieLens-20M scale that is ~17 programs instead of ~450.

    The chunk size for width D is ``max(row_multiple, min(batch_rows,
    batch_rows*min_width//D))`` — the same work-per-step rule as
    pack_buckets; callers pass the identical parameters to
    ``width_class_chunk`` to recover it.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    cols_s, vals_s, indptr, degrees = group_rows(rows, cols, vals, n_rows)
    if len(cols_s) == 0:
        # every entry was hot (see ops/hot.py): keep one sentinel element so
        # the fully-masked padded gathers below have a valid source
        cols_s = np.zeros(1, dtype=np.int64)
        vals_s = np.zeros(1, dtype=np.float64)

    # active_mask overrides which rows get a solve slot (the hot/cold split
    # packs cold entries only; all-hot rows arrive with cold degree 0 and
    # land in the min-width class fully masked — see ops/hot.py).
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

    classes: List[Bucket] = []
    boundaries = np.nonzero(np.diff(widths))[0] + 1
    for cls_rows, d_width in zip(
        np.split(active, boundaries),
        widths[np.concatenate([[0], boundaries])] if len(active) else [],
    ):
        d_width = int(d_width)
        chunk_b = width_class_chunk(
            d_width, batch_rows, min_width, row_multiple, n_rows=len(cls_rows)
        )
        n_pad = _round_up(len(cls_rows), chunk_b)

        row_ids = np.full(n_pad, n_rows, dtype=np.int32)
        row_ids[: len(cls_rows)] = cls_rows
        deg = degrees[cls_rows]
        offsets = np.arange(d_width, dtype=np.int64)[None, :]
        mask_c = offsets < deg[:, None]
        flat_pos = np.minimum(
            indptr[cls_rows][:, None] + offsets, max(len(cols_s) - 1, 0)
        )
        col_idx = np.zeros((n_pad, d_width), dtype=np.int32)
        values = np.zeros((n_pad, d_width), dtype=dtype)
        mask = np.zeros((n_pad, d_width), dtype=bool)
        col_idx[: len(cls_rows)] = np.where(mask_c, cols_s[flat_pos], 0)
        values[: len(cls_rows)] = np.where(mask_c, vals_s[flat_pos], 0.0)
        mask[: len(cls_rows)] = mask_c
        classes.append(Bucket(row_ids, col_idx, values, mask))
    return classes


def width_class_chunk(
    d_width: int,
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    n_rows: int = 0,
) -> int:
    """Rows per device scan step for a width-D class (constant work/step).

    When the class's true row count (``n_rows``) is smaller than the work
    cap, the chunk shrinks to it — otherwise tiny classes would be padded up
    to the cap (a 600-row class padded to a 2048-row chunk).
    """
    cap = min(batch_rows, max(1, (batch_rows * min_width) // d_width))
    if n_rows:
        cap = min(cap, _round_up(n_rows, row_multiple))
    return max(row_multiple, (cap // row_multiple) * row_multiple)


def chunks_for_classes(
    classes: List[Bucket],
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
) -> List[int]:
    """Scan chunk size for each packed width class.

    A class padded below the work cap is a single chunk (its padded height);
    otherwise the padded height is a multiple of the cap by construction.
    """
    return [
        min(
            width_class_chunk(c.shape[1], batch_rows, min_width, row_multiple),
            c.shape[0],
        )
        for c in classes
    ]


def packed_stats(buckets: List[Bucket]) -> dict:
    """Padding-efficiency stats (logged at init for observability)."""
    real = sum(int(b.mask.sum()) for b in buckets)
    padded = sum(b.mask.size for b in buckets)
    shapes = sorted({b.shape for b in buckets})
    return {
        "nnz": real,
        "padded_elems": padded,
        "fill_ratio": real / max(padded, 1),
        "num_buckets": len(buckets),
        "distinct_shapes": shapes,
    }
