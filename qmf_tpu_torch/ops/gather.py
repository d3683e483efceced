"""Row gather ``table[idx]``: the hand-written CUDA kernels and their plain version.

Port of the three TPU gather probes: ``pallas_gather`` and ``pallas_take``
(benchmarks/gather_micro.py:68, :95) and the on-chip-table gather of
benchmarks/vmem_gather_micro.py (:68; ``_take_kernel`` with
``jnp.take(..., fill_value=0)``, ``_loop_kernel`` without a bound check).
All compute out[r] = table[idx[r]]; the port computes that function for
every r (``pallas_gather`` as written repeats its first block of indices in
every grid step; its docstring and its own check state the gather).

On a CUDA tensor :func:`gather_rows` launches ``csrc/gather.cu`` (see
qmf_tpu_torch/kernels.py) and raises if it cannot; on a CPU tensor it runs
:func:`gather_rows_plain`. The variants are access shapes of the same
copy: ``"vec"`` (a group of lanes per row, the widest vectors that fit),
``"warp"`` (a warp per row) and ``"tile"`` (a warp per tile of consecutive
output rows, staged through shared memory by asynchronous copies and
written by one bulk store, see :func:`tile_plan`). ``fill`` adds
``jnp.take``'s ``fill_value=0`` rule to ``"vec"``; without it an
out-of-range index is the caller's error and nothing checks it on the
device.

``launches`` counts kernel launches by kernel (the variants, and ``"fill"``);
CPU calls and empty index arrays do not count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qmf_tpu_torch import kernels

launches = {**dict.fromkeys(kernels.GATHER_VARIANTS, 0), "fill": 0}

_TABLE_DTYPES = (torch.bfloat16, torch.float32, torch.float64)
_WIDTHS = (16, 8, 4, 2)  # vector bytes, widest first
_TILE_BYTES = 4096  # what a tile aims at: 32 rows of 128 bytes
_TILE_MAX_ROWS = 32  # lane t of the warp holds the tile's index t


def _check(table: torch.Tensor, idx: torch.Tensor, variant: str,
           fill: bool) -> None:
    if variant not in kernels.GATHER_VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (expected one of "
                         f"{tuple(kernels.GATHER_VARIANTS)})")
    if fill and variant != "vec":
        raise ValueError('fill runs with variant "vec" only')
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"expected a table (rows >= 1, k >= 1), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in _TABLE_DTYPES:
        raise ValueError(f"expected a bfloat16, float32 or float64 table, "
                         f"got {table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected int32 or int64 indices, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table on {table.device} but idx on {idx.device}")


def vector_bytes(row_bytes: int, table_ptr: int, out_ptr: int,
                 variant: str = "vec") -> int:
    """The vector width in bytes a launch copies with: of 16, 8, 4 and 2,
    those that divide a row's bytes and both base pointers. ``"vec"`` takes
    the widest; ``"warp"`` the widest that still gives each of the 32 lanes
    a piece, else the narrowest."""
    legal = [w for w in _WIDTHS
             if row_bytes % w == 0 and table_ptr % w == 0 and out_ptr % w == 0]
    if not legal:
        raise ValueError(f"rows of {row_bytes} bytes at {table_ptr:#x} / "
                         f"{out_ptr:#x} are not 2-byte aligned")
    if variant == "warp":
        return next((w for w in legal if 32 * w <= row_bytes), legal[-1])
    return legal[0]


class TilePlan(NamedTuple):
    """How a ``"tile"`` launch moves its rows: ``rows`` consecutive output
    rows a tile, ``stages`` tiles a warp in shared memory, copies of
    ``width`` bytes."""

    rows: int
    stages: int
    width: int


def tile_plan(row_bytes: int, table_ptr: int, out_ptr: int) -> TilePlan:
    """The plan of a ``"tile"`` launch, by shape.

    A tile is as many rows as come to 4096 bytes, at least 1 and at most 32.
    Where a row's bytes and both base pointers are multiples of 16, a warp
    keeps two tiles, reads a tile's rows with 16-byte ``cp.async`` by groups
    of lanes and writes the tile with one bulk store. Bulk
    stores take only 16-byte sizes and addresses, so every other shape
    (k = 1, 3, 30 or 65 in bf16; a table view that starts one element into
    its storage) gets one tile a warp, lane copies of the widest width that
    fits into the tile and lane stores out of it: the same
    kernel, dispatched by shape. Raises where the tiles of one warp pass a
    block's shared memory.
    """
    width = vector_bytes(row_bytes, table_ptr, out_ptr)
    rows = max(1, min(_TILE_MAX_ROWS, _TILE_BYTES // row_bytes))
    plan = TilePlan(rows, 2 if width == 16 else 1, width)
    if plan.stages * plan.rows * row_bytes > kernels.MAX_SMEM_BYTES:
        raise ValueError(
            f"rows of {row_bytes} bytes are too long for variant \"tile\": "
            f"{plan.stages} tiles of them pass {kernels.MAX_SMEM_BYTES} "
            f"bytes of shared memory")
    return plan


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      fill: bool = False) -> torch.Tensor:
    """Plain PyTorch ``table[idx]``: ``index_select`` on the raveled index,
    shaped ``idx.shape + (k,)``. With ``fill``, negative indices wrap once
    and indices still outside [0, rows) give zero rows."""
    flat = idx.reshape(-1)
    shape = (*idx.shape, table.shape[1])
    if not fill:
        return table.index_select(0, flat).reshape(shape)
    rows = table.shape[0]
    wrapped = torch.where(flat < 0, flat + rows, flat)
    live = (wrapped >= 0) & (wrapped < rows)
    out = table.index_select(0, wrapped.clamp(0, rows - 1))
    return out.masked_fill_(~live.unsqueeze(1), 0).reshape(shape)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, variant: str = "vec",
                fill: bool = False, l2_window: bool = False) -> torch.Tensor:
    """``table[idx]`` for a (rows, k) table and integer idx of any shape:
    ``idx.shape + (k,)``, bit for bit the table's rows.

    ``l2_window`` pins the table in the card's L2 for the launch (it has to
    fit the persisting carve-out the device allows); call
    ``kernels.reset_l2_persistence`` after the last such launch.
    """
    _check(table, idx, variant, fill)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, fill)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {table.device}")
    if not table.is_contiguous():
        raise ValueError("the kernel takes a contiguous table (rows of k "
                         f"elements back to back), got strides "
                         f"{table.stride()}")
    flat = idx.reshape(-1).contiguous()
    k = table.shape[1]
    out = torch.empty((flat.shape[0], k), dtype=table.dtype,
                      device=table.device)
    if flat.shape[0]:
        shape = (k * table.element_size(), table.data_ptr(), out.data_ptr())
        if variant == "tile":
            plan = tile_plan(*shape)
            how = (plan.width, plan.rows, plan.stages)
        else:
            how = (vector_bytes(*shape, variant),)
        kernels.launch_gather(table, flat, out, variant, fill, l2_window,
                              *how)
        launches["fill" if fill else variant] += 1
    return out.reshape(*idx.shape, k)
