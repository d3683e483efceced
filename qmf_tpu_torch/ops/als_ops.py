"""Batched weighted-ALS math in PyTorch (port of qmf_tpu/ops/als_ops.py).

For each row u with observed signals (j, r_uj), solve the Hu-Koren normal
equations (reference qmf/wals/WALSEngine.cpp:266-310)

    A_u x = b_u,   A_u = YtY + sum_j alpha r_uj y_j y_j^T + lambda I
                   b_u = sum_j (1 + alpha r_uj) y_j

a width class of rows at a time: the Gramian is one matmul, the per-row A and
b are a gather plus batched products, and the solves of a class are one
batched SPD solve (ops/spd_solve.py: the hand-written CUDA kernel on a GPU),
or with ``class_solve=False`` one such solve a build chunk.
With solver="fused" each chunk of a class is gathered and then built and
solved in one call (ops/build_solve.py: the fused CUDA kernel on a GPU), so
A never leaves the kernel. With the hot/cold split (ops/hot.py) the head's
entries enter A and b through dense per-row weights instead of the gather.
The per-row loss uses the identity of qmf_tpu: at the solution
x^T (A - lambda I) x = x.b - lambda |x|^2.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from qmf_tpu_torch.ops import build_solve, spd_solve
from qmf_tpu_torch.utils import tracing


def gramian(y: torch.Tensor) -> torch.Tensor:
    """YtY as one matmul (exact; replaces reference computeXtX)."""
    return y.T @ y


def hot_tables(y_hot: torch.Tensor, precision: str):
    """The hot rows in the build's operand dtype and their rank-1 table:
    (y_hot, Z (H, k*k)) with Z[h] = vec(y_h y_h^T). Under "default" with f32
    factors both are bf16, each product rounded to bf16, as qmf_tpu
    computes them (als_ops.py:117-129)."""
    if precision == "default" and y_hot.dtype == torch.float32:
        y_hot = y_hot.to(torch.bfloat16)
    return y_hot, build_solve.rank1_table(y_hot)


def _flat_gather(y: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``y[col_idx]`` through raveled indices: (B, D, k)."""
    return y.index_select(0, col_idx.reshape(-1)).reshape(
        *col_idx.shape, y.shape[1]
    )


def _build_bucket(y, yty, col_idx, values, mask, alpha, lam, precision,
                  hot=None, y_hot=None, z=None):
    """Normal-equation build for one padded bucket: (A (B,k,k), b (B,k),
    conf_sum (B,)); the gather + batched products, no solve.

    precision="default" with f32 factors rounds the gathered factors and the
    weights to bf16 before the gather, as qmf_tpu does at als_ops.py:159-187,
    and accumulates A and b in f32. bf16 x bf16 products are exact in f32, so
    upcasting the rounded operands and multiplying in true fp32 gives the
    f32-accumulated result; A is never rounded to bf16.

    ``hot`` = (w_a (B,H), w_b (B,H), conf_hot (B,)) adds the hot head with
    y_hot and Z from :func:`hot_tables` (als_ops.py:197-206): two GEMMs on
    the upcast operands, in the engine dtype.
    """
    dtype = y.dtype
    k = yty.shape[0]
    maskf = mask.to(dtype)
    w = alpha * values * maskf
    conf = maskf + w
    eye = torch.eye(k, dtype=dtype, device=y.device)
    if precision == "default" and dtype == torch.float32:
        bf16 = torch.bfloat16
        yg = _flat_gather(y.to(bf16), col_idx)  # (B, D, k) bf16
        ygw = (yg * w.to(bf16).unsqueeze(-1)).to(dtype)  # bf16 rounding
        yg = yg.to(dtype)
        b = torch.bmm(conf.to(bf16).to(dtype).unsqueeze(1), yg).squeeze(1)
    else:
        yg = _flat_gather(y, col_idx)
        ygw = yg * w.unsqueeze(-1)
        b = torch.bmm(conf.unsqueeze(1), yg).squeeze(1)
    a = torch.baddbmm(yty + lam * eye, ygw.transpose(1, 2), yg)
    conf_sum = conf.sum(dim=1)
    if hot is not None:
        w_a, w_b, conf_hot = hot
        a = a + (w_a.to(dtype) @ z.to(dtype)).reshape(-1, k, k)
        b = b + w_b.to(dtype) @ y_hot.to(dtype)
        conf_sum = conf_sum + conf_hot
    return a, b, conf_sum


def _solve_dispatch(a: torch.Tensor, b: torch.Tensor,
                    solver: str) -> torch.Tensor:
    if solver == "kernel":
        return spd_solve.solve_spd(a, b)
    if solver == "cholesky":
        return spd_solve.solve_spd_reference(a, b)
    if solver == "lu":
        # general solve (tolerates indefinite A like dsysv_); no raise on a
        # singular row, as the JAX solve does not raise either
        return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)
    raise ValueError(f"unknown WALS solver {solver!r}")


def _loss_from_solution(x, b, conf_sum, lam):
    # Reference loss (WALSEngine.cpp:289-304):
    #   loss = sum(conf) - 2 x.b + x^T A0 x
    # and A x = b at the solution, so x^T A0 x = x.b - lam |x|^2.
    return conf_sum - (x * b).sum(dim=1) - lam * (x * x).sum(dim=1)


def _chunks(n: int, chunk_b):
    """(start, end) of each chunk of ``chunk_b`` rows (one if None)."""
    step = n if chunk_b is None or chunk_b >= n else chunk_b
    return [(s, min(s + step, n)) for s in range(0, n, max(step, 1))]


def _hot_rows(hot, s: int, e: int):
    """Rows [s, e) of one class's hot arrays (None passes through)."""
    return None if hot is None else tuple(t[s:e] for t in hot)


def _build_chunked(y, yty, col_idx, values, mask, alpha, lam, precision,
                   chunk_b=None, hot=None, y_hot=None, z=None):
    """:func:`_build_bucket` over chunks of ``chunk_b`` rows (bounding the
    (chunk_b, D, k) gathered working set, as qmf_tpu's build scan does),
    stacked into one (A, b, conf_sum) for the whole bucket."""
    n = col_idx.shape[0]
    if chunk_b is None or chunk_b >= n:
        return _build_bucket(
            y, yty, col_idx, values, mask, alpha, lam, precision, hot, y_hot,
            z,
        )
    k = y.shape[1]
    # chunk results go straight into one preallocated buffer per class
    # (no list of chunks and concatenation: A is the largest tensor)
    a = torch.empty((n, k, k), dtype=y.dtype, device=y.device)
    b = torch.empty((n, k), dtype=y.dtype, device=y.device)
    conf_sum = torch.empty((n,), dtype=y.dtype, device=y.device)
    for s, e in _chunks(n, chunk_b):
        a[s:e], b[s:e], conf_sum[s:e] = _build_bucket(
            y, yty, col_idx[s:e], values[s:e], mask[s:e], alpha, lam,
            precision, _hot_rows(hot, s, e), y_hot, z,
        )
    return a, b, conf_sum


def _solve_chunked(y, yty, col_idx, values, mask, alpha, lam, solver,
                   precision, chunk_b=None, hot=None, y_hot=None, z=None):
    """:func:`_build_bucket` and one batched solve a chunk of ``chunk_b``
    rows (qmf_tpu's in-scan solve, ``_scan_class``, als_ops.py:321-346):
    each chunk's A is solved as soon as it is built, so no more than one
    chunk's (A, b) is held. Returns (x, b, conf_sum) for the whole bucket,
    which the loss reads as :func:`_build_chunked`'s."""
    n, k = col_idx.shape[0], y.shape[1]
    x = torch.empty((n, k), dtype=y.dtype, device=y.device)
    b = torch.empty_like(x)
    conf_sum = torch.empty((n,), dtype=y.dtype, device=y.device)
    for s, e in _chunks(n, chunk_b):
        with tracing.part("wals_build", y.device):
            a, b[s:e], conf_sum[s:e] = _build_bucket(
                y, yty, col_idx[s:e], values[s:e], mask[s:e], alpha, lam,
                precision, _hot_rows(hot, s, e), y_hot, z,
            )
        with tracing.part("wals_solve", y.device):
            x[s:e] = _solve_dispatch(a, b[s:e], solver)
    return x, b, conf_sum


def _solve_bucket_body(y, yty, col_idx, values, mask, alpha, lam, solver,
                       precision="highest", chunk_b=None, hot=None,
                       y_hot=None, z=None, class_solve=True):
    """Build, solve and loss for one bucket of rows: (x (B,k), loss (B,)).

    The build runs in chunks of ``chunk_b`` rows. With ``class_solve`` the
    whole bucket is then solved by one batched solve; without, each chunk
    is solved as it is built (:func:`_solve_chunked`). Every system is
    solved alone either way, so both give the same x and loss. The builds
    are parts ``wals_build``, the solves and the loss ``wals_solve``
    (utils/tracing.py).
    """
    if class_solve:
        with tracing.part("wals_build", y.device):
            a, b, conf_sum = _build_chunked(
                y, yty, col_idx, values, mask, alpha, lam, precision,
                chunk_b, hot, y_hot, z,
            )
        with tracing.part("wals_solve", y.device):
            x = _solve_dispatch(a, b, solver)
            loss = _loss_from_solution(x, b, conf_sum, lam)
    else:
        x, b, conf_sum = _solve_chunked(
            y, yty, col_idx, values, mask, alpha, lam, solver, precision,
            chunk_b, hot, y_hot, z,
        )
        with tracing.part("wals_solve", y.device):
            loss = _loss_from_solution(x, b, conf_sum, lam)
    return x, loss


def _fused_class(y_s, ytyl, col_idx, values, mask, alpha, lam, chunk_b,
                 hot=None, y_hot=None):
    """One class through build_solve.build_solve, a chunk of ``chunk_b``
    rows per call (qmf_tpu's _class_fused, als_ops.py:377-434): the weights
    and the loss once per class, the gather per chunk, the build, factor and
    solve in one call per chunk. ``y_s`` is the fixed side in the stream
    dtype. Returns (x (B,k) f32, loss (B,))."""
    maskf = mask.to(values.dtype)
    w = alpha * values * maskf
    conf = maskf + w
    conf_sum = conf.sum(dim=1)
    if hot is not None:
        conf_sum = conf_sum + hot[2]
    n, k = col_idx.shape[0], ytyl.shape[0]
    x = torch.empty((n, k), dtype=torch.float32, device=ytyl.device)
    b = torch.empty_like(x)
    for s, e in _chunks(n, chunk_b):
        x[s:e], b[s:e] = build_solve.build_solve(
            _flat_gather(y_s, col_idx[s:e]), w[s:e], conf[s:e], ytyl,
            None if hot is None else (hot[0][s:e], hot[1][s:e]),
            None if hot is None else y_hot,
        )
    return x, _loss_from_solution(x, b, conf_sum, lam)


def _solve_side(y, class_arrays, chunk_sizes: Sequence[int], n_rows: int,
                alpha, lam, solver: str, precision: str, hot=None,
                mesh=None, n_fixed=None, class_solve: bool = True):
    """One half-epoch: every width class of one side against fixed ``y``.

    Per class: a chunked build and one batched solve (qmf_tpu's "pallas"
    branch, als_ops.py:492-503); with ``class_solve=False`` one batched
    solve a chunk as it is built instead (its in-scan solve, :511-518),
    which holds one chunk's A rather than the class's; or with
    solver="fused", which ignores ``class_solve`` as qmf_tpu's does, one
    build+solve call per chunk (its "fused" branch, :467-481, gathered per
    chunk rather than per class: rows are independent, and the (chunk_b,
    D, k) stream stays bounded; weights and loss stay per class); then the
    scatter of the solved rows. ``hot`` =
    (hot_ids, [per-class (w_a, w_b, conf_hot)]) adds the hot/cold split.
    Returns (new factors (n_rows, k), summed un-normalized loss (0-d)).

    With ``mesh`` (parallel/mesh.py; qmf_tpu's ``spmd``), ``y`` is the whole
    fixed side on every rank, its rows from ``n_fixed`` on zero padding,
    and each class holds its full ``row_ids`` but only this rank's block of
    rows of everything else, hot weights included (parallel/sharded_wals.py
    ShardedBuckets), with ``chunk_sizes`` this rank's share of each chunk.
    The rank builds and solves its rows only; one all_gather per class
    brings every rank the whole class, which is scattered as without a
    mesh, and the loss is one all_reduce at the end. The new factors are
    padded to a height the world size divides; padding rows of the classes
    carry that height, the sink's id. YtY is computed whole on every rank
    from the real rows of ``y`` (k^2 n flops), as one device computes it:
    one rank's results are the single-device engine's bit for bit, and more
    ranks differ only where a batched GEMM of fewer rows sums in another
    order.
    """
    k = y.shape[1]
    yty = gramian(y[:n_fixed])
    if mesh is not None:
        n_rows += (-n_rows) % mesh.size
    # padding rows carry row id n_rows: scatter into one extra sink row and
    # slice it off (index_copy_ has no mode="drop")
    x_out = torch.zeros((n_rows + 1, k), dtype=y.dtype, device=y.device)
    loss = torch.zeros((), dtype=y.dtype, device=y.device)
    if hot is not None:
        hot_ids, hot_classes = hot
        y_hot, z = hot_tables(y[hot_ids], precision)
    else:
        hot_classes = [None] * len(class_arrays)
        y_hot = z = None
    if solver == "fused":
        ytyl = yty + lam * torch.eye(k, dtype=y.dtype, device=y.device)
        y_s = (y.to(torch.bfloat16)
               if precision == "default" and y.dtype == torch.float32 else y)
        for (row_ids, col_idx, values, mask), chunk_b, hot_cls in zip(
            class_arrays, chunk_sizes, hot_classes
        ):
            with tracing.part("wals_build_solve", y.device):
                x, row_loss = _fused_class(y_s, ytyl, col_idx, values, mask,
                                           alpha, lam, chunk_b, hot_cls,
                                           y_hot)
            loss = loss + row_loss.sum()
            x_out.index_copy_(0, row_ids, _whole_class(x, mesh))
        return x_out[:n_rows], _sum_over_ranks(loss, mesh)
    if z is not None:
        # the split path's hot GEMMs run on operands upcast once per side
        y_hot, z = y_hot.to(y.dtype), z.to(y.dtype)
    for (row_ids, col_idx, values, mask), chunk_b, hot_cls in zip(
        class_arrays, chunk_sizes, hot_classes
    ):
        x, row_loss = _solve_bucket_body(
            y, yty, col_idx, values, mask, alpha, lam, solver, precision,
            chunk_b, hot_cls, y_hot, z, class_solve,
        )
        loss = loss + row_loss.sum()
        x_out.index_copy_(0, row_ids, _whole_class(x, mesh))
    return x_out[:n_rows], _sum_over_ranks(loss, mesh)


def _whole_class(x: torch.Tensor, mesh) -> torch.Tensor:
    """The solved rows of the whole class: this rank's block without a
    mesh is the class; with one, the ranks' blocks in rank order."""
    return x if mesh is None else mesh.all_gather_rows(x)


def _sum_over_ranks(loss: torch.Tensor, mesh) -> torch.Tensor:
    return loss if mesh is None else mesh.all_reduce_sum(loss)


def train_epoch(user_factors, item_factors, user_arrays, item_arrays,
                alpha, lam, solver: str, precision: str, n_users: int,
                n_items: int, user_chunks, item_chunks, user_hot=None,
                item_hot=None, mesh=None, class_solve: bool = True):
    """One full WALS epoch: users against items, then items against the new
    users (reference WALSEngine.cpp:82-96). Returns
    (u_new, v_new, loss_u, loss_v); the reference logs the item-side loss.
    ``user_hot``/``item_hot`` are each side's hot state, ``mesh`` shares
    each half-epoch's rows among ranks, and the factors it returns are
    padded to heights the world size divides (see _solve_side), which
    ``class_solve`` also takes."""
    del user_factors  # recomputed from scratch each epoch (reference zeroes)
    u_new, loss_u = _solve_side(
        item_factors, user_arrays, user_chunks, n_users, alpha, lam, solver,
        precision, user_hot, mesh, n_items, class_solve,
    )
    v_new, loss_v = _solve_side(
        u_new, item_arrays, item_chunks, n_items, alpha, lam, solver,
        precision, item_hot, mesh, n_users, class_solve,
    )
    return u_new, v_new, loss_u, loss_v


def epoch_body(user_arrays, item_arrays, alpha, lam, solver: str,
               precision: str, n_users: int, n_items: int, user_chunks,
               item_chunks, user_hot=None, item_hot=None, mesh=None,
               class_solve: bool = True):
    """:func:`train_epoch` on these classes as a function of the item
    factors alone: ``epoch(item_factors) -> (u_new, v_new, loss_v)``. This
    is the epoch an engine runs as one program, eagerly or captured as a
    CUDA graph (ops/graphs.py EpochGraph): it reads no device value on the
    host, so a capture holds all of it. Both half-epochs are the part
    ``wals_epoch`` (utils/tracing.py), stamped at every replay."""

    def epoch(item_factors):
        with tracing.part("wals_epoch", item_factors.device):
            u_new, v_new, _, loss_v = train_epoch(
                None, item_factors, user_arrays, item_arrays, alpha, lam,
                solver, precision, n_users, n_items, user_chunks,
                item_chunks, user_hot, item_hot, mesh, class_solve,
            )
        return u_new, v_new, loss_v

    return epoch


def train_epochs(epoch, item_factors: torch.Tensor, nepochs: int):
    """The whole run: ``nepochs`` epochs of ``epoch`` from ``item_factors``
    (qmf_tpu's ``train_epochs``, als_ops.py:576-637, whose ``lax.scan`` over
    the epochs is this loop). ``epoch`` is :func:`epoch_body`'s function,
    or an ops/graphs.py EpochGraph of it on a CUDA device, which runs its
    first call as the warm-up and replays the captured epoch at every later
    one. Returns (u_final, v_final, losses (nepochs,)): the item-side loss
    of each epoch, as the reference logs it (WALSEngine.cpp:82-96), left on
    the device. Nothing here reads the device."""
    if nepochs < 1:
        raise ValueError(f"train_epochs needs nepochs >= 1, got {nepochs}")
    losses = torch.empty((nepochs,), dtype=item_factors.dtype,
                         device=item_factors.device)
    v = item_factors
    for e in range(nepochs):
        u, v, loss = epoch(v)
        losses[e] = loss
    return u, v, losses


def compute_scores(user_factors: torch.Tensor, item_factors: torch.Tensor,
                   item_biases: torch.Tensor | None = None,
                   user_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Dense score matrix: scores[t, i] = bias_i + <p_u(t), q_i> (replaces
    the reference's per-user scoring loop, qmf/Engine.cpp:73-96)."""
    u = user_factors if user_idx is None else user_factors[user_idx]
    scores = torch.matmul(u, item_factors.T)
    if item_biases is not None:
        scores = scores + item_biases[None, :]
    return scores


def naive_reference_solve(
    y: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    alpha: float,
    lam: float,
) -> Tuple[np.ndarray, float]:
    """Float64 numpy oracle of the reference per-row update, for tests
    (a copy of qmf_tpu.ops.als_ops.naive_reference_solve, a transcription
    of WALSEngine.cpp:266-310)."""
    k = y.shape[1]
    a = y.T @ y
    b = np.zeros(k)
    loss = 0.0
    for c, v in zip(cols, vals):
        yj = y[c]
        b += yj * (1.0 + alpha * v)
        a += np.outer(yj, yj) * (alpha * v)
        loss += 1.0 + alpha * v
    b_mat = a.copy()
    a = a + lam * np.eye(k)
    x = np.linalg.solve(a, b)
    loss += x @ b_mat @ x - 2.0 * x @ b
    return x, loss
