"""Serving's seen-item exclusion: the hand-written CUDA kernel and its plain version.

``scores`` is a batch's (B, I) score matrix, ``users`` its (B,) dense user
indices and ``pos_set`` the CSR positive set of all users
(``bpr_ops.PosSet``). :func:`exclude_seen_` writes ``-inf`` in place at
``scores[b, j]`` for every ``j`` in
``pos_set.items[indptr[users[b]] : indptr[users[b] + 1]]`` that lies in
``[0, I)``: the entries where ``bpr_ops._is_member`` over the batch's
(users, items) grid is true, which the JAX package's serving masks
(qmf_tpu/models/recommend.py), so the result is the same bit for bit. The
work is the batch's seen entries, not the grid.

On a CUDA tensor it launches ``csrc/exclude_seen.cu`` (see
qmf_tpu_torch/kernels.py) with no host read of a device value and no
allocation, so it can be captured; on a CPU tensor it runs
:func:`exclude_seen_plain`. A user outside ``[0, U)`` is the caller's
error: the plain version raises, the kernel leaves its row as it is.

``launches`` counts kernel launches; CPU calls, empty batches and empty
positive sets do not count.
"""

from __future__ import annotations

import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops.bpr_ops import PosSet

launches = 0
kernels.register_counter(globals(), "launches")


def _check(scores: torch.Tensor, pos_set: PosSet,
           users: torch.Tensor) -> None:
    if scores.dim() != 2:
        raise ValueError(f"expected (B, I) scores, got {tuple(scores.shape)}")
    if scores.dtype not in kernels.EXCLUDE_SEEN_DTYPES:
        raise ValueError(f"expected float32, float64 or bfloat16 scores, "
                         f"got {scores.dtype}")
    if users.shape != scores.shape[:1]:
        raise ValueError(f"{tuple(users.shape)} users for "
                         f"{scores.shape[0]} score rows")
    if users.dtype != torch.int32:
        raise ValueError(f"expected int32 users, got {users.dtype}")
    if pos_set.indptr.dtype != torch.int32 or \
            pos_set.items.dtype != torch.int32:
        raise ValueError(f"expected an int32 positive set, got "
                         f"{pos_set.indptr.dtype} / {pos_set.items.dtype}")
    for name, t in (("indptr", pos_set.indptr), ("items", pos_set.items),
                    ("users", users)):
        if t.device != scores.device:
            raise ValueError(f"scores on {scores.device} but {name} on "
                             f"{t.device}")


def exclude_seen_plain(scores: torch.Tensor, pos_set: PosSet,
                       users: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the batch's segments laid end to end with
    ``repeat_interleave``, then one ``index_put_`` of ``-inf``. Returns
    ``scores``."""
    users = users.long()
    start = pos_set.indptr[users].long()
    length = pos_set.indptr[users + 1].long() - start
    rows = torch.repeat_interleave(
        torch.arange(users.shape[0], device=scores.device), length)
    # each entry's place in its user's segment: its place in the laid-out
    # list less where its row's run begins there
    run = torch.cumsum(length, 0) - length
    at = torch.arange(rows.shape[0], device=scores.device) - run[rows]
    cols = pos_set.items[start[rows] + at].long()
    keep = (cols >= 0) & (cols < scores.shape[1])
    return scores.index_put_(
        (rows[keep], cols[keep]),
        torch.tensor(-torch.inf, dtype=scores.dtype, device=scores.device))


def exclude_seen_(scores: torch.Tensor, pos_set: PosSet,
                  users: torch.Tensor) -> torch.Tensor:
    """``-inf`` in place at each row's seen items (see the module's
    docstring). ``pos_set`` and ``users`` lie on the scores' device.
    Returns ``scores``."""
    global launches
    _check(scores, pos_set, users)
    if scores.device.type == "cpu":
        return exclude_seen_plain(scores, pos_set, users)
    if scores.device.type != "cuda":
        raise ValueError(f"exclude_seen_ runs on cpu or cuda, not "
                         f"{scores.device}")
    if not scores.is_contiguous():
        raise ValueError(f"the kernel takes contiguous scores, got strides "
                         f"{scores.stride()}")
    if scores.shape[0] and pos_set.items.shape[0]:
        kernels.launch_exclude_seen(scores, pos_set.indptr.contiguous(),
                                    pos_set.items.contiguous(),
                                    users.contiguous())
        launches += 1
    return scores
