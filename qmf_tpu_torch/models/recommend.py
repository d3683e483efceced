"""Serving-side top-N recommendation from trained factors.

Port of qmf_tpu/models/recommend.py. The reference stops at saving factor
files; serving is left to the caller. Here score = bias + <p_u, q_i> is one
matmul over a batch of users, already-seen items are pushed to -inf by a
scatter at each user's entries of the CSR positive set
(``ops/exclude_seen.py``; bit for bit the scores of qmf_tpu's membership
test over the (users, items) grid, for work in the batch's seen entries
alone), and the head comes from ``torch.topk``.

Ties. ``jax.lax.top_k`` returns the lower index first among equal scores;
``torch.topk`` promises no order, and it may pick any of the items tied at
the n-th score. Rows with fewer than n unseen items tie at -inf, and
integer-valued factors tie often, so the head is repaired: ``topk`` gives
the n-th score, the items above it are in, the lowest-indexed items equal to
it fill the rest, and a stable sort orders the n by score.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qmf_tpu_torch.ops import als_ops
from qmf_tpu_torch.ops.bpr_ops import PosSet
from qmf_tpu_torch.ops.exclude_seen import exclude_seen_
from qmf_tpu_torch.utils import tracing


def _top_n(scores: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, scores) of the n largest of each row, descending, the lower
    index first among equal scores."""
    nth = torch.topk(scores, n, dim=1).values[:, -1:]
    above = scores > nth
    tied = scores == nth
    room = n - above.sum(dim=1, keepdim=True)
    taken = above | (tied & (torch.cumsum(tied, dim=1, dtype=torch.int32)
                             <= room))
    idx = taken.nonzero()[:, 1]
    if idx.shape[0] != scores.shape[0] * n:
        raise ValueError("top-n needs scores that compare (found NaN)")
    idx = idx.reshape(-1, n)  # ascending within each row
    top, order = torch.sort(scores.gather(1, idx), dim=1, descending=True,
                            stable=True)
    return idx.gather(1, order), top


def recommend_top_n(
    user_factors,
    item_factors,
    user_idx,
    n: int = 10,
    item_biases=None,
    seen: Optional[PosSet] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-n item indices + scores for the given dense user indices.

    Factors and biases are numpy arrays or tensors (a tensor already on the
    device is used where it is); scores come in their dtype. ``seen`` (a
    :class:`PosSet`, e.g. built from the training ratings) excludes
    already-interacted items. ``device=None`` is the CUDA card.

    The request is the part ``serve_request`` (utils/tracing.py), the
    scores, the exclusion and the head its parts ``serve_scores``,
    ``serve_seen`` and ``serve_topn``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        # a score matmul in TF32 keeps three digits; serving may run with
        # no engine ever built to turn it off
        torch.backends.cuda.matmul.allow_tf32 = False
    with tracing.part("serve_request", dev):
        users = torch.as_tensor(np.asarray(user_idx, dtype=np.int32))
        all_users = torch.as_tensor(user_factors)
        uf = all_users[users.to(all_users.device)].to(dev)
        itf = torch.as_tensor(item_factors).to(dev)
        ib = None if item_biases is None else \
            torch.as_tensor(item_biases).to(dev)
        with tracing.part("serve_scores", dev):
            scores = als_ops.compute_scores(uf, itf, item_biases=ib)
        if seen is not None:
            with tracing.part("serve_seen", dev):
                exclude_seen_(scores, PosSet(seen.indptr.to(dev),
                                             seen.items.to(dev),
                                             seen.max_degree),
                              users.to(dev))
        with tracing.part("serve_topn", dev):
            idx, top = _top_n(scores, n)
    return idx.to(torch.int32).cpu().numpy(), top.cpu().numpy()
