"""BPR on tensors: positive sets, negative sampling, minibatch SGD, eval loss.

Port of qmf_tpu/ops/bpr_ops.py, function for function under the same names:

- the per-user positive sets (CSR with its vectorized binary search, the
  packed bitmap, the blocked Bloom filter); the make_* functions are numpy
  on the host, as the originals, and return tensors on the device they are
  given; the structures are equal array for array to qmf_tpu's;
- the hashes (``_feistel_bijection``, ``_mix32``, ``_cand_hash``,
  ``_word_probe``, ``_mix_bijection``), bit for bit: int32 tensors end to
  end, so that multiplies wrap as qmf_tpu's do;
- the grouped epoch: ``_sample_pack_grouped_body`` shuffles the positives,
  presamples every negative as a 2-bit round index and packs the stream;
  ``_sgd_epoch_scan_grouped_body`` walks it in minibatches and rebuilds each
  negative from the hashes; ``grouped_epoch`` makes both one function of
  the epoch's keys, rate and parameters, and ``sgd_epoch_grouped`` runs it;
- the legacy triplet epochs: ``_sample_pack_impl`` with
  ``_sgd_epoch_scan_packed_impl`` (negatives presampled and packed as
  ``pos << 15 | neg``; ``packed_epoch`` makes both one function) and
  ``_sgd_epoch_impl`` (sampling inside each step, CSR membership: the steps
  of ``instep_step``); ``sgd_epoch`` chooses between them;
- the functions an engine runs as one program (``grouped_epoch``,
  ``packed_epoch``, ``instep_step``) read no device value on the host, so
  on a card each is captured as a CUDA graph (ops/graphs.py): the epoch's
  rate is a 0-d tensor on the device, the collision buffer of the
  presampler has a fixed size (``_compact``), and the draws stay outside;
- the shared step (``_sample_negatives_impl``, ``_sgd_update_body``,
  ``sgd_step``), ``eval_loss`` and ``sample_negatives_host``.

The update rule is the reference's (BPREngine.cpp:178-220):
    e = 1 / (1 + exp(score_diff))        (d/dx log sigmoid)
    b_i += lr (e - bias_lambda b_i);  b_j += lr (-e - bias_lambda b_j)
    p_u += lr (e (q_i - q_j) - user_lambda p_u)
    q_i += lr (e p_u - item_lambda q_i)
    q_j += lr (-e p_u - item_lambda q_j)
Every update of a minibatch reads the parameters as they were before the
batch, and contributions to the same row sum. Given a ``mesh``
(parallel/mesh.py), the SGD loops compute the gradients of this rank's
lanes of each step only and apply the whole step's, gathered from every
rank (``_whole_batch``): the data-parallel epoch of parallel/sharded_bpr.py.

Every random draw is an argument. A function that qmf_tpu gives a PRNG key
is split in two here: the inner function takes the drawn integers (round
keys ``rk``, shuffle keys ``ks``, a permutation, the candidate matrix
``cands``) and is deterministic, so a test can hand it the integers that
``jax.random`` drew and compare bit for bit; ``draw_grouped_keys`` and
``draw_epoch`` draw them from an explicit ``torch.Generator`` on the
tensors' device, and ``sgd_epoch_grouped``, ``sgd_epoch``,
``sample_negatives`` and ``sgd_step`` are the thin callers that draw and
pass on. Nothing here reads torch's global RNG.

The SGD functions update the factor tables in place (``index_add_``) and
return the same ``BPRParams``: within a step every gather happens before
the first scatter. On the CPU ``index_add_`` sums duplicates in stream
order; on a CUDA device it uses atomics, so results agree with the CPU's to
rounding, not bit for bit.

torch has no uint32 arithmetic: a uint32 modulo goes through int64, the
Bloom hash runs in int64 with every product kept below 2^63, and
``jax.lax.shift_right_logical`` is written as an arithmetic shift and a
mask. The streams and the membership words stay int32.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qmf_tpu_torch.utils import tracing
from qmf_tpu_torch.utils.logging import log


class BPRParams(NamedTuple):
    """Model state; the SGD functions update these tensors in place."""

    user_factors: torch.Tensor  # (U, k)
    item_factors: torch.Tensor  # (I, k)
    item_biases: torch.Tensor  # (I,) — zeros and unused when use_biases=False


class PosSet(NamedTuple):
    """Per-user positive-item sets in CSR form for device membership tests.

    int32 throughout, as qmf_tpu's (a flat user*n_items+item key would
    overflow int32 already at MovieLens-20M scale: 138k users x 27k items
    > 2^31).
    """

    indptr: torch.Tensor  # (U+1,) int32 — per-user segment offsets
    items: torch.Tensor  # (nnz,) int32 — item ids, sorted within each segment
    max_degree: int  # python int — bounds the binary search depth


def make_pos_set(
    user_idx: np.ndarray, item_idx: np.ndarray, n_users: int,
    return_sorted: bool = False, *, device,
):
    """Build the CSR positive-set structure (host side, deduplicated).

    With ``return_sorted`` also returns the lexsorted deduplicated
    (user, item) host arrays — they are exactly the order
    :func:`make_pos_bitmap` needs, so callers building both structures pay
    for one lexsort instead of two."""
    order = np.lexsort((item_idx, user_idx))
    u = np.asarray(user_idx)[order]
    i = np.asarray(item_idx)[order]
    # dedup (user, item) pairs
    if len(u):
        keep = np.ones(len(u), dtype=bool)
        keep[1:] = (u[1:] != u[:-1]) | (i[1:] != i[:-1])
        u, i = u[keep], i[keep]
    counts = np.bincount(u, minlength=n_users)
    indptr = np.zeros(n_users + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    max_degree = int(counts.max()) if n_users else 0
    ps = PosSet(
        torch.from_numpy(indptr).to(device),
        torch.from_numpy(i.astype(np.int32)).to(device),
        max_degree,
    )
    if return_sorted:
        return ps, u, i
    return ps


class PosBitmap(NamedTuple):
    """Dense packed (user, item) membership bitmap for O(1) device tests.

    One int32 word holds 32 item slots: bit (i % 32) of
    ``words[u * words_per_user + i // 32]``. A membership test is one
    random gather instead of the CSR binary search's ~log2(max_degree)
    chained gathers. Memory is U*I/8 bytes, so callers gate on a budget and
    fall back to :class:`PosSet` when the id space is too large.
    """

    words: torch.Tensor  # (U * words_per_user,) int32
    words_per_user: int


def make_pos_bitmap(
    user_idx: np.ndarray, item_idx: np.ndarray, n_users: int, n_items: int,
    assume_lex_sorted: bool = False, *, device,
) -> PosBitmap:
    """Build the packed membership bitmap (host side, vectorized).

    ``assume_lex_sorted``: the inputs are already lexsorted by
    (user, item) — e.g. :func:`make_pos_set`'s ``return_sorted`` output —
    so ``word_idx = u*wpu + (i>>5)`` is nondecreasing and the argsort is
    skipped."""
    wpu = (n_items + 31) // 32
    # _is_member_bitmap computes u * wpu + (i >> 5) in the callers' int32;
    # guard the word count so the index cannot silently wrap.
    if n_users * wpu >= 2**31:
        raise ValueError(
            f"bitmap word count {n_users * wpu} overflows int32 indexing; "
            "lower bitmap_budget_mb or use the CSR membership path"
        )
    u = np.asarray(user_idx, dtype=np.int64)
    i = np.asarray(item_idx, dtype=np.int64)
    word_idx = u * wpu + (i >> 5)
    bit = np.uint32(1) << (i & 31).astype(np.uint32)
    if not assume_lex_sorted:
        order = np.argsort(word_idx, kind="stable")
        word_idx, bit = word_idx[order], bit[order]
    # OR together all bits landing in the same word (segment reduce)
    starts = np.concatenate(
        [[0], np.nonzero(np.diff(word_idx))[0] + 1]
    ) if len(word_idx) else np.zeros(0, dtype=np.int64)
    n_words = n_users * wpu
    if len(word_idx) and len(starts) * 8 < n_words * 4:
        # sparse device-side build: ship only the distinct (word, bits)
        # pairs and scatter-set into device zeros — host memory and
        # transfer scale with nnz, not U*I. Indices are unique after the
        # reduceat, so the scatter-set has no duplicates.
        uniq_idx = torch.from_numpy(word_idx[starts]).to(device)
        uniq_bits = torch.from_numpy(
            np.bitwise_or.reduceat(bit, starts).view(np.int32)).to(device)
        words = torch.zeros(n_words, dtype=torch.int32, device=device)
        words.index_copy_(0, uniq_idx, uniq_bits)
        return PosBitmap(words, wpu)
    words = np.zeros(n_words, dtype=np.uint32)
    if len(word_idx):
        words[word_idx[starts]] = np.bitwise_or.reduceat(bit, starts)
    return PosBitmap(torch.from_numpy(words.view(np.int32)).to(device), wpu)


def _is_member_bitmap(
    bitmap: PosBitmap, users: torch.Tensor, cand: torch.Tensor
) -> torch.Tensor:
    """Vectorized O(1) membership test: one gather + bit extract."""
    word = bitmap.words[users * bitmap.words_per_user + (cand >> 5)]
    # torch's >> on int32 is arithmetic: it fills from the sign above bit
    # 31 - s only, and bit 0 of the result is bit s of the word either way
    return ((word >> (cand & 31)) & 1) == 1


class PosBloom(NamedTuple):
    """Blocked Bloom filter over each user's positive set.

    The scale path for catalogs whose exact :class:`PosBitmap` exceeds the
    memory budget: memory here is U * bits_per_user / 8 bytes, independent
    of n_items. Two fixed-hash bit positions per item inside the user's
    private 2^m-bit block. No false negatives: a "not member" answer is
    exact; false positives (rate ~(load)^2) only cost an exact verify.
    """

    words: torch.Tensor  # (U * words_per_user,) int32
    words_per_user: int  # power of two


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    in 16-bit halves so that no product reaches 2^63."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _bloom_positions(item, bits_per_user: int):
    """Two bit positions for ``item`` in a 2^m-bit block (double hashing).

    On an np.uint32 array it is qmf_tpu's arithmetic as written (wraparound
    multiply, logical shifts); on a torch integer tensor the same values
    come out as int64, the item taken mod 2^32 as a cast to uint32 takes
    it. The host-side build and the device membership test must agree bit
    for bit.
    """
    if isinstance(item, np.ndarray):
        mask = np.uint32(bits_per_user - 1)
        h = item * np.uint32(0x9E3779B1)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x85EBCA77)
        h = h ^ (h >> np.uint32(13))
        p1 = h & mask
        p2 = (p1 + ((h >> np.uint32(16)) | np.uint32(1))) & mask
        return p1, p2
    mask = bits_per_user - 1
    h = _mul32(item.to(torch.int64) & _M32, 0x9E3779B1)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA77)
    h = h ^ (h >> 13)
    p1 = h & mask
    p2 = (p1 + ((h >> 16) | 1)) & mask
    return p1, p2


def make_pos_bloom(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_users: int,
    bits_per_user: int,
    *,
    device,
) -> PosBloom:
    """Build the blocked Bloom filter (host side, vectorized)."""
    if bits_per_user < 32 or bits_per_user & (bits_per_user - 1):
        raise ValueError("bits_per_user must be a power of two >= 32")
    wpu = bits_per_user // 32
    if n_users * wpu >= 2**31:
        raise ValueError("bloom word count overflows int32 indexing")
    u = np.asarray(user_idx, dtype=np.int64)
    i = np.asarray(item_idx, dtype=np.uint32)
    p1, p2 = _bloom_positions(i, bits_per_user)
    base = u * wpu
    word_idx = np.concatenate([base + (p1 >> 5), base + (p2 >> 5)])
    bit = np.concatenate(
        [np.uint32(1) << (p1 & 31), np.uint32(1) << (p2 & 31)]
    )
    order = np.argsort(word_idx, kind="stable")
    word_idx, bit = word_idx[order], bit[order]
    words = np.zeros(n_users * wpu, dtype=np.uint32)
    if len(word_idx):
        starts = np.concatenate([[0], np.nonzero(np.diff(word_idx))[0] + 1])
        words[word_idx[starts]] = np.bitwise_or.reduceat(bit, starts)
    return PosBloom(torch.from_numpy(words.view(np.int32)).to(device), wpu)


def _is_member_bloom(
    bloom: PosBloom, users: torch.Tensor, cand: torch.Tensor
) -> torch.Tensor:
    """MAY-be-member test: two gathers + bit tests. False positives only."""
    bits_per_user = bloom.words_per_user * 32
    p1, p2 = _bloom_positions(cand, bits_per_user)
    base = users * bloom.words_per_user
    w1 = bloom.words[base + (p1 >> 5)]
    w2 = bloom.words[base + (p2 >> 5)]
    b1 = (w1 >> (p1 & 31)) & 1
    b2 = (w2 >> (p2 & 31)) & 1
    return (b1 & b2) == 1


def _is_member(
    pos_set: PosSet, users: torch.Tensor, cand: torch.Tensor
) -> torch.Tensor:
    """Vectorized per-user binary search: is cand[b] in users[b]'s set?"""
    lo = pos_set.indptr[users]
    end = pos_set.indptr[users + 1]
    hi = end
    steps = max(1, int(np.ceil(np.log2(max(pos_set.max_degree, 1) + 1))) + 1)
    items = pos_set.items
    if items.shape[0] == 0:
        return torch.zeros(users.shape, dtype=torch.bool, device=users.device)
    last = items.shape[0] - 1
    for _ in range(steps):
        # overflow-safe midpoint: lo + hi wraps int32 once the CSR holds
        # >= 2^30 positives
        mid = lo + (hi - lo) // 2
        v = items[torch.clamp(mid, max=last)]
        go_right = (v < cand) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    found = items[torch.clamp(lo, max=last)] == cand
    return found & (lo < end)


def _shift_right_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """``jax.lax.shift_right_logical`` by a static ``s`` in [1, 31] on
    int32: torch's ``>>`` fills with the sign, the mask clears the fill."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x.astype(uint32) % uint32(n)`` as int32, through int64."""
    return ((x.to(torch.int64) & _M32) % n).to(torch.int32)


def _draw_keys(generator: torch.Generator, shape) -> torch.Tensor:
    """int32 keys in [0, 2^30), as ``jax.random.randint(key, shape, 0,
    1 << 30)`` draws them in qmf_tpu, on the generator's device."""
    return torch.randint(0, 1 << 30, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def _draw_candidates(generator: torch.Generator, shape,
                     n_items: int) -> torch.Tensor:
    """Uniform int32 candidate items in [0, n_items)."""
    return torch.randint(0, n_items, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def _sample_negatives_impl(
    cands: torch.Tensor,  # (rounds, B) int32 candidate items
    users: torch.Tensor,
    indptr: torch.Tensor,
    pos_items: torch.Tensor,
    max_degree: int,
    bitmap_words: Optional[torch.Tensor] = None,
    wpu: int = 0,
) -> torch.Tensor:
    """Per row the first round's candidate that is no positive of the row's
    user; rows that collide in every round keep the last candidate. The
    candidates are what qmf_tpu draws with ``jax.random.randint`` inside."""
    pos_set = PosSet(indptr, pos_items, max_degree)
    rounds = cands.shape[0]
    neg = torch.zeros_like(users)
    valid = torch.zeros(users.shape, dtype=torch.bool, device=users.device)

    def member(cand):
        if bitmap_words is not None:
            return _is_member_bitmap(
                PosBitmap(bitmap_words, wpu), users, cand
            )
        return _is_member(pos_set, users, cand)

    for r in range(rounds):
        cand = cands[r]
        cand_ok = ~member(cand)
        take = (~valid) & cand_ok
        neg = torch.where(take, cand, neg)
        # after the final round, fall back to the last candidate if invalid
        if r == rounds - 1:
            neg = torch.where(valid | take, neg, cand)
        valid = valid | cand_ok
    return neg


def sample_negatives(
    generator: torch.Generator,
    users: torch.Tensor,  # (B,) int32 user indices
    pos_set: PosSet,
    n_items: int,
    rounds: int = 4,
    bitmap: Optional[PosBitmap] = None,
) -> torch.Tensor:
    """Sample one negative item per row, rejecting the user's positives.

    Fixed-round re-sampling. Rows still colliding after ``rounds`` rounds
    keep the last candidate — residual collision probability is
    (user_degree/n_items)^rounds.
    """
    cands = _draw_candidates(generator, (rounds, users.shape[0]), n_items)
    return _sample_negatives_impl(
        cands,
        users,
        pos_set.indptr,
        pos_set.items,
        max_degree=pos_set.max_degree,
        bitmap_words=None if bitmap is None else bitmap.words,
        wpu=0 if bitmap is None else bitmap.words_per_user,
    )


def _score_diff(
    params: BPRParams,
    users: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    use_biases: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    pu = params.user_factors[users]  # (B, k)
    qi = params.item_factors[pos]
    qj = params.item_factors[neg]
    d = torch.sum(pu * (qi - qj), dim=1)
    if use_biases:
        d = d + params.item_biases[pos] - params.item_biases[neg]
    return d, pu, qi, qj


def _sgd_update_body(
    params: BPRParams,
    users: torch.Tensor,  # (B,) int32
    pos_items: torch.Tensor,  # (B,) int32
    neg: torch.Tensor,  # (B,) int32 pre-sampled negatives
    weight: torch.Tensor,  # (B,) 0/1 mask for batch padding
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    mesh=None,
    batch_size: int = 0,
) -> BPRParams:
    """The SGD update of one minibatch with negatives already sampled, in
    place. Everything the gradients read is gathered before the first
    scatter, so they see the pre-batch parameters. With ``mesh`` the rows
    are this rank's lanes of a step of ``batch_size`` rows, and the update
    is the whole step's (:func:`_whole_batch`).

    The rate is folded into each lane's weight, which every gradient term
    carries, so the updates come out scaled by it (qmf_tpu's
    ``at[].add(lr * d)`` with the product taken first): as a 0-d tensor on
    the device it is read there, and a CUDA graph of the step takes each
    epoch's rate rather than the one it was captured with."""
    dtype = params.user_factors.dtype
    weight = weight * torch.as_tensor(lr, dtype=dtype, device=weight.device)
    d, pu, qi, qj = _score_diff(params, users, pos_items, neg, use_biases)
    e = (1.0 / (1.0 + torch.exp(d))) * weight  # masked loss derivative
    wcol = weight[:, None]
    du = e[:, None] * (qi - qj) - user_lambda * pu * wcol
    epu = e[:, None] * pu
    dpos = epu - item_lambda * qi * wcol
    dneg = -epu - item_lambda * qj * wcol
    dbp = dbn = None
    if use_biases:
        dbp = e - bias_lambda * params.item_biases[pos_items] * weight
        dbn = -e - bias_lambda * params.item_biases[neg] * weight
    users, pos_items, neg, du, dpos, dneg, dbp, dbn = _whole_batch(
        (users, pos_items, neg, du, dpos, dneg, dbp, dbn), batch_size, mesh)

    params.user_factors.index_add_(0, users, du)
    params.item_factors.index_add_(0, pos_items, dpos)
    params.item_factors.index_add_(0, neg, dneg)
    if use_biases:
        params.item_biases.index_add_(0, pos_items, dbp)
        params.item_biases.index_add_(0, neg, dbn)
    return params


def _lanes(batch_size: int, mesh) -> Tuple[int, int]:
    """This rank's lanes [lo, hi) of a step of ``batch_size`` rows: the
    ranks' shares in rank order, differing by at most one row (all of the
    step without a mesh)."""
    if mesh is None:
        return 0, batch_size
    return mesh.lanes(batch_size)


# The integer type of each float width: the parts of a step travel as one
# tensor of such words, the float rows bit for bit.
_WORDS = {4: torch.int32, 8: torch.int64}


def _whole_batch(parts, batch_size: int, mesh):
    """The whole step's rows of ``parts``, per-lane tensors (ids, gradient
    rows; None passes through) that each rank computed on its
    :func:`_lanes`, the ranks' lanes in rank order, so every rank then
    applies the step as one device would. One all_gather a step: the float
    rows are viewed as integer words of their width and travel beside the
    ids, which come back in that integer type. Without a mesh, ``parts``
    as given."""
    if mesh is None:
        return parts
    live = [i for i, t in enumerate(parts) if t is not None]
    word = _WORDS[next(parts[i].element_size() for i in live
                       if parts[i].is_floating_point())]
    flat = []
    for i in live:
        t = parts[i].reshape(parts[i].shape[0], math.prod(parts[i].shape[1:]))
        flat.append(t.view(word) if t.is_floating_point() else t.to(word))
    whole = mesh.all_gather_rows(torch.cat(flat, dim=1), batch_size)
    out = list(parts)
    for i, piece in zip(live, whole.split([f.shape[1] for f in flat], 1)):
        if parts[i].is_floating_point():
            piece = piece.view(parts[i].dtype)
        out[i] = piece.reshape(batch_size, *parts[i].shape[1:])
    return out


def _sgd_step_body(
    params: BPRParams,
    cands: torch.Tensor,  # (neg_rounds, B) int32 candidate items
    users: torch.Tensor,  # (B,) int32
    pos_items: torch.Tensor,  # (B,) int32
    weight: torch.Tensor,  # (B,) 0/1 mask for batch padding
    indptr: torch.Tensor,
    set_items: torch.Tensor,
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    max_degree: int,
    bitmap_words: Optional[torch.Tensor] = None,
    wpu: int = 0,
    mesh=None,
    batch_size: int = 0,
) -> BPRParams:
    """One synchronous minibatch update (reference update(), vectorized);
    with ``mesh``, of this rank's lanes (see :func:`_sgd_update_body`)."""
    neg = _sample_negatives_impl(
        cands,
        users,
        indptr,
        set_items,
        max_degree=max_degree,
        bitmap_words=bitmap_words,
        wpu=wpu,
    )
    return _sgd_update_body(
        params, users, pos_items, neg, weight, lr, user_lambda, item_lambda,
        bias_lambda, use_biases=use_biases, mesh=mesh, batch_size=batch_size,
    )


def sgd_step(
    params: BPRParams,
    generator: torch.Generator,
    users: torch.Tensor,
    pos_items: torch.Tensor,
    weight: torch.Tensor,
    pos_set: PosSet,
    lr: float,
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    n_items: int,
    use_biases: bool,
    neg_rounds: int,
) -> BPRParams:
    cands = _draw_candidates(generator, (neg_rounds, users.shape[0]), n_items)
    return _sgd_step_body(
        params,
        cands,
        users,
        pos_items,
        weight,
        pos_set.indptr,
        pos_set.items,
        lr,
        user_lambda,
        item_lambda,
        bias_lambda,
        use_biases=use_biases,
        max_degree=pos_set.max_degree,
    )


def instep_step(
    users_flat: torch.Tensor,  # (S*B,) int32 triplet users (padded)
    items_flat: torch.Tensor,  # (S*B,) int32 positive items
    weights_flat: torch.Tensor,  # (S*B,) 0/1 padding mask
    indptr: torch.Tensor,
    set_items: torch.Tensor,
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    max_degree: int,
    batch_size: int,
    bitmap_words: Optional[torch.Tensor] = None,
    wpu: int = 0,
    mesh=None,
):
    """One step of the legacy epoch with sampling inside each step, as a
    function of its step index and the epoch's draws: ``step(t, perm,
    cands, lr, uf, itf, ib) -> (t, uf, itf, ib)``. ``t`` is a 0-d int64
    tensor on the device, which the step reads (rows t*B .. t*B + B - 1 of
    the stream through ``perm``, the epoch's permutation of it, or an
    arange without shuffle; ``cands[t]``, (neg_rounds, B) candidate items)
    and then advances by one; the parameters are updated in place. That is
    qmf_tpu's ``lax.scan`` body (its ``_sgd_epoch_impl``): a CUDA graph of
    the step (ops/graphs.py) is replayed once a step, its step index read
    from the device, since a graph of every step of an epoch would hold
    ~1,000 kernels for each of its thousands of steps (the CSR binary
    search). Nothing in it reads a device value on the host. With
    ``mesh``, each rank samples and computes its lanes of every step."""
    s = users_flat.shape[0] // batch_size
    lo, hi = _lanes(batch_size, mesh)

    def step(t, perm, cands, lr, uf, itf, ib):
        at = t.view(1)
        rows = perm.view(s, batch_size).index_select(0, at)[0, lo:hi]
        _sgd_step_body(
            BPRParams(uf, itf, ib),
            cands.index_select(0, at)[0][:, lo:hi],
            users_flat[rows],
            items_flat[rows],
            weights_flat[rows],
            indptr,
            set_items,
            lr,
            user_lambda,
            item_lambda,
            bias_lambda,
            use_biases=use_biases,
            max_degree=max_degree,
            bitmap_words=bitmap_words,
            wpu=wpu,
            mesh=mesh,
            batch_size=batch_size,
        )
        t.add_(1)
        return t, uf, itf, ib

    return step


def stream_rows(n: int, device) -> torch.Tensor:
    """The unshuffled order of an n-row stream: what :func:`instep_step`
    reads in place of a permutation without shuffle."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _sgd_epoch_impl(
    params: BPRParams,
    perm: Optional[torch.Tensor],  # (S*B,) permutation, None = no shuffle
    cands: torch.Tensor,  # (S, neg_rounds, B) int32 candidate items
    users_flat: torch.Tensor,  # (S*B,) int32 triplet users (padded)
    items_flat: torch.Tensor,  # (S*B,) int32 positive items
    weights_flat: torch.Tensor,  # (S*B,) 0/1 padding mask
    indptr: torch.Tensor,
    set_items: torch.Tensor,
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    max_degree: int,
    batch_size: int,
    bitmap_words: Optional[torch.Tensor] = None,
    wpu: int = 0,
    mesh=None,
) -> BPRParams:
    """A full training epoch with sampling inside each step: every step of
    :func:`instep_step`, in order (with ``mesh``, each rank samples and
    computes its lanes of every step).

    The reference walks the (shuffled) positive-pair vector once per epoch,
    sampling negatives per pair (BPREngine.cpp:146-176). Here the epoch is
    a loop over minibatches: an optional permutation of the triplet stream,
    then per step the negatives from that step's candidates and the SGD
    update.

    Shuffle-semantics note: the reference shuffles the positive-pair vector
    and emits num_negative_samples consecutive updates per pair
    (BPREngine.cpp:172-174); permuting the expanded triplet stream is an
    equivalent-in-distribution ordering.
    """
    dev = users_flat.device
    step = instep_step(
        users_flat, items_flat, weights_flat, indptr, set_items, user_lambda,
        item_lambda, bias_lambda, use_biases, max_degree, batch_size,
        bitmap_words, wpu, mesh)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    if perm is None:
        perm = stream_rows(users_flat.shape[0], dev)
    lr = torch.as_tensor(lr, dtype=params.user_factors.dtype, device=dev)
    for _ in range(users_flat.shape[0] // batch_size):
        step(t, perm, cands, lr, *params)
    return params


_PACK_SHIFT = 15  # packed items: pos << 15 | neg, valid while n_items <= 32768

# fallback-path diagnoses already emitted (log once per reason set, not per
# epoch — the condition is fixed at init time)
_fallback_logged: set = set()


def _feistel_bijection(ks: torch.Tensor, m: int, b: int) -> torch.Tensor:
    """A keyed bijection on [0, m * 2**b) as pure index arithmetic, from
    the six int32 keys ``ks`` in [0, 2^30).

    Generalizes :func:`_mix_bijection` (power-of-two domains only) to any
    domain of the form m * 2**b: write x = q * 2**b + r and alternate
    coordinate updates that are each bijective for a fixed other coordinate
    (a Feistel-style network):

        r ^= h(q) & (2**b - 1)   (XOR: bijective in r)
        q  = (q + h(r)) mod m    (add: bijective in q)
        r  = mix_pow2(r)         (odd-multiplier/xorshift mixer: bijective)

    Three rounds give epoch-shuffle-grade mixing. This keeps the shuffled
    stream length within 2**b of the real length (callers pick b ~ 16),
    instead of the up-to-2x padding a pure power-of-two bijection needs.
    Bit for bit qmf_tpu's on the same keys: int32 throughout, multiplies
    wrap.
    """
    n = m << b
    mask_b = (1 << b) - 1

    def h(x, k):
        x = x * ((k << 1) | 1)
        x = x ^ ((x >> 7) ^ (x >> 13))
        return x * 0x6C62_72E5 + k

    x = torch.arange(n, dtype=torch.int32, device=ks.device)
    q = x >> b
    r = x & mask_b
    for i in range(3):
        r = r ^ (h(q, ks[2 * i]) & mask_b)
        q = (q + (h(r, ks[2 * i + 1]) & 0x3FFF_FFFF)) % m
        # in-place power-of-two mix of r
        r = (r * ((ks[2 * i] << 1) | 1)) & mask_b
        r = r ^ (r >> max(1, b // 2))
    return q * (1 << b) + r


def _mix32(rk: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Murmur-finalizer-grade 32-bit mixer of slot index f under round key
    rk (3,) int32. Shared by :func:`_cand_hash` and :func:`_word_probe`;
    must stay bit-identical between the presampling pass and the
    reconstruction in the SGD loop (the stream stores only a 2-bit round
    index per slot and the loop recomputes the candidate item from it),
    and to qmf_tpu's. The mixer depends on int32 wraparound: both
    arguments must be int32 tensors."""
    if f.dtype != torch.int32 or rk.dtype != torch.int32:
        raise TypeError(
            f"_mix32 needs int32 tensors, got rk {rk.dtype}, f {f.dtype}"
        )
    x = f * ((rk[0] << 1) | 1)
    x = x ^ ((x >> 7) ^ (x >> 13))
    x = x * ((rk[1] << 1) | 1)
    x = x ^ (x >> 11)
    x = x * ((rk[2] << 1) | 1)
    x = x ^ (x >> 9)
    return x


def _cand_hash(rk: torch.Tensor, f: torch.Tensor, n_items: int) -> torch.Tensor:
    """Candidate item for slot index f under round key rk (3,) int32,
    uniform-enough over [0, n_items) (bias ~ n_items/2^32)."""
    return _umod(_mix32(rk, f), n_items)


# In-word probe offsets (mod 32) for the word sampler: slot j's probe
# round r tests bit (bit0 + _WORD_DELTA[j * (n_rounds-1) + r]) & 31 of the
# row's ONE gathered bitmap word. Pairwise distinct mod 32, so no two
# (slot, round) probes of a row can select the same item; spread out, so
# probes test well-separated bits. Capacity: num_neg * (n_rounds-1) <= 15
# (checked by word_sampler_applies); beyond it the grouped path falls back
# to the compacted exact-rejection sampler.
_WORD_DELTA = (0, 11, 19, 5, 16, 27, 3, 9, 25, 7, 14, 22, 29, 2, 13)


def word_sampler_applies(num_neg: int, n_rounds: int) -> bool:
    """True when the shared-word probe table covers every (slot, round)."""
    return num_neg * max(n_rounds - 1, 0) <= len(_WORD_DELTA)


def _word_probe(rk: torch.Tensor, row: torch.Tensor, wpu: int):
    """(word, bit0) coordinates of stream row ``row``'s shared probe word:
    word uniform over the user's ``wpu`` bitmap words, bit0 uniform over
    its 32 bits. ONE word gather per positive serves every (slot, round)
    probe of that row — slot j's round-r probe tests bit
    (bit0 + _WORD_DELTA[j*(n_rounds-1)+r]) & 31. Bit-identical contract
    with the reconstruction in the SGD loop, like :func:`_cand_hash`."""
    x = _mix32(rk, row)
    b0 = x & 31
    # the logical shift leaves 27 bits, so the uint32 modulo is an int32 one
    w = _shift_right_logical(x, 5) % wpu
    return w, b0


def _word_tail_mask(n_items: int, wpu: int) -> Optional[int]:
    """int32 mask of the NEVER-VALID bits of a user's last bitmap word
    (item ids >= n_items), or None when n_items fills the word exactly.
    The word sampler ORs it in so an invalid bit always reads "member" and
    is never chosen as a negative."""
    tail = n_items - 32 * (wpu - 1)
    if tail >= 32:
        return None
    return int(np.int32(np.uint32((0xFFFFFFFF << tail) & 0xFFFFFFFF)))


def _sample_rounds_word(
    rk: torch.Tensor,  # (R, 3) int32 round keys
    users: torch.Tensor,  # (n_rows,) int32 user of each stream row
    bitmap: PosBitmap,
    n_items: int,
    n_rounds: int,
    num_neg: int,
):
    """Single-shared-gather variant of :func:`_sample_rounds`: each
    positive row gathers ONE bitmap word; slot j's rounds r < n_rounds-1
    probe bits (b0 + _WORD_DELTA[j*(n_rounds-1)+r]) & 31 of that word; the
    final round is a fresh per-slot :func:`_cand_hash` candidate accepted
    UNCHECKED.

    Semantics vs the reference's resample-until-non-positive
    (BPREngine-inl.h:48-60): probe 0 of slot 0 is exactly uniform over the
    32*wpu padded id domain (tail-masked); later probes and sibling slots
    stay within the row's 32-item block (conditionally correlated), and
    the unchecked last round keeps a positive with probability
    ~p_collision when reached. Within-row slots never collide with each
    other on probe rounds (_WORD_DELTA offsets are distinct mod 32).

    Returns (rounds (n_rows, num_neg) int32, n_overflow=0) — there is no
    collision buffer to overflow.
    """
    n_rows = users.shape[0]
    wpu = bitmap.words_per_user
    dev = users.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if n_rounds == 1:
        return torch.zeros((n_rows, num_neg), dtype=torch.int32,
                           device=dev), zero
    row = torch.arange(n_rows, dtype=torch.int32, device=dev)
    w, b0 = _word_probe(rk[0], row, wpu)
    word = bitmap.words[users * wpu + w]
    invalid = _word_tail_mask(n_items, wpu)
    if invalid is not None:
        word = torch.where(w == wpu - 1, word | invalid, word)
    cols = []
    for j in range(num_neg):
        r_col = torch.full((n_rows,), n_rounds - 1, dtype=torch.int32,
                           device=dev)
        for r in range(n_rounds - 2, -1, -1):
            bit = (b0 + _WORD_DELTA[j * (n_rounds - 1) + r]) & 31
            member = ((word >> bit) & 1) == 1
            r_col = torch.where(member, r_col, r)
        cols.append(r_col)
    return torch.stack(cols, dim=1), zero


def _compact(mask: torch.Tensor, cap: int):
    """qmf_tpu's ``jnp.where(mask, size=cap, fill_value=n)``: a (cap,)
    int32 buffer of the positions of the first ``cap`` set entries of the
    (n,) ``mask`` in ascending order, ``n`` in the slots beyond the set
    count; and the count beyond ``cap`` as an int32 device scalar. A set
    entry's slot in the buffer is its running count less one, so slot j
    holds the first position where the running count reaches j + 1: a
    binary search of the running count (``searchsorted`` gives n where it
    never does). The shape is fixed and nothing is read on the host, so a
    CUDA graph captures it; and no two slots are written to one place."""
    count = torch.cumsum(mask, 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    cidx = torch.searchsorted(count, want, out_int32=True)
    n_overflow = torch.clamp(mask.sum(dtype=torch.int32) - cap, min=0)
    return cidx, n_overflow


def _set_compacted(n: int, cidx: torch.Tensor,
                   chosen: torch.Tensor) -> torch.Tensor:
    """(n,) int32 zeros with ``chosen`` set at the positions ``cidx`` of
    :func:`_compact`, whose fill rows (position n) land in one sink slot
    past the end and are dropped, as qmf_tpu's ``.at[cidx].set(chosen,
    mode="drop")`` drops them."""
    rounds = torch.zeros((n + 1,), dtype=torch.int32, device=cidx.device)
    rounds.index_put_((cidx,), chosen)
    return rounds[:n]


def _slot_users(u: torch.Tensor, num_neg: int) -> torch.Tensor:
    """The user of each negative slot f = row * num_neg + j: each row's user
    repeated num_neg times, (n_rows * num_neg,), so that the presamplers'
    f = arange(N_slots) lines up with the SGD loop's (t * batch + lane) *
    num_neg + j (an expand: its shape is known without the device)."""
    return u[:, None].expand(u.shape[0], num_neg).reshape(-1)


def _first_round(member, rk: torch.Tensor, users_slots: torch.Tensor,
                 n_items: int) -> torch.Tensor:
    """Round 0's test of every slot f at full stream width: whether
    ``_cand_hash(rk[0], f)`` is a positive of ``users_slots[f]`` by
    ``member(users, items)`` (the exact bitmap, or the Bloom filter whose
    hits are then verified)."""
    f = torch.arange(users_slots.shape[0], dtype=torch.int32,
                     device=users_slots.device)
    return member(users_slots, _cand_hash(rk[0], f, n_items))


def _collided(cidx: torch.Tensor, users_slots: torch.Tensor):
    """(slot index, user) of each compacted slot ``cidx`` (:func:`_compact`),
    whose fill rows read slot 0."""
    cf = torch.where(cidx < users_slots.shape[0], cidx, 0)
    return cf, users_slots[cf]


def _later_rounds(member, rk: torch.Tensor, cf: torch.Tensor,
                  cu: torch.Tensor, n_items: int, n_rounds: int,
                  chosen: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """Rounds 1..R-1 on the compacted slots (:func:`_collided`): each slot
    not yet ``found`` takes the first round whose candidate ``member``
    rejects; the others keep ``chosen``. Returns the chosen round of each
    compacted slot."""
    for r in range(1, n_rounds):
        m_r = member(cu, _cand_hash(rk[r], cf, n_items))
        take = (~found) & (~m_r)
        chosen = torch.where(take, r, chosen)
        found = found | take
    return chosen


def _resample_bitmap(bitmap: PosBitmap, rk: torch.Tensor, cidx: torch.Tensor,
                     users_slots: torch.Tensor, n_items: int,
                     n_rounds: int) -> torch.Tensor:
    """:func:`_sample_rounds`'s later rounds: the compacted slots collided
    in round 0, so each starts at the last round, not yet found."""
    cf, cu = _collided(cidx, users_slots)
    return _later_rounds(
        functools.partial(_is_member_bitmap, bitmap), rk, cf, cu, n_items,
        n_rounds,
        torch.full(cf.shape, n_rounds - 1, dtype=torch.int32,
                   device=cf.device),
        torch.zeros(cf.shape, dtype=torch.bool, device=cf.device))


def _resample_exact(pos_set: PosSet, rk: torch.Tensor, cidx: torch.Tensor,
                    users_slots: torch.Tensor, n_items: int,
                    n_rounds: int) -> torch.Tensor:
    """:func:`_sample_rounds_bloom`'s later rounds: the compacted Bloom hits
    get the exact round-0 verdict of the CSR set first; false positives
    keep round 0, true members walk rounds 1..R-1 under exact tests."""
    member = functools.partial(_is_member, pos_set)
    cf, cu = _collided(cidx, users_slots)
    m0 = member(cu, _cand_hash(rk[0], cf, n_items))
    chosen = torch.where(m0, n_rounds - 1, 0).to(torch.int32)
    return _later_rounds(member, rk, cf, cu, n_items, n_rounds, chosen, ~m0)


def _sample_rounds(
    rk: torch.Tensor,  # (R, 3) int32 round keys
    users_slots: torch.Tensor,  # (N,) int32 user of each negative slot
    bitmap: PosBitmap,
    n_items: int,
    n_rounds: int,
    collide_cap: int,
):
    """Pick, per negative slot f, the first round r whose candidate
    ``_cand_hash(rk[r], f)`` is NOT a positive of users_slots[f].

    Exact-rejection semantics (reference BPREngine-inl.h:48-60) at ~1/R of
    the membership cost: only round 0 is tested at full stream width; the
    ~(avg_degree/n_items) fraction of colliding slots is compacted to a
    fixed ``collide_cap``-slot buffer (:func:`_compact`), the first in
    ascending order, and rounds 1..R-1 test only those. Slots colliding in every round keep the LAST
    round's candidate (residual probability (degree/n_items)^R, matching
    sample_negatives).

    Returns (rounds (N,) int32 in [0, R), n_overflow) where n_overflow
    counts colliders beyond ``collide_cap`` (those keep round 0; callers
    should log when it is nonzero — quality degrades gracefully).
    """
    n = users_slots.shape[0]
    dev = users_slots.device
    member0 = _first_round(
        functools.partial(_is_member_bitmap, bitmap), rk, users_slots,
        n_items)
    if n_rounds == 1:
        return (torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    cidx, n_overflow = _compact(member0, collide_cap)
    chosen = _resample_bitmap(bitmap, rk, cidx, users_slots, n_items,
                              n_rounds)
    return _set_compacted(n, cidx, chosen), n_overflow


def _sample_rounds_bloom(
    rk: torch.Tensor,  # (R, 3) int32 round keys
    users_slots: torch.Tensor,  # (N,) int32 user of each negative slot
    bloom: PosBloom,
    pos_set: PosSet,
    n_items: int,
    n_rounds: int,
    collide_cap: int,
):
    """:func:`_sample_rounds` for catalogs beyond the exact-bitmap budget.

    Same contract and EXACT same sampling semantics, composed differently:
    round 0 is tested at full stream width against the blocked Bloom filter
    (2 gathers/slot, no false negatives), and only the Bloom HITS — true
    collisions plus the ~load^2 false-positive fraction — are compacted to
    ``collide_cap`` slots and exact-verified with the CSR binary search.
    Bloom false positives keep their (verified-negative) round-0 candidate;
    true members walk rounds 1..R-1 under exact CSR tests.
    """
    hit0 = _first_round(functools.partial(_is_member_bloom, bloom), rk,
                        users_slots, n_items)
    cidx, n_overflow = _compact(hit0, collide_cap)
    chosen = _resample_exact(pos_set, rk, cidx, users_slots, n_items,
                             n_rounds)
    return _set_compacted(users_slots.shape[0], cidx, chosen), n_overflow


def draw_grouped_keys(generator: torch.Generator, n_rounds: int,
                      shuffle: bool):
    """The grouped epoch's draws: the round keys ``rk`` (n_rounds, 3) and,
    with ``shuffle``, the six Feistel keys ``ks`` (else None)."""
    rk = _draw_keys(generator, (n_rounds, 3))
    return rk, _draw_keys(generator, (6,)) if shuffle else None


def _sample_pack_grouped_body(
    rk: torch.Tensor,  # (n_rounds, 3) int32 round keys
    ks: Optional[torch.Tensor],  # (6,) int32 Feistel keys, None = no shuffle
    pos_up: torch.Tensor,  # (n_stream, 2) int32 [user, pos_item] rows,
    #                        n_stream = m * 2**feistel_b
    bitmap_words: torch.Tensor,  # exact-bitmap OR bloom words, per `membership`
    n_items: int,
    n_real: int,  # rows < n_real are real positive pairs, >= are padding
    num_neg: int,
    n_rounds: int,
    wpu: int,
    u_shift: int,
    feistel_b: int,
    collide_cap: int,
    membership: str = "bitmap",
    indptr: Optional[torch.Tensor] = None,  # CSR verify arrays (bloom mode)
    csr_items: Optional[torch.Tensor] = None,
    max_degree: int = 0,
):
    """Grouped-epoch pass 1: shuffle positives, presample ALL negatives,
    encode each row as (u_enc, pos).

    The row's num_neg negatives are NOT stored as items: slot f's candidate
    under round r is the pure function _cand_hash(rk[r], f), so storing the
    chosen 2-bit round index per slot is enough for the SGD loop to
    reconstruct the item with arithmetic. Encoding:

        u_enc = (u << u_shift) | round_j bits (2 per negative) << 1 | valid

    This removes the pos<<15|neg item-count ceiling (any int32 item id
    works) and cuts the shuffled stream from triplet-level to
    positive-level width. The (user, item) pairs arrive interleaved as one
    (n_stream, 2) tensor so the shuffle is one row gather.

    Returns (enc, p, n_overflow); ``rk`` and ``ks`` are the integers that
    qmf_tpu draws inside its ``_sample_pack_grouped_body``.
    """
    u, p, valid = _shuffled_rows(ks, pos_up, n_real, feistel_b)
    if membership == "word":
        rounds_row, n_overflow = _sample_rounds_word(
            rk, u, PosBitmap(bitmap_words, wpu), n_items, n_rounds, num_neg
        )
    else:
        users_slots = _slot_users(u, num_neg)
        if membership == "bloom":
            rounds, n_overflow = _sample_rounds_bloom(
                rk,
                users_slots,
                PosBloom(bitmap_words, wpu),
                PosSet(indptr, csr_items, max_degree),
                n_items,
                n_rounds,
                collide_cap,
            )
        else:
            rounds, n_overflow = _sample_rounds(
                rk,
                users_slots,
                PosBitmap(bitmap_words, wpu),
                n_items,
                n_rounds,
                collide_cap,
            )
        rounds_row = rounds.reshape(u.shape[0], num_neg)
    return _encode(u, valid, u_shift, rounds_row), p, n_overflow


def _shuffled_rows(ks: Optional[torch.Tensor], pos_up: torch.Tensor,
                   n_real: int, feistel_b: int):
    """Pass 1's shuffle: the (user, item) rows of ``pos_up`` in the order of
    the Feistel bijection on the six keys ``ks`` (one row gather; in stream
    order with ``ks`` None), as (u, p, valid), valid marking the rows that
    came from the real prefix of ``n_real`` rows."""
    n_stream = pos_up.shape[0]
    if ks is not None:
        idx = _feistel_bijection(ks, n_stream >> feistel_b, feistel_b)
        up = pos_up[idx]
        valid = idx < n_real
    else:
        up = pos_up
        valid = torch.arange(
            n_stream, dtype=torch.int32, device=pos_up.device
        ) < n_real
    return up[:, 0], up[:, 1], valid


def _encode(u: torch.Tensor, valid: torch.Tensor, u_shift: int,
            rounds_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The packed row (u << u_shift) | round_j << (1 + 2j) | valid, with
    the (n_rows, num_neg) chosen rounds ``rounds_row`` (none: the user and
    the valid bit alone)."""
    enc = (u << u_shift) | valid.to(torch.int32)
    if rounds_row is not None:
        for j in range(rounds_row.shape[1]):
            enc = enc | (rounds_row[:, j] << (1 + 2 * j))
    return enc


def _slot_tables(num_neg: int, n_rounds: int, use_word: bool, device):
    """Per negative slot j, as (num_neg,) int32 tensors: j itself (its
    offset in the slot index), the shift of its 2-bit round index in u_enc,
    and for the word sampler its probe offsets by round, (num_neg,
    n_rounds-1), else None. Made once an epoch, outside the loop."""
    slot = torch.arange(num_neg, dtype=torch.int32, device=device)
    delta = None
    if use_word and n_rounds > 1:
        delta = torch.tensor(
            _WORD_DELTA[: num_neg * (n_rounds - 1)], dtype=torch.int32,
            device=device,
        ).reshape(num_neg, n_rounds - 1)
    return slot, 1 + 2 * slot, delta


def _decode_negatives(
    ue: torch.Tensor,  # (B,) int32 encoded rows
    row_idx: torch.Tensor,  # (B,) int32 positions of the rows in the stream
    rk: torch.Tensor,
    tables,  # _slot_tables(...)
    n_items: int,
    n_rounds: int,
    use_word: bool,
    wpu: int,
):
    """The negatives of encoded stream rows, rebuilt from their 2-bit round
    indices as (negs, rounds), both (B, num_neg) int32, all slots at once:
    slot j of row i has index f = i * num_neg + j. Must mirror
    :func:`_sample_rounds_word` (``use_word``) or :func:`_sample_rounds`."""
    slot, r_shift, delta = tables
    f = (row_idx * slot.shape[0])[:, None] + slot
    r_all = (ue[:, None] >> r_shift) & 3
    if use_word:
        # shared-word in-word probes for r < n_rounds-1, fresh per-slot
        # hash for the unchecked final round
        negs = _cand_hash(rk[n_rounds - 1], f, n_items)
        if n_rounds > 1:
            w_row, b0_row = _word_probe(rk[0], row_idx, wpu)
            base = (w_row * 32)[:, None]
            for r in range(n_rounds - 1):
                cand_r = base + ((b0_row[:, None] + delta[:, r]) & 31)
                negs = torch.where(r_all == r, cand_r, negs)
    else:
        negs = _cand_hash(rk[0], f, n_items)
        for r in range(1, n_rounds):
            negs = torch.where(
                r_all == r, _cand_hash(rk[r], f, n_items), negs
            )
    return negs, r_all


def _step_decode(
    ue: torch.Tensor,  # (B,) int32 encoded rows of one step
    row0: int,  # the stream position of lane 0 of the step
    lane: torch.Tensor,  # (B,) int32 the rows' lanes
    rk: torch.Tensor,
    lr: torch.Tensor,  # 0-d, the factors' dtype
    tables,  # _slot_tables(...)
    u_shift: int,
    n_items: int,
    n_rounds: int,
    use_word: bool,
    wpu: int,
):
    """The first of a grouped step's reads: its rows decoded, as (w, u,
    negs): the valid bit times the rate (B,), the users (B,) and the
    negatives (B, num_neg) (:func:`_decode_negatives`)."""
    # the valid bit times the rate: every gradient term carries w, so the
    # updates come out already scaled by the rate
    w = (ue & 1).to(lr.dtype) * lr
    u = _shift_right_logical(ue, u_shift)
    negs, _ = _decode_negatives(ue, row0 + lane, rk, tables, n_items,
                                n_rounds, use_word, wpu)
    return w, u, negs


def _step_gathers(params: BPRParams, u: torch.Tensor, p: torch.Tensor,
                  negs: torch.Tensor, use_biases: bool):
    """The rest of a grouped step's reads, the rows its gradients read:
    (pu, qp, qn, bp, bn), qn (B, num_neg, k), the biases None without
    ``use_biases``."""
    uf, itf, ib = params
    pu = uf[u]
    qp = itf[p]
    qn = itf[negs]  # (B, num_neg, k)
    bp = bn = None
    if use_biases:
        bp = ib[p]
        bn = ib[negs]  # (B, num_neg)
    return pu, qp, qn, bp, bn


def _step_grads(w, pu, qp, qn, bp, bn, user_lambda: float,
                item_lambda: float, bias_lambda: float):
    """A grouped step's gradients from its reads (:func:`_step_decode`'s
    ``w``, :func:`_step_gathers`' rows), already scaled by the rate: (du,
    dp, dn, dbp, dbn), dn (B, num_neg, k) slot j's update of its
    negative's row, dbp and dbn None without biases."""
    num_neg = qn.shape[1]
    wcol = w[:, None]
    d = ((pu * qp).sum(1))[:, None] - (pu[:, None, :] * qn).sum(2)
    if bp is not None:
        d = d + bp[:, None] - bn
    e = (1.0 / (1.0 + torch.exp(d))) * wcol  # (B, num_neg)
    e_sum = e.sum(1)
    # user update: sum of the num_neg triplet gradients
    du = (e[:, :, None] * (qp[:, None, :] - qn)).sum(1) \
        - num_neg * user_lambda * pu * wcol
    dp = e_sum[:, None] * pu - num_neg * item_lambda * qp * wcol
    dn = -e[:, :, None] * pu[:, None, :] - item_lambda * qn * wcol[:, :, None]
    dbp = dbn = None
    if bp is not None:
        dbp = e_sum - num_neg * bias_lambda * bp * w
        dbn = -e - bias_lambda * bn * wcol
    return du, dp, dn, dbp, dbn


def _step_writes(params: BPRParams, u, p, negs, du, dp, dn, dbp, dbn,
                 item_scatter: str) -> None:
    """A grouped step's writes: the scatter-adds of its gradients
    (:func:`_step_grads`) into the parameters, in place, by
    ``item_scatter`` (:func:`_sgd_epoch_scan_grouped_body`)."""
    uf, itf, ib = params
    uf.index_add_(0, u, du)
    if item_scatter in ("merged", "dense"):
        # slot-major, as qmf_tpu concatenates: p, negatives of slot 0, ...
        all_idx = torch.cat([p, negs.T.reshape(-1)])
        all_upd = torch.cat([dp, dn.transpose(0, 1).reshape(-1, dn.shape[2])])
        if item_scatter == "dense":
            itf.add_(torch.zeros_like(itf).index_add_(0, all_idx, all_upd))
        else:
            itf.index_add_(0, all_idx, all_upd)
        if dbp is not None:
            bupd = torch.cat([dbp, dbn.T.reshape(-1)])
            if item_scatter == "dense":
                ib.add_(torch.zeros_like(ib).index_add_(0, all_idx, bupd))
            else:
                ib.index_add_(0, all_idx, bupd)
    else:
        itf.index_add_(0, p, dp)
        for j in range(negs.shape[1]):
            itf.index_add_(0, negs[:, j], dn[:, j])
        if dbp is not None:
            ib.index_add_(0, p, dbp)
            for j in range(negs.shape[1]):
                ib.index_add_(0, negs[:, j], dbn[:, j])


def _sgd_epoch_scan_grouped_body(
    params: BPRParams,
    u_enc: torch.Tensor,  # (S*B,) int32: user + per-slot round bits + valid
    pos: torch.Tensor,  # (S*B,) int32 positive items
    rk: torch.Tensor,  # (R, 3) int32 round keys (shared with presampling)
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    batch_size: int,
    num_neg: int,
    n_items: int,
    n_rounds: int,
    u_shift: int,
    item_scatter: str = "seq",
    sampler: str = "rounds",
    wpu: int = 0,
    mesh=None,
    tables=None,
) -> BPRParams:
    """Grouped-epoch pass 2: minibatch SGD, one row per POSITIVE, in place.

    Compared to the triplet stream this shares the user/positive gathers
    and the user/positive scatters across the row's num_neg negatives.
    Negative items are reconstructed from the 2-bit round indices via
    _cand_hash. Update semantics are identical to num_neg consecutive
    triplet rows of the ungrouped epoch: every gradient reads pre-batch
    parameters (each step gathers all it reads before its first scatter);
    duplicate-row contributions (including the num_neg-fold regularization
    pull on u and pos) sum.

    ``item_scatter``: "seq" adds the positive rows and then each slot's
    negative rows, 1 + num_neg ``index_add_`` calls on the live table;
    "merged" adds them in one (1 + num_neg) * B-row call; "dense" sums them
    into a zeroed (n_items, k) accumulator and adds that densely. The three
    agree to rounding. The loop holds no host read of a device value.

    With ``mesh`` (parallel/mesh.py) each rank computes the gradients of its
    lanes of every step only, and :func:`_whole_batch` hands every rank the
    whole step's, which each applies as without a mesh.

    ``lr`` enters as a 0-d tensor on the device, folded into each lane's
    valid weight ``w``, which every gradient term carries (qmf_tpu's
    ``at[].add(lr * d)`` with the product taken first), so a CUDA graph of
    this loop (ops/graphs.py) reads the epoch's rate from that tensor
    rather than keeping the one it was captured with, at one (B,) multiply
    a step. ``tables`` are :func:`_slot_tables` for this configuration,
    made here if None: a graph takes them made beforehand, since their
    host-to-device copy cannot be captured.

    A step is :func:`_step_decode` and :func:`_step_gathers` (its reads),
    :func:`_step_grads`, :func:`_whole_batch` and :func:`_step_writes`,
    the helpers tools/bpr_grouped_micro.py builds its variants from.
    """
    s = u_enc.shape[0] // batch_size
    dev = u_enc.device
    ue_steps = u_enc.reshape(s, batch_size)
    p_steps = pos.reshape(s, batch_size)
    lo, hi = _lanes(batch_size, mesh)
    lane = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    use_word = sampler == "word"
    if tables is None:
        tables = _slot_tables(num_neg, n_rounds, use_word, dev)
    lr = torch.as_tensor(lr, dtype=params.user_factors.dtype, device=dev)

    for t in range(s):
        ue, p = ue_steps[t, lo:hi], p_steps[t, lo:hi]
        w, u, negs = _step_decode(ue, t * batch_size, lane, rk, lr, tables,
                                  u_shift, n_items, n_rounds, use_word, wpu)
        # every read of the step, before its first write
        rows = _step_gathers(params, u, p, negs, use_biases)
        grads = _step_grads(w, *rows, user_lambda, item_lambda, bias_lambda)
        u, p, negs, *grads = _whole_batch((u, p, negs, *grads), batch_size,
                                          mesh)
        _step_writes(params, u, p, negs, *grads, item_scatter)
    return params


def grouped_path_reject_reason(
    n_users: int,
    n_items: int,
    num_neg: int,
    n_rounds: int,
    batch_size: int,
    has_bitmap: bool,
) -> Optional[str]:
    """Why the grouped packed epoch cannot run, or None if it can.

    Callers log the reason so a configuration that silently loses the fast
    path (e.g. a non-power-of-two batch_size) is diagnosable from the log.
    The strings are qmf_tpu's.
    """
    u_shift = 1 + 2 * num_neg
    if not has_bitmap:
        return "no positive-membership structure (bitmap/bloom) available"
    if num_neg < 1:
        return f"num_negative_samples={num_neg} < 1"
    if u_shift > 30:
        return (
            f"num_negative_samples={num_neg} leaves no user bits "
            f"(needs 1 + 2*{num_neg} + user bits <= 31)"
        )
    if not 1 <= n_rounds <= 4:
        return (
            f"neg_resample_rounds={n_rounds} outside [1, 4] "
            "(round index must fit 2 bits)"
        )
    if batch_size < 1:
        return f"batch_size={batch_size} < 1"
    if batch_size & (batch_size - 1):
        return (
            f"batch_size={batch_size} is not a power of two "
            "(stream shuffle needs an m * 2^b domain)"
        )
    if n_users > (1 << (31 - u_shift)):
        return (
            f"n_users={n_users} exceeds 2^{31 - u_shift} "
            f"(user id must fit beside {num_neg} 2-bit round indices)"
        )
    if n_items >= (1 << 31):
        return f"n_items={n_items} >= 2^31"
    return None


class GroupedParts(NamedTuple):
    """The grouped epoch's two parts for one configuration
    (:func:`grouped_parts`)."""

    pass1: Callable  # (rk, ks) -> (enc, p, n_overflow)
    sgd: Callable  # (enc, p, rk, lr, uf, itf, ib) -> (uf, itf, ib)
    pack: dict  # pass 1's keyword arguments besides its four tensors


def grouped_parts(
    pos_up: torch.Tensor,  # (n_stream, 2) int32 padded [user, item] pair rows
    bitmap,  # PosBitmap (exact) or PosBloom (needs pos_set for verify)
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    n_items: int,
    n_real: int,
    use_biases: bool,
    num_neg: int,
    neg_rounds: int,
    batch_size: int,
    collide_cap: int,
    shuffle: bool,
    pos_set: Optional[PosSet] = None,
    item_scatter: str = "seq",
    sampler: str = "rounds",
    mesh=None,
) -> GroupedParts:
    """The two parts of one grouped training epoch for one configuration,
    each a function of what changes from epoch to epoch: ``pass1(rk, ks) ->
    (enc, p, n_overflow)`` (:func:`_sample_pack_grouped_body`: shuffle,
    presample, pack; ``ks`` read only with ``shuffle``) and ``sgd(enc, p,
    rk, lr, uf, itf, ib) -> (uf, itf, ib)`` (:func:`grouped_sgd`), with
    ``pack``, pass 1's keyword arguments. :func:`grouped_epoch` runs one
    after the other.

    Caller contract: pos_up is padded to a multiple of batch_size (a power
    of two), n_real marks the real prefix length, and
    grouped_path_reject_reason(...) returned None for this configuration.
    """
    is_bloom = isinstance(bitmap, PosBloom)
    if is_bloom and pos_set is None:
        raise ValueError("bloom membership requires pos_set for exact verify")
    use_word = _uses_word(bitmap, sampler, num_neg, neg_rounds)
    sgd = grouped_sgd(bitmap, user_lambda, item_lambda, bias_lambda,
                      use_biases, batch_size, num_neg, n_items, neg_rounds,
                      item_scatter, sampler, mesh)
    pack = dict(
        n_items=n_items, n_real=n_real, num_neg=num_neg, n_rounds=neg_rounds,
        wpu=bitmap.words_per_user, u_shift=1 + 2 * num_neg,
        feistel_b=batch_size.bit_length() - 1, collide_cap=collide_cap,
        membership="word" if use_word
        else ("bloom" if is_bloom else "bitmap"),
        indptr=pos_set.indptr if is_bloom else None,
        csr_items=pos_set.items if is_bloom else None,
        max_degree=pos_set.max_degree if is_bloom else 0,
    )

    def pass1(rk, ks):
        return _sample_pack_grouped_body(
            rk, ks if shuffle else None, pos_up, bitmap.words, **pack)

    return GroupedParts(pass1, sgd, pack)


def grouped_epoch(*args, **kwargs):
    """One grouped training epoch for one configuration (the arguments of
    :func:`grouped_parts`), as a function of what changes from epoch to
    epoch: ``epoch(rk, ks, lr, uf, itf, ib) -> (uf, itf, ib, n_overflow)``,
    the round keys, the six Feistel keys (read only with ``shuffle``: a
    placeholder of that shape otherwise), the rate as a 0-d tensor and the
    parameters, updated in place. It is pass 1 and then the SGD loop,
    qmf_tpu's two programs as one. Nothing in it reads a device value on
    the host (the collision buffer has a fixed size, :func:`_compact`), so
    a CUDA graph (ops/graphs.py) captures all of it. ``n_overflow`` is a
    DEVICE scalar of collision-buffer overflows (callers log it when
    nonzero, reading it at a point that already syncs).

    With ``mesh`` every rank presamples the whole epoch (the collision
    buffer compacts over the whole stream, so a slice cannot be presampled
    alone) and steps its lanes (parallel/sharded_bpr.py).

    The epoch is the part ``bpr_epoch`` (utils/tracing.py), pass 1 and the
    loop its parts ``bpr_pass1`` and ``bpr_sgd``, stamped at every replay.
    """
    pass1, sgd, _ = grouped_parts(*args, **kwargs)

    def epoch(rk, ks, lr, uf, itf, ib):
        with tracing.part("bpr_epoch", rk.device):
            with tracing.part("bpr_pass1", rk.device):
                enc, p, n_overflow = pass1(rk, ks)
            with tracing.part("bpr_sgd", rk.device):
                params = sgd(enc, p, rk, lr, uf, itf, ib)
        return (*params, n_overflow)

    return epoch


def no_keys(n: int, device) -> torch.Tensor:
    """The placeholder of an unshuffled epoch's ``n`` shuffle keys: an epoch
    program always takes the tensor, and reads it only to shuffle."""
    return torch.zeros((n,), dtype=torch.int32, device=device)


def sgd_epoch_grouped_keyed(
    params: BPRParams,
    rk: torch.Tensor,  # (neg_rounds, 3) int32 round keys
    ks: Optional[torch.Tensor],  # (6,) int32 Feistel keys, None = no shuffle
    pos_up: torch.Tensor,  # (n_stream, 2) int32 padded [user, item] pair rows
    bitmap,  # PosBitmap (exact) or PosBloom (needs pos_set for verify)
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    n_items: int,
    n_real: int,
    use_biases: bool,
    num_neg: int,
    neg_rounds: int,
    batch_size: int,
    collide_cap: int,
    pos_set: Optional[PosSet] = None,
    item_scatter: str = "seq",
    sampler: str = "rounds",
    mesh=None,
):
    """One grouped training epoch on given keys: :func:`grouped_epoch`'s
    function for this configuration, called once. Returns (params,
    n_overflow), n_overflow a device scalar."""
    epoch = grouped_epoch(
        pos_up, bitmap, user_lambda, item_lambda, bias_lambda, n_items,
        n_real, use_biases, num_neg, neg_rounds, batch_size, collide_cap,
        ks is not None, pos_set, item_scatter, sampler, mesh)
    uf = params.user_factors
    lr = torch.as_tensor(lr, dtype=uf.dtype, device=uf.device)
    *new_params, n_overflow = epoch(
        rk, no_keys(6, uf.device) if ks is None else ks, lr, *params)
    return BPRParams(*new_params), n_overflow


def _uses_word(bitmap, sampler: str, num_neg: int, neg_rounds: int) -> bool:
    """Whether the grouped epoch samples with the shared-word sampler: asked
    for, on the exact bitmap, and applicable to these counts."""
    return (sampler == "word" and not isinstance(bitmap, PosBloom)
            and word_sampler_applies(num_neg, neg_rounds))


def grouped_sgd(bitmap, user_lambda: float, item_lambda: float,
                bias_lambda: float, use_biases: bool, batch_size: int,
                num_neg: int, n_items: int, neg_rounds: int,
                item_scatter: str = "seq", sampler: str = "rounds",
                mesh=None):
    """The grouped epoch's SGD loop (:func:`_sgd_epoch_scan_grouped_body`)
    for one configuration, as a function of what changes from epoch to
    epoch: ``sgd(enc, p, rk, lr, uf, itf, ib) -> (uf, itf, ib)``, the
    packed stream, the round keys, the rate as a 0-d tensor and the
    parameters, updated in place. Its arguments are :func:`grouped_epoch`'s,
    which runs it after pass 1. The loop reads no device value on the
    host."""
    use_word = _uses_word(bitmap, sampler, num_neg, neg_rounds)
    tables = _slot_tables(num_neg, neg_rounds, use_word, bitmap.words.device)

    def sgd(enc, p, rk, lr, uf, itf, ib):
        return tuple(_sgd_epoch_scan_grouped_body(
            BPRParams(uf, itf, ib), enc, p, rk, lr, user_lambda,
            item_lambda, bias_lambda, use_biases=use_biases,
            batch_size=batch_size, num_neg=num_neg, n_items=n_items,
            n_rounds=neg_rounds, u_shift=1 + 2 * num_neg,
            item_scatter=item_scatter,
            sampler="word" if use_word else "rounds",
            wpu=bitmap.words_per_user if use_word else 0, mesh=mesh,
            tables=tables,
        ))

    return sgd


def sgd_epoch_grouped(
    params: BPRParams,
    generator: torch.Generator,
    pos_up: torch.Tensor,
    bitmap,
    lr: float,
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    n_items: int,
    n_real: int,
    use_biases: bool,
    num_neg: int,
    neg_rounds: int,
    shuffle: bool,
    batch_size: int,
    collide_cap: int,
    pos_set: Optional[PosSet] = None,
    item_scatter: str = "seq",
    sampler: str = "rounds",
):
    """:func:`sgd_epoch_grouped_keyed` on keys drawn from ``generator``
    (qmf_tpu's ``sgd_epoch_grouped`` with the generator in the key's
    place)."""
    rk, ks = draw_grouped_keys(generator, neg_rounds, shuffle)
    return sgd_epoch_grouped_keyed(
        params, rk, ks, pos_up, bitmap, lr, user_lambda, item_lambda,
        bias_lambda, n_items=n_items, n_real=n_real, use_biases=use_biases,
        num_neg=num_neg, neg_rounds=neg_rounds, batch_size=batch_size,
        collide_cap=collide_cap, pos_set=pos_set, item_scatter=item_scatter,
        sampler=sampler,
    )


def _mix_bijection(ks: torch.Tensor, n_pow2: int, kbits: int) -> torch.Tensor:
    """A keyed bijection on [0, 2^kbits) as pure index arithmetic, from the
    three int32 keys ``ks`` in [0, 2^30).

    Three odd-multiplier multiplications mod 2^k interleaved with
    xor-shift-right mixes — every step is invertible mod 2^k (odd multiplier:
    unit of Z/2^k; x ^ (x>>a): triangular linear map over GF(2)), so the
    composition is a permutation. Quality: an LCG-grade mix, re-keyed per
    epoch; the reference's mt19937 shuffle (BPREngine.cpp:172-174) is
    likewise "only" pseudorandom — SGD needs decorrelation, not
    cryptography. Bit for bit qmf_tpu's on the same keys.
    """
    mask = n_pow2 - 1
    x = torch.arange(n_pow2, dtype=torch.int32, device=ks.device)
    x = (x * ((ks[0] << 1) | 1)) & mask
    x = x ^ ((x >> 7) ^ (x >> 13))
    x = (x * ((ks[1] << 1) | 1)) & mask
    x = x ^ (x >> (max(1, kbits // 2)))
    x = (x * ((ks[2] << 1) | 1)) & mask
    return x


def _sample_pack_impl(
    ks: Optional[torch.Tensor],  # (3,) int32 shuffle keys, None = no shuffle
    cands: torch.Tensor,  # (neg_rounds, N) int32 candidate items
    tri_ui: torch.Tensor,  # (N, 2) int32 [user, pos_item] rows, N a power of 2
    bitmap_words: torch.Tensor,
    n_real: int,  # rows < n_real are real triplets, >= are padding
    wpu: int,
):
    """Packed legacy epoch, pass 1: shuffle, presample negatives, pack.

    - The epoch shuffle is a sort-free bijective index hash applied as ONE
      row gather of the interleaved (user, item) stream; the padding mask
      needs no gather at all (w = idx < n_real).
    - Negatives are parameter-independent, so sampling commutes with the
      SGD updates; one wide bitmap-membership pass replaces per-step
      sampling. The sampled negative is packed into the positive-item
      stream (pos << 15 | neg).

    ``ks`` and ``cands`` are the integers that qmf_tpu draws inside its
    ``_sample_pack_impl``. Returns (u, packed, w); w is float32.
    """
    n = tri_ui.shape[0]
    if ks is not None:
        idx = _mix_bijection(ks, n, n.bit_length() - 1)
        ui = tri_ui[idx]
        w = (idx < n_real).to(torch.float32)
    else:
        ui = tri_ui
        w = (
            torch.arange(n, dtype=torch.int32, device=tri_ui.device) < n_real
        ).to(torch.float32)
    u = ui[:, 0]
    items = ui[:, 1]
    bitmap = PosBitmap(bitmap_words, wpu)
    neg = torch.zeros_like(u)
    valid = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    neg_rounds = cands.shape[0]
    for r in range(neg_rounds):
        cand = cands[r]
        cand_ok = ~_is_member_bitmap(bitmap, u, cand)
        take = (~valid) & cand_ok
        neg = torch.where(take, cand, neg)
        if r == neg_rounds - 1:
            neg = torch.where(valid | take, neg, cand)
        valid = valid | cand_ok
    packed = (items << _PACK_SHIFT) | neg
    return u, packed, w


def _sgd_epoch_scan_packed_impl(
    params: BPRParams,
    users_flat: torch.Tensor,
    packed_flat: torch.Tensor,  # (S*B,) pos << 15 | neg
    weights_flat: torch.Tensor,
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    batch_size: int,
    mesh=None,
) -> BPRParams:
    """Packed legacy epoch, pass 2: minibatch SGD over presampled triplets
    (with ``mesh``, each rank computes its lanes of every step)."""
    s = users_flat.shape[0] // batch_size
    u_steps = users_flat.reshape(s, batch_size)
    p_steps = packed_flat.reshape(s, batch_size)
    w_steps = weights_flat.reshape(s, batch_size).to(
        params.user_factors.dtype)
    lo, hi = _lanes(batch_size, mesh)
    for t in range(s):
        p = p_steps[t, lo:hi]
        _sgd_update_body(
            params, u_steps[t, lo:hi], p >> _PACK_SHIFT,
            p & ((1 << _PACK_SHIFT) - 1), w_steps[t, lo:hi], lr, user_lambda,
            item_lambda, bias_lambda, use_biases=use_biases, mesh=mesh,
            batch_size=batch_size,
        )
    return params


def packed_epoch(
    tri_ui: torch.Tensor,  # (N, 2) int32 [user, pos_item] rows, N a power of 2
    bitmap: PosBitmap,
    n_real: int,
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    use_biases: bool,
    batch_size: int,
    shuffle: bool,
    mesh=None,
):
    """The packed legacy epoch for one configuration as a function of its
    draws and the parameters: ``epoch(ks, cands, lr, uf, itf, ib) -> (uf,
    itf, ib)``, the three shuffle keys (read only with ``shuffle``: a
    placeholder of that shape otherwise), the candidates (neg_rounds, N),
    the rate as a 0-d tensor and the parameters, updated in place. It is
    pass 1 (:func:`_sample_pack_impl`) and then every step
    (:func:`_sgd_epoch_scan_packed_impl`), qmf_tpu's two programs as one;
    nothing in it reads a device value on the host, so a CUDA graph
    (ops/graphs.py) captures all of it."""

    def epoch(ks, cands, lr, uf, itf, ib):
        u, packed, w = _sample_pack_impl(
            ks if shuffle else None, cands, tri_ui, bitmap.words, n_real,
            bitmap.words_per_user)
        _sgd_epoch_scan_packed_impl(
            BPRParams(uf, itf, ib), u, packed, w, lr, user_lambda,
            item_lambda, bias_lambda, use_biases=use_biases,
            batch_size=batch_size, mesh=mesh)
        return uf, itf, ib

    return epoch


def packed_path_reasons(n: int, n_items: int, batch_size: int,
                         has_bitmap: bool, n_real: Optional[int]) -> list:
    """Why :func:`sgd_epoch` cannot take the packed presampled path; empty
    when it can (a bitmap, n_items within the packing bound, a stream
    padded to a power of two that the batch divides, n_real known)."""
    reasons = []
    if not has_bitmap:
        reasons.append("no membership bitmap (over budget?)")
    if n_items > (1 << _PACK_SHIFT):
        reasons.append(f"n_items={n_items} > {1 << _PACK_SHIFT}")
    if n & (n - 1) != 0:
        reasons.append(f"triplet stream length {n} not a power of two")
    if n % batch_size != 0:
        reasons.append(f"stream length {n} % batch_size {batch_size} != 0")
    if n_real is None:
        reasons.append("n_real not provided")
    return reasons


def draw_epoch(generator: torch.Generator, n: int, n_items: int,
               neg_rounds: int, shuffle: bool, batch_size: int,
               packed: bool):
    """The legacy epoch's draws for a stream of ``n`` triplets, as
    (shuffle_draw, cands): on the packed path the three keys of
    :func:`_mix_bijection` and candidates (neg_rounds, n); on the in-step
    path a permutation of the stream, padded to a multiple of the batch,
    and candidates (steps, neg_rounds, batch_size). shuffle_draw is None
    without ``shuffle``."""
    if packed:
        ks = _draw_keys(generator, (3,)) if shuffle else None
        return ks, _draw_candidates(generator, (neg_rounds, n), n_items)
    n += (-n) % batch_size
    perm = torch.randperm(
        n, generator=generator, device=generator.device, dtype=torch.int32
    ) if shuffle else None
    return perm, _draw_candidates(
        generator, (n // batch_size, neg_rounds, batch_size), n_items)


def sgd_epoch_drawn(
    params: BPRParams,
    shuffle_draw: Optional[torch.Tensor],
    cands: torch.Tensor,
    users_flat: torch.Tensor,
    items_flat: torch.Tensor,
    weights_flat: torch.Tensor,
    pos_set: PosSet,
    lr,  # float, or a 0-d tensor of the factors' dtype on their device
    user_lambda: float,
    item_lambda: float,
    bias_lambda: float,
    n_items: int,
    use_biases: bool,
    batch_size: int,
    bitmap: Optional[PosBitmap] = None,
    n_real: Optional[int] = None,  # real (unpadded) triplet count
    mesh=None,
) -> BPRParams:
    """One full legacy training epoch on the draws of :func:`draw_epoch`;
    with ``mesh`` every rank presamples the whole epoch and steps its lanes
    (parallel/sharded_bpr.py).

    When a membership bitmap exists and the item space fits the packing
    bound (n_items <= 2**_PACK_SHIFT), negatives are presampled in one wide
    pass and packed into the items stream (:func:`packed_epoch`). Otherwise
    the epoch samples inside each step with the CSR binary search
    (:func:`_sgd_epoch_impl`), and logs once which precondition failed.
    """
    n = users_flat.shape[0]
    uf = params.user_factors
    lr = torch.as_tensor(lr, dtype=uf.dtype, device=uf.device)
    reasons = packed_path_reasons(
        n, n_items, batch_size, bitmap is not None, n_real)
    if not reasons:
        epoch = packed_epoch(
            torch.stack([users_flat, items_flat], dim=1), bitmap, n_real,
            user_lambda, item_lambda, bias_lambda, use_biases, batch_size,
            shuffle_draw is not None, mesh)
        keys = no_keys(3, uf.device) if shuffle_draw is None else shuffle_draw
        return BPRParams(*epoch(keys, cands, lr, *params))
    log_fallback(reasons)
    # the in-step path still needs batch divisibility (the loop reshapes to
    # (steps, batch_size)): pad with zero-weight no-op rows, matching the
    # engine's own stream padding semantics
    pad = (-n) % batch_size
    if pad:
        users_flat = torch.cat([users_flat, users_flat.new_zeros(pad)])
        items_flat = torch.cat([items_flat, items_flat.new_zeros(pad)])
        weights_flat = torch.cat([weights_flat, weights_flat.new_zeros(pad)])
    # the in-step sampler tests membership with the CSR binary search, as
    # qmf_tpu's in-scan sampler does; the bitmap serves the presampling
    # passes and the eval sets
    return _sgd_epoch_impl(
        params,
        shuffle_draw,
        cands,
        users_flat,
        items_flat,
        weights_flat,
        pos_set.indptr,
        pos_set.items,
        lr,
        user_lambda,
        item_lambda,
        bias_lambda,
        use_biases=use_biases,
        max_degree=pos_set.max_degree,
        batch_size=batch_size,
        mesh=mesh,
    )


def log_fallback(reasons) -> None:
    """Log, once a process for each set of reasons, that a legacy epoch
    samples inside each step (:func:`packed_path_reasons`)."""
    reason_key = tuple(reasons)
    if reason_key not in _fallback_logged:
        _fallback_logged.add(reason_key)
        log.info(
            "BPR epoch falling back to in-step CSR sampling (slower than "
            "the packed presampled path): %s", "; ".join(reasons)
        )


def sgd_epoch(params: BPRParams, generator: torch.Generator,
              users_flat: torch.Tensor, items_flat: torch.Tensor,
              weights_flat: torch.Tensor, pos_set: PosSet, lr: float,
              user_lambda: float, item_lambda: float, bias_lambda: float,
              n_items: int, use_biases: bool, neg_rounds: int,
              shuffle: bool, batch_size: int,
              bitmap: Optional[PosBitmap] = None,
              n_real: Optional[int] = None) -> BPRParams:
    """:func:`sgd_epoch_drawn` on draws from ``generator`` (qmf_tpu's
    ``sgd_epoch`` with the generator in the key's place)."""
    n = users_flat.shape[0]
    packed = not packed_path_reasons(
        n, n_items, batch_size, bitmap is not None, n_real)
    shuffle_draw, cands = draw_epoch(
        generator, n, n_items, neg_rounds, shuffle, batch_size, packed)
    return sgd_epoch_drawn(
        params, shuffle_draw, cands, users_flat, items_flat, weights_flat,
        pos_set, lr, user_lambda, item_lambda, bias_lambda, n_items=n_items,
        use_biases=use_biases, batch_size=batch_size, bitmap=bitmap,
        n_real=n_real,
    )


# rows of an eval set scored at a time: bounds the three gathered (rows, k)
# tables of eval_loss on a 50M-row eval set
_EVAL_CHUNK = 1 << 22


def eval_loss(
    params: BPRParams,
    users: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    use_biases: bool,
) -> torch.Tensor:
    """Mean logistic loss log(1+exp(-d)) over a fixed triplet eval set
    (reference BPREngine.cpp:237-239, 246-261), as a 0-d tensor."""
    n = users.shape[0]
    total = torch.zeros((), dtype=params.user_factors.dtype,
                        device=users.device)
    for s in range(0, n, _EVAL_CHUNK):
        e = s + _EVAL_CHUNK
        d, _, _, _ = _score_diff(
            params, users[s:e], pos[s:e], neg[s:e], use_biases)
        # log1p(exp(-d)) computed stably
        total = total + torch.logaddexp(torch.zeros_like(d), -d).sum()
    return total / n


def sample_negatives_host(
    rng: np.random.Generator,
    users: np.ndarray,
    pos_users: np.ndarray,
    pos_items: np.ndarray,
    n_items: int,
) -> np.ndarray:
    """Host-side exact rejection sampling (for fixed eval sets); a copy of
    qmf_tpu's.

    Loops until every row is valid — matching the reference's unbounded
    rejection loop (BPREngine-inl.h:48-60). Host numpy has real int64, so
    a flat key is safe here.
    """
    users = users.astype(np.int64)
    key_set = np.unique(
        pos_users.astype(np.int64) * np.int64(n_items)
        + pos_items.astype(np.int64)
    )
    neg = rng.integers(0, n_items, size=len(users))
    while True:
        keys = users * n_items + neg
        pos_idx = np.searchsorted(key_set, keys)
        pos_idx = np.minimum(pos_idx, len(key_set) - 1)
        bad = key_set[pos_idx] == keys if len(key_set) else np.zeros(
            len(users), dtype=bool
        )
        if not bad.any():
            return neg.astype(np.int64)
        neg[bad] = rng.integers(0, n_items, size=int(bad.sum()))
