"""Per-user positive-item sets and their membership tests.

Port of what serving needs from qmf_tpu/ops/bpr_ops.py (:47-279): the CSR
positive set with its vectorized binary search, the packed bitmap and the
blocked Bloom filter. The make_* functions are numpy on the host, as the
originals, and return tensors on the device they are given; the structures
are equal array for array to qmf_tpu's. The samplers and the SGD step of
that module are not ported yet (ROADMAP.md, queue 1).

torch has no uint32 arithmetic, so the Bloom hash runs in int64 with every
product kept below 2^63 and masked to 32 bits; the words stay int32 bit
patterns, as qmf_tpu stores them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
