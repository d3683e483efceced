"""Raw id <-> dense index bimap (reference qmf/utils/IdIndex.h:27-62).

Copy of qmf_tpu/data/id_index.py.

The reference assigns indices via incremental ``getOrSetIdx`` calls; the two
engines produce two different orderings, and both matter for output parity:

- WALS builds the index from signal groups of a dataset sorted by id
  (qmf/wals/WALSEngine.cpp:130-163), so index order == ascending raw id.
  Use :meth:`IdIndex.from_sorted_ids`.
- BPR builds it in order of first appearance in the dataset file
  (qmf/bpr/BPREngine.cpp:69-77). Use :meth:`IdIndex.from_first_occurrence`.

Lookups of unseen ids return ``MISSING_IDX`` (the reference uses SIZE_MAX,
qmf/utils/IdIndex.h:29).
"""

from __future__ import annotations

import numpy as np

# Sentinel for "id not in index". The reference uses SIZE_MAX; -1 plays the
# same role and is friendlier to vectorized masking.
MISSING_IDX = -1


class IdIndex:
    """Vectorized bimap between raw int64 ids and contiguous [0, n) indices."""

    def __init__(self, ids_in_index_order: np.ndarray):
        self._ids = np.asarray(ids_in_index_order, dtype=np.int64)
        if len(np.unique(self._ids)) != len(self._ids):
            raise ValueError("duplicate ids in index")
        # sorted view for O(log n) vectorized lookup
        self._sort_order = np.argsort(self._ids, kind="stable")
        self._sorted_ids = self._ids[self._sort_order]

    # --- constructors -----------------------------------------------------
    @classmethod
    def from_sorted_ids(cls, raw_ids: np.ndarray) -> "IdIndex":
        """Index order = ascending raw id (WALS grouping order)."""
        return cls(np.unique(np.asarray(raw_ids, dtype=np.int64)))

    @classmethod
    def from_sorted_ids_with_lookup(cls, raw_ids: np.ndarray):
        """(index, indices-of-raw_ids) in one pass.

        The ``return_inverse`` of the same np.unique sort IS the lookup of
        the input ids, so engine inits over tens of millions of ratings
        skip the separate 20M-row searchsorted pass (BPR init stage
        attribution, benchmarks/README.md)."""
        raw_ids = np.asarray(raw_ids, dtype=np.int64)
        uniq, inverse = np.unique(raw_ids, return_inverse=True)
        return cls(uniq), inverse.astype(np.int64)

    @classmethod
    def from_first_occurrence(cls, raw_ids: np.ndarray) -> "IdIndex":
        """Index order = order of first appearance (BPR getOrSetIdx order)."""
        raw_ids = np.asarray(raw_ids, dtype=np.int64)
        _, first_pos = np.unique(raw_ids, return_index=True)
        return cls(raw_ids[np.sort(first_pos)])

    @classmethod
    def from_first_occurrence_with_lookup(cls, raw_ids: np.ndarray):
        """(index, indices-of-raw_ids) in one pass (see
        :meth:`from_sorted_ids_with_lookup`); index order = first
        appearance."""
        raw_ids = np.asarray(raw_ids, dtype=np.int64)
        uniq, first_pos, inverse = np.unique(
            raw_ids, return_index=True, return_inverse=True
        )
        # rank sorted-unique slots by first appearance: rank[j] = the
        # first-occurrence index of sorted-unique id j
        order = np.argsort(first_pos, kind="stable")
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq), dtype=np.int64)
        return cls(raw_ids[np.sort(first_pos)]), rank[inverse]

    # --- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ids)

    @property
    def size(self) -> int:
        return len(self._ids)

    @property
    def ids(self) -> np.ndarray:
        """Raw ids in index order; ``ids[idx]`` == reference ``index.id(idx)``."""
        return self._ids

    def id(self, idx: int) -> int:
        return int(self._ids[idx])

    def idx(self, raw_id: int) -> int:
        """Single lookup; MISSING_IDX when absent."""
        return int(self.lookup(np.array([raw_id], dtype=np.int64))[0])

    def lookup(self, raw_ids: np.ndarray) -> np.ndarray:
        """Vectorized raw id -> index; MISSING_IDX where absent."""
        raw_ids = np.asarray(raw_ids, dtype=np.int64)
        pos = np.searchsorted(self._sorted_ids, raw_ids)
        pos_clipped = np.minimum(pos, len(self._sorted_ids) - 1) if self.size else pos
        if self.size == 0:
            return np.full(raw_ids.shape, MISSING_IDX, dtype=np.int64)
        found = self._sorted_ids[pos_clipped] == raw_ids
        out = np.where(found, self._sort_order[pos_clipped], MISSING_IDX)
        return out.astype(np.int64)

    def contains(self, raw_id: int) -> bool:
        return self.idx(raw_id) != MISSING_IDX
