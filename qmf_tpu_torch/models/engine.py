# Copy of qmf_tpu/models/engine.py (numpy only). The port cannot import the
# original because qmf_tpu/models/__init__.py imports jax.
"""Engine base: shared test-evaluation and factor-save helpers.

Mirrors the reference's abstract ``Engine`` (qmf/Engine.h:32-96): the
``init -> initTest -> optimize -> evaluate -> save*Factors`` lifecycle, plus
``init_avg_test_data`` (dense per-test-user label rows over all items,
reference qmf/Engine.cpp:27-71) and score computation (one device matmul
replacing the reference's parallel per-user loop, qmf/Engine.cpp:73-96).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from qmf_tpu.data.dataset import Dataset
from qmf_tpu.data.factor_io import FactorData, save_factors
from qmf_tpu.data.id_index import MISSING_IDX, IdIndex


class Engine:
    """Abstract training engine lifecycle."""

    def init(self, dataset: Dataset) -> None:
        raise NotImplementedError

    def init_test(self, test_dataset: Dataset) -> None:
        raise NotImplementedError

    def optimize(self) -> None:
        raise NotImplementedError

    def evaluate(self, epoch: int) -> None:
        raise NotImplementedError

    def save_user_factors(self, file_name: str) -> None:
        raise NotImplementedError

    def save_item_factors(self, file_name: str) -> None:
        raise NotImplementedError

    # --- shared helpers -----------------------------------------------------
    @staticmethod
    def init_avg_test_data(
        test_dataset: Dataset,
        user_index: IdIndex,
        item_index: IdIndex,
        num_test_users: int = 0,
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Build (test_users, dense labels) for averaged ranking metrics.

        Reference semantics (qmf/Engine.cpp:27-71): keep test elements whose
        user AND item appear in the training index; optionally subsample
        ``num_test_users`` users with a seeded shuffle; labels are dense rows
        over ALL items (zero where unrated).

        Note: when subsampling, the exact set of chosen users differs from
        the reference (it shuffles an unordered_set-ordered vector with
        std::mt19937 — not reproducible across standard libraries either);
        the selection here is a seeded numpy permutation of the
        ascending-index user list. Statistically equivalent.
        """
        uidx = user_index.lookup(test_dataset.user_ids)
        iidx = item_index.lookup(test_dataset.item_ids)
        valid = (uidx != MISSING_IDX) & (iidx != MISSING_IDX)
        uidx, iidx = uidx[valid], iidx[valid]
        values = test_dataset.values[valid]

        test_users = np.unique(uidx)
        if 0 < num_test_users < len(test_users):
            rng = np.random.RandomState(seed)
            test_users = test_users[
                rng.permutation(len(test_users))[:num_test_users]
            ]

        # vectorized dense fill: map each element's user index to its row in
        # test_users (or -1 if not selected), then one fancy-indexed
        # assignment (last write wins on duplicates, matching the
        # reference's sequential overwrite, qmf/Engine.cpp:62-66)
        user_pos = np.full(user_index.size, -1, dtype=np.int64)
        user_pos[test_users] = np.arange(len(test_users))
        rows = user_pos[uidx]
        sel = rows >= 0
        labels = np.zeros((len(test_users), item_index.size), dtype=np.float64)
        labels[rows[sel], iidx[sel]] = values[sel]
        return test_users.astype(np.int64), labels

    @staticmethod
    def save_factor_data(
        factors: np.ndarray,
        index: IdIndex,
        file_name: str,
        biases: Optional[np.ndarray] = None,
    ) -> None:
        """Save raw factor arrays in the reference text format."""
        fd = FactorData(factors.shape[0], factors.shape[1], biases is not None)
        fd.factors[:] = factors
        if biases is not None:
            fd.biases[:] = biases
        save_factors(fd, index, file_name)
