"""Ratings dataset: text reader/writer and the in-memory COO container.

Copy of qmf_tpu/data/dataset.py; its native C++ reader is the port's own
copy (data/native.py).

The on-disk format is the reference's: one ``"<user> <item> <value>"`` triple
per line, whitespace separated (reference qmf/DatasetReader.cpp:29-42, parsed
there with ``sscanf("%lld %lld %lf")``). A malformed line is a hard error,
matching the reference's CHECK failure.

Instead of the reference's ``vector<DatasetElem>`` array-of-structs
(qmf/DatasetReader.h:29-33), the in-memory layout is a struct-of-arrays COO
triple — the layout every downstream device computation (segment packing,
gathers, einsums) actually wants.

Reading uses, in order of preference:
1. the native C++ parser (data/native.py: mmap + a parse on every core), or,
   where that library cannot be built or loaded,
2. a vectorized numpy parse (fast C-level parse via ``np.fromstring``), or
3. a pure-Python line loop (exact int64 parsing, arbitrary whitespace).
``native.last_path["read"]`` names the path the last read took.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from qmf_tpu_torch.utils.logging import log


@dataclasses.dataclass
class Dataset:
    """COO ratings: parallel arrays of (user id, item id, value)."""

    user_ids: np.ndarray  # int64 (n,)
    item_ids: np.ndarray  # int64 (n,)
    values: np.ndarray  # float64 (n,)

    def __post_init__(self) -> None:
        self.user_ids = np.asarray(self.user_ids, dtype=np.int64)
        self.item_ids = np.asarray(self.item_ids, dtype=np.int64)
        self.values = np.asarray(self.values, dtype=np.float64)
        if not (len(self.user_ids) == len(self.item_ids) == len(self.values)):
            raise ValueError("user_ids, item_ids, values must be equal length")

    def __len__(self) -> int:
        return len(self.user_ids)

    def swapped(self) -> "Dataset":
        """Dataset with user and item ids exchanged.

        The reference does this in place to reuse its user-side grouping code
        for items (qmf/wals/WALSEngine.cpp:43-53).
        """
        return Dataset(self.item_ids, self.user_ids, self.values)


def _read_python(path: str) -> Dataset:
    users, items, values = [], [], []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.split()
            try:
                if len(parts) < 3:
                    raise ValueError("expected 3 fields")
                users.append(int(parts[0]))
                items.append(int(parts[1]))
                values.append(float(parts[2]))
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: the file format is incorrect: {line!r}"
                ) from None
    return Dataset(
        np.array(users, dtype=np.int64),
        np.array(items, dtype=np.int64),
        np.array(values, dtype=np.float64),
    )


def _read_numpy(path: str) -> Dataset:
    """Vectorized parse: every whitespace-separated token must be numeric and
    the token count a multiple of 3. Falls back on any irregularity."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.strip():
        return Dataset(
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64)
        )
    import warnings

    with warnings.catch_warnings():
        # np.fromstring's text mode warns when trailing data is unparseable;
        # we detect that case below (token-count check) and fall back.
        warnings.simplefilter("ignore")
        flat = np.fromstring(raw, dtype=np.float64, sep=" ")  # noqa: NPY201
    if flat.size == 0 or flat.size % 3 != 0:
        raise ValueError("irregular token count")
    # Count lines to detect lines with a wrong field count that still yield a
    # multiple-of-3 token total.
    nlines = raw.count(b"\n") + (0 if raw.endswith(b"\n") else 1)
    if flat.size != 3 * nlines:
        raise ValueError("token count does not match 3 per line")
    triples = flat.reshape(-1, 3)
    users = triples[:, 0]
    items = triples[:, 1]
    # Ids above 2**53 don't round-trip through float64; fall back to exact
    # parsing in that (unlikely) regime.
    if np.any(np.abs(users) > 2**53) or np.any(np.abs(items) > 2**53):
        raise ValueError("ids exceed float64 exact-integer range")
    if np.any(users != np.floor(users)) or np.any(items != np.floor(items)):
        raise ValueError("non-integer id field")
    return Dataset(
        users.astype(np.int64), items.astype(np.int64), triples[:, 2].copy()
    )


def read_dataset(path: str) -> Dataset:
    """Read a ratings text file into a :class:`Dataset`."""
    from qmf_tpu_torch.data import native

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if native.available():
        native.last_path["read"] = "native"
        return native.read_dataset(path)
    try:
        with np.errstate(all="ignore"):
            ds = _read_numpy(path)
        native.last_path["read"] = "numpy"
    except ValueError:
        ds = _read_python(path)
        native.last_path["read"] = "python"
    log.warning("read %s with the %s reader: the native reader is "
                "unavailable (%s)", path, native.last_path["read"],
                native.unavailable_reason())
    return ds


def write_dataset(dataset: Dataset, path: str) -> None:
    """Write a dataset in the reference text format."""
    with open(path, "w") as f:
        for u, i, v in zip(dataset.user_ids, dataset.item_ids, dataset.values):
            f.write(f"{u} {i} {v:g}\n")
    log.info("wrote %d ratings to %s", len(dataset), path)
