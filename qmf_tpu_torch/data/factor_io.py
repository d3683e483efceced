"""Model state container and text factor save/load.

``FactorData`` mirrors the reference's factor matrix + optional bias vector
(reference qmf/FactorData.h:28-142) as host numpy arrays; device computation
takes/returns plain arrays, keeping this container the single host-side source
of truth between epochs.

``save_factors`` writes the reference's text format — one line per element:
``id [bias] f0 ... f{k-1}`` at fixed 9-decimal precision (reference
qmf/Engine.cpp:98-122) — so factor files are interchangeable between the two
implementations.

Copy of qmf_tpu/data/factor_io.py. Its native C++ writer is the port's own
copy (data/native.py), taken first; the Python writer here, the fallback
where that library cannot be built or loaded, gives the same bytes.
``native.last_path["write"]`` names the path the last save took.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from qmf_tpu_torch.data.id_index import IdIndex
from qmf_tpu_torch.utils.logging import log


class FactorData:
    """Factors (nelems x nfactors) plus optional per-element biases."""

    def __init__(self, nelems: int, nfactors: int, with_biases: bool = False):
        self.factors = np.zeros((nelems, nfactors), dtype=np.float64)
        self.biases: Optional[np.ndarray] = (
            np.zeros(nelems, dtype=np.float64) if with_biases else None
        )

    @property
    def nelems(self) -> int:
        return self.factors.shape[0]

    @property
    def nfactors(self) -> int:
        return self.factors.shape[1]

    @property
    def with_biases(self) -> bool:
        return self.biases is not None

    def bias_at(self, idx: int) -> float:
        # Reference returns 0.0 for bias reads when biases are disabled
        # (qmf/FactorData.h:44-46).
        return float(self.biases[idx]) if self.biases is not None else 0.0

    # --- initialization ----------------------------------------------------
    def set_factors_zero(self) -> None:
        self.factors[:] = 0.0

    def set_factors_uniform(self, bound: float, rng: np.random.Generator) -> None:
        """Uniform(-bound, bound) init (reference WALSEngine.cpp:58-62)."""
        self.factors[:] = rng.uniform(-bound, bound, size=self.factors.shape)

    def set_biases_uniform(self, bound: float, rng: np.random.Generator) -> None:
        if self.biases is None:
            raise ValueError("can't set biases when with_biases = false")
        self.biases[:] = rng.uniform(-bound, bound, size=self.biases.shape)

    def set_factors_from_file(self, file_name: str) -> None:
        """Fill factors row-major from a one-float-per-line file.

        Matches reference qmf/FactorData.h:74-100: if the file has fewer
        values than nelems*nfactors, logs an error and leaves the remaining
        entries untouched (the reference returns early mid-fill).
        """
        need = self.nelems * self.nfactors
        vals = []
        with open(file_name, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                vals.append(float(line.split()[0]))
                if len(vals) >= need:
                    break
        count = len(vals)
        flat = self.factors.reshape(-1)
        flat[:count] = np.asarray(vals, dtype=np.float64)
        if count < need:
            log.error("read uniform data from %s failed.", file_name)
        log.info("initialized factor from file size: %d", count)


def write_factors_python(file_name: str, ids: np.ndarray, factors: np.ndarray,
                         biases: Optional[np.ndarray]) -> None:
    """The Python writer: ``id [bias] f0 ... f{k-1}`` lines at 9 decimals,
    the bytes of ``native.write_factors``."""
    with open(file_name, "w") as out:
        for idx in range(factors.shape[0]):
            parts = [str(ids[idx])]
            if biases is not None:
                parts.append(f"{biases[idx]:.9f}")
            parts.extend(f"{v:.9f}" for v in factors[idx])
            out.write(" ".join(parts) + "\n")


def save_factors(factor_data: FactorData, index: IdIndex, file_name: str) -> None:
    """Write factors in the reference's 9-decimal fixed-point text format."""
    from qmf_tpu_torch.data import native

    if factor_data.nelems != index.size:
        raise ValueError(
            f"factor rows ({factor_data.nelems}) != index size ({index.size})"
        )
    args = (file_name, index.ids, factor_data.factors, factor_data.biases)
    if native.available():
        native.last_path["write"] = "native"
        native.write_factors(*args)
        return
    native.last_path["write"] = "python"
    log.warning("writing %s with the python writer: the native writer is "
                "unavailable (%s)", file_name, native.unavailable_reason())
    write_factors_python(*args)


def load_factors(
    file_name: str, with_biases: bool = False
) -> Tuple[np.ndarray, FactorData]:
    """Read a factor file back. Returns (ids, FactorData)."""
    rows = []
    ids = []
    with open(file_name, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ids.append(int(parts[0]))
            rows.append([float(x) for x in parts[1:]])
    arr = np.asarray(rows, dtype=np.float64)
    ncols = arr.shape[1] if arr.size else 0
    nfactors = ncols - 1 if with_biases else ncols
    fd = FactorData(len(ids), nfactors, with_biases)
    if with_biases:
        fd.biases[:] = arr[:, 0]
        fd.factors[:] = arr[:, 1:]
    elif arr.size:
        fd.factors[:] = arr
    return np.asarray(ids, dtype=np.int64), fd
