"""The reference text formats and id maps, shared with ``qmf_tpu``.

``qmf_tpu.data`` is plain numpy (no jax), so the port uses it as it is;
this module re-exports what the port's callers name, so that they import
only ``qmf_tpu_torch``.
"""

from qmf_tpu.data import (  # noqa: F401  (re-exported)
    MISSING_IDX,
    Dataset,
    FactorData,
    IdIndex,
    load_factors,
    read_dataset,
    save_factors,
    write_dataset,
)
