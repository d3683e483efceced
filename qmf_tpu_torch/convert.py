"""Carry a qmf_tpu (JAX) engine's parameters into the port.

The JAX engine's factors arrive as numpy arrays (``np.asarray`` of its
device arrays), so this module needs no jax. Typical use, on a port engine
initialized from the same dataset::

    u, v = factors_from_jax(np.asarray(jax_engine.user_factors),
                            np.asarray(jax_engine.item_factors),
                            device="cuda", dtype=torch.float32)
    engine.load_factors(u, v)

A qmf_tpu checkpoint directory needs no conversion: both engines write and
read one format (qmf_tpu_torch/utils/checkpoint.py is a copy of
qmf_tpu/utils/checkpoint.py; ``WALSEngine.enable_checkpointing``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def factors_from_jax(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    device: str | torch.device,
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(user, item) factor tensors on ``device`` in ``dtype``, copied (a
    JAX array's host view is read-only).

    Only the first n rows of a sharded engine's padded arrays are real; pass
    them sliced to the index sizes.
    """
    return tuple(
        torch.tensor(np.asarray(f), dtype=dtype, device=device)
        for f in (user_factors, item_factors)
    )
