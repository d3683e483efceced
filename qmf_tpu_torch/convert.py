"""Carry a qmf_tpu (JAX) engine's parameters into the port.

The JAX engine's factors arrive as numpy arrays (``np.asarray`` of its
device arrays), so this module needs no jax. Typical use, on a port engine
initialized from the same dataset::

    u, v = factors_from_jax(np.asarray(jax_engine.user_factors),
                            np.asarray(jax_engine.item_factors),
                            device="cuda", dtype=torch.float32)
    engine.load_factors(u, v)

A BPR engine's three arrays go through ``bpr_params_from_jax`` the same way.

A qmf_tpu checkpoint directory needs no conversion: both engines write and
read one format (qmf_tpu_torch/utils/checkpoint.py is a copy of
qmf_tpu/utils/checkpoint.py; ``WALSEngine.enable_checkpointing``); of a
BPR checkpoint the factors resume and the PRNG key does not
(``models/bpr.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def bpr_params_from_jax(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    item_biases: Optional[np.ndarray],
    dtype: torch.dtype,
    device: str | torch.device,
):
    """A qmf_tpu ``BPRParams`` (its three arrays as numpy) as the port's
    ``ops.bpr_ops.BPRParams`` on ``device`` in ``dtype``, copied. ``None``
    biases become zeros, which is what an engine without ``use_biases``
    holds. Assign the result to an initialized ``BPREngine.params``."""
    from qmf_tpu_torch.ops.bpr_ops import BPRParams

    uf, itf = factors_from_jax(user_factors, item_factors, device, dtype)
    if item_biases is None:
        ib = torch.zeros(itf.shape[0], dtype=dtype, device=device)
    else:
        ib = torch.tensor(np.asarray(item_biases), dtype=dtype, device=device)
    if ib.shape != (itf.shape[0],):
        raise ValueError(
            f"item biases {tuple(ib.shape)} != ({itf.shape[0]},)")
    return BPRParams(uf, itf, ib)
