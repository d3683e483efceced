"""Per-epoch checkpoint/resume.

The reference has no mid-training checkpointing (SURVEY.md section 5.4): its
fault-tolerance story is per-bucket work reassignment inside an epoch
(reference RunOneTask.cpp:177-240). In the TPU design an epoch is a single
device program, so the recovery unit becomes the epoch: the model state is
snapshotted after each epoch and a restarted run resumes from the last
complete snapshot — equivalent end state, simpler machinery. What each
engine snapshots: WALS saves factors + the epoch counter only (it has no
mid-run RNG — item factors are re-derived from users each epoch); BPR
additionally saves its sampler RNG key and decayed learning rate
(models/bpr.py).

Format: one .npz per snapshot plus a LATEST pointer file, written atomically
(tmp + rename) so a crash mid-write never corrupts the resume point.

Copy of qmf_tpu/utils/checkpoint.py: the on-disk format is the same, so a
checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from qmf_tpu_torch.utils.logging import log


def save_checkpoint(
    directory: str,
    epoch: int,
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomically write snapshot for ``epoch``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{epoch:06d}.npz")
    tmp = path + ".tmp"
    payload = dict(arrays)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"epoch": epoch, **(meta or {})}).encode(), dtype=np.uint8
    )
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    log.info("checkpoint: wrote %s", path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def load_checkpoint(path: str):
    """Returns (epoch, arrays dict, meta dict)."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return int(meta["epoch"]), arrays, meta
