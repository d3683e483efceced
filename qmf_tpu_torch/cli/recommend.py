"""``recommend`` CLI of the PyTorch port — batch top-N serving from saved
factor files.

Port of qmf_tpu/cli/recommend.py, with its flags, checks and output format,
plus ``--device``. Load the text factor files a training run produced,
score every requested user against the full catalog as one matmul per
batch, and emit the top-N items per user — optionally excluding items the
user already interacted with in a ratings file (the reference's dataset
text format). The factor files hold doubles; scores are computed in
float32, as qmf_tpu's CLI computes them.

Output format (one line per user, raw ids)::

    <user_id>\t<item_id>:<score> <item_id>:<score> ...

Example::

    python -m qmf_tpu_torch.cli.recommend --user_factors=./user.dat \
        --item_factors=./item.dat --exclude_seen=./ratings.txt \
        --topn=10 --output=./recs.txt
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("recommend")
    fl.define_string("user_factors", "", "trained user factor file")
    fl.define_string("item_factors", "", "trained item factor file")
    fl.define_integer("topn", 10, "items to recommend per user")
    fl.define_string(
        "users",
        "",
        "comma-separated raw user ids to serve (default: every user in "
        "the factor file)",
    )
    fl.define_string(
        "exclude_seen",
        "",
        "ratings file (reference text format); items a user already "
        "interacted with are excluded from their list",
    )
    fl.define_string("output", "", "output path (default: stdout)")
    fl.define_bool(
        "item_biases",
        False,
        "the item factor file carries a bias column (BPR --use_biases "
        "output format: id bias f0 ... fk-1)",
    )
    fl.define_integer(
        "batch_users", 4096, "users scored per device batch"
    )
    fl.define_string("device", "cuda", "torch device: cuda | cuda:N | cpu")
    return fl


def main(argv=None) -> int:
    fl = make_flags()
    fl.parse(argv)

    if not fl.user_factors or not fl.item_factors:
        log.error("need --user_factors and --item_factors")
        return 1

    from qmf_tpu_torch.data import load_factors
    from qmf_tpu_torch.models.recommend import recommend_top_n

    user_ids, ufd = load_factors(fl.user_factors)
    item_ids, ifd = load_factors(fl.item_factors, with_biases=fl.item_biases)
    n = min(fl.topn, len(item_ids))

    # raw id <-> dense index maps in factor-file order
    uid_to_idx = {int(u): i for i, u in enumerate(user_ids)}
    if fl.users:
        try:
            query_raw = [int(s) for s in fl.users.split(",") if s]
        except ValueError as e:
            log.error("bad --users list: %s", e)
            return 1
        missing = [u for u in query_raw if u not in uid_to_idx]
        if missing:
            log.error("unknown user ids (not in factor file): %s", missing)
            return 1
        query = np.array([uid_to_idx[u] for u in query_raw], dtype=np.int32)
    else:
        query_raw = [int(u) for u in user_ids]
        query = np.arange(len(user_ids), dtype=np.int32)

    seen = None
    if fl.exclude_seen:
        from qmf_tpu_torch.data import read_dataset
        from qmf_tpu_torch.ops.bpr_ops import make_pos_set

        ds = read_dataset(fl.exclude_seen)

        def remap(raw, file_ids):
            # vectorized raw id -> factor-file row (or -1 if absent)
            order = np.argsort(file_ids, kind="stable")
            sorted_ids = np.asarray(file_ids)[order]
            pos = np.searchsorted(sorted_ids, raw)
            pos = np.clip(pos, 0, len(sorted_ids) - 1)
            hit = sorted_ids[pos] == raw
            return np.where(hit, order[pos], -1)

        u_idx = remap(np.asarray(ds.user_ids), user_ids)
        i_idx = remap(np.asarray(ds.item_ids), item_ids)
        keep = (u_idx >= 0) & (i_idx >= 0)
        seen = make_pos_set(
            u_idx[keep].astype(np.int64),
            i_idx[keep].astype(np.int64),
            len(user_ids),
            device=fl.device,
        )

    # on the device once, in float32, for every batch
    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32).to(fl.device)

    user_factors, item_factors = on_device(ufd.factors), on_device(ifd.factors)
    biases = on_device(ifd.biases) if ifd.with_biases else None
    out = open(fl.output, "w") if fl.output else sys.stdout
    try:
        for s in range(0, len(query), fl.batch_users):
            batch = query[s : s + fl.batch_users]
            idx, sc = recommend_top_n(
                user_factors,
                item_factors,
                batch,
                n=n,
                item_biases=biases,
                seen=seen,
                device=fl.device,
            )
            for row, (ti, ts) in enumerate(zip(idx, sc)):
                pairs = " ".join(
                    f"{int(item_ids[i])}:{v:.6f}"
                    for i, v in zip(ti, ts)
                    if np.isfinite(v)
                )
                out.write(f"{query_raw[s + row]}\t{pairs}\n")
    finally:
        if fl.output:
            out.close()
    log.info("wrote top-%d for %d users", n, len(query))
    return 0


if __name__ == "__main__":
    sys.exit(main())
