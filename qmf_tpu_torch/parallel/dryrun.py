"""Sharded runs driven from files, and the multi-rank dry run.

:func:`run_jobs` is a rank program for ``launch.spawn``: it trains the
sharded engines on ratings read from ``.npz`` files (arrays ``users``,
``items``, ``values``) and writes, per rank, what a caller checks: the
factors with and without their padding rows, the losses, each epoch's
seconds, the kernels' launches, the collectives' bytes and the Gramian of
the padded factors. Ranks import none of the caller's state.

:func:`dryrun_multichip` is the port's twin of qmf_tpu's
``__graft_entry__.dryrun_multichip``: one sharded WALS epoch and one
sharded BPR epoch on ``n`` ranks of the device asked for (NCCL, one card a
rank, for "cuda"; gloo for the CPU or for ranks sharing one named card),
then both engines in float64 against the single-device engines on the
same data, within 1e-9. It never moves to the CPU by itself: "cuda" with
fewer than ``n`` cards raises.

    python -m qmf_tpu_torch.parallel.dryrun 2 [--device=cpu|cuda|cuda:0]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from qmf_tpu_torch.config import BPRConfig, MetricsConfig, WALSConfig
from qmf_tpu_torch.data.dataset import Dataset
from qmf_tpu_torch.parallel import launch
from qmf_tpu_torch.parallel.mesh import Mesh

PARITY_TOL = 1e-9


def write_ratings_npz(path: str, dataset: Dataset) -> None:
    np.savez(path, users=dataset.user_ids, items=dataset.item_ids,
             values=dataset.values)


def read_ratings_npz(path: str) -> Dataset:
    with np.load(path) as f:
        return Dataset(f["users"], f["items"], f["values"])


def _metrics(job: dict):
    from qmf_tpu_torch.metrics import MetricsEngine

    if not job.get("test"):
        return None
    me = MetricsEngine(MetricsConfig(**job.get("metrics", {})))
    me.add_test_avg_metric("auc")
    return me


def _run_wals(mesh: Mesh, job: dict) -> dict:
    from qmf_tpu_torch.ops import build_solve, spd_solve
    from qmf_tpu_torch.parallel.engine import ShardedWALSEngine
    from qmf_tpu_torch.parallel.sharded_wals import sharded_gramian

    me = _metrics(job)
    eng = ShardedWALSEngine(WALSConfig(**job["config"]), me, mesh=mesh)
    if job.get("hot_widths"):
        # each side's width forced, the user side's first (init's order)
        order = iter(job["hot_widths"])
        eng._resolve_hot_width = lambda col_degrees, n_build_rows: next(order)
    eng.init(read_ratings_npz(job["train"]))
    if me is not None:
        eng.init_test(read_ratings_npz(job["test"]))
    if job.get("checkpoint"):
        eng.enable_checkpointing(job["checkpoint"])
    losses, epoch_s = [], []
    eng.progress_cb = lambda e, loss, dt: (losses.append(loss),
                                           epoch_s.append(dt))
    spd_solve.launches = build_solve.launches = 0
    build_solve.launches_hot = 0
    mesh.reset_counts()
    eng.optimize()
    out = {
        "user_factors": eng.user_factors[: eng.nusers],
        "item_factors": eng.item_factors[: eng.nitems],
        "user_pad_rows": eng.user_factors[eng.nusers:],
        "item_pad_rows": eng.item_factors[eng.nitems:],
        "losses": losses, "epoch_s": epoch_s,
        "chol_solve_launches": spd_solve.launches,
        "build_solve_launches": build_solve.launches,
        "build_solve_hot_launches": build_solve.launches_hot,
        "solver": eng._solver,
        "hot_widths": [eng.hot_widths["user"], eng.hot_widths["item"]],
        "pack_kind": eng._pack_kind,
        # why the epoch program ran as eager ops (empty: a CUDA graph)
        "eager_reasons": "; ".join(eng._eager_reasons),
    }
    # after optimize: the Gramian's collective is not in the counts above
    out.update({f"collective_{k}": v for k, v in mesh.counts.items()})
    for side, y in (("user", eng.user_factors), ("item", eng.item_factors)):
        out[f"gram_{side}"] = sharded_gramian(mesh.block(y), mesh)
    if me is not None and mesh.rank == 0:
        out["auc"] = me.last("test_avg_auc")[1]
    return out


def _run_bpr(mesh: Mesh, job: dict) -> dict:
    from qmf_tpu_torch.parallel.sharded_bpr import ShardedBPREngine

    eng = ShardedBPREngine(BPRConfig(**job["config"]), mesh=mesh)
    eng.init(read_ratings_npz(job["train"]))
    if job.get("checkpoint"):
        eng.enable_checkpointing(job["checkpoint"])
    epoch_s = []
    eng.progress_cb = lambda e, tr, te, dt: epoch_s.append(dt)
    mesh.reset_counts()
    eng.optimize()
    out = dict(zip(("user_factors", "item_factors", "item_biases"),
                   eng.params))
    out.update({"grouped": eng._grouped, "epoch_s": epoch_s,
                "stream_rows": (eng._grp_up if eng._grouped
                                else eng._tri_users).shape[0],
                "real_triplets": eng._n_real_triplets})
    out.update({f"collective_{k}": v for k, v in mesh.counts.items()})
    return out


def run_jobs(mesh: Mesh, jobs) -> None:
    """Run each job, in order, on this rank; each rank writes
    ``{job['out']}.rank{r}.npz``.

    A job is a dict: ``engine`` ("wals" or "bpr"), ``train`` (and for WALS
    optionally ``test`` with ``metrics``, MetricsConfig's arguments; AUC is
    computed on rank 0), ``config`` (the engine config's arguments),
    optionally ``checkpoint`` (a directory: resume from it, write to it),
    for WALS optionally ``hot_widths`` ((user H, item H), forced in place
    of what the config's hot_width resolves to), and ``out``.
    """
    for job in jobs:
        run = {"wals": _run_wals, "bpr": _run_bpr}[job["engine"]]
        res = run(mesh, job)
        arrays = {k: (v.cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v)) for k, v in res.items()}
        np.savez(f"{job['out']}.rank{mesh.rank}.npz", **arrays)


def read_result(out: str, rank: int = 0) -> dict:
    with np.load(f"{out}.rank{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def dryrun_data(n_devices: int, seed: int = 0) -> Dataset:
    """The dry run's dataset: 4 n users of 2-8 ratings each over 40 items
    (qmf_tpu's dryrun_multichip data)."""
    rng = np.random.default_rng(seed)
    users, items, vals = [], [], []
    for u in range(4 * n_devices):
        deg = int(rng.integers(2, 9))
        for i in rng.choice(40, size=deg, replace=False):
            users.append(u + 1)
            items.append(i + 1)
            vals.append(float(rng.integers(1, 6)))
    return Dataset(np.array(users), np.array(items), np.array(vals))


def _dryrun_jobs(n_devices: int) -> dict:
    """Name -> (engine, config arguments) of the dry run's four runs."""
    return {
        "wals": ("wals", dict(nepochs=1, nfactors=8, init_seed=0)),
        "bpr": ("bpr", dict(nepochs=1, nfactors=8,
                            batch_size=16 * n_devices)),
        "wals64": ("wals", dict(nepochs=2, nfactors=8, init_seed=0,
                                dtype="float64")),
        "bpr64": ("bpr", dict(nepochs=2, nfactors=8,
                              batch_size=16 * n_devices, init_seed=1,
                              dtype="float64")),
    }


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One sharded WALS epoch and one sharded BPR epoch on ``n_devices``
    ranks on ``device``, then float64 parity of both engines against the
    single-device engines within 1e-9. Raises on any failure.

    ``device`` "cuda" gives each rank a card of its own over NCCL, and
    raises when fewer than ``n_devices`` cards are visible; "cpu" runs
    gloo ranks on the host; an indexed card ("cuda:0") puts every rank on
    it over gloo."""
    from qmf_tpu_torch.models import BPREngine, WALSEngine

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and dev.index is None else "gloo"
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on {device!r}: {cards} CUDA "
            f"device(s) visible, and NCCL takes one card a rank; pass "
            f"device='cpu' (--device=cpu) for gloo ranks on the host, or "
            f"'cuda:0' (--device=cuda:0) for gloo ranks sharing one card")
    data = dryrun_data(n_devices)
    runs = _dryrun_jobs(n_devices)
    with tempfile.TemporaryDirectory(prefix="qmf_dryrun_") as tmp:
        train = os.path.join(tmp, "train.npz")
        write_ratings_npz(train, data)
        jobs = [{"engine": engine, "train": train, "config": cfg,
                 "out": os.path.join(tmp, name)}
                for name, (engine, cfg) in runs.items()]
        t0 = time.time()
        launch.spawn(run_jobs, n_devices, backend=backend, device=device,
                     args=(jobs,))
        wall_s = time.time() - t0
        res = {name: read_result(os.path.join(tmp, name)) for name in runs}
    for name in ("wals", "bpr"):
        for key, arr in res[name].items():
            if key.endswith("factors") and not np.isfinite(arr).all():
                raise AssertionError(f"{name}: non-finite {key}")
    single = WALSEngine(WALSConfig(**runs["wals64"][1]), device=device)
    single.init(data)
    single.optimize()
    bpr = BPREngine(BPRConfig(**runs["bpr64"][1]), device=device)
    bpr.init(data)
    bpr.optimize()
    for name, want in (
        ("wals64", {"user_factors": single.user_factors,
                    "item_factors": single.item_factors}),
        ("bpr64", dict(zip(("user_factors", "item_factors", "item_biases"),
                           bpr.params))),
    ):
        for key, w in want.items():
            np.testing.assert_allclose(
                res[name][key], w.cpu().numpy(), rtol=PARITY_TOL,
                atol=1e-12,
                err_msg=f"sharded {name} {key} diverged from the "
                        "single-device float64 engine")
    path = "grouped" if bool(res["bpr"]["grouped"]) else "legacy-stream"
    print(f"dryrun_multichip OK on {n_devices} {device} ranks "
          f"({backend}): WALS epoch "
          f"{float(res['wals']['epoch_s'][0]):.3f}s + BPR {path} epoch "
          f"{float(res['bpr']['epoch_s'][0]):.3f}s ({wall_s:.1f} s with "
          "start-up), sharded-vs-single float64 parity within 1e-9 for "
          "both engines")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="multi-rank dry run of the "
                                "sharded engines")
    p.add_argument("n_devices", nargs="?", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card a rank) | cpu (gloo) | cuda:N "
                        "(gloo ranks sharing one card)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
