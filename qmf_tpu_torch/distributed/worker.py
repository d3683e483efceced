"""Per-process training worker for multi-process (multi-host) WALS (the
port's counterpart of qmf_tpu/distributed/worker.py).

This is the compute role the reference's Labor played
(reference distributed/labor/Labor.cpp:326-405: receive dataset + fixed
factors, solve 10k-row buckets, send rows back). Here every participating
process is one rank of ONE ``torch.distributed`` process group and runs the
port's ShardedWALSEngine (qmf_tpu_torch/parallel/engine.py): the
scheduler process's worker is rank 0, each labor host runs one worker as
rank 1..N-1. Dataset rows are read per-process from the shared filesystem
(the reference also assumed a shared filesystem for task files,
wals_submit.cpp:17-25), and the solved rows travel by the group's
collectives instead of the reference's TCP star.

PyTorch runs one process per rank, so a worker is ONE rank on one device
(qmf_tpu's worker drives every local device of its host):

- ``n_local_devices == 0``: the rank runs on ``device`` (default "cuda",
  the card the process sees first; run one labor per card, each with its
  own ``CUDA_VISIBLE_DEVICES``);
- ``n_local_devices == 1``: the rank runs on the CPU over gloo (test and
  dev deployments; qmf_tpu's virtual CPU devices);
- ``n_local_devices > 1`` raises.

``backend`` defaults to NCCL for a card and gloo for the CPU; ranks that
share one card (a scheduler and a labor on a one-card host) need
``backend="gloo"`` with an indexed ``device`` ("cuda:0"), since NCCL takes
one card a rank.

The worker is launched as a fresh subprocess per task (one process group
per process lifetime), with `python -m qmf_tpu_torch.distributed.worker`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

from qmf_tpu_torch.distributed.taskdef import TaskDef
from qmf_tpu_torch.utils.logging import log


def default_ckpt_dir(td: TaskDef, taskid: int) -> str:
    """Shared-fs checkpoint directory for a task, keyed by taskid AND a
    digest of the task definition, so every worker (and a retried attempt,
    or the scheduler's single-process fallback) resumes the same run —
    while a DIFFERENT task that happens to reuse the output path and a
    recycled taskid (scheduler restart; failed tasks leave their dir
    behind) can never silently auto-resume foreign factors. The digest
    covers the FULL task definition — a leftover dir from a run with a
    different regularization_lambda/confidence_weight/solver must not be
    resumed either. Equal to qmf_tpu's for the same task, so a checkpoint
    of either package's run resumes in the other."""
    import hashlib

    digest = hashlib.sha1(
        json.dumps(td.to_dict(), sort_keys=True).encode()
    ).hexdigest()[:8]
    return f"{td.user_factors}.ckpt_task{taskid}_{digest}"


def task_config(td: TaskDef):
    """The WALSConfig of a task: the TaskDef's fields, every other knob at
    its default."""
    from qmf_tpu_torch.config import WALSConfig

    return WALSConfig(
        nepochs=td.nepochs,
        nfactors=td.nfactors,
        regularization_lambda=td.regularization_lambda,
        confidence_weight=td.confidence_weight,
        init_distribution_bound=td.init_distribution_bound,
        distribution_file=td.distribution_file,
        dtype=td.dtype,
        solver=td.solver,
    )


def worker_device(n_local_devices: int, device: str) -> str:
    """The device of a worker's rank: ``device``, or the CPU when
    ``n_local_devices`` is 1. A worker is one rank, so more than one local
    device raises."""
    if n_local_devices > 1:
        raise ValueError(
            f"n_local_devices={n_local_devices}: a worker of the port is one "
            "rank on one device (PyTorch runs one process per rank); to use "
            "a host with several cards, run one labor per card, each with "
            "its own CUDA_VISIBLE_DEVICES")
    return "cpu" if n_local_devices == 1 else device


def run_worker(
    td: TaskDef,
    coordinator: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    n_local_devices: int = 0,
    taskid: int = 0,
    ckpt_dir: Optional[str] = None,
    progress_path: Optional[str] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> Dict[str, Any]:
    """Join the process group, co-train, save factors on rank 0.

    Per-epoch fault tolerance: every attempt checkpoints to ``ckpt_dir``
    (default: a shared-fs dir keyed by taskid) and auto-resumes from LATEST,
    so a worker killed mid-run costs at most one epoch when the scheduler
    retries the task — the recovery semantics the reference got from
    per-bucket reassignment + state re-push (RunOneTask.cpp:177-240,
    Connection.cpp:307-413), with the epoch as the recovery unit.

    Progress: when ``progress_path`` is set, a JSON line with
    {taskid, epoch, loss, wall_s} is atomically rewritten after every epoch
    (the per-bucket progress logging analog, RunOneTask.cpp:208-212); the
    spawning agent tails it and forwards progress to the scheduler.

    Returns a result dict (on every rank; only rank 0's is reported), with
    the kernels' launches, each epoch's loss and seconds, the seconds of
    each start-up stage and of each stage of the engine's init, and the
    paths the read and the save took (``data.native.last_path``).
    """
    t_start = time.time()
    dev = worker_device(n_local_devices, device)
    import torch
    import torch.distributed as dist

    from qmf_tpu_torch.data import native, read_dataset
    from qmf_tpu_torch.ops import build_solve, spd_solve
    from qmf_tpu_torch.parallel import ShardedWALSEngine, multihost

    stages = {"import_s": time.time() - t_start}
    t0 = time.time()
    if torch.device(dev).type == "cuda":
        torch.cuda.init()
    stages["device_init_s"] = time.time() - t0
    t0 = time.time()
    # a worker is the one rank of its host whatever its process id: a bare
    # "cuda" is the first card this process sees, not cuda:<rank>
    os.environ["LOCAL_RANK"] = "0"
    if num_processes > 1:
        multihost.initialize(
            coordinator=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            backend=backend,
            device=dev,
        )
    mesh = multihost.global_mesh(dev)
    stages["join_s"] = time.time() - t0

    engine = ShardedWALSEngine(task_config(td), mesh=mesh)
    t0 = time.time()
    dataset = read_dataset(td.train_set)
    stages["read_s"] = time.time() - t0
    t0 = time.time()
    engine.init(dataset)
    del dataset
    stages["init_s"] = time.time() - t0
    engine.enable_checkpointing(ckpt_dir or default_ckpt_dir(td, taskid))
    losses, epoch_s = [], []
    # fault-injection knob (tests/ops drills), under qmf_tpu's name so one
    # drill serves both packages: stretch each epoch so a worker can be
    # killed mid-run deterministically. The reference has no
    # fault-injection tooling at all (SURVEY.md section 5.3).
    epoch_sleep = float(os.environ.get("QMF_TPU_EPOCH_SLEEP_S", "0") or 0)

    def _report(epoch, loss, wall_s):
        losses.append(float(loss))
        epoch_s.append(wall_s)
        if progress_path:
            tmp = progress_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "taskid": taskid,
                        "epoch": epoch,
                        "nepochs": td.nepochs,
                        "loss": float(loss),
                        "wall_s": round(wall_s, 3),
                    },
                    f,
                )
            os.replace(tmp, progress_path)
        if epoch_sleep:
            time.sleep(epoch_sleep)

    engine.progress_cb = _report
    spd_solve.launches = build_solve.launches = build_solve.launches_hot = 0
    t0 = time.time()
    engine.optimize()
    wall = time.time() - t0
    launches = {"chol_solve": spd_solve.launches,
                "build_solve": build_solve.launches,
                "build_solve_hot": build_solve.launches_hot}

    # The factors are whole on every rank after each half-epoch; rank 0
    # alone writes them (the engine's save methods skip the other ranks) —
    # the analog of the reference scheduler gathering kCalcRsp rows before
    # saveFactors (RunOneTask.cpp:153-155).
    t0 = time.time()
    engine.save_user_factors(td.user_factors)
    engine.save_item_factors(td.item_factors)
    if num_processes > 1:
        dist.barrier()
        dist.destroy_process_group()
    stages["save_s"] = time.time() - t0
    return {
        "taskid": taskid,
        "process_id": process_id,
        "num_processes": num_processes,
        "nusers": engine.nusers,
        "nitems": engine.nitems,
        "global_devices": mesh.size,
        "local_devices": 1,
        "wall_s": round(wall, 3),
        "device": str(mesh.device),
        "backend": mesh.backend,
        "solver": engine._solver,
        "hot_widths": engine.hot_widths,
        "launches": launches,
        "losses": losses,
        "epoch_s": [round(s, 4) for s in epoch_s],
        "stages": {k: round(v, 3) for k, v in stages.items()},
        # init_s by stage, the pack's kind, and the read's and save's path
        "init_stages": {k: round(v, 3)
                        for k, v in engine._init_stages.items()},
        "pack": engine._pack_kind,
        "io": dict(native.last_path),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task-json", required=True,
                   help="TaskDef as a JSON object (or @/path/to/file.json)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--n-local-devices", type=int, default=0,
                   help="1 = this rank on the CPU over gloo (0 = --device)")
    p.add_argument("--taskid", type=int, default=0)
    p.add_argument("--result", default=None,
                   help="write the result JSON to this path")
    p.add_argument("--ckpt-dir", default=None,
                   help="per-epoch checkpoint directory (shared fs); "
                        "default derives from user_factors + taskid")
    p.add_argument("--progress", default=None,
                   help="atomically rewrite per-epoch progress JSON here")
    p.add_argument("--device", default="cuda",
                   help="torch device of this rank: cuda | cuda:N | cpu")
    p.add_argument("--backend", default="",
                   help="process-group backend (default: nccl for a card, "
                        "gloo for the CPU)")
    args = p.parse_args(argv)

    raw = args.task_json
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    td = TaskDef.from_dict(json.loads(raw))
    td.validate()

    result = run_worker(
        td,
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        n_local_devices=args.n_local_devices,
        taskid=args.taskid,
        ckpt_dir=args.ckpt_dir,
        progress_path=args.progress,
        device=args.device,
        backend=args.backend or None,
    )
    log.info("worker done: %s", result)
    if args.result:
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, args.result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
