"""The two waits that used to end healthy multi-rank runs, on gloo CPU
ranks.

1. ``--n_devices=N`` of the training CLIs (``launch.run_cli``) waits for
   its ranks with no deadline, as qmf_tpu's ``--n_devices`` does; ``spawn``
   keeps its deadline for the dry run and the tests.
2. Rank 0 writing the factor files alone, while the other ranks wait in
   the worker's final barrier, is bounded by the collective timeout
   (``multihost.COLLECTIVE_TIMEOUT_S``), not by the rendezvous's short
   ``GROUP_TIMEOUT_S``.

Each test shortens the constant it is about (``launch.DEADLINE_S`` and
spawn's deadline to 1 s; ``multihost.GROUP_TIMEOUT_S`` to 4 s in the
ranks' processes) and makes the run outlive it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from qmf_tpu_torch.cli import wals as wals_cli
from qmf_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shortened bounds (s), and how long rank 0's save is slowed past them
SHORT_DEADLINE_S, SHORT_GROUP_TIMEOUT_S, SLOW_SAVE_S = 1.0, 4, 8.0


def _ratings(path, seed=5, n=800):
    rng = np.random.default_rng(seed)
    path.write_text("".join(
        f"{u} {i} {v}\n" for u, i, v in zip(rng.integers(1, 60, n),
                                             rng.integers(1, 40, n),
                                             rng.integers(1, 6, n))))
    return str(path)


def test_run_cli_waits_past_the_spawn_deadline(tmp_path, monkeypatch):
    """The wals CLI on 2 ranks outlives a 1 s spawn deadline (starting a
    rank alone takes longer) and ends with rc 0 and its files; spawn with
    that deadline, as the dry run and the tests call it, still ends the
    same ranks."""
    train = _ratings(tmp_path / "train.txt")
    argv = [f"--train_dataset={train}", "--n_devices=2", "--device=cpu",
            "--nepochs=2", "--nfactors=4", "--dtype=float64",
            f"--user_factors={tmp_path / 'u.dat'}",
            f"--item_factors={tmp_path / 'i.dat'}"]
    spawn = launch.spawn
    deadlines = []

    def short_spawn(*args, deadline_s=SHORT_DEADLINE_S, **kw):
        deadlines.append(deadline_s)
        return spawn(*args, deadline_s=deadline_s, **kw)

    monkeypatch.setattr(launch, "DEADLINE_S", SHORT_DEADLINE_S)
    monkeypatch.setattr(launch, "spawn", short_spawn)
    t0 = time.monotonic()
    assert wals_cli.main(argv) == 0
    assert time.monotonic() - t0 > SHORT_DEADLINE_S
    assert deadlines == [None]
    assert (tmp_path / "u.dat").stat().st_size > 0
    assert (tmp_path / "i.dat").stat().st_size > 0

    with pytest.raises(TimeoutError, match="still running after 1 s"):
        spawn(wals_cli._rank_main, 2, device="cpu",
              args=(argv[:-2] + [f"--user_factors={tmp_path / 'u2.dat'}",
                                 f"--item_factors={tmp_path / 'i2.dat'}"],),
              deadline_s=SHORT_DEADLINE_S)
    assert not (tmp_path / "u2.dat").exists()


# One rank of a 2-rank control-plane task (distributed.worker.run_worker) in
# a process of its own: the rendezvous's timeout shortened, rank 0's user
# factor save slowed by ``slow_s``. The ranks start together (ready files),
# well inside the short rendezvous.
RANK = r"""
import json, os, sys, time
import torch
from qmf_tpu_torch.distributed.taskdef import TaskDef
from qmf_tpu_torch.distributed.worker import run_worker
from qmf_tpu_torch.models.wals import WALSEngine
from qmf_tpu_torch.parallel import multihost

spec = json.loads(sys.argv[1])
torch.set_num_threads(1)
multihost.GROUP_TIMEOUT_S = spec["group_timeout_s"]
if spec["rank"] == 0 and spec["slow_s"]:
    save = WALSEngine.save_user_factors

    def slow_save(self, path):
        time.sleep(spec["slow_s"])
        save(self, path)

    WALSEngine.save_user_factors = slow_save
open(spec["ready"] + str(spec["rank"]), "w").close()
while not all(os.path.exists(spec["ready"] + str(r)) for r in (0, 1)):
    time.sleep(0.01)
res = run_worker(TaskDef.from_dict(spec["task"]),
                 coordinator=spec["coordinator"], num_processes=2,
                 process_id=spec["rank"], n_local_devices=1,
                 ckpt_dir=spec["ckpt"])
with open(spec["result"], "w") as f:
    json.dump(res, f)
"""


def _start_task(tmp, train, slow_s):
    """Both ranks of one task, started; (processes, result paths, files)."""
    files = (str(tmp / "user.dat"), str(tmp / "item.dat"))
    task = dict(train_set=train, user_factors=files[0],
                item_factors=files[1], nepochs=3, nfactors=4,
                dtype="float64")
    coordinator = f"127.0.0.1:{launch.free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, QMF_TPU_LOGLEVEL="WARNING")
    procs, results = [], []
    for rank in (0, 1):
        results.append(str(tmp / f"rank{rank}.json"))
        spec = dict(task=task, rank=rank, coordinator=coordinator,
                    slow_s=slow_s, group_timeout_s=SHORT_GROUP_TIMEOUT_S,
                    ready=str(tmp / "ready"), ckpt=str(tmp / "ckpt"),
                    result=results[-1])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, json.dumps(spec)], cwd=REPO,
            env=env, stderr=subprocess.PIPE, text=True))
    return procs, results, files


def test_slow_rank0_save_outlives_the_group_timeout(tmp_path):
    """Rank 0's save takes 8 s past a 4 s GROUP_TIMEOUT_S while rank 1
    waits in the final barrier: both ranks end in their first attempt, and
    the files are byte for byte those of a run whose save was not
    slowed."""
    train = _ratings(tmp_path / "train.txt")
    runs = {}
    for name, slow in (("slow", SLOW_SAVE_S), ("plain", 0.0)):
        (tmp_path / name).mkdir()
        runs[name] = _start_task(tmp_path / name, train, slow)
    out = {}
    for name, (procs, results, files) in runs.items():
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
        res = []
        for path in results:
            with open(path) as f:
                res.append(json.load(f))
        out[name] = res, [open(f, "rb").read() for f in files]
    (slow0, slow1), slow_files = out["slow"]
    assert slow1["stages"]["save_s"] >= SLOW_SAVE_S > SHORT_GROUP_TIMEOUT_S
    assert len(slow0["losses"]) == len(slow1["losses"]) == 3
    assert slow_files == out["plain"][1]
    assert all(len(b) > 0 for b in slow_files)
