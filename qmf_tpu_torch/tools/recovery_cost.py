"""The wall-clock cost of one killed-worker recovery of the control plane.

    python -m qmf_tpu_torch.tools.recovery_cost [nratings] [nepochs]
        [--nfactors=16] [--preset=NAME] [--epoch_sleep_s=S] [--reps=1]
        [--dtype=float32] [--out_dir=DIR] [--device=cuda]

The port's counterpart of benchmarks/recovery_cost.py. The control plane
(qmf_tpu_torch/distributed) pays for a worker lost mid-run with: failure
detection (the labor's ``task_done`` with rc != 0), the abort of the other
rank, a fresh quorum, a new worker a rank (its start-up: import, device
init, the group's rendezvous, read, init) and the epochs after the last
durable checkpoint. The tool runs one task twice on a ``Scheduler`` with one
in-process ``Labor`` (two ranks of one process group, each in a worker
subprocess):

- run A, uninterrupted: wall W0;
- run B, the labor's worker SIGKILLed as soon as the first epoch's
  checkpoint (``LATEST``) exists: wall W1, the kill at ``t_kill``.

The recovery overhead is W1 - W0. ``detect_s`` is W1 - t_kill - the resumed
attempt's ``wall_s`` (its epochs): the failure report, the abort, the new
quorum and the new workers up to their first epoch, and their save. Of it,
the resumed worker's ``startup_s`` (its stages before the epochs: import,
device init, join, read, init) and ``save_s`` are its own report;
``detect_other_s`` is the rest: the report, the abort, the quorum, the
processes' starts before their first stage and their ends.

On a card (the default) both ranks share ``cuda:0`` over gloo, since NCCL
takes one card a rank (chip_smoke.py phase 11b's layout); the kernels and
the native I/O library are built in this process first, so no timed run
compiles them. ``--device=cpu`` runs both ranks on the host
(``n_local_devices=1``), for tests; without a card ``--device=cuda``
raises.

The task is the JAX probe's: ``nratings`` lines of ``default_rng(7)``
ratings (users 1-3,999, items 1-1,499, values 1-5), ``nepochs``, k =
``--nfactors``, no init file, plus ``solver : "auto"`` (the TaskDef's
default "cholesky" is the plain torch solve; "auto" reaches chol_solve.cu
on a card) and, unless float32, a ``dtype`` line. ``--preset=NAME`` writes
``tools.datagen``'s preset instead (seed 42, all ratings, as tools/bench.py
loads it); its k defaults to 64 and its epochs to 3. Every run has its own
factor paths, so no run resumes another's checkpoint. Both ranks of both
runs sleep ``--epoch_sleep_s`` after each epoch (``QMF_TPU_EPOCH_SLEEP_S``),
so that the kill lands with most epochs still to run; run B must report two
attempts and a resumed attempt of fewer epochs than the task's, or the tool
raises.

Prints the JAX probe's three lines for each pair, then one JSON line:
the pair with the median overhead (``w0_s``, ``w1_s``, ``overhead_s``,
``t_kill_s``, ``detect_s``, ``detect_other_s``, each run's ``attempts``,
``num_processes`` and ``launches``, the resumed attempt's ``wall_s``,
``startup_s``, ``stages``, ``init_stages`` and epochs, and B's factor
files against A's, max abs and normwise), every pair under ``pairs`` and
the medians under ``median``, with the card's name and power limit as
nvidia-smi gives them. With ``--reps N`` the A and B runs take turns, N
pairs.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np

from qmf_tpu_torch.distributed.labor import Labor
from qmf_tpu_torch.distributed.scheduler import Scheduler
from qmf_tpu_torch.distributed.submit import scheduler_status, submit_task_file
from qmf_tpu_torch.distributed.taskdef import load_taskdef
from qmf_tpu_torch.distributed.worker import default_ckpt_dir

NRATINGS, NEPOCHS, NFACTORS = 200_000, 8, 16  # the JAX probe's defaults
PRESET_NFACTORS, PRESET_NEPOCHS = 64, 3  # a preset's: the main path's width
# Seconds each rank sleeps after each epoch. On a card an epoch of the
# default task takes milliseconds, and the kill must land before the task
# ends: half a second an epoch leaves most epochs after it.
EPOCH_SLEEP_S = 0.5
POLL_S = 0.05
TASK_DEADLINE_S = 1800.0  # a run's deadline: any run ends well inside it
RECOVERY_PARTS = "(detection + abort + re-quorum + re-rendezvous + " \
    "re-init + resume from last epoch checkpoint)"


class Fixture:
    """A Scheduler on an ephemeral port, served by its own event loop in a
    thread, with one Labor attached on that loop."""

    def __init__(self, device: str):
        on_card = device != "cpu"
        self.scheduler = Scheduler(
            "127.0.0.1", 0, multiproc=True,
            n_local_devices=0 if on_card else 1, prepare_timeout=60.0,
            device=device, backend="gloo")
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def boot():
                await self.scheduler.start()
                started.set()

            self.loop.run_until_complete(boot())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(10):
            raise RuntimeError("the scheduler did not start within 10 s")
        self.labor = Labor("127.0.0.1", self.scheduler.port)
        self._labor_run = asyncio.run_coroutine_threadsafe(self.labor.run(),
                                                           self.loop)
        _wait(lambda: self.scheduler.labors, 10, "the labor's attach")

    @property
    def port(self) -> int:
        return self.scheduler.port

    def close(self) -> None:
        """Stop the labor and the scheduler; cancelling them kills any
        worker still running."""
        self._labor_run.cancel()
        asyncio.run_coroutine_threadsafe(self.scheduler.stop(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _wait(cond, deadline: float, what: str):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        value = cond()
        if value:
            return value
        time.sleep(POLL_S)
    raise TimeoutError(f"no {what} within {deadline:.0f} s")


def write_probe_ratings(path: str, nratings: int) -> None:
    """The JAX probe's ratings file, byte for byte."""
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for u, i, v in zip(rng.integers(1, 4000, nratings),
                           rng.integers(1, 1500, nratings),
                           rng.integers(1, 6, nratings)):
            f.write(f"{u} {i} {v}\n")


def task_text(train: str, out_dir: str, tag: str, nepochs: int,
              nfactors: int, dtype: str = "float32") -> str:
    """The JAX probe's task text, then ``solver : "auto"`` and, unless
    float32, the dtype."""
    text = (f"nepochs : {nepochs}\n"
            f"nfactors : {nfactors}\n"
            f'train_set : "{train}"\n'
            f'user_factors : "{out_dir}/u_{tag}.dat"\n'
            f'item_factors : "{out_dir}/i_{tag}.dat"\n'
            'solver : "auto"\n')
    if dtype != "float32":
        text += f'dtype : "{dtype}"\n'
    return text


def make_task(out_dir: str, tag: str, nratings: int, nepochs: int,
              nfactors: int = NFACTORS, dtype: str = "float32",
              train: str | None = None) -> str:
    """Write a task file (and, where ``train`` is None, the probe's ratings
    as ``out_dir/train.txt`` if absent); returns its path."""
    if train is None:
        train = os.path.join(out_dir, "train.txt")
        if not os.path.exists(train):
            write_probe_ratings(train, nratings)
    path = os.path.join(out_dir, f"task_{tag}.pb")
    with open(path, "w") as f:
        f.write(task_text(train, out_dir, tag, nepochs, nfactors, dtype))
    return path


@contextlib.contextmanager
def epoch_sleep(seconds: float):
    """Every worker started inside sleeps ``seconds`` after each epoch."""
    old = os.environ.get("QMF_TPU_EPOCH_SLEEP_S")
    os.environ["QMF_TPU_EPOCH_SLEEP_S"] = str(seconds)
    try:
        yield
    finally:
        if old is None:
            del os.environ["QMF_TPU_EPOCH_SLEEP_S"]
        else:
            os.environ["QMF_TPU_EPOCH_SLEEP_S"] = old


def run_once(task_path: str, kill: bool, device: str = "cuda:0",
             deadline_s: float = TASK_DEADLINE_S) -> tuple:
    """Submit the task to a fresh scheduler and labor, SIGKILL the labor's
    worker once ``LATEST`` exists if ``kill``, and wait for the task's end.
    Returns (wall s, rank 0's result, t_kill s or None), both times from
    the submit. Raises if the task failed or ended before the kill."""
    fx = Fixture(device)
    t_kill = None
    try:
        t0 = time.time()
        rsp = submit_task_file("127.0.0.1", fx.port, task_path)
        if rsp.get("status") != "OK":
            raise RuntimeError(f"submit refused: {rsp}")
        if kill:
            latest = os.path.join(default_ckpt_dir(load_taskdef(task_path),
                                                   rsp["taskid"]), "LATEST")

            def checkpointed():
                if fx.scheduler.history:
                    raise RuntimeError(
                        f"the task ended before its first checkpoint was "
                        f"seen: {fx.scheduler.history[-1]}; raise "
                        f"--epoch_sleep_s")
                return os.path.exists(latest)

            _wait(checkpointed, deadline_s, "first checkpoint")
            pid = fx.labor.worker_pid
            if pid is None:
                raise RuntimeError("the labor runs no worker to kill")
            os.kill(pid, signal.SIGKILL)
            t_kill = time.time() - t0

        def ended():
            hist = scheduler_status("127.0.0.1", fx.port)["history"]
            return hist[-1] if hist and hist[-1]["state"] in (
                "done", "failed") else None

        last = _wait(ended, deadline_s, "end of the task")
        wall = time.time() - t0
        # rank 1 may still be exiting: the next run must not overlap it
        _wait(lambda: fx.labor.worker_pid is None, deadline_s,
              "end of the labor's worker")
    finally:
        fx.close()
    if last["state"] != "done":
        raise RuntimeError(f"the task failed: {last}")
    return wall, last["result"], t_kill


def factor_diff(got: tuple, want: tuple) -> dict:
    """B's (user, item) factor files against A's: the max abs difference,
    and the max of it over max(1, the row's max |A|) (chip_smoke.py's
    normwise error). Files equal byte for byte differ by 0 and are not
    parsed (at ml20m, parsing the four files takes seconds)."""
    from qmf_tpu_torch.data import load_factors

    max_abs = normwise = 0.0
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            if fg.read() == fw.read():
                continue
        (gids, gfd), (wids, wfd) = load_factors(g), load_factors(w)
        if list(gids) != list(wids):
            raise RuntimeError(f"{g}: ids differ from {w}")
        diff = np.abs(gfd.factors - wfd.factors)
        scale = np.maximum(np.abs(wfd.factors).max(axis=1, keepdims=True),
                           1.0)
        max_abs = max(max_abs, float(diff.max(initial=0.0)))
        normwise = max(normwise, float((diff / scale).max(initial=0.0)))
    return {"max_abs": max_abs, "normwise": normwise}


def measure_pair(task_a: str, task_b: str, device: str) -> dict:
    """Run A on ``task_a`` and B, killed, on ``task_b`` (the same task with
    other factor paths); the pair's numbers. Raises unless A took one
    attempt and B two, B's resumed attempt ran fewer epochs than the task,
    and, on a card, each run launched chol_solve.cu."""
    w0, ra, _ = run_once(task_a, kill=False, device=device)
    w1, rb, t_kill = run_once(task_b, kill=True, device=device)
    ta, td = load_taskdef(task_a), load_taskdef(task_b)
    epochs = len(rb["losses"])
    if ra.get("attempts") != 1 or rb.get("attempts") != 2 \
            or not 0 < epochs < td.nepochs:
        raise RuntimeError(
            f"run A took {ra.get('attempts')} attempts (want 1), run B "
            f"{rb.get('attempts')} (want 2) and resumed {epochs} of "
            f"{td.nepochs} epochs (want 0 < n < {td.nepochs})")
    if device != "cpu" and not (ra["launches"]["chol_solve"] > 0
                                and rb["launches"]["chol_solve"] > 0):
        raise RuntimeError(f"chol_solve.cu not launched: run A "
                           f"{ra['launches']}, run B {rb['launches']}")
    detect = w1 - t_kill - rb["wall_s"]
    startup = sum(v for k, v in rb["stages"].items() if k != "save_s")
    return {
        "w0_s": round(w0, 3), "w1_s": round(w1, 3),
        "overhead_s": round(w1 - w0, 3), "t_kill_s": round(t_kill, 3),
        "detect_s": round(detect, 3),
        "detect_other_s": round(detect - startup - rb["stages"]["save_s"],
                                3),
        "attempts": [ra["attempts"], rb["attempts"]],
        "num_processes": [ra["num_processes"], rb["num_processes"]],
        "resumed": {"wall_s": rb["wall_s"], "epochs": epochs,
                    "startup_s": round(startup, 3), "stages": rb["stages"],
                    "init_stages": rb["init_stages"]},
        "launches": [ra["launches"], rb["launches"]],
        "b_vs_a": factor_diff((td.user_factors, td.item_factors),
                              (ta.user_factors, ta.item_factors)),
    }


def probe_lines(pair: dict, nratings: int, nepochs: int,
                nfactors: int) -> list:
    """The JAX probe's three lines, in its wording, for one pair."""
    return [
        f"uninterrupted: {pair['w0_s']:.1f}s wall, "
        f"attempts={pair['attempts'][0]}, "
        f"procs={pair['num_processes'][0]}",
        f"killed-after-first-checkpoint: {pair['w1_s']:.1f}s wall "
        f"(kill at +{pair['t_kill_s']:.1f}s), "
        f"attempts={pair['attempts'][1]}, "
        f"procs={pair['num_processes'][1]}",
        f"RECOVERY OVERHEAD: {pair['overhead_s']:.1f}s for one killed "
        f"worker at {nratings} ratings x {nepochs} epochs, k={nfactors}, "
        f"2 processes {RECOVERY_PARTS}",
    ]


def summary(pairs: list) -> dict:
    """The pair of median overhead (the lower of two middle ones), and the
    median of each time over the pairs."""
    order = sorted(range(len(pairs)), key=lambda p: pairs[p]["overhead_s"])
    keys = ("w0_s", "w1_s", "overhead_s", "t_kill_s", "detect_s",
            "detect_other_s")
    return {**pairs[order[(len(pairs) - 1) // 2]],
            "median": {k: round(float(np.median([p[k] for p in pairs])), 4)
                       for k in keys}}


def _device(name: str) -> str:
    """The ranks' device: "cpu", or an indexed card ("cuda" is cuda:0).
    Raises without a card."""
    import torch

    dev = torch.device(name)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"--device {name}: cuda, cuda:N or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); --device=cpu runs the ranks on the host")
    return f"cuda:{dev.index or 0}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nratings", nargs="?", type=int, default=NRATINGS)
    ap.add_argument("nepochs", nargs="?", type=int, default=None)
    ap.add_argument("--nfactors", type=int, default=None)
    ap.add_argument("--preset", default=None,
                    help="tools.datagen's preset as the ratings (k 64, 3 "
                         "epochs unless given)")
    ap.add_argument("--epoch_sleep_s", type=float, default=EPOCH_SLEEP_S)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--out_dir", default=None,
                    help="where the ratings, tasks and factors go "
                         "(default: a temporary directory, removed after)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _device(args.device)
    nepochs = args.nepochs or (PRESET_NEPOCHS if args.preset else NEPOCHS)
    nfactors = args.nfactors or (PRESET_NFACTORS if args.preset
                                 else NFACTORS)
    card = None
    if device != "cpu":
        from qmf_tpu_torch import kernels
        from qmf_tpu_torch.tools.bench import card_info

        card = card_info()
        print(f"# card: {card['line']}", file=sys.stderr, flush=True)
        t0 = time.time()
        kernels.load()
        print(f"# kernels built or loaded: {time.time() - t0:.3f}s",
              file=sys.stderr, flush=True)
    from qmf_tpu_torch.data import native

    if not native.available():
        raise RuntimeError(f"native I/O library: "
                           f"{native.unavailable_reason()}")
    with contextlib.ExitStack() as stack:
        out_dir = args.out_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="qmf_recovery_"))
        train, nratings = None, args.nratings
        if args.preset:
            from qmf_tpu_torch.tools.datagen import (PRESETS, generate,
                                                     write_ratings_parallel)

            t0 = time.time()
            ratings = generate(**PRESETS[args.preset], seed=42)
            train, nratings = os.path.join(out_dir, f"{args.preset}.txt"), \
                len(ratings[0])
            write_ratings_parallel(train, *ratings)
            print(f"# data ({args.preset}, seed 42): {nratings} ratings "
                  f"written in {time.time() - t0:.3f}s", file=sys.stderr,
                  flush=True)
        pairs = []
        with epoch_sleep(args.epoch_sleep_s):
            for rep in range(args.reps):
                a, b = (make_task(out_dir, f"{run}{rep}", nratings, nepochs,
                                  nfactors, args.dtype, train)
                        for run in ("base", "kill"))
                pairs.append(measure_pair(a, b, device))
                for line in probe_lines(pairs[-1], nratings, nepochs,
                                        nfactors):
                    print(line, flush=True)
    print(json.dumps({
        "nratings": nratings, "nepochs": nepochs, "nfactors": nfactors,
        "preset": args.preset, "dtype": args.dtype, "device": device,
        "epoch_sleep_s": args.epoch_sleep_s, "reps": args.reps,
        **summary(pairs), "pairs": pairs,
        "card": card and card["line"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
