"""The port's control plane (qmf_tpu_torch/distributed and the wals_scheduler,
wals_labor and wals_submit CLIs) on the CPU.

The first classes mirror tests/test_distributed.py case for case through
the port alone: scheduler + labors + submit in-process over real sockets
(ephemeral ports). The end-to-end cases run real worker subprocesses, one
gloo CPU rank each (``n_local_devices=1``), and hold their factor files to
qmf_tpu's single-device WALSEngine in float64 within 1e-9: with no labor,
with one labor (a world of 2), and after the labor's worker is killed and
the task retried from its checkpoint. The cross-package cases hold the wire
protocol, the checkpoint directory and the CLIs' flags to qmf_tpu's, and
run a labor of either package against the other's scheduler.

Every subprocess case has its own deadline (the scheduler's
``worker_timeout`` and ``prepare_timeout``, and the poll loops below).
"""

import asyncio
import json
import os
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import read_dataset as jax_read_dataset
from qmf_tpu.distributed import protocol as jax_protocol
from qmf_tpu.distributed.labor import Labor as JaxLabor
from qmf_tpu.distributed.scheduler import Scheduler as JaxScheduler
from qmf_tpu.distributed.taskdef import TaskDef as JaxTaskDef
from qmf_tpu.distributed.worker import default_ckpt_dir as jax_ckpt_dir
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu_torch.cli import gen_uniform as gen_cli
from qmf_tpu_torch.cli import wals as wals_cli
from qmf_tpu_torch.data import load_factors
from qmf_tpu_torch.distributed import protocol
from qmf_tpu_torch.distributed import scheduler as sched_mod
from qmf_tpu_torch.distributed.labor import Labor
from qmf_tpu_torch.distributed.scheduler import LaborInfo, Scheduler
from qmf_tpu_torch.distributed.submit import scheduler_status, submit_task_file
from qmf_tpu_torch.distributed.taskdef import TaskDef, parse_taskdef
from qmf_tpu_torch.distributed.worker import (
    default_ckpt_dir,
    run_worker,
    worker_device,
)

# float64: the factor files (9 decimals) against qmf_tpu's factors in
# memory; float32: qmf_tpu's golden tolerance (tests/test_distributed.py)
F64_TOL = 1e-9
F32 = dict(rtol=5e-4, atol=5e-5)
# the end-to-end task: 4 epochs, k = 4, float64, the TaskDef's solver
NEPOCHS, K = 4, 4
# a poll loop's deadline (s) and step
DEADLINE_S, POLL_S = 60.0, 0.05


def _wait(cond, deadline=DEADLINE_S, what="condition"):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        value = cond()
        if value:
            return value
        time.sleep(POLL_S)
    raise AssertionError(f"{what} not reached within {deadline} s")


def _wait_task(port, deadline=DEADLINE_S):
    """The last history entry of a task that ended, or raise."""

    def ended():
        status = scheduler_status("127.0.0.1", port)
        hist = status["history"]
        return hist[-1] if hist and hist[-1]["state"] in (
            "done", "failed") else None

    return _wait(ended, deadline, "task end")


def _fake_runner(results):
    def runner(td: TaskDef, taskid: int):
        results.append((taskid, td.train_set))
        return {"ok": True, "taskid": taskid}

    return runner


class SchedulerFixture:
    """Runs a Scheduler (the port's, or ``cls``) on an ephemeral port in a
    background event loop."""

    def __init__(self, runner=None, heartbeat_interval=30.0, cls=Scheduler,
                 **kwargs):
        self.scheduler = cls(
            "127.0.0.1",
            0,
            runner=runner,
            heartbeat_interval=heartbeat_interval,
            **kwargs,
        )
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        self._started.wait(10)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def boot():
            await self.scheduler.start()
            self._started.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()

    @property
    def port(self):
        return self.scheduler.port

    def run_coro(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        asyncio.run_coroutine_threadsafe(
            self.scheduler.stop(), self.loop
        ).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _task_file(tmp_path, text):
    path = tmp_path / "task.pb"
    path.write_text(text)
    return str(path)


class TestTaskDef:
    def test_parses_reference_example_format(self):
        text = (
            'nepochs : 5\n'
            'nfactors : 30\n'
            'distribution_file : "../uniform.dat"\n'
            'train_set : "../n_rating.csv"\n'
            'user_factors : "./user_factors_vec.dat"\n'
            'item_factors : "./item_factors_vec.dat"\n'
        )
        td = parse_taskdef(text)
        assert td.nepochs == 5 and td.nfactors == 30
        assert td.train_set == "../n_rating.csv"
        assert td.distribution_file == "../uniform.dat"
        # proto defaults preserved (task.proto:7-10)
        assert td.regularization_lambda == 0.05
        assert td.confidence_weight == 40.0
        # no solver line: the plain solve, no kernel (README)
        assert td.solver == "cholesky"

    def test_missing_required_raises(self):
        with pytest.raises(ValueError, match="required"):
            parse_taskdef("nepochs : 5\n")

    def test_unknown_field_raises(self):
        with pytest.raises(ValueError, match="unknown field"):
            parse_taskdef('bogus : 1\ntrain_set : "x"\n')

    def test_comments_and_floats(self):
        td = parse_taskdef(
            "# job\nregularization_lambda : 0.1\n"
            'train_set : "a"\nuser_factors : "b"\nitem_factors : "c"\n'
        )
        assert td.regularization_lambda == pytest.approx(0.1)

    def test_hash_inside_quoted_string(self):
        td = parse_taskdef(
            'train_set : "data#1.csv"  # trailing comment\n'
            'user_factors : "u#f.dat"\nitem_factors : "c"\n'
        )
        assert td.train_set == "data#1.csv"
        assert td.user_factors == "u#f.dat"

    def test_escaped_quotes_and_backslashes_unescaped(self):
        td = parse_taskdef(
            'train_set : "data\\"1.csv"\n'
            'user_factors : "dir\\\\u.dat"\n'
            'item_factors : "c"\n'
        )
        assert td.train_set == 'data"1.csv'
        assert td.user_factors == "dir\\u.dat"


class TestProtocol:
    def test_frame_roundtrip(self):
        msg = {"kind": "status", "x": [1, 2, 3]}
        raw = protocol.encode_frame(msg)
        assert raw[:4] == protocol.MAGIC
        (length,) = struct.unpack(">I", raw[4:8])
        assert json.loads(raw[8 : 8 + length].decode()) == msg

    def test_bad_magic_rejected(self):
        with pytest.raises(protocol.ProtocolError):
            protocol._decode_head(b"XXXX\x00\x00\x00\x01")

    def test_cut_frame_is_a_connection_error(self):
        """EOF mid-payload raises ConnectionError (which the daemons'
        reconnect/drop handlers catch), a clean EOF returns None."""

        async def read(data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await protocol.read_frame(reader)

        raw = protocol.encode_frame({"kind": "status"})
        assert asyncio.run(read(b"")) is None
        with pytest.raises(ConnectionError, match="mid-frame"):
            asyncio.run(read(raw[:-2]))


class TestControlPlane:
    def test_submit_runs_task_and_status(self, tmp_path):
        results = []
        fx = SchedulerFixture(runner=_fake_runner(results))
        try:
            task_file = _task_file(
                tmp_path,
                'nepochs : 1\ntrain_set : "train.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n',
            )
            rsp = submit_task_file("127.0.0.1", fx.port, task_file)
            assert rsp["status"] == "OK" and rsp["taskid"] == 1
            _wait(lambda: results, what="runner call")
            assert results == [(1, "train.txt")]
            last = _wait_task(fx.port)
            status = scheduler_status("127.0.0.1", fx.port)
            assert status["kind"] == "status_rsp"
            assert last["state"] == "done"
            # send_path mode (the reference's) reaches the same runner
            rsp = submit_task_file("127.0.0.1", fx.port, task_file,
                                   send_path=True)
            assert rsp["status"] == "OK" and rsp["taskid"] == 2
            _wait(lambda: len(results) == 2, what="second runner call")
        finally:
            fx.close()

    def test_submit_malformed_task_fails_cleanly(self, tmp_path):
        fx = SchedulerFixture(runner=_fake_runner([]))
        try:
            rsp = protocol.send_and_recv(
                "127.0.0.1",
                fx.port,
                {"kind": "submit_task", "task_text": "nonsense ::"},
            )
            assert rsp["status"] == "FAIL"
            # the client refuses a malformed file before sending it
            with pytest.raises(ValueError):
                submit_task_file("127.0.0.1", fx.port,
                                 _task_file(tmp_path, "nonsense ::"))
            assert scheduler_status("127.0.0.1", fx.port)["history"] == []
        finally:
            fx.close()

    def test_labor_attach_heartbeat_and_announce(self, tmp_path):
        results = []
        fx = SchedulerFixture(
            runner=_fake_runner(results), heartbeat_interval=0.3
        )
        labor = Labor("127.0.0.1", fx.port)
        labor_future = fx.run_coro(labor.run())
        try:
            _wait(lambda: fx.scheduler.labors, what="attach")
            assert len(fx.scheduler.labors) == 1

            submit_task_file("127.0.0.1", fx.port, _task_file(
                tmp_path,
                'nepochs : 2\ntrain_set : "t.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n',
            ))
            _wait(lambda: labor.taskid == 1, what="announcement")

            # heartbeat path: after the short interval, labor's info_rsp
            # must have updated the scheduler's view
            def seen():
                li = next(iter(fx.scheduler.labors.values()), None)
                return li is not None and li.taskid == 1

            _wait(seen, what="heartbeat reply")
        finally:
            labor_future.cancel()
            fx.close()

    def test_hung_labor_is_dropped_after_unanswered_probe(self):
        """A connected-but-silent labor must be probed once and then dropped
        after one unanswered interval — not re-touched forever."""
        fx = SchedulerFixture(runner=_fake_runner([]), heartbeat_interval=0.3)
        try:
            class _NullWriter:
                def write(self, data):
                    pass

                async def drain(self):
                    pass

                def close(self):
                    pass

            async def attach_fake():
                li = LaborInfo("fake:1")
                li.writer = _NullWriter()
                fx.scheduler.labors["fake:1"] = li

            fx.run_coro(attach_fake()).result(10)
            _wait(lambda: "fake:1" not in fx.scheduler.labors,
                  what="hung labor dropped")
        finally:
            fx.close()

    def test_labor_loss_flags_active_attempt(self):
        sched = Scheduler("127.0.0.1", 0)
        sched._fail_event = asyncio.Event()
        sched._active_peers = {"10.0.0.1:1"}
        sched._notice_labor_loss("10.0.0.2:9")  # bystander
        assert not sched._fail_event.is_set()
        sched._notice_labor_loss("10.0.0.1:1")  # participant
        assert sched._fail_event.is_set()
        # no in-flight attempt: must not crash
        sched._fail_event = None
        sched._notice_labor_loss("10.0.0.1:1")

    def test_stale_task_done_cannot_fail_healthy_attempt(self):
        sched = Scheduler("127.0.0.1", 0)
        sched.current = {"taskid": 7}
        sched._fail_event = asyncio.Event()
        sched._active_peers = {"10.0.0.1:1"}
        msg = {"kind": "task_done", "taskid": 7, "rc": 1}
        asyncio.run(sched._dispatch(msg, "10.0.0.9:9", None))  # bystander
        assert not sched._fail_event.is_set()
        asyncio.run(sched._dispatch(msg, "10.0.0.1:1", None))  # participant
        assert sched._fail_event.is_set()

    def test_heartbeat_reply_reports_running_epoch(self):
        sched = Scheduler("127.0.0.1", 0)
        sched.taskid = 3
        rsp = asyncio.run(sched._dispatch({"kind": "heartbeat"}, "p:1", None))
        assert rsp == {"kind": "info_rsp", "taskid": 3, "epoch": 0}
        sched.current = {
            "taskid": 3,
            "progress": {
                "scheduler": {"epoch": 4},
                "10.0.0.1:1": {"epoch": 5},
            },
        }
        rsp = asyncio.run(sched._dispatch({"kind": "heartbeat"}, "p:1", None))
        assert rsp["epoch"] == 5

    def test_abort_racing_task_start_arms_deferred_kill(self):
        """A task_abort dispatched from the same buffered read batch as
        task_start (before the worker coroutine ever runs) must arm the
        deferred-kill flag on the holder the worker path reads."""

        async def scenario():
            labor = Labor("127.0.0.1", 0)
            labor._dispatch(
                {
                    "kind": "task_start",
                    "taskid": 5,
                    "task": {},
                    "coordinator": "127.0.0.1:1",
                    "num_processes": 2,
                    "process_id": 1,
                    "device": "cpu",
                    "backend": "gloo",
                }
            )
            assert labor._worker_holder is not None
            labor._dispatch({"kind": "task_abort", "taskid": 5})
            armed = labor._worker_holder.get("aborted")
            labor._worker_task.cancel()
            try:
                await labor._worker_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            return armed

        assert asyncio.run(scenario()) is True

    def test_labor_detach_is_noticed(self):
        fx = SchedulerFixture(runner=_fake_runner([]))
        labor = Labor("127.0.0.1", fx.port)
        fut = fx.run_coro(labor.run())
        try:
            _wait(lambda: fx.scheduler.labors, what="attach")
            fut.cancel()  # closes the connection
            _wait(lambda: not fx.scheduler.labors, what="detach")
        finally:
            fx.close()

    def test_new_labor_absorbed_at_failure_retry(self, tmp_path, monkeypatch):
        """A labor that attaches only AFTER the first attempt started joins
        the retry's quorum. Worker subprocesses are faked: attempt 1's rank
        0 blocks until the second labor is attached, then fails; attempt 2
        succeeds at once."""
        l2_attached = threading.Event()
        calls = {"p0": 0}

        async def fake_rws(td, taskid, coordinator, num_processes,
                           process_id, **kw):
            if process_id != 0:  # labor-side worker: succeed instantly
                return {"taskid": taskid, "process_id": process_id}
            calls["p0"] += 1
            if calls["p0"] == 1:
                while not l2_attached.is_set():
                    await asyncio.sleep(0.05)
                raise RuntimeError("injected attempt-1 failure")
            return {"taskid": taskid, "process_id": 0,
                    "num_processes": num_processes,
                    "device": kw["device"], "backend": kw["backend"]}

        monkeypatch.setattr(sched_mod, "run_worker_subprocess", fake_rws)

        fx = SchedulerFixture(multiproc=True, prepare_timeout=15.0,
                              device="cuda:0", backend="gloo")
        labor1 = Labor("127.0.0.1", fx.port)
        fut1 = fx.run_coro(labor1.run())
        fut2 = None
        try:
            _wait(lambda: len(fx.scheduler.labors) == 1, what="attach 1")
            rsp = submit_task_file("127.0.0.1", fx.port, _task_file(
                tmp_path,
                'nepochs : 1\ntrain_set : "t.txt"\n'
                'user_factors : "%s"\nitem_factors : "%s"\n'
                % (tmp_path / "u.dat", tmp_path / "i.dat"),
            ))
            assert rsp["status"] == "OK"
            _wait(lambda: calls["p0"] >= 1, what="attempt 1")
            labor2 = Labor("127.0.0.1", fx.port)
            fut2 = fx.run_coro(labor2.run())
            _wait(lambda: len(fx.scheduler.labors) == 2, what="attach 2")
            l2_attached.set()  # release attempt 1 into its injected failure
            last = _wait_task(fx.port)
            assert last["state"] == "done", last
            assert last["result"]["attempts"] == 2, last["result"]
            assert len(last["result"]["labors"]) == 2, last["result"]
            assert last["result"]["num_processes"] == 3, last["result"]
            # the scheduler's device and backend reached rank 0
            assert (last["result"]["device"], last["result"]["backend"]) \
                == ("cuda:0", "gloo")
        finally:
            fut1.cancel()
            if fut2 is not None:
                fut2.cancel()
            fx.close()

    def test_quorum_miss_falls_back_to_local(self, tmp_path):
        """No labors ready within the prepare window -> the task still runs
        (single-process)."""
        results = []
        fx = SchedulerFixture(
            runner=_fake_runner(results), multiproc=True, prepare_timeout=0.5
        )
        sock = socket.create_connection(("127.0.0.1", fx.port))
        try:
            sock.sendall(protocol.encode_frame({"kind": "attach_labor"}))
            buf = sock.recv(4096)
            assert buf[:4] == protocol.MAGIC
            _wait(lambda: fx.scheduler.labors, what="raw attach")
            td = parse_taskdef(
                'nepochs : 1\ntrain_set : "t.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n'
            )

            async def go():
                return await fx.scheduler._run_multiproc(td, taskid=99)

            result = fx.run_coro(go()).result(30)
            assert result == {"ok": True, "taskid": 99, "attempts": 1}
            assert results == [(99, "t.txt")]
        finally:
            sock.close()
            fx.close()

    def test_task_start_carries_device_and_backend(self, monkeypatch):
        """Every rank of a group must agree on the backend: task_start
        carries the scheduler's device and backend beside
        n_local_devices, and a worker is one rank (more local devices
        raise)."""
        sent = []

        class _Writer:
            def write(self, data):
                sent.append(json.loads(data[8:].decode()))

            async def drain(self):
                pass

        async def fake_rws(*a, **kw):
            return {"process_id": 0, **{k: kw[k] for k in (
                "device", "backend", "n_local_devices")}}

        monkeypatch.setattr(sched_mod, "run_worker_subprocess", fake_rws)

        async def scenario():
            sched = Scheduler("127.0.0.1", 0, device="cuda:0",
                              backend="gloo", prepare_timeout=5.0)
            li = LaborInfo("p:1")
            li.writer = _Writer()
            sched.labors["p:1"] = li
            broadcast = sched._broadcast

            async def acked(msg, peers=None):
                out = await broadcast(msg, peers)
                if msg["kind"] == "task_prepare":  # the labor's ack
                    sched._ready_peers.add("p:1")
                return out

            sched._broadcast = acked
            return await sched._run_multiproc_once(
                TaskDef(train_set="t", user_factors="u", item_factors="i"),
                1)

        result = asyncio.run(scenario())
        assert result == {"process_id": 0, "device": "cuda:0",
                          "backend": "gloo", "n_local_devices": 0,
                          "labors": ["p:1"]}
        start = [f for f in sent if f["kind"] == "task_start"]
        assert len(start) == 1
        assert (start[0]["device"], start[0]["backend"],
                start[0]["n_local_devices"], start[0]["process_id"],
                start[0]["num_processes"]) == ("cuda:0", "gloo", 0, 1, 2)
        with pytest.raises(ValueError, match="one labor per card"):
            worker_device(2, "cuda")
        assert worker_device(1, "cuda") == "cpu"
        assert worker_device(0, "cuda:0") == "cuda:0"


# --- end to end: real worker subprocesses on gloo CPU ranks -----------------

def _task_text(dist, train, user, item, dtype="float64", nepochs=NEPOCHS):
    return (
        f"nepochs : {nepochs}\n"
        f"nfactors : {K}\n"
        f'dtype : "{dtype}"\n'
        f'distribution_file : "{dist}"\n'
        f'train_set : "{train}"\n'
        f'user_factors : "{user}"\n'
        f'item_factors : "{item}"\n'
    )


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Ratings, an init file, and qmf_tpu's single-device WALSEngine in
    float64 on them (the task's configuration): (dir, files, factors)."""
    tmp = tmp_path_factory.mktemp("dist_golden")
    rng = np.random.default_rng(5)
    lines = [
        f"{u} {i} {v}\n"
        for u, i, v in zip(
            rng.integers(1, 60, 800),
            rng.integers(1, 40, 800),
            rng.integers(1, 6, 800),
        )
    ]
    train = tmp / "train.txt"
    train.write_text("".join(lines))
    dist = tmp / "uniform.dat"
    gen_cli.main(["20000", str(dist), "--seed=3"])
    td = TaskDef()
    eng = JaxWALSEngine(JaxWALSConfig(
        nepochs=NEPOCHS, nfactors=K,
        regularization_lambda=td.regularization_lambda,
        confidence_weight=td.confidence_weight,
        init_distribution_bound=td.init_distribution_bound,
        distribution_file=str(dist), dtype="float64", solver=td.solver))
    eng.init(jax_read_dataset(str(train)))
    eng.optimize()
    want = {"user": (np.asarray(eng.user_index.ids),
                     np.asarray(eng.user_factors, dtype=np.float64)),
            "item": (np.asarray(eng.item_index.ids),
                     np.asarray(eng.item_factors, dtype=np.float64))}
    return tmp, {"train": str(train), "dist": str(dist)}, want


def _assert_files_match(user, item, want, tol=F64_TOL):
    for side, path in (("user", user), ("item", item)):
        ids, fd = load_factors(str(path))
        np.testing.assert_array_equal(ids, want[side][0])
        np.testing.assert_allclose(fd.factors, want[side][1], rtol=0,
                                   atol=tol)


def _run_submitted(fx, task_file, deadline=DEADLINE_S):
    rsp = submit_task_file("127.0.0.1", fx.port, task_file)
    assert rsp["status"] == "OK", rsp
    return _wait_task(fx.port, deadline)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_no_labor_task_runs_a_worker_subprocess(golden, tmp_path, dtype):
    """The reference's golden workflow (examples/README.md:4-13): a task
    submitted to a real Scheduler with no labor runs the port's worker in
    a fresh subprocess; its factor files equal the port's wals CLI on the
    same files, and in float64 qmf_tpu's single-device engine within 1e-9."""
    _, files, want = golden
    assert wals_cli.main([
        f"--train_dataset={files['train']}",
        f"--distribution_file={files['dist']}",
        f"--nepochs={NEPOCHS}", f"--nfactors={K}", f"--dtype={dtype}",
        "--solver=cholesky", "--device=cpu",
        f"--user_factors={tmp_path / 'su.dat'}",
        f"--item_factors={tmp_path / 'si.dat'}",
    ]) == 0
    fx = SchedulerFixture(n_local_devices=1, worker_timeout=DEADLINE_S)
    try:
        last = _run_submitted(fx, _task_file(tmp_path, _task_text(
            files["dist"], files["train"], tmp_path / "du.dat",
            tmp_path / "di.dat", dtype)))
        assert last["state"] == "done", last
        res = last["result"]
        assert (res["num_processes"], res["global_devices"],
                res["local_devices"], res["device"]) == (1, 1, 1, "cpu")
        assert res["launches"] == {"chol_solve": 0, "build_solve": 0,
                                   "build_solve_hot": 0}
        assert len(res["losses"]) == NEPOCHS
        # the daemon made no checkpoint directory survive
        td = parse_taskdef(_task_text(files["dist"], files["train"],
                                      tmp_path / "du.dat",
                                      tmp_path / "di.dat", dtype))
        assert not os.path.exists(default_ckpt_dir(td, 1))
    finally:
        fx.close()
    cli = {side: load_factors(str(tmp_path / f"s{side[0]}.dat"))
           for side in ("user", "item")}
    cli = {s: (ids, fd.factors) for s, (ids, fd) in cli.items()}
    if dtype == "float64":
        _assert_files_match(tmp_path / "du.dat", tmp_path / "di.dat", want)
        _assert_files_match(tmp_path / "du.dat", tmp_path / "di.dat", cli)
    else:
        for side, path in (("user", "du.dat"), ("item", "di.dat")):
            ids, fd = load_factors(str(tmp_path / path))
            np.testing.assert_array_equal(ids, cli[side][0])
            np.testing.assert_allclose(fd.factors, cli[side][1], **F32)


def _attach(fx, labor_cls=Labor):
    labor = labor_cls("127.0.0.1", fx.port)
    fut = fx.run_coro(labor.run())
    _wait(lambda: fx.scheduler.labors, what="labor attach")
    return labor, fut


def test_two_process_run_matches_single_device(golden, tmp_path):
    """The scheduler's worker (rank 0) and one labor's (rank 1), gloo CPU
    ranks, make a world of 2; the float64 factors match qmf_tpu's
    single-device engine within 1e-9."""
    _, files, want = golden
    fx = SchedulerFixture(multiproc=True, n_local_devices=1,
                          prepare_timeout=30.0, worker_timeout=DEADLINE_S)
    labor, fut = _attach(fx)
    try:
        peer = next(iter(fx.scheduler.labors))
        last = _run_submitted(fx, _task_file(tmp_path, _task_text(
            files["dist"], files["train"], tmp_path / "mu.dat",
            tmp_path / "mi.dat")))
        assert last["state"] == "done", last
        res = last["result"]
        assert res["labors"] == [peer] and res["attempts"] == 1
        assert (res["num_processes"], res["global_devices"],
                res["local_devices"], res["backend"]) == (2, 2, 1, "gloo")
        rank1 = _wait(lambda: labor.last_result, what="the labor's result")
        assert rank1["process_id"] == 1
        assert rank1["losses"] == res["losses"]
    finally:
        fut.cancel()
        fx.close()
    _assert_files_match(tmp_path / "mu.dat", tmp_path / "mi.dat", want)


def test_worker_killed_mid_run_is_retried_from_checkpoint(
    golden, tmp_path, monkeypatch
):
    """SIGKILL the labor's worker mid-run: the scheduler shows live progress,
    detects the broken group, kills its own worker, and retries the task,
    resuming from the shared per-epoch checkpoint; the float64 factors
    match an uninterrupted run and qmf_tpu's engine within 1e-9."""
    _, files, want = golden
    # stretch epochs so the kill window is deterministic
    monkeypatch.setenv("QMF_TPU_EPOCH_SLEEP_S", "0.75")
    text = _task_text(files["dist"], files["train"], tmp_path / "ku.dat",
                      tmp_path / "ki.dat")
    ckpt_dir = default_ckpt_dir(parse_taskdef(text), taskid=1)
    fx = SchedulerFixture(multiproc=True, n_local_devices=1,
                          prepare_timeout=30.0, worker_timeout=DEADLINE_S)
    labor, fut = _attach(fx)
    try:
        rsp = submit_task_file("127.0.0.1", fx.port,
                               _task_file(tmp_path, text))
        assert rsp["status"] == "OK" and rsp["taskid"] == 1

        def progress():
            status = scheduler_status("127.0.0.1", fx.port)
            cur = status.get("current") or {}
            return any(li["epoch"] > 0 for li in status["labors"].values()) \
                or cur.get("progress")

        _wait(progress, what="mid-run progress in status")
        _wait(lambda: os.path.exists(os.path.join(ckpt_dir, "LATEST")),
              what="first checkpoint")
        pid = labor.worker_pid
        assert pid is not None, "labor worker already gone?"
        os.kill(pid, signal.SIGKILL)

        last = _wait_task(fx.port)
        assert last["state"] == "done", last
        res = last["result"]
        assert res["attempts"] == 2, res
        assert res["num_processes"] == 2
        # resumed: the second attempt ran fewer epochs than the task's
        assert 0 < len(res["losses"]) < NEPOCHS, res
        assert not os.path.exists(ckpt_dir)
    finally:
        fut.cancel()
        fx.close()

    monkeypatch.delenv("QMF_TPU_EPOCH_SLEEP_S")
    monkeypatch.setenv("LOCAL_RANK", "0")  # run_worker sets it; undone here
    run_worker(parse_taskdef(_task_text(
        files["dist"], files["train"], tmp_path / "su.dat",
        tmp_path / "si.dat")), n_local_devices=1)
    _assert_files_match(tmp_path / "ku.dat", tmp_path / "ki.dat", want)
    straight = {side: load_factors(str(tmp_path / f"s{side[0]}.dat"))
                for side in ("user", "item")}
    _assert_files_match(tmp_path / "ku.dat", tmp_path / "ki.dat",
                        {s: (ids, fd.factors)
                         for s, (ids, fd) in straight.items()})


# --- against qmf_tpu's control plane ---------------------------------------

def test_default_ckpt_dir_equals_qmf_tpu():
    for td in (TaskDef(train_set="t", user_factors="/x/u.dat",
                       item_factors="i"),
               parse_taskdef('nepochs : 3\ntrain_set : "a#b"\n'
                             'user_factors : "u"\nitem_factors : "i"\n'
                             'solver : "fused"\n')):
        for taskid in (0, 7):
            assert default_ckpt_dir(td, taskid) == jax_ckpt_dir(
                JaxTaskDef.from_dict(td.to_dict()), taskid)


@pytest.mark.parametrize("writer,reader", [(jax_protocol, protocol),
                                           (protocol, jax_protocol)],
                         ids=["jax_to_port", "port_to_jax"])
def test_frames_cross_the_packages(writer, reader):
    """Frames written by either package's write_frame parse in the other's
    read_frame, over a real socket pair."""
    msgs = [{"kind": "attach_labor"},
            {"kind": "progress", "taskid": 2, "epoch": 1, "loss": 0.5,
             "text": "déjà #1"}]

    async def scenario():
        received = []

        async def serve(r, w):
            while (msg := await reader.read_frame(r)) is not None:
                received.append(msg)
            w.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        r, w = await asyncio.open_connection("127.0.0.1", port)
        for msg in msgs:
            await writer.write_frame(w, msg)
        w.close()
        await w.wait_closed()
        for _ in range(200):
            if len(received) == len(msgs):
                break
            await asyncio.sleep(0.01)
        server.close()
        await server.wait_closed()
        return received

    assert asyncio.run(scenario()) == msgs


@pytest.mark.parametrize("labor_cls,sched_cls", [(Labor, JaxScheduler),
                                                 (JaxLabor, Scheduler)],
                         ids=["port_labor", "jax_labor"])
def test_labor_attaches_to_the_other_package(tmp_path, labor_cls, sched_cls):
    """Either package's labor attaches to the other's scheduler, answers
    its heartbeats and takes its announcement; either submit client talks
    to either scheduler."""
    from qmf_tpu.distributed.submit import (
        submit_task_file as jax_submit_task_file)

    results = []
    fx = SchedulerFixture(runner=_fake_runner(results),
                          heartbeat_interval=0.3, cls=sched_cls)
    labor, fut = _attach(fx, labor_cls)
    try:
        task_file = _task_file(
            tmp_path, 'nepochs : 2\ntrain_set : "t.txt"\n'
            'user_factors : "u.dat"\nitem_factors : "i.dat"\n')
        for submit in (submit_task_file, jax_submit_task_file):
            assert submit("127.0.0.1", fx.port, task_file)["status"] == "OK"
        _wait(lambda: len(results) == 2, what="both tasks run")
        _wait(lambda: labor.taskid == 2, what="announcement")

        def seen():
            li = next(iter(fx.scheduler.labors.values()), None)
            return li is not None and li.taskid == 2

        _wait(seen, what="heartbeat reply")
    finally:
        fut.cancel()
        fx.close()


@pytest.fixture
def restore_sigpipe():
    """wals_submit makes SIGPIPE fatal (a unix tool piped into head); the
    test process keeps Python's default."""
    before = signal.getsignal(signal.SIGPIPE)
    yield
    signal.signal(signal.SIGPIPE, before)


@pytest.mark.parametrize("cli,argv", [
    ("wals_scheduler", ["--scheduler_port=9001", "--multiproc=false",
                        "--coordinator_ip", "10.0.0.1",
                        "--n_local_devices=1", "rest"]),
    ("wals_scheduler", []),
    ("wals_labor", ["-scheduler_ip", "10.0.0.2", "--reconnect_backoff=0.5"]),
    ("wals_labor", []),
    ("wals_submit", ["--status", "h", "1"]),
    ("wals_submit", ["--send_path", "h", "1", "task.pb"]),
], ids=["scheduler", "scheduler_defaults", "labor", "labor_defaults",
        "submit_status", "submit_send_path"])
def test_cli_flags_parse_alike(cli, argv, restore_sigpipe):
    """The three CLIs take qmf_tpu's flags with its defaults and return the
    same positional arguments; the scheduler adds --device (default cuda)
    and --backend (default empty)."""
    import importlib

    from qmf_tpu.utils.flags import Flags as JaxFlags

    port = importlib.import_module(f"qmf_tpu_torch.cli.{cli}").make_flags()
    jax_mod = importlib.import_module(f"qmf_tpu.cli.{cli}")
    if cli == "wals_submit":  # qmf_tpu builds these flags inside main()
        jax = JaxFlags("wals_submit")
        jax.define_bool("send_path", False, "")
        jax.define_bool("status", False, "")
    else:
        jax = jax_mod.make_flags()
    assert port.parse(list(argv)) == jax.parse(list(argv))
    extra = {k: v for k, v in port.values.items() if k not in jax.values}
    assert {k: port.values[k] for k in jax.values} == jax.values
    assert extra == ({"device": "cuda", "backend": ""}
                     if cli == "wals_scheduler" else {})


def test_submit_cli_exit_codes_alike(tmp_path, capsys, restore_sigpipe):
    """wals_submit of either package: 2 without its positional arguments,
    0 for a submitted task and for --status, against the port's scheduler."""
    from qmf_tpu.cli import wals_submit as jax_submit_cli
    from qmf_tpu_torch.cli import wals_submit as port_submit_cli

    results = []
    fx = SchedulerFixture(runner=_fake_runner(results))
    try:
        task_file = _task_file(
            tmp_path, 'train_set : "t.txt"\nuser_factors : "u.dat"\n'
            'item_factors : "i.dat"\n')
        port = str(fx.port)
        for cli in (port_submit_cli, jax_submit_cli):
            assert cli.main(["127.0.0.1"]) == 2
            assert cli.main(["--status", "127.0.0.1"]) == 2
            assert cli.main(["127.0.0.1", port, task_file]) == 0
            capsys.readouterr()
            assert cli.main(["--status", "127.0.0.1", port]) == 0
            assert '"kind": "status_rsp"' in capsys.readouterr().out
        _wait(lambda: len(results) == 2, what="both tasks run")
    finally:
        fx.close()
