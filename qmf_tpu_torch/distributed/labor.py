"""Labor: worker daemon that attaches to the scheduler (the port's
counterpart of qmf_tpu/distributed/labor.py, with its dispatch).

Re-design of the reference Labor (reference distributed/labor/Labor.cpp).
The reference labor was the compute worker: it received the full dataset
and fixed factors over TCP and solved 10k-row buckets (Labor.cpp:197-405).
Here a *labor process* is a per-host agent whose jobs are:

- liveness: attach (kAttachLabor analog, Labor.cpp:105-143) and answer
  heartbeats with its local (taskid, epoch) (kInfoRsp, Labor.cpp:179-195);
- task sync: record task announcements so a multi-host run can join the
  right process group (the kPushRate/kPushFixed guards, Labor.cpp:245-346,
  collapse into this: the data moves by the group's collectives now);
- elasticity: labors may attach/detach at any time, mirroring the
  reference's any-time kAttachLabor semantics.
- compute: on `task_start`, spawn a training worker subprocess that joins
  the scheduler-announced process group as one rank of the sharded engine
  on the announced device and backend (the kCalc compute role,
  Labor.cpp:326-405; see qmf_tpu_torch/distributed/worker.py). A worker
  is one rank on one device: run one labor per card.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional

from qmf_tpu_torch.distributed import protocol
from qmf_tpu_torch.utils.logging import log


class Labor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8900):
        self.host = host
        self.port = port
        self.taskid = 0
        self.epoch = 0
        self.attached = False
        self.current_task: Optional[Dict[str, Any]] = None
        self.last_result: Optional[Dict[str, Any]] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._worker_task: Optional[asyncio.Task] = None
        # pid of the currently-running worker subprocess (None when idle);
        # exposed for ops/tests (e.g. fault-injection kills a live worker)
        self.worker_pid: Optional[int] = None
        # taskid of a task_prepare that arrived while busy (acked on exit)
        self._pending_prepare: Optional[int] = None
        # live worker subprocess handle (for task_abort kills)
        self._worker_holder: Optional[Dict[str, Any]] = None
        # in-flight drain of the last progress frame (backpressure guard)
        self._progress_drain: Optional[asyncio.Future] = None

    async def run(self) -> None:
        """Connect, attach, then serve heartbeats/announcements forever."""
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self._writer = writer
        try:
            await protocol.write_frame(writer, {"kind": "attach_labor"})
            rsp = await protocol.read_frame(reader)
            if not rsp or rsp.get("status") != "OK":
                raise RuntimeError(f"attach failed: {rsp}")
            self.attached = True
            log.info("attached to scheduler %s:%d as %s", self.host,
                     self.port, rsp.get("peer"))
            while True:
                msg = await protocol.read_frame(reader)
                if msg is None:
                    log.warning("scheduler connection closed")
                    return
                reply = self._dispatch(msg)
                if reply is not None:
                    await protocol.write_frame(writer, reply)
        finally:
            self.attached = False
            if self._worker_task is not None:
                self._worker_task.cancel()
            writer.close()

    def _dispatch(self, msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        kind = msg.get("kind")
        if kind == "heartbeat":
            # kInfoRsp analog: report local task/epoch state
            return {
                "kind": "info_rsp",
                "taskid": self.taskid,
                "epoch": self.epoch,
            }
        if kind == "task_announce":
            self.taskid = msg.get("taskid", 0)
            self.epoch = 0
            self.current_task = msg.get("task")
            log.info("task %d announced", self.taskid)
            return None
        if kind == "task_prepare":
            # readiness ack (quorum phase); if still busy, remember the
            # prepare and ack the moment the worker exits (closes the race
            # where a retry's prepare lands while the failed worker is
            # still being reaped — the scheduler's quorum window is open)
            if self._worker_task is not None and not self._worker_task.done():
                self._pending_prepare = msg.get("taskid", 0)
                log.warning(
                    "task %s prepare deferred: worker busy", msg.get("taskid")
                )
                return None
            return {"kind": "task_ready", "taskid": msg.get("taskid", 0)}
        if kind == "task_abort":
            # the scheduler declared the process group broken: kill our worker
            # NOW so this labor can ack the retry's task_prepare instead of
            # staying wedged on dead collectives until its own timeout
            if (
                msg.get("taskid", 0) == self.taskid
                and self._worker_task is not None
                and not self._worker_task.done()
            ):
                # the holder is created in the task_start dispatch (before
                # _run_worker first runs), so an abort that arrives in the
                # same socket-buffer batch as task_start still arms the
                # deferred kill on the dict _run_worker will actually read
                holder = self._worker_holder
                if holder is None:
                    return None  # _run_worker already finished and cleared it
                proc = holder.get("proc")
                if proc is not None and proc.returncode is None:
                    log.warning(
                        "task %d aborted by scheduler — killing worker",
                        self.taskid,
                    )
                    proc.kill()
                else:
                    # abort raced the subprocess spawn: the holder exists but
                    # the pid-poll loop hasn't populated 'proc' yet. Leave a
                    # flag; _run_worker kills the subprocess the moment it
                    # appears (otherwise the labor stays wedged on dead
                    # collectives until the worker timeout)
                    holder["aborted"] = True
                    log.warning(
                        "task %d aborted before worker spawn completed — "
                        "deferred kill armed",
                        self.taskid,
                    )
            return None
        if kind == "task_start":
            self.taskid = msg.get("taskid", 0)
            self.epoch = 0
            self.current_task = msg.get("task")
            log.info(
                "task %d: joining %d-process run as process %d",
                self.taskid,
                msg.get("num_processes", 1),
                msg.get("process_id", -1),
            )
            # create the subprocess holder HERE so a task_abort dispatched
            # from the same buffered read batch (before the _run_worker
            # coroutine gets scheduled) arms its deferred-kill flag on the
            # dict the worker path will see
            self._worker_holder = {}
            # run in the background so heartbeats stay answered
            self._worker_task = asyncio.ensure_future(self._run_worker(msg))
            return None
        return None

    def _on_progress(self, prog: Dict[str, Any]) -> None:
        """Forward the worker's per-epoch progress to the scheduler (the
        reference's mid-epoch progress reports, RunOneTask.cpp:208-212) and
        keep the local heartbeat state current.

        Backpressure: a stalled scheduler connection must not accumulate
        per-epoch frames unboundedly in the transport buffer for the life of
        a long task — skip the frame when the transport is closing or a
        previous drain hasn't completed (progress is a lossy live view; the
        next epoch's frame supersedes it anyway)."""
        self.epoch = prog.get("epoch", self.epoch)
        w = self._writer
        if w is None or w.transport.is_closing():
            return
        if self._progress_drain is not None and not self._progress_drain.done():
            return  # previous frame still draining: drop this one
        try:
            w.write(protocol.encode_frame({"kind": "progress", **prog}))
            self._progress_drain = asyncio.ensure_future(self._drain(w))
        except (ConnectionError, RuntimeError):
            pass

    @staticmethod
    async def _drain(w: asyncio.StreamWriter) -> None:
        try:
            await w.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def _run_worker(self, msg: Dict[str, Any]) -> None:
        from qmf_tpu_torch.distributed.scheduler import run_worker_subprocess
        from qmf_tpu_torch.distributed.taskdef import TaskDef

        taskid = msg.get("taskid", 0)
        # created by the task_start dispatch; fall back for direct callers
        # (tests) that invoke _run_worker without going through _dispatch
        if self._worker_holder is None:
            self._worker_holder = {}
        holder: Dict[str, Any] = self._worker_holder

        def _spawned():
            self.worker_pid = holder.get("pid")

        try:
            td = TaskDef.from_dict(msg["task"])
            coro = run_worker_subprocess(
                td,
                taskid=taskid,
                coordinator=msg["coordinator"],
                num_processes=msg["num_processes"],
                process_id=msg["process_id"],
                n_local_devices=msg.get("n_local_devices", 0),
                device=msg.get("device", "cuda"),
                backend=msg.get("backend", ""),
                # the scheduler's configured per-attempt wall is authoritative
                # (it detects failures much earlier via task_done/labor-loss;
                # this is the last-resort backstop on both sides)
                timeout=msg.get("worker_timeout", 3600.0),
                proc_holder=holder,
                on_progress=self._on_progress,
            )
            task = asyncio.ensure_future(coro)
            # expose the pid as soon as the subprocess exists
            while not task.done() and "pid" not in holder:
                await asyncio.sleep(0.01)
            _spawned()
            # a task_abort that raced the spawn left a deferred-kill flag
            proc = holder.get("proc")
            if holder.get("aborted") and proc is not None and \
                    proc.returncode is None:
                log.warning("task %d: executing deferred abort kill", taskid)
                proc.kill()
            result = await task
            self.last_result = result
            # the labor CLI's log is where an operator reads this rank's
            # result (its launches, epochs and start-up stages)
            log.info("task %d: worker result %s", taskid,
                     json.dumps(result))
            reply = {"kind": "task_done", "taskid": taskid, "rc": 0}
        except Exception as e:  # worker failures must not kill the agent
            log.error("task %d worker failed: %s", taskid, e)
            reply = {
                "kind": "task_done",
                "taskid": taskid,
                "rc": 1,
                "error": str(e)[-500:],
            }
        finally:
            self.worker_pid = None
            self._worker_holder = None
        if self._writer is not None:
            try:
                await protocol.write_frame(self._writer, reply)
                if self._pending_prepare is not None:
                    pending, self._pending_prepare = self._pending_prepare, None
                    await protocol.write_frame(
                        self._writer,
                        {"kind": "task_ready", "taskid": pending},
                    )
            except (ConnectionError, RuntimeError):
                pass
