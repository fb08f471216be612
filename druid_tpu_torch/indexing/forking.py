"""Process-isolated task execution: forked peons + overlord action server.

The port's copy of the reference package's `indexing/forking.py`.
Reference analogs (indexing-service/src/main/java/org/apache/druid/indexing/):
  overlord/ForkingTaskRunner.java — one OS process per task, task spec
    handed over on disk, logs captured, exit code = task outcome
  worker/WorkerTaskMonitor.java + overlord/RemoteTaskRunner.java — the
    worker heartbeat / dead-worker restart loop (single-host here: the
    runner monitors its own child processes and re-forks)
  common/actions/RemoteTaskActionClient.java — peon-side task actions
    (lock, allocate, publish) POSTed to the overlord, which executes them
    against the one authoritative lockbox + metadata store

Why processes: a task that runs out of memory or crashes must not take
down query serving. The query path never runs in peons: ingest is host
work over numpy, so a peon's toolbox names device="cpu" and the peon never
creates a CUDA context (it reports `torch.cuda.is_initialized()` with its
status); the serving process keeps the card. A peon is
`python -m druid_tpu_torch.peon <spec>`, started from the directory that
holds the package, with the environment it inherits.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.cluster.metadata import MetadataStore, SegmentDescriptor
from druid_tpu_torch.indexing.locks import TaskLockbox
from druid_tpu_torch.indexing.task import Task, TaskStatus
from druid_tpu_torch.storage.deep import DeepStorage, LocalDeepStorage
from druid_tpu_torch.utils.intervals import Interval

#: the directory that holds the druid_tpu_torch package (a peon's cwd)
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class TaskActionServer:
    """The overlord's task-action endpoint: every metadata/lock mutation a
    peon needs runs HERE, in the overlord process, against the one lockbox
    (TaskActionClient boundary). Actions and statuses are recorded for
    observability and tests."""

    def __init__(self, metadata: MetadataStore, lockbox: TaskLockbox,
                 host: str = "127.0.0.1", port: int = 0, runner=None):
        self.metadata = metadata
        self.lockbox = lockbox
        #: the runner sub-task submissions fan out on (set by the runner
        #: that owns this server)
        self.runner = runner
        self.actions: List[dict] = []          # received action log
        self.statuses: Dict[str, TaskStatus] = {}
        #: what each peon said of its own process with its status: whether
        #: it had a CUDA context, and the modules it had imported
        self.peon_reports: Dict[str, dict] = {}
        self.heartbeats: Dict[str, float] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                try:
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                try:
                    if self.path == "/action":
                        self._reply(200, outer._do_action(payload))
                    elif self.path == "/status":
                        outer._record_status(payload)
                        self._reply(200, {"ok": True})
                    elif self.path == "/heartbeat":
                        with outer._lock:
                            outer.heartbeats[payload["worker"]] = time.time()
                        self._reply(200, {"ok": True})
                    else:
                        self._reply(404, {"error": "no such path"})
                except Exception as e:   # action failure → structured error
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def status(self, task_id: str) -> Optional[TaskStatus]:
        """Locked read of a peon-reported status — monitors poll this
        while handler threads record into the same dict."""
        with self._lock:
            return self.statuses.get(task_id)

    def peon_report(self, task_id: str) -> Optional[dict]:
        """The last peon's report of its process (cudaInitialized,
        importedJax, importedReference), or None before its status."""
        with self._lock:
            return self.peon_reports.get(task_id)

    def live_workers(self, ttl: float = 30.0) -> List[str]:
        """Workers whose heartbeat arrived within `ttl` seconds — the
        overlord's view of peon liveness (WorkerTaskMonitor's periodic
        status report; process exit remains the authoritative single-host
        death signal, heartbeats are the observable)."""
        now = time.time()
        with self._lock:
            return sorted(w for w, t in self.heartbeats.items()
                          if now - t <= ttl)

    def _record_status(self, payload: dict) -> None:
        st = TaskStatus(payload["task"], payload["state"],
                        payload.get("error"))
        with self._lock:
            self.statuses[st.task_id] = st
            if "peon" in payload:
                self.peon_reports[st.task_id] = payload["peon"]

    def _do_action(self, payload: dict) -> dict:
        task_id = payload["task"]
        action = payload["action"]
        args = payload.get("args", {})
        with self._lock:
            self.actions.append({"task": task_id, "action": action})
        if action == "lock":
            from druid_tpu_torch.indexing.locks import LockType
            lt = LockType(args.get("lockType", "exclusive"))
            out = []
            for iv_s in args["intervals"]:
                lk = self.lockbox.acquire(task_id, args["datasource"],
                                          Interval.parse(iv_s),
                                          priority=args.get("priority", 50),
                                          lock_type=lt)
                if lk is None:
                    self.lockbox.release_all(task_id)
                    return {"lock": None}
                out.append(lk)
            return {"lock": {"version": out[0].version} if out else None}
        if action == "is_revoked":
            return {"revoked": self.lockbox.is_revoked(task_id)}
        if action == "publish":
            # idempotent per task id: a peon that died AFTER its publish
            # committed but BEFORE reporting status is re-forked, re-reads,
            # and calls publish again with freshly-allocated partitions —
            # the marker makes the retry a no-op success instead of a
            # duplicate append (exactly-once for crash-retried sub-tasks)
            marker = f"task_publish:{task_id}"
            if self.metadata.get_config(marker):
                return {"ok": True}
            descs = [SegmentDescriptor.from_json(d)
                     for d in args["segments"]]
            ok = self.lockbox.critical_section(
                task_id, lambda: self.metadata.publish_segments(descs))
            if ok:
                self.metadata.set_config(
                    marker, {"segments": [d.id for d in descs]})
            return {"ok": bool(ok)}
        if action == "allocate_segment":
            version, pnum = self.metadata.allocate_segment(
                args["datasource"], Interval.parse(args["interval"]))
            return {"version": version, "partition": pnum}
        if action == "visible_segments":
            descs = self.metadata.visible_segments(
                args["datasource"], Interval.parse(args["interval"]))
            return {"segments": [d.to_json() for d in descs]}
        if action == "unused_segments":
            descs = self.metadata.unused_segments(
                args["datasource"], Interval.parse(args["interval"]))
            return {"segments": [d.to_json() for d in descs]}
        if action == "delete_segments":
            self.metadata.delete_segments(args["ids"])
            return {"ok": True}
        if action == "submit_task":
            # supervisor tasks (ParallelIndexTask) fan sub-tasks out
            # through the overlord — each gets its own peon
            if self.runner is None:
                raise ValueError("no task runner attached")
            from druid_tpu_torch.indexing.task import task_from_json
            sub = task_from_json(args["spec"])
            self.runner.submit(sub)
            return {"ok": True, "task": sub.id}
        if action == "task_status":
            if self.runner is None:
                raise ValueError("no task runner attached")
            st = self.runner.status(args["id"])
            if st is None:
                return {"state": "UNKNOWN", "error": None}
            return {"state": st.state, "error": st.error}
        raise ValueError(f"unknown task action {action!r}")


# ---------------------------------------------------------------------------
# Peon side: the toolbox whose actions travel over HTTP
# ---------------------------------------------------------------------------

class _RemoteActions:
    def __init__(self, base_url: str, task_id: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.task_id = task_id
        self.timeout = timeout

    def call(self, action: str, **args) -> dict:
        body = json.dumps({"task": self.task_id, "action": action,
                           "args": args}).encode()
        req = urllib.request.Request(
            self.base_url + "/action", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def post(self, path: str, payload: dict) -> None:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()


class _PeonLock:
    def __init__(self, version: str):
        self.version = version


class _RemoteMetadata:
    """The slice of MetadataStore tasks touch, proxied through actions."""

    def __init__(self, actions: _RemoteActions):
        self._a = actions

    def allocate_segment(self, datasource: str, interval: Interval,
                         version=None):
        r = self._a.call("allocate_segment", datasource=datasource,
                         interval=str(interval))
        return r["version"], r["partition"]

    def visible_segments(self, datasource: str, interval: Interval):
        r = self._a.call("visible_segments", datasource=datasource,
                         interval=str(interval))
        return [SegmentDescriptor.from_json(d) for d in r["segments"]]

    def unused_segments(self, datasource: str, interval: Interval):
        r = self._a.call("unused_segments", datasource=datasource,
                         interval=str(interval))
        return [SegmentDescriptor.from_json(d) for d in r["segments"]]

    def delete_segments(self, ids: Sequence[str]) -> None:
        self._a.call("delete_segments", ids=list(ids))


class _RemoteLockbox:
    def __init__(self, actions: _RemoteActions):
        self._a = actions

    def is_revoked(self, task_id: str) -> bool:
        return bool(self._a.call("is_revoked")["revoked"])


class _RemoteTaskRunner:
    """Peon-side sub-task fan-out: submissions go to the overlord's action
    endpoint, which forks a peon per sub-task; await polls status (the
    reference supervisor task's HTTP round to the overlord)."""

    def __init__(self, actions: _RemoteActions, poll_interval: float = 0.2):
        self._a = actions
        self.poll_interval = poll_interval

    def submit(self, task: Task) -> str:
        return self._a.call("submit_task", spec=task.to_json())["task"]

    def await_task(self, task_id: str, timeout: float = 600.0) -> TaskStatus:
        deadline = time.time() + timeout
        while time.time() < deadline:
            r = self._a.call("task_status", id=task_id)
            if r["state"] in ("SUCCESS", "FAILED"):
                return TaskStatus(task_id, r["state"], r.get("error"))
            time.sleep(self.poll_interval)
        raise TimeoutError(f"sub-task {task_id} still running")


class PeonToolbox:
    """TaskToolbox for a forked peon: lock/publish/metadata actions go to
    the overlord over HTTP; segment bytes go straight to shared deep
    storage (exactly the reference's split — peons push to S3/HDFS
    themselves, only the metadata commit runs overlord-side). Its device
    is the CPU: a peon's work is host work and never touches the card."""

    def __init__(self, actions: _RemoteActions, deep_storage: DeepStorage,
                 device="cpu"):
        self._a = actions
        self.deep_storage = deep_storage
        self.device = device_mod.resolve(device)
        self.metadata = _RemoteMetadata(actions)
        self.lockbox = _RemoteLockbox(actions)
        self.task_runner = _RemoteTaskRunner(actions)

    def lock(self, task: Task, intervals: Sequence[Interval],
             lock_type=None):
        from druid_tpu_torch.utils.intervals import condense
        r = self._a.call("lock", datasource=task.datasource,
                         intervals=[str(iv) for iv in condense(intervals)],
                         priority=task.priority,
                         lockType=getattr(lock_type, "value", "exclusive"))
        lk = r.get("lock")
        return _PeonLock(lk["version"]) if lk else None

    def push(self, segment, descriptor: SegmentDescriptor):
        return self.deep_storage.push(segment, descriptor)

    def pull(self, descriptor: SegmentDescriptor):
        return self.deep_storage.pull(descriptor)

    def publish(self, task: Task,
                descriptors: Sequence[SegmentDescriptor]) -> bool:
        return bool(self._a.call(
            "publish", segments=[d.to_json() for d in descriptors])["ok"])


def _process_report() -> dict:
    """This process's own account: a CUDA context (torch.cuda.is_initialized)
    and whether jax or the reference package was ever imported."""
    import torch
    mods = list(sys.modules)
    return {"cudaInitialized": bool(torch.cuda.is_initialized()),
            "importedJax": any(m == "jax" or m.startswith("jax.")
                               for m in mods),
            "importedReference": any(m == "druid_tpu"
                                     or m.startswith("druid_tpu.")
                                     for m in mods)}


def peon_main(spec_path: str) -> int:
    """Entry point of the forked peon process (CliPeon analog): read the
    task spec, run the task against the remote toolbox, report status."""
    with open(spec_path) as f:
        spec = json.load(f)
    from druid_tpu_torch.indexing.task import task_from_json
    task = task_from_json(spec["task"])
    actions = _RemoteActions(spec["actionUrl"], task.id)

    # periodic worker heartbeat for the overlord's liveness view
    stop_hb = threading.Event()

    def beat():
        while not stop_hb.is_set():
            try:
                actions.post("/heartbeat", {"worker": f"peon-{task.id}"})
            except Exception:
                # overlord unreachable: its liveness view ages us out
                logging.getLogger(__name__).debug(
                    "heartbeat for peon-%s failed", task.id, exc_info=True)
            stop_hb.wait(spec.get("heartbeatPeriod", 5.0))

    threading.Thread(target=beat, daemon=True).start()
    toolbox = PeonToolbox(actions,
                          LocalDeepStorage(spec["deepStorageDir"]),
                          device="cpu")
    try:
        status = task.run(toolbox)
    except Exception as e:
        status = TaskStatus.failure(task.id, e)
    finally:
        stop_hb.set()
    report = _process_report()
    print(f"peon {task.id}: {status.state}, {json.dumps(report)}",
          flush=True)
    actions.post("/status", {"task": task.id, "state": status.state,
                             "error": status.error, "peon": report})
    return 0 if status.state == "SUCCESS" else 1


# ---------------------------------------------------------------------------
# Overlord side: the forking runner
# ---------------------------------------------------------------------------

class ForkingTaskRunner:
    """Run each task in a forked python process. A peon that dies without
    reporting a terminal status (OOM-kill, crash) releases its locks and is
    re-forked up to max_restarts times — the single-host collapse of
    RemoteTaskRunner's dead-worker task restart."""

    def __init__(self, metadata: MetadataStore,
                 deep_storage_dir: Optional[str] = None,
                 lockbox: Optional[TaskLockbox] = None,
                 max_restarts: int = 2,
                 poll_interval: float = 0.1):
        self.metadata = metadata
        self.lockbox = lockbox or TaskLockbox()
        # absolute: the peons run from the package's parent directory
        self.deep_storage_dir = os.path.abspath(
            deep_storage_dir or tempfile.mkdtemp(prefix="druid_tpu_deep_"))
        self.deep_storage = LocalDeepStorage(self.deep_storage_dir)
        self.actions = TaskActionServer(metadata, self.lockbox)
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.processes: Dict[str, subprocess.Popen] = {}
        self.attempts: Dict[str, int] = {}
        self._statuses: Dict[str, TaskStatus] = {}
        self._monitors: Dict[str, threading.Thread] = {}
        self._specs: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._listeners: List[Callable[[TaskStatus], None]] = []
        self._shutdown = False
        self.actions.runner = self

    def add_listener(self, fn: Callable[[TaskStatus], None]) -> None:
        self._listeners.append(fn)

    # ---- lifecycle ------------------------------------------------------
    def submit(self, task: Task) -> str:
        with self._lock:
            if task.id in self._monitors:
                return task.id
            # serialize FIRST: a task that cannot round-trip (unserializable
            # firehose, non-JSON payload) must fail the submit, not leave a
            # forever-RUNNING orphan row in the metadata store
            task_json = task.to_json()
            spec_dir = tempfile.mkdtemp(prefix=f"peon_{task.id[:24]}_")
            spec_path = os.path.join(spec_dir, "task.json")
            with open(spec_path, "w") as f:
                json.dump({"task": task_json,
                           "actionUrl": self.actions.url,
                           "deepStorageDir": self.deep_storage_dir}, f)
            self.metadata.insert_task(task.id, task.datasource, "RUNNING",
                                      task_json)
            self._statuses[task.id] = TaskStatus(task.id, "RUNNING")
            self._specs[task.id] = spec_path
            self.attempts[task.id] = 0
            t = threading.Thread(target=self._monitor, args=(task.id,),
                                 daemon=True)
            self._monitors[task.id] = t
        t.start()
        return task.id

    def _fork(self, task_id: str, attempt: int) -> subprocess.Popen:
        # the package's parent directory as the working directory: `-m`
        # finds druid_tpu_torch there, whatever the caller's path
        with self._lock:
            spec_path = self._specs[task_id]
        log_path = spec_path + f".log.{attempt}"
        logf = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "druid_tpu_torch.peon", spec_path],
            stdout=logf, stderr=subprocess.STDOUT, cwd=_PACKAGE_PARENT)
        logf.close()
        with self._lock:
            self.processes[task_id] = proc
        return proc

    #: one bounded park quantum on a live peon; the monitor re-checks
    #: shutdown between quanta instead of parking on wait() forever
    PROC_WAIT_POLL_S = 1.0
    #: grace between SIGTERM and SIGKILL when shutdown interrupts a peon
    PROC_KILL_GRACE_S = 5.0

    def _await_proc(self, proc) -> None:
        """Park on the peon in bounded quanta. A shutdown observed between
        quanta escalates terminate → (after PROC_KILL_GRACE_S) kill, so
        the monitor thread can never outlive stop() on a wedged peon —
        the one pre-known stall in the tree (a bare proc.wait() here
        parked the monitor for as long as the peon cared to run)."""
        while True:
            try:
                proc.wait(timeout=self.PROC_WAIT_POLL_S)
                return
            except subprocess.TimeoutExpired:
                pass
            if self._shutdown:
                break
        proc.terminate()
        try:
            proc.wait(timeout=self.PROC_KILL_GRACE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=self.PROC_KILL_GRACE_S)
            except subprocess.TimeoutExpired:
                pass        # unkillable (kernel-stuck): do not hang stop()

    def _monitor(self, task_id: str) -> None:
        while True:
            # snapshot the attempt count under the lock once; unlocked
            # re-reads below would race a concurrent resubmit's reset
            with self._lock:
                self.attempts[task_id] += 1
                attempt = self.attempts[task_id]
            proc = self._fork(task_id, attempt)
            self._await_proc(proc)
            reported = self.actions.status(task_id)
            if reported is not None and reported.state in ("SUCCESS",
                                                           "FAILED"):
                status = reported
                break
            # peon died without a terminal report: free its locks so the
            # retry (or anyone else) can proceed, then maybe re-fork
            self.lockbox.release_all(task_id)
            if self._shutdown:
                status = TaskStatus.failure(task_id, "runner shut down")
                break
            if attempt > self.max_restarts:
                status = TaskStatus.failure(
                    task_id, f"peon died {attempt} times "
                    f"(exit {proc.returncode})")
                break
        self.lockbox.release_all(task_id)
        with self._lock:
            self._statuses[task_id] = status
        self.metadata.update_task_status(task_id, status.state)
        for fn in list(self._listeners):
            fn(status)

    # ---- status ---------------------------------------------------------
    def status(self, task_id: str) -> Optional[TaskStatus]:
        with self._lock:
            st = self._statuses.get(task_id)
        return st

    def await_task(self, task_id: str, timeout: float = 300.0) -> TaskStatus:
        mon = self._monitors.get(task_id)
        if mon is None:
            raise KeyError(task_id)
        mon.join(timeout)
        if mon.is_alive():
            raise TimeoutError(f"task {task_id} still running")
        return self.status(task_id)

    def run_task(self, task: Task, timeout: float = 300.0) -> TaskStatus:
        self.submit(task)
        return self.await_task(task.id, timeout)

    def task_log(self, task_id: str) -> str:
        """The task's captured stdout/stderr across all peon attempts
        (reference: TaskLogStreamer / overlord GET /task/{id}/log)."""
        spec = self._specs.get(task_id)
        if spec is None:
            return ""
        import glob as globlib
        parts = []
        for path in sorted(globlib.glob(spec + ".log.*")):
            attempt = path.rsplit(".", 1)[-1]
            with open(path, "rb") as f:
                parts.append(f"--- attempt {attempt} ---\n"
                             + f.read().decode(errors="replace"))
        return "\n".join(parts)

    def shutdown(self) -> None:
        # order matters: the flag stops monitors from re-forking the peons
        # the kill below makes look dead
        self._shutdown = True
        with self._lock:
            procs = list(self.processes.values())
            monitors = list(self._monitors.values())
        for p in procs:
            if p.poll() is None:
                p.kill()
        # reap the monitor threads before tearing down the action server
        # they report through: each sees its peon dead + the shutdown flag
        # and finishes; an unjoined monitor would race the teardown below
        for t in monitors:
            if t.is_alive():
                t.join(timeout=5.0)
        self.actions.stop()
