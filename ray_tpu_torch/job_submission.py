"""Job submission: run driver scripts as managed subprocesses.

The counterpart of `ray_tpu/job_submission.py`; a client's default log
directory is `<tmp>/rtt_jobs_<pid>`.

Parity: reference dashboard/modules/job (JobSubmissionClient + JobManager
driving a supervisor that spawns the entrypoint with its runtime_env,
tracking status and capturing logs). Re-shaped for this stack: jobs are
subprocesses of the submitting driver's host (the single-head topology),
with env fanout, captured logs, status polling, and stop.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


@dataclasses.dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = PENDING
    return_code: Optional[int] = None
    submitted_at: float = dataclasses.field(default_factory=time.time)
    ended_at: Optional[float] = None
    log_path: str = ""
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


class JobSubmissionClient:
    """Submit/inspect/stop jobs (reference JobSubmissionClient API:
    submit_job, get_job_status, get_job_logs, list_jobs, stop_job)."""

    def __init__(self, log_dir: Optional[str] = None):
        self._log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"rtt_jobs_{os.getpid()}")
        os.makedirs(self._log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   job_id: Optional[str] = None) -> str:
        from ray_tpu_torch.api import validate_runtime_env
        renv = validate_runtime_env(runtime_env) or {}
        job_id = job_id or "job_" + uuid.uuid4().hex[:10]
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
        log_path = os.path.join(self._log_dir, f"{job_id}.log")
        env = dict(os.environ)
        env.update(renv.get("env_vars") or {})
        env["RAY_TPU_JOB_ID"] = job_id
        cwd = renv.get("working_dir") or None
        # pip / py_modules for a job (a subprocess on THIS host) become
        # PYTHONPATH entries: the venv's site-packages materializes via
        # the per-host cache; py_modules local paths ride directly
        # (never silently ignore a validated option)
        extra_paths = []
        if renv.get("pip"):
            from ray_tpu_torch._private.runtime_env import ensure_pip_env
            extra_paths.append(ensure_pip_env(renv["pip"]))
        for m in renv.get("py_modules") or []:
            if isinstance(m, str):
                extra_paths.append(os.path.dirname(os.path.abspath(m))
                                   if os.path.isfile(m)
                                   else os.path.dirname(
                                       os.path.abspath(m.rstrip("/"))))
            else:
                raise ValueError(
                    "job py_modules entries must be local paths")
        if extra_paths:
            env["PYTHONPATH"] = os.pathsep.join(
                extra_paths + [env.get("PYTHONPATH", "")]).rstrip(
                    os.pathsep)
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       log_path=log_path, metadata=dict(metadata or {}))
        log_f = open(log_path, "wb")
        proc = subprocess.Popen(
            entrypoint, shell=True, stdout=log_f, stderr=log_f,
            env=env, cwd=cwd)
        log_f.close()
        info.status = RUNNING
        with self._lock:
            self._jobs[job_id] = info
            self._procs[job_id] = proc
        threading.Thread(target=self._reap, args=(job_id,),
                         daemon=True).start()
        return job_id

    def _reap(self, job_id: str) -> None:
        proc = self._procs[job_id]
        rc = proc.wait()
        with self._lock:
            info = self._jobs[job_id]
            if info.status == RUNNING:
                info.status = SUCCEEDED if rc == 0 else FAILED
            info.return_code = rc
            info.ended_at = time.time()

    def get_job_status(self, job_id: str) -> str:
        return self._info(job_id).status

    def get_job_info(self, job_id: str) -> JobInfo:
        return self._info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        info = self._info(job_id)
        try:
            with open(info.log_path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def list_log_files(self) -> List[Dict[str, Any]]:
        """Log files in this client's log dir (dashboard /api/logs)."""
        out = []
        for info in self.list_jobs():
            try:
                size = os.path.getsize(info.log_path)
            except OSError:
                size = 0
            out.append({"job_id": info.job_id, "path": info.log_path,
                        "size_bytes": size, "status": info.status})
        return out

    def tail_logs(self, job_id: str, lines: int = 200) -> List[str]:
        """Last N lines of a job's log (dashboard /api/logs/<job>)."""
        text = self.get_job_logs(job_id)
        return text.splitlines()[-max(1, lines):]

    def stop_job(self, job_id: str) -> bool:
        info = self._info(job_id)
        proc = self._procs.get(job_id)
        if proc is None or proc.poll() is not None:
            return False
        with self._lock:
            info.status = STOPPED
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
        return True

    def wait_until_finished(self, job_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        status = self.get_job_status(job_id)
        while True:
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            if time.time() >= deadline:
                raise TimeoutError(f"job {job_id} still {status} after "
                                   f"{timeout}s")
            time.sleep(0.2)
            status = self.get_job_status(job_id)

    def _info(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise ValueError(f"no job {job_id!r}")
        return info


_DEFAULT_CLIENT = None


def default_client() -> "JobSubmissionClient":
    """Process-wide client (the dashboard's job/log endpoints use it, so
    jobs submitted through it are the ones observability surfaces)."""
    global _DEFAULT_CLIENT
    if _DEFAULT_CLIENT is None:
        _DEFAULT_CLIENT = JobSubmissionClient()
    return _DEFAULT_CLIENT
