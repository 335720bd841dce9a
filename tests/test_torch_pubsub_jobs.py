"""Pubsub channels (N9) + job submission (P18): the twin of
`tests/test_pubsub_jobs.py`, case for case, on the port
(`ray_tpu_torch/_private/pubsub.py`, `ray_tpu_torch/job_submission.py`).

The runtime fixtures are this file's own, and a live port runtime is
shut down when the module ends.
"""
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.job_submission import (FAILED, STOPPED, SUCCEEDED,
                                          JobSubmissionClient)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# --------------------------------------------------------------- pubsub
def test_pubsub_cursor_semantics():
    from ray_tpu_torch._private.pubsub import Publisher
    pub = Publisher()
    pub.publish("c", {"a": 1})
    pub.publish("c", {"a": 2})
    msgs, cur = pub.poll("c", cursor=0)
    assert [m["a"] for m in msgs] == [1, 2]
    msgs2, cur2 = pub.poll("c", cursor=cur)
    assert msgs2 == []                 # nothing new
    pub.publish("c", {"a": 3})
    msgs3, _ = pub.poll("c", cursor=cur)
    assert [m["a"] for m in msgs3] == [3]


def test_pubsub_long_poll_blocks_until_publish():
    import threading

    from ray_tpu_torch._private.pubsub import Publisher
    pub = Publisher()
    got = {}

    def consumer():
        got["msgs"], _ = pub.poll("evt", cursor=0, timeout=10.0)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.3)
    pub.publish("evt", "hello")
    t.join(timeout=10)
    assert got["msgs"] == ["hello"]


def test_actor_lifecycle_published(ray_cluster):
    from ray_tpu_torch._private import context
    from ray_tpu_torch._private.pubsub import ACTOR_CHANNEL

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote())
    ray_tpu_torch.kill(a)
    deadline = time.time() + 15
    states = set()
    cursor = 0
    ctx = context.get_ctx()
    while time.time() < deadline and "DEAD" not in states:
        msgs, cursor = ctx.state_op("pubsub_poll", channel=ACTOR_CHANNEL,
                                    cursor=cursor, timeout=1.0)
        states |= {m["state"] for m in msgs}
    assert "ALIVE" in states and "DEAD" in states


# ----------------------------------------------------------------- jobs
def test_job_submission_lifecycle(tmp_path):
    client = JobSubmissionClient(log_dir=str(tmp_path))
    jid = client.submit_job(
        entrypoint=f'{sys.executable} -c "import os; '
                   f"print('job says', os.environ['GREETING'], "
                   f"os.environ['RAY_TPU_JOB_ID'])\"",
        runtime_env={"env_vars": {"GREETING": "hi"}},
        metadata={"owner": "test"})
    assert client.wait_until_finished(jid, timeout=60) == SUCCEEDED
    logs = client.get_job_logs(jid)
    assert "job says hi" in logs and jid in logs
    info = client.get_job_info(jid)
    assert info.return_code == 0 and info.metadata["owner"] == "test"
    assert len(client.list_jobs()) == 1


def test_job_failure_and_stop(tmp_path):
    client = JobSubmissionClient(log_dir=str(tmp_path))
    bad = client.submit_job(
        entrypoint=f'{sys.executable} -c "raise SystemExit(3)"')
    assert client.wait_until_finished(bad, timeout=60) == FAILED
    assert client.get_job_info(bad).return_code == 3

    slow = client.submit_job(
        entrypoint=f'{sys.executable} -c "import time; time.sleep(600)"')
    time.sleep(0.5)
    assert client.stop_job(slow)
    assert client.wait_until_finished(slow, timeout=60) == STOPPED
    with pytest.raises(ValueError):
        client.get_job_status("nope")


def test_pubsub_stale_cursor_raises():
    from ray_tpu_torch._private.pubsub import Publisher, StaleCursorError
    pub = Publisher(maxlen_per_channel=4)
    for i in range(10):
        pub.publish("c", i)
    with pytest.raises(StaleCursorError):
        pub.poll("c", cursor=2)          # seqs 0..5 evicted
    msgs, _ = pub.poll("c", cursor=6)    # oldest retained
    assert msgs == [6, 7, 8, 9]
