"""Listener authentication: the shared-secret handshake gates every
accepted connection BEFORE any frame is unpickled (the wire is pickle,
so an open listener is an RCE surface; reference scopes this via its
tokened client/job servers, python/ray/util/client/server/).

The port's twin of `tests/test_auth.py`, case for case.
"""
import os
import subprocess
import sys
import textwrap


def test_auth_token_gates_listener(tmp_path):
    """With RAY_TPU_AUTH_TOKEN set: workers (inheriting the token) run
    tasks normally, while an unauthenticated raw connection and a
    wrong-token connection are both refused without deserializing
    anything."""
    out = tmp_path / "out.txt"
    src = textwrap.dedent(f"""
        import pickle, socket, struct, time
        import ray_tpu_torch

        rt = ray_tpu_torch.init(num_cpus=2)

        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        assert ray_tpu_torch.get(f.remote(41), timeout=60) == 42  # authed path

        host, port = rt.address
        LEN = struct.Struct("<Q")

        def probe(first_frames):
            s = socket.create_connection((host, port))
            s.settimeout(5.0)
            try:
                for fr in first_frames:
                    s.sendall(LEN.pack(len(fr)) + fr)
                # server must close without replying. A clean FIN
                # (recv -> b"") and an RST (ConnectionResetError) are
                # BOTH rejection: the server closes with our trailing
                # frame still unread, so the kernel may reset — which
                # race wins depends on box load (this was a flake).
                try:
                    data = s.recv(1024)
                except ConnectionResetError:
                    return True           # reset == refused, no data
                except (TimeoutError, OSError):
                    return False          # no close, no data: fail
                return data == b""        # clean close == rejected
            finally:
                s.close()

        # 1) no token, straight to a pickled frame (the RCE attempt)
        evil = pickle.dumps({{"type": "ping"}})
        assert probe([evil]), "unauthenticated frame was not rejected"
        # 2) wrong token
        assert probe([b"wrong-token", evil]), "bad token accepted"

        # runtime still healthy after the rejected probes
        assert ray_tpu_torch.get(f.remote(1), timeout=60) == 2
        with open({str(out)!r}, "w") as fh:
            fh.write("ok")
        ray_tpu_torch.shutdown()
    """)
    env = dict(os.environ)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = pkg + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_AUTH_TOKEN"] = "s3cret-token"
    env.pop("RAY_TPU_NODE_ID", None)
    p = subprocess.run([sys.executable, "-c", src], env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert out.read_text() == "ok"
