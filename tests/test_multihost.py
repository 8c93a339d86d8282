"""REAL multi-process `jax.distributed` exercise.

Spawns two OS processes that form a 2-process / 4-device CPU process group
via `jax.distributed.initialize` (coordinator on 127.0.0.1), build the
global ("data", "space") mesh, run the full sharded encode step as ONE
SPMD program spanning both processes, and verify byte-identical containers
per process — the CI-runnable stand-in for a multi-host cluster
(BASELINE config 5; SURVEY §5.8). The reference has no analog: its
"distributed backend" is docker-exec + CSV rendezvous
(docker_manager.rs:227-255).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_encode():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=560)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid={pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid} imgs=2" in out, out[-3000:]
