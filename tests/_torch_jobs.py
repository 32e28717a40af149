"""Start and wait for a gloo job of tests/_torch_dist_worker.py: `world`
processes started as torchrun would start them (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), each logging to
WORKDIR/rank{r}.log, running WORKDIR/tasks.json in order."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(workdir: str, world: int) -> list:
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist_worker", workdir],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait(procs: list, workdir: str, timeout: float = 600.0) -> None:
    """Wait for every rank (killing what outlives `timeout`); raises with
    the ranks' log tails unless all exited 0."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    logs = [open(os.path.join(workdir, f"rank{r}.log")).read()[-4000:]
            for r in range(len(procs))]
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(logs)
