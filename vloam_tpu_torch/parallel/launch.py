"""Start the ranks of an SPMD program as local processes.

The JAX reference drives all its devices from one process; the port runs
one process per rank (parallel/sharded.py). launch() starts N copies of a
Python command line under sys.executable with torchrun's environment (RANK,
LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a free
MASTER_PORT; OMP_NUM_THREADS, where unset, shares the cores out), so
``sharded.data_mesh()`` in each builds the group. Rank 0
keeps stdout; the other ranks' stdout is discarded (their errors are not),
so rank 0 alone prints, and programs let rank 0 alone write files.

The first rank to exit nonzero ends the run: the others are killed and its
code is returned. A run that outlasts `timeout` is killed whole and gives
124, the code of timeout(1). No rank is left running either way.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int, base=None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    # the ranks share the cores: oversubscribed OpenMP pools stall every
    # small op (as torchrun, which sets 1)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    return env


def launch(args: list[str], n: int, timeout: float | None = None,
           env: dict | None = None) -> int:
    """Run `python args...` as ranks 0..n-1; returns 0, the first nonzero
    exit code, or 124 on timeout."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, *args], env=rank_env(r, n, port, env),
        stdout=None if r == 0 else subprocess.DEVNULL) for r in range(n)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()

