"""Start the ranks of an SPMD program as local processes.

The JAX reference drives all its devices from one process; the port runs
one process per rank (parallel/sharded.py). launch() starts N copies of a
Python command line under sys.executable with torchrun's environment (RANK,
LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1,
MASTER_PORT; OMP_NUM_THREADS, where unset, shares out the cores the
launcher may run on), so
``sharded.data_mesh()`` in each builds the group. As torchrun's agent does,
the launcher itself hosts the group's TCPStore, bound to a port the system
picks and held open until the ranks are done, and
TORCHELASTIC_USE_AGENT_STORE makes every rank join it as a client: no rank
binds a port, so no other program can take one between its choice and its
use. Rank 0 keeps stdout;
the other ranks' stdout is discarded, so rank 0 alone prints, and programs
let rank 0 alone write files. Each rank's stderr is kept and passed on when
the ranks are done.

The first rank to exit nonzero ends the run: the others are killed and its
code is the run's. A run that outlasts `timeout` is killed whole and gives
124, the code of timeout(1). No rank is left running either way.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import NamedTuple

import torch.distributed as dist

TAIL_BYTES = 4000  # of each rank's stderr, in a failure's report


class Launch(NamedTuple):
    """How the ranks ended: `code` is 0, the first nonzero exit code or 124
    (the timeout); `codes` each rank's exit code (negative: killed by that
    signal); `tails` the end of each rank's stderr."""

    code: int
    codes: list[int]
    tails: list[str]

    def report(self) -> str:
        return "\n".join(
            f"rank {r} exited {c}; its stderr ends:\n"
            + (t.rstrip() or "(empty)")
            for r, (c, t) in enumerate(zip(self.codes, self.tails)))


def rank_env(rank: int, n: int, port: int, base=None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True")
    # the ranks share the cores this process may run on (its affinity, not
    # the host's count): oversubscribed OpenMP pools stall every small op
    # (as torchrun, which sets 1)
    cores = len(os.sched_getaffinity(0))
    env.setdefault("OMP_NUM_THREADS", str(max(1, cores // n)))
    # a rank that dies on a signal (an abort in C++) prints its Python
    # stack to the stderr its report keeps
    env.setdefault("PYTHONFAULTHANDLER", "1")
    return env


def launch(args: list[str], n: int, timeout: float | None = None,
           env: dict | None = None) -> Launch:
    """Run `python args...` as ranks 0..n-1 and wait for them."""
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          timeout=timedelta(seconds=60),
                          wait_for_workers=False)
    errs = [tempfile.TemporaryFile() for _ in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, *args], env=rank_env(r, n, store.port, env),
        stdout=None if r == 0 else subprocess.DEVNULL, stderr=errs[r])
        for r in range(n)]
    try:
        code = _wait(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for f in errs:
            f.seek(0)
            err = f.read()
            f.close()
            sys.stderr.buffer.write(err)
            tails.append(err[-TAIL_BYTES:].decode(errors="replace"))
        sys.stderr.flush()
    del store
    return Launch(code, [p.returncode for p in procs], tails)


def _wait(procs, timeout: float | None) -> int:
    deadline = None if timeout is None else time.monotonic() + timeout
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
