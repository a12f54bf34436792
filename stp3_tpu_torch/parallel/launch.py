"""Start a group of ranks on this host, as torchrun does, with a deadline.

``run_ranks(cmd, world, timeout_s)`` starts ``world`` copies of ``cmd``,
each with torchrun's environment (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a free local port),
and waits for all of them. A rank that exits non-zero ends the group at
once (the others would wait at their next collective until the group's
timeout), and so does the deadline: every process still running is
killed and the call raises. A collective that deadlocks therefore costs
the caller ``timeout_s``, never more.

``local_rank_of`` maps a rank to ``LOCAL_RANK``: by default each rank its
own card; ``share_device=True`` puts every rank on card 0 (several ranks
sharing one card over gloo, for a machine with one card).
"""
from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(cmd: Sequence[str], world: int, timeout_s: float,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
              share_device: bool = False) -> List[str]:
    """Run ``cmd`` as ranks 0..world-1; returns each rank's standard
    output (its standard error appended). Raises ``RuntimeError`` with the
    tail of a failed rank's output when one exits non-zero, and
    ``TimeoutError`` when the group outlives ``timeout_s``; either way no
    process of the group is left running."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world))
    with tempfile.TemporaryDirectory(prefix='stp3_ranks_') as logs:
        procs, files, failed = [], [], None
        try:
            for rank in range(world):
                f = open(os.path.join(logs, f'rank{rank}.log'), 'w+')
                files.append(f)
                procs.append(subprocess.Popen(
                    list(cmd), cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                    env={**base, 'RANK': str(rank),
                         'LOCAL_RANK': '0' if share_device else str(rank)}))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outputs = []
        for f in files:
            f.seek(0)
            outputs.append(f.read())
            f.close()
    if failed is not None:
        raise RuntimeError(f'rank {failed} of {world} exited with {procs[failed].returncode}; '
                           f'its output ends:\n{outputs[failed][-6000:]}')
    if not all(p.returncode == 0 for p in procs):
        late = [r for r, p in enumerate(procs) if p.returncode != 0]
        raise TimeoutError(f'ranks {late} of {world} still ran after {timeout_s:.0f} s and were '
                           f'killed; rank {late[0]} output ends:\n{outputs[late[0]][-6000:]}')
    return outputs
