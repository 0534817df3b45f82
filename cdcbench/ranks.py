"""One process a card: the launcher of a cell that asks for several chips.

It starts ``run.py`` once a rank with torchrun's variables (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free
local port), so that the port's ``runtime.maybe_init_distributed`` joins
them. Rank 0 prints the result; the other ranks' output goes to temporary
files under ``TMPDIR`` and is shown only when a rank fails. When one rank
fails, the others are ended, and every rank is waited for.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

RANK_TIMEOUT_S = 1100


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script, argv, n: int) -> int:
    port = free_port()
    procs, logs = [], []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = None if rank == 0 else tempfile.TemporaryFile()
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *argv], env=env,
            stdout=log, stderr=subprocess.STDOUT if log else None))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    codes = [None] * n
    try:
        while None in codes:
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    for r, (code, log) in enumerate(zip(codes, logs)):
        if log is not None:
            if code != 0:
                log.seek(0)
                tail = log.read()[-4000:].decode(errors="replace")
                print(f"cdcbench: rank {r} exited {code}:\n{tail}",
                      file=sys.stderr)
            log.close()
    if any(codes[1:]):
        return codes[0] or 5
    return codes[0]
