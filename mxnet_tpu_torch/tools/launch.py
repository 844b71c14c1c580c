#!/usr/bin/env python
"""Job launcher: spawn N worker processes with the dist env protocol.

The port's own copy of the JAX package's ``tools/launch.py`` (the
reference's ``tools/launch.py`` + ``dmlc_tracker/local.py``).  Every
process is a worker; rank 0 hosts the ``torch.distributed`` TCP store
at the coordinator address.  The launcher's jobs are the env handshake,
output fan-in (each line prefixed with its worker's rank) and failure
detection with a clean abort: the first worker to fail, or the timeout,
takes the whole job down (SIGTERM, then SIGKILL) instead of leaving the
others hung in a collective.  Every child is reaped with a timeout.

Usage::

    python3 -m mxnet_tpu_torch.tools.launch -n 2 [--coordinator
        127.0.0.1:9876] [--timeout 600] python3 train.py --epochs 10

Workers join with ``mxnet_tpu_torch.parallel.dist.initialize()`` (no
arguments).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["launch", "main"]

_REAP_S = 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(proc, rank):
    prefix = f"[worker-{rank}] ".encode()
    out = sys.stdout.buffer
    for line in iter(proc.stdout.readline, b""):
        out.write(prefix + line)
        out.flush()


def _reap(procs):
    """SIGTERM every live worker, wait up to ``_REAP_S`` for all, then
    SIGKILL and wait for the rest."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    t_end = time.monotonic() + _REAP_S
    for p in procs:
        try:
            p.wait(timeout=max(0.1, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=_REAP_S)


def launch(n: int, cmd, coordinator: str = None, env_extra=None,
           timeout: float = None) -> int:
    """Spawn ``n`` workers running ``cmd``; returns the job's exit code:
    0 only if every worker exits 0, the first failing worker's code
    otherwise, 124 on ``timeout`` (seconds)."""
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    procs, pumps = [], []
    for rank in range(n):
        env = dict(os.environ)
        env.update(env_extra or {})
        env.update({
            "MXNET_TPU_COORDINATOR": coordinator,
            "MXNET_TPU_NUM_PROCS": str(n),
            "MXNET_TPU_PROC_ID": str(rank),
            # reference-compatible names for ported scripts
            "DMLC_NUM_WORKER": str(n),
            "DMLC_WORKER_ID": str(rank),
        })
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append(p)
        t = threading.Thread(target=_pump, args=(p, rank), daemon=True,
                             name=f"launch-pump-{rank}")
        t.start()
        pumps.append(t)

    deadline = time.monotonic() + timeout if timeout else None
    failed_rank, rc = None, 0
    try:
        while True:
            alive = False
            for rank, p in enumerate(procs):
                code = p.poll()
                if code is None:
                    alive = True
                elif code != 0 and failed_rank is None:
                    failed_rank, rc = rank, code
            if failed_rank is not None or not alive:
                break
            if deadline and time.monotonic() > deadline:
                failed_rank, rc = -1, 124
                break
            time.sleep(0.05)
    finally:
        if failed_rank is not None:
            what = "timeout" if failed_rank == -1 \
                else f"worker-{failed_rank} exited rc={rc}"
            sys.stderr.write(f"launch: {what} — aborting remaining "
                             f"workers\n")
        _reap(procs)
        for t in pumps:
            t.join(timeout=_REAP_S)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Launch an N-process mxnet_tpu_torch job (local mode)")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store (default: a free "
                         "local port)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill the job after this many seconds")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VALUE for workers (repeatable)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no worker command given")
    extra = dict(kv.split("=", 1) for kv in args.env)
    return launch(args.num_workers, args.command,
                  coordinator=args.coordinator, env_extra=extra,
                  timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
