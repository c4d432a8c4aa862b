"""Kill-able process sandbox for hostile/corrupt image decodes.

The reference isolates each worker's decode in a 1-task
ProcessPoolExecutor it can kill and respawn on timeout
(pystripe/core.py:1710-1755); the thread-deadline fallback in
parallel/executor.py merely *abandons* a wedged decode — the daemon
thread keeps holding memory and file handles for the process lifetime.
This module restores the reference's reclaim semantics: one worker
process per reader, killed outright on deadline and respawned for the
next read (VERDICT r4 item 3).

The decode result crosses the process boundary by pickling — the same
copy overhead the reference documents for its own sandbox ("adds up to
30 percent overhead for copying the data from one process to another",
convert.py:386-390).  Use the thread mode for trusted inputs; the
process mode for corrupt-prone ones.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
from typing import Callable, Optional

import numpy as np

__all__ = ["SandboxedReader"]


def _sandbox_child(conn, reader: Optional[Callable]) -> None:
    """Worker loop: receive (path, frame), decode, send back the array.
    Runs until the parent sends None or kills the process.

    The child decodes on the host only: it pins JAX to the CPU before
    anything could initialise a backend, so it never takes a share of the
    parent's card (unpickling `reader` may already have imported jax,
    hence the config update as well as the variable)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")
    if reader is None:
        from ipp_tpu.io import tiff as tio

        reader = tio.imread
    # readiness handshake: spawn + imports can take seconds under load;
    # the parent must not charge them against the per-decode deadline
    conn.send(("ready", None))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None:
            return
        path, frame = msg
        try:
            if frame is None:
                img = np.asarray(reader(path))
            else:
                from ipp_tpu.io.dcimg import dcimg_imread

                img = np.asarray(dcimg_imread(path, frame))
            conn.send(("ok", img))
        except BaseException as exc:  # noqa: BLE001 - report, don't die
            try:
                conn.send(("err", f"{type(exc).__name__}: {exc}"))
            except Exception:
                return


class SandboxedReader:
    """One kill-able decode worker.

    read() forwards to the worker and waits up to `timeout` seconds; a
    deadline miss KILLS the worker (reclaiming its memory/file handles,
    unlike a leaked daemon thread) and raises TimeoutError — the next
    read respawns a fresh worker.  Decode exceptions in the worker
    surface as RuntimeError without costing the worker.
    """

    def __init__(self, reader: Optional[Callable] = None,
                 timeout: Optional[float] = 300.0):
        # spawn (not fork): the parent holds JAX/GPU state and live
        # threads that must not be inherited mid-flight
        self._ctx = mp.get_context("spawn")
        self._reader = reader
        self._timeout = timeout
        self._proc = None
        self._conn = None
        self.respawns = 0  # observable for tests/metrics

    def _ensure_worker(self) -> None:
        if self._proc is not None and self._proc.is_alive():
            return
        if self._proc is not None:
            self.respawns += 1
        parent_conn, child_conn = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_sandbox_child, args=(child_conn, self._reader),
            daemon=True)
        self._proc.start()
        child_conn.close()
        self._conn = parent_conn
        # wait for the child's import phase OUTSIDE the decode deadline
        if not parent_conn.poll(120):
            self._kill()
            raise RuntimeError("sandbox worker failed to start in 120s")
        status, _ = parent_conn.recv()
        assert status == "ready", status

    def _kill(self) -> None:
        if self._proc is not None:
            self._proc.kill()  # SIGKILL: a wedged decode ignores SIGTERM
            self._proc.join(5)
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def read(self, path, frame: Optional[int] = None) -> np.ndarray:
        self._ensure_worker()
        try:
            self._conn.send((str(path), frame))
            if self._timeout and self._timeout > 0:
                if not self._conn.poll(self._timeout):
                    self._kill()
                    raise TimeoutError(
                        f"sandboxed decode exceeded {self._timeout}s: "
                        f"{path} (worker killed)")
            status, payload = self._conn.recv()
        except TimeoutError:
            # deliberate: builtin TimeoutError subclasses OSError, so it
            # must escape BEFORE the worker-died handler below or the
            # executor's timeout->zero-tile branch never sees it
            raise
        except (EOFError, OSError, BrokenPipeError) as exc:
            # worker died mid-decode (segfault in a codec, OOM-kill):
            # reclaim and report; next read respawns
            self._kill()
            raise RuntimeError(f"sandbox worker died decoding {path}: "
                               f"{exc}") from exc
        if status != "ok":
            raise RuntimeError(f"sandboxed decode failed for {path}: "
                               f"{payload}")
        return payload

    def close(self) -> None:
        if self._proc is not None and self._proc.is_alive():
            try:
                self._conn.send(None)
                self._proc.join(2)
            except Exception:
                pass
            if self._proc.is_alive():
                self._kill()
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self._proc = None  # a later read() is a fresh start, not a respawn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
