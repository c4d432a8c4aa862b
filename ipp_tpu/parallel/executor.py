"""Streaming tile executor: host IO threads feeding batched device calls.

Replaces the reference's process-pool runtimes (pystripe
MultiProcessQueueRunner, pystripe/core.py:1687-1771; parallel_image_processor
MultiProcess, parallel_image_processor.py:219-445) with a single-process
design suited to one-accelerator-many-cores hosts:

- reader threads decode tiles into a bounded queue (backpressure = the
  reference's RAM admission semaphore, parallel_image_processor.py:210-217),
- tiles of equal shape are batched and processed by one jitted device call
  (amortizing dispatch; XLA overlaps H2D/compute/D2H),
- writer threads commit outputs atomically,
- failures: a corrupt/hung read is replaced by a zero tile and counted
  (the reference's timeout->dummy fallback, pystripe/core.py:1730-1755),
- resume: existing outputs are skipped (pystripe/core.py:1511).
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io import tiff as tio
from ..utils.progress import ProgressReporter

__all__ = ["TileTask", "run_tile_pipeline"]


@dataclass
class TileTask:
    input_path: Path
    output_path: Path
    # multi-frame container (DCIMG) tasks carry the frame index; plain
    # image files leave it None (reference process_dc_images z_idx,
    # pystripe/core.py:1649-1684)
    frame: Optional[int] = None


@dataclass
class _Batch:
    tasks: List[TileTask]
    imgs: List[np.ndarray]


def run_tile_pipeline(
    tasks: Sequence[TileTask],
    process_batch: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 8,
    reader_threads: int = 8,
    writer_threads: int = 4,
    resume: bool = False,
    compression: Optional[str] = None,
    progress_desc: str = "tiles",
    reader: Optional[Callable[[Path], np.ndarray]] = None,
    read_timeout: Optional[float] = 300.0,
    expected_shape: Optional[Tuple[int, int]] = None,
    expected_dtype=np.uint16,
    read_sandbox: str = "thread",
) -> Dict[str, int]:
    """Run `process_batch` over all tasks; returns counters
    {'done', 'skipped', 'failed'}.

    Failed/hung reads ALWAYS produce an output tile (zeros pushed through
    `process_batch` so shape/dtype match real outputs) — the reference's
    dummy-substitution guarantee (pystripe/core.py:1730-1755); without it
    the stitcher would see holes in the output series.  The dummy shape
    comes from the first successful read in the same input directory, then
    any successful read, then `expected_shape`.  Dummies count once, under
    'failed'.

    read_sandbox: 'thread' (default) abandons a hung decode on a daemon
    thread; 'process' decodes in a kill-able worker process per reader
    that is SIGKILLed and respawned on deadline — full resource reclaim
    for hostile/corrupt-prone inputs, matching the reference's 1-task
    ProcessPoolExecutor sandbox (pystripe/core.py:1710-1755).  The
    process mode requires a picklable `reader`."""
    tasks = [t for t in tasks]
    counters = {"done": 0, "skipped": 0, "failed": 0}
    lock = threading.Lock()
    if resume:
        remaining = []
        for t in tasks:
            if t.output_path.exists():
                counters["skipped"] += 1
            else:
                remaining.append(t)
        tasks = remaining
    if not tasks:
        return counters

    read_fn = reader or tio.imread
    if expected_shape is not None:
        # RAM-sized pool cap (the reference's merge_step_cores model,
        # process_images.py:644-655): each reader holds one decoded tile
        # plus its queue slot; f32 intermediates on device don't count
        from ..utils.memory import workers_for_ram

        tile_b = (int(np.prod(expected_shape))
                  * np.dtype(expected_dtype).itemsize)
        reader_threads = workers_for_ram(8 * tile_b, reader_threads)
    prog = ProgressReporter(len(tasks), desc=progress_desc)
    in_q: "queue.Queue[Optional[Tuple[TileTask, Optional[np.ndarray]]]]" = (
        queue.Queue(maxsize=4 * batch_size))
    out_q: "queue.Queue[Optional[Tuple[TileTask, np.ndarray]]]" = (
        queue.Queue(maxsize=4 * batch_size))

    task_iter = iter(tasks)
    iter_lock = threading.Lock()

    def _read_with_deadline(fn, *args):
        """Run one decode on a DAEMON thread with a deadline: a genuinely
        hung read (stuck NFS, kernel D-state) is abandoned — it cannot
        occupy a pool worker forever nor block interpreter exit (the
        reference kills the whole 1-task worker process for this,
        pystripe/core.py:1710-1755)."""
        if not (read_timeout and read_timeout > 0):
            return fn(*args)
        box = {}
        done = threading.Event()

        def run():
            try:
                box["v"] = fn(*args)
            except BaseException as exc:  # noqa: BLE001
                box["e"] = exc
            done.set()

        threading.Thread(target=run, daemon=True).start()
        if not done.wait(read_timeout):
            raise TimeoutError
        if "e" in box:
            raise box["e"]
        return box["v"]

    from ..utils.memory import ram_gate

    tile_nbytes = [0]  # set from the first decoded tile

    assert read_sandbox in ("thread", "process"), read_sandbox
    sandboxes: List = []  # live SandboxedReaders, closed on exit
    sandbox_lock = threading.Lock()

    def read_worker():
        sandbox = None
        if read_sandbox == "process":
            from .sandbox import SandboxedReader

            sandbox = SandboxedReader(reader, timeout=read_timeout)
            with sandbox_lock:
                sandboxes.append(sandbox)
        while True:
            with iter_lock:
                t = next(task_iter, None)
            if t is None:
                in_q.put(None)
                return
            # explicit RAM admission (the reference's
            # free_ram_is_not_enough poll, parallel_image_processor.py:
            # 210-217): each reader needs headroom for its decode plus
            # the batches already queued — gate on ~4 tiles' worth
            ram_gate(4 * tile_nbytes[0])
            try:
                # timeout sandbox: a hung/corrupt read becomes a zero tile
                if sandbox is not None:
                    img = np.asarray(sandbox.read(t.input_path, t.frame))
                elif t.frame is None:
                    img = np.asarray(_read_with_deadline(
                        read_fn, t.input_path))
                else:
                    from ..io.dcimg import dcimg_imread

                    img = np.asarray(_read_with_deadline(
                        dcimg_imread, t.input_path, t.frame))
            except TimeoutError:
                print(f"read timeout, substituting zeros: {t.input_path}")
                img = None
            except Exception:
                traceback.print_exc()
                img = None  # zero-tile substitution downstream
            if img is not None and not tile_nbytes[0]:
                tile_nbytes[0] = img.nbytes
            in_q.put((t, img))

    def write_worker():
        while True:
            item = out_q.get()
            if item is None:
                return
            t, img, is_dummy = item
            try:
                t.output_path.parent.mkdir(parents=True, exist_ok=True)
                tio.imwrite(t.output_path, img, compression=compression)
                with lock:
                    counters["failed" if is_dummy else "done"] += 1
            except Exception:
                traceback.print_exc()
                with lock:
                    counters["failed"] += 1
            prog.step()

    readers = [threading.Thread(target=read_worker, daemon=True)
               for _ in range(reader_threads)]
    writers = [threading.Thread(target=write_worker, daemon=True)
               for _ in range(writer_threads)]
    for th in readers + writers:
        th.start()

    # batch by shape/dtype so each jit executable sees uniform batches
    pending: Dict[Tuple, _Batch] = {}
    finished_readers = 0
    dummy_ids = set()  # id(task) of zero-substituted tiles: count as failed

    # lagged fetch: batch k's result streams device->host
    # (copy_to_host_async) while batch k+1 uploads/dispatches — the same
    # one-in-flight pipeline as the merge and decon loops, so the two
    # transfer directions overlap.  IPP_TPU_EXEC_ASYNC=0
    # forces the serialized dispatch->fetch order (A/B lever; mirrors
    # IPP_TPU_MERGE_ASYNC).
    import os as _os

    from ..utils.lagged import OneInFlight

    lag = OneInFlight(
        depth=1 if _os.environ.get("IPP_TPU_EXEC_ASYNC", "1") != "0" else 0)

    def drain_one(item):
        from ..utils import iostat

        tasks, dev = item
        try:
            with iostat.span("device_process"):  # fetch wait
                out = np.asarray(dev)
            assert out.shape[0] == len(tasks)
            for t, o in zip(tasks, out):
                out_q.put((t, o, id(t) in dummy_ids))
        except Exception:
            traceback.print_exc()
            with lock:
                counters["failed"] += len(tasks)
            for _ in tasks:
                prog.step()

    def flush(key):
        from ..utils import iostat

        b = pending.pop(key, None)
        if b is None or not b.imgs:
            return
        batch = np.stack(b.imgs)
        try:
            with iostat.span("device_process",
                             batch.nbytes):  # upload+dispatch
                dev = process_batch(batch)
            done = lag.put((b.tasks, dev), dev)
        except Exception:
            traceback.print_exc()
            with lock:
                counters["failed"] += len(b.tasks)
            for _ in b.tasks:
                prog.step()
            return
        if done is not None:
            drain_one(done)

    def enqueue(t: TileTask, img: np.ndarray):
        key = (img.shape, str(img.dtype))
        b = pending.setdefault(key, _Batch([], []))
        b.tasks.append(t)
        b.imgs.append(img)
        if len(b.imgs) >= batch_size:
            flush(key)

    # dummy shape: first successful read in the same input dir, then any
    # successful read, then the caller-provided expectation
    dir_hints: Dict[Path, Tuple] = {}
    global_hint: Optional[Tuple] = None
    deferred: List[TileTask] = []  # failed before any usable shape hint

    def hint_for(t: TileTask) -> Optional[Tuple]:
        h = dir_hints.get(t.input_path.parent, global_hint)
        if h is None and expected_shape is not None:
            h = (tuple(expected_shape), np.dtype(expected_dtype))
        return h

    while finished_readers < reader_threads:
        item = in_q.get()
        if item is None:
            finished_readers += 1
            continue
        t, img = item
        if img is None:
            dummy_ids.add(id(t))
            h = hint_for(t)
            if h is not None:
                enqueue(t, np.zeros(h[0], h[1]))
            else:
                deferred.append(t)
            continue
        dir_hints.setdefault(t.input_path.parent, (img.shape, img.dtype))
        global_hint = global_hint or (img.shape, img.dtype)
        enqueue(t, img)
    for t in deferred:
        h = hint_for(t)
        if h is None:
            # nothing succeeded and no expectation given: still emit a
            # file (the reference never leaves a hole in the series)
            h = ((16, 16), np.dtype(expected_dtype))
            print(f"no shape hint for dummy tile {t.output_path}; "
                  "writing 16x16 zeros")
        enqueue(t, np.zeros(h[0], h[1]))
    for key in list(pending):
        flush(key)
    for item in lag.flush():
        drain_one(item)

    for _ in writers:
        out_q.put(None)
    for th in writers:
        th.join()
    for sb in sandboxes:
        sb.close()
    if sandboxes:
        counters["sandbox_respawns"] = sum(sb.respawns for sb in sandboxes)
    prog.close()
    return counters
