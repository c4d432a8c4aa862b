"""Mesh, halo exchange, and sharded execution on the virtual 8-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ipp_tpu.parallel.halo import exchange_halos_z, sharded_map_blocks_z
from ipp_tpu.parallel.mesh import block_sharding, data_sharding, make_mesh


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(8, z_parallel=1)


def test_mesh_axes(mesh8):
    assert mesh8.shape == {"data": 8, "z": 1}
    m2 = make_mesh(8, z_parallel=2)
    assert m2.shape == {"data": 4, "z": 2}


def test_halo_exchange_z_matches_gather(rng):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("z",))
    vol = jnp.asarray(rng.standard_normal((16, 8, 8)).astype(np.float32))
    halo = 2

    def fn(block_ext):
        return block_ext  # identity: wrapper crops halos back off

    with mesh:
        sharded = jax.device_put(vol, NamedSharding(mesh, P("z", None, None)))
        out = jax.jit(sharded_map_blocks_z(fn, mesh, halo))(sharded)
        np.testing.assert_allclose(np.asarray(out), np.asarray(vol))

    # now verify halos carry REAL neighbor data: a mean-filter along z over
    # the extended block must equal the global mean filter (away from edges)
    def zmean(block_ext):
        k = 2 * halo + 1
        stack = jnp.stack([block_ext[i:block_ext.shape[0] - (k - 1 - i)]
                           for i in range(k)])
        m = jnp.mean(stack, axis=0)
        return jnp.pad(m, ((halo, halo), (0, 0), (0, 0)))

    with mesh:
        sharded = jax.device_put(vol, NamedSharding(mesh, P("z", None, None)))
        out = np.asarray(jax.jit(sharded_map_blocks_z(zmean, mesh, halo))(sharded))
    k = 2 * halo + 1
    ref_full = np.stack([np.asarray(vol)[i:16 - (k - 1 - i)]
                         for i in range(k)]).mean(axis=0)
    # out[halo + j] is the filter centered at plane halo + j == ref_full[j]:
    # exact everywhere away from the global edges, proving the halos carried
    # real neighbor data across shard boundaries
    np.testing.assert_allclose(out[halo:16 - halo], ref_full, atol=1e-5)


def test_data_sharding_destripe(mesh8, rng):
    from ipp_tpu.ops.destripe import filter_streaks

    tiles = jnp.asarray(rng.integers(0, 40000, (8, 64, 64)).astype(np.uint16))
    with mesh8:
        sharded = jax.device_put(tiles, data_sharding(mesh8, 3))
        ref = np.asarray(filter_streaks(tiles, sigma=(8, 8), wavelet="db3"))
        # shard_map per-device local programs
        from jax import shard_map

        f = shard_map(lambda t: filter_streaks(t, sigma=(8, 8), wavelet="db3"),
                      mesh=mesh8, in_specs=P(("data", "z"), None, None),
                      out_specs=P(("data", "z"), None, None))
        out = np.asarray(jax.jit(f)(sharded))
    np.testing.assert_array_equal(out, ref)


def test_sharded_rl_matches_blockwise(rng):
    """z-sharded RL over 4 devices == the single-device block pipeline with
    the same halo/crop decomposition (overlap-discard is the contract; the
    monolithic-FFT result differs only inside the halo-sized boundary)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from jax.sharding import Mesh

    from ipp_tpu.ops.deconv import richardson_lucy, richardson_lucy_sharded_z
    from ipp_tpu.ops.psf import gaussian_psf
    from scipy.ndimage import convolve as ndi_convolve, gaussian_filter

    truth = gaussian_filter(
        (rng.random((16, 32, 32)) > 0.98).astype(np.float32) * 1000, 0.8)
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    blurred = ndi_convolve(truth, psf, mode="constant").astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:4]), ("z",))
    halo = 2
    sharded_in = jax.device_put(
        jnp.asarray(blurred), NamedSharding(mesh, P("z", None, None)))
    out_sh = np.asarray(richardson_lucy_sharded_z(
        sharded_in, jnp.asarray(psf), mesh, niter=4, halo=halo))

    # single-device equivalent: same blocks, same halos, serial
    ref = np.zeros_like(blurred)
    for i in range(4):
        z0, z1 = 4 * i, 4 * (i + 1)
        lo = max(0, z0 - halo)
        hi = min(16, z1 + halo)
        block = blurred[lo:hi]
        # edge devices replicate the boundary plane like exchange_halos_z
        pad_top = halo - (z0 - lo)
        pad_bot = halo - (hi - z1)
        if pad_top:
            block = np.concatenate([np.repeat(block[:1], pad_top, 0), block])
        if pad_bot:
            block = np.concatenate([block, np.repeat(block[-1:], pad_bot, 0)])
        from ipp_tpu.ops.deconv import fft_shape_for

        fshape = fft_shape_for(block.shape, psf.shape)
        dec = np.asarray(richardson_lucy(jnp.asarray(block), jnp.asarray(psf),
                                         niter=4, fft_shape=fshape))
        ref[z0:z1] = dec[halo:halo + 4]
    # the contract: the distributed result equals the serial block pipeline
    # bit-for-bit (up to float tolerance).  (Deconvolution *quality* at this
    # toy scale is meaningless: 4-plane slabs are entirely inside the edge
    # taper; production slabs are hundreds of planes.)
    np.testing.assert_allclose(out_sh, ref, rtol=1e-4, atol=1e-2)
    assert np.isfinite(out_sh).all() and out_sh.max() > 0


def test_run_tile_pipeline_resume_and_corrupt(tmp_path, rng):
    """Executor: batching, resume skip, corrupt-file zero substitution."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.executor import TileTask, run_tile_pipeline

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    tasks = []
    for i in range(6):
        p = in_dir / f"t{i}.tif"
        tio.imwrite(p, np.full((16, 16), i + 1, np.uint16))
        tasks.append(TileTask(p, out_dir / f"t{i}.tif"))
    # corrupt one input
    (in_dir / "t3.tif").write_bytes(b"not a tiff at all")

    counters = run_tile_pipeline(tasks, lambda b: b * 2, batch_size=4,
                                 reader_threads=2, writer_threads=2)
    assert counters["done"] == 5  # real tiles
    assert counters["failed"] == 1  # the corrupt one, zero-substituted
    out3 = tio.imread(out_dir / "t3.tif")
    assert (out3 == 0).all()
    out2 = tio.imread(out_dir / "t2.tif")
    assert (out2 == 6).all()

    # resume: everything skipped
    counters2 = run_tile_pipeline(tasks, lambda b: b * 2, resume=True)
    assert counters2["skipped"] == 6 and counters2["done"] == 0


def _wedge_reader(path):
    """Picklable shim codec for the sandbox test: wedges forever on files
    named *wedge*, decodes everything else normally (spawned sandbox
    workers import this by qualified name)."""
    import time
    from pathlib import Path as _P

    from ipp_tpu.io import tiff as _tio

    if "wedge" in _P(path).name:
        time.sleep(600)
    return _tio.imread(path)


def test_run_tile_pipeline_process_sandbox_recovers(tmp_path):
    """VERDICT r4 item 3: read_sandbox='process' decodes in a kill-able
    worker.  A wedged decode (sleep in the shim codec) must be KILLED at
    the deadline — not abandoned on a leaked thread — the worker
    respawned, and the pool must finish the remaining tiles
    (reference pystripe/core.py:1710-1755)."""
    import time

    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.executor import TileTask, run_tile_pipeline

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    tasks = []
    wedge = in_dir / "a_wedge.tif"  # sorts first; single reader hits it
    tio.imwrite(wedge, np.full((16, 16), 7, np.uint16))
    tasks.append(TileTask(wedge, out_dir / "a_wedge.tif"))
    for i in range(4):
        p = in_dir / f"t{i}.tif"
        tio.imwrite(p, np.full((16, 16), i + 1, np.uint16))
        tasks.append(TileTask(p, out_dir / f"t{i}.tif"))

    t0 = time.time()
    counters = run_tile_pipeline(
        tasks, lambda b: b * 2, batch_size=2, reader_threads=1,
        writer_threads=1, reader=_wedge_reader, read_timeout=3.0,
        read_sandbox="process", expected_shape=(16, 16))
    elapsed = time.time() - t0
    assert counters["done"] == 4
    assert counters["failed"] == 1  # the wedged tile, zero-substituted
    # the worker was killed and respawned (not waited out): well under
    # the 600 s wedge, and the respawn counter observed the kill
    assert elapsed < 120, elapsed
    assert counters["sandbox_respawns"] >= 1
    assert (tio.imread(out_dir / "a_wedge.tif") == 0).all()
    for i in range(4):
        assert (tio.imread(out_dir / f"t{i}.tif") == 2 * (i + 1)).all()


def test_sandboxed_reader_timeout_raises_timeout_error(tmp_path):
    """The deadline miss must surface as TimeoutError — builtin
    TimeoutError subclasses OSError, and a careless except-order turns
    it into the worker-died RuntimeError (review finding r5), which
    would misroute the executor's timeout->zero-tile branch."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.sandbox import SandboxedReader

    wedge = tmp_path / "a_wedge.tif"
    tio.imwrite(wedge, np.zeros((8, 8), np.uint16))
    with SandboxedReader(reader=_wedge_reader, timeout=2.0) as sb:
        with pytest.raises(TimeoutError):
            sb.read(wedge)
        # pool recovers: next read respawns and serves
        good = tmp_path / "good.tif"
        tio.imwrite(good, np.full((8, 8), 5, np.uint16))
        assert (sb.read(good) == 5).all()
        assert sb.respawns == 1


def test_sandboxed_reader_decode_error_keeps_worker(tmp_path):
    """A decode *exception* (corrupt file) must surface as RuntimeError
    without killing the worker; the same worker then serves good reads."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.sandbox import SandboxedReader

    good = tmp_path / "good.tif"
    tio.imwrite(good, np.full((8, 8), 3, np.uint16))
    bad = tmp_path / "bad.tif"
    bad.write_bytes(b"not a tiff")
    with SandboxedReader(timeout=30.0) as sb:
        with pytest.raises(RuntimeError):
            sb.read(bad)
        out = sb.read(good)
        assert (out == 3).all()
        assert sb.respawns == 0  # exception path keeps the worker


def test_run_tile_pipeline_all_failed_still_emits(tmp_path):
    """A read failing before ANY successful read must still write a dummy
    tile (reference guarantee, pystripe/core.py:1730-1755) — round-1 gap."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.executor import TileTask, run_tile_pipeline

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    tasks = []
    for i in range(3):
        p = in_dir / f"t{i}.tif"
        p.write_bytes(b"corrupt")
        tasks.append(TileTask(p, out_dir / f"t{i}.tif"))
    counters = run_tile_pipeline(
        tasks, lambda b: (b * 2).astype(np.uint16), batch_size=2,
        reader_threads=2, writer_threads=1,
        expected_shape=(8, 8), expected_dtype=np.uint16)
    assert counters["failed"] == 3 and counters["done"] == 0
    for i in range(3):
        out = tio.imread(out_dir / f"t{i}.tif")
        assert out.shape == (8, 8) and (out == 0).all()


def test_run_tile_pipeline_lagged_fetch_failure(tmp_path):
    """The lagged device->host fetch keeps one batch in flight; a batch
    whose materialization fails must count its tiles failed WITHOUT
    hanging the writer threads or dropping later batches."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.executor import TileTask, run_tile_pipeline

    class Lazy:
        """Device-array stand-in: async copy kick + deferred fetch."""

        def __init__(self, arr, fail):
            self._arr, self._fail = arr, fail

        def copy_to_host_async(self):
            pass

        def __array__(self, dtype=None, copy=None):
            if self._fail:
                raise RuntimeError("simulated device fetch failure")
            return self._arr

    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    tasks = []
    for i in range(8):
        p = in_dir / f"t{i}.tif"
        tio.imwrite(p, np.full((8, 8), i + 1, np.uint16))
        tasks.append(TileTask(p, out_dir / f"t{i}.tif"))

    def proc(batch):
        # fail exactly the batch containing value 3 (tile index 2)
        return Lazy(batch * 2, fail=bool((batch == 3).any()))

    counters = run_tile_pipeline(tasks, proc, batch_size=2,
                                 reader_threads=1, writer_threads=2)
    assert counters["done"] == 6 and counters["failed"] == 2
    written = sorted(q.name for q in out_dir.glob("*.tif"))
    assert len(written) == 6
    assert not (out_dir / "t2.tif").exists()  # failed batch: t2+t3
    assert not (out_dir / "t3.tif").exists()
    assert (tio.imread(out_dir / "t7.tif") == 16).all()


def test_run_tile_pipeline_dummy_shape_per_dir(tmp_path):
    """Dummy shape comes from the same input directory, not the last-seen
    batch of a differently-shaped directory."""
    from ipp_tpu.io import tiff as tio
    from ipp_tpu.parallel.executor import TileTask, run_tile_pipeline

    a = tmp_path / "a"
    b = tmp_path / "b"
    out_dir = tmp_path / "out"
    a.mkdir()
    b.mkdir()
    tio.imwrite(a / "t0.tif", np.ones((8, 8), np.uint16))
    tio.imwrite(b / "t0.tif", np.ones((12, 12), np.uint16))
    (b / "t1.tif").write_bytes(b"corrupt")
    tasks = [TileTask(a / "t0.tif", out_dir / "a0.tif"),
             TileTask(b / "t0.tif", out_dir / "b0.tif"),
             TileTask(b / "t1.tif", out_dir / "b1.tif")]
    counters = run_tile_pipeline(tasks, lambda x: x, batch_size=1,
                                 reader_threads=1, writer_threads=1)
    assert counters["done"] == 2 and counters["failed"] == 1
    assert tio.imread(out_dir / "b1.tif").shape == (12, 12)


def test_distributed_helpers_single_process():
    """Multi-host helpers degrade gracefully on one process (the real
    multi-host path cannot run here; structure + slicing logic tested)."""
    import jax

    from ipp_tpu.parallel.distributed import (device_put_global, initialize,
                                              global_mesh, is_multihost,
                                              process_slice)

    assert initialize() is False  # no coordinator env: single process
    assert not is_multihost()
    mesh = global_mesh(z_parallel=2)
    assert dict(mesh.shape) == {"data": 4, "z": 2}
    assert process_slice(10) == (0, 10)
    from ipp_tpu.parallel.mesh import data_sharding

    arr = np.arange(32, dtype=np.float32).reshape(8, 4)
    out = device_put_global(arr, data_sharding(global_mesh(), 2))
    np.testing.assert_array_equal(np.asarray(out), arr)


def test_progress_modes(monkeypatch):
    """IPP_TPU_PROGRESS=off silences the bar; =log emits newline lines
    (the reference --noprogressbar/--logprogress pair)."""
    import io

    from ipp_tpu.utils.progress import ProgressReporter

    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")
    s = io.StringIO()
    p = ProgressReporter(3, desc="x", stream=s)
    for _ in range(3):
        p.step()
    p.close()
    assert s.getvalue() == ""

    monkeypatch.setenv("IPP_TPU_PROGRESS", "log")
    s = io.StringIO()
    p = ProgressReporter(3, desc="x", stream=s)
    for _ in range(3):
        p.step()
    p.close()
    v = s.getvalue()
    assert "\r" not in v and v.endswith("\n") and "3/3" in v


def test_one_in_flight_pipeline():
    from ipp_tpu.utils.lagged import OneInFlight

    class H:
        def __init__(self):
            self.kicked = 0

        def copy_to_host_async(self):
            self.kicked += 1

    lag = OneInFlight()
    h1, h2 = H(), H()
    assert lag.put("a", h1) is None
    assert h1.kicked == 1
    assert lag.put("b", h2) == "a"   # one batch in flight
    assert lag.put("c") == "b"       # no handle: numpy-style item
    assert lag.flush() == ["c"]
    assert lag.flush() == []
    # depth=0 serializes (the IPP_TPU_EXEC_ASYNC=0 A/B lever)
    ser = OneInFlight(depth=0)
    assert ser.put("x") == "x"
    assert ser.flush() == []
    # handles without copy_to_host_async are tolerated
    assert OneInFlight().put("y", object(), None) is None


def test_ram_admission_gate(monkeypatch):
    """utils.memory: the explicit RAM gate (reference
    free_ram_is_not_enough, parallel_image_processor.py:210-217) blocks
    under pressure, never deadlocks (bounded by timeout), and the
    worker cap mirrors the reference's merge_step_cores model
    (process_images.py:644-655)."""
    import time

    from ipp_tpu.utils import memory

    avail = memory.available_ram_bytes()
    assert avail is not None and avail > 0  # /proc/meminfo on Linux

    # plenty available: returns immediately
    t0 = time.monotonic()
    memory.ram_gate(1024)
    assert time.monotonic() - t0 < 0.1

    # simulated pressure: bounded wait, proceeds after timeout
    monkeypatch.setattr(memory, "available_ram_bytes", lambda: 100)
    t0 = time.monotonic()
    memory.ram_gate(10**12, poll_s=0.02, timeout_s=0.1)
    dt = time.monotonic() - t0
    assert 0.08 < dt < 2.0

    # kill switch
    monkeypatch.setenv("IPP_TPU_RAM_GATE", "0")
    t0 = time.monotonic()
    memory.ram_gate(10**12, timeout_s=5.0)
    assert time.monotonic() - t0 < 0.1
    monkeypatch.delenv("IPP_TPU_RAM_GATE")

    # worker cap: fits (avail - reserve) / per_worker, floor 1
    monkeypatch.setattr(memory, "available_ram_bytes",
                        lambda: 10 * 2**30)
    assert memory.workers_for_ram(2 * 2**30, 16) == 4
    assert memory.workers_for_ram(100 * 2**30, 16) == 1
    assert memory.workers_for_ram(0.1 * 2**30, 4) == 4
    monkeypatch.setattr(memory, "available_ram_bytes", lambda: None)
    assert memory.workers_for_ram(2**30, 8) == 8  # unknown: trust caller


def _platform_reader(path):
    """Picklable shim codec: returns the JAX platform the sandbox worker
    computes on, as bytes."""
    import jax

    return np.frombuffer(jax.devices()[0].platform.encode(), np.uint8)


def test_sandbox_worker_stays_off_the_gpu(tmp_path, monkeypatch):
    """A decode worker never opens the parent's card: even when the parent
    environment asks for CUDA, the worker's JAX runs on the CPU (a second
    process on a card would fail for want of the memory the parent
    reserved)."""
    from ipp_tpu.parallel.sandbox import SandboxedReader

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with SandboxedReader(reader=_platform_reader, timeout=120.0) as sb:
        assert bytes(sb.read(tmp_path / "unused.tif")).decode() == "cpu"
