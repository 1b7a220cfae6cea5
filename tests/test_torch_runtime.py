"""The port's Device / Buffer / Program object model (paper §4 workflow),
held to the cases of ``tests/test_runtime_objects.py`` on the CPU device,
plus the port's own rules: discovery lists CUDA devices only, the package
needs no JAX, and results agree with the reference's runtime."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.core import Dim3, get_all_devices, registry, wait_all

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def device():
    devices = get_all_devices(1, 0, platform="cpu").get()  # Listing 1, CPU on request
    assert len(devices) == 1
    return devices[0]


def test_torch_default_discovery_lists_no_cpu_device():
    devices = get_all_devices().get()
    assert all(d.platform == "cuda" for d in devices)
    assert len(devices) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)


def test_torch_unknown_platform_fails():
    with pytest.raises(ValueError, match="unknown platform"):
        get_all_devices(platform="tpu").get()


def test_torch_get_all_devices_future_and_capability_filter(device):
    assert get_all_devices(99, 0, platform="cpu").get() == []
    assert device.capability() >= (1, 0)
    assert device.is_local and device.key == "cpu:0"
    assert device.default_stream.cuda_stream is None  # CPU streams are host lanes only


def test_torch_device_registered_in_agas(device):
    assert registry.resolve(device.gid) is device
    assert registry.placement(device.gid).device_key == device.key


def test_torch_package_imports_without_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        import repro_torch.core, repro_torch.kernels
        import repro_torch.configs, repro_torch.models.convert, repro_torch.serving.serve_step
        import repro_torch.models.ssm_lm, repro_torch.kernels.ssd_scan.ops
        import repro_torch.models.moe, repro_torch.models.encdec, repro_torch.models.hybrid
        from repro_torch.configs import get_config
        for arch in ("qwen2-moe-a2.7b", "phi3.5-moe", "starcoder2-7b", "whisper-tiny",
                     "qwen2-vl-72b", "hymba-1.5b"):
            get_config(arch)
        from repro_torch.kernels import all_kernels
        all_kernels()
        assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules), "imports repro"
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_torch_buffer_roundtrip(device):
    buf = device.create_buffer(16, np.float32).get()
    assert buf.dtype == torch.float32 and buf.nbytes == 64
    data = np.arange(16, dtype=np.float32)
    buf.enqueue_write(0, data).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), data)


def test_torch_buffer_write_from_tensor_and_2d_shape(device):
    buf = device.create_buffer((2, 3), torch.int32, fill=5).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.full((2, 3), 5))
    buf.enqueue_write(0, torch.arange(6, dtype=torch.int32)).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.arange(6).reshape(2, 3))


def test_torch_buffer_offset_window_write_read(device):
    buf = device.create_buffer(10, np.int32, fill=0).get()
    buf.enqueue_write(3, np.array([7, 8, 9], dtype=np.int32)).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), [0, 0, 0, 7, 8, 9, 0, 0, 0, 0])
    np.testing.assert_array_equal(buf.enqueue_read_sync(offset=3, count=3), [7, 8, 9])


def test_torch_buffer_window_bounds_raise_value_error(device):
    buf = device.create_buffer(8, np.int32).get()
    for offset, count in [(-1, 2), (0, 9), (7, 2), (9, 0), (0, -1), (-3, None)]:
        with pytest.raises(ValueError, match="out of range"):
            buf.enqueue_read(offset, count)
    with pytest.raises(ValueError, match="out of range"):
        buf.enqueue_write(-1, np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        buf.enqueue_write(6, np.zeros(4, np.int32))  # 6 + 4 > 8
    with pytest.raises(ValueError, match="out of range"):
        buf.enqueue_write(0, np.zeros(4, np.int32), count=9)
    with pytest.raises(ValueError, match="exceeds"):
        buf.enqueue_write(0, np.zeros(4, np.int32), count=6)
    buf.enqueue_write(6, np.array([5, 6], np.int32)).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(6, 2), [5, 6])
    assert buf.enqueue_read_sync(8, 0).size == 0  # empty tail window


def test_torch_buffer_window_bounds_property(device):
    """Any (offset, count) window is either fully inside the buffer — and
    round-trips exactly — or raises ValueError; never silently clamped."""
    size = 16
    buf = device.create_buffer(size, np.int32).get()
    base = np.arange(size, dtype=np.int32)
    buf.enqueue_write(0, base).get()

    @settings(max_examples=30, deadline=None)
    @given(
        offset=st.integers(min_value=-3, max_value=size + 3),
        count=st.integers(min_value=-2, max_value=size + 3),
    )
    def check(offset, count):
        if 0 <= offset and 0 <= count and offset + count <= size:
            out = buf.enqueue_read_sync(offset, count)
            np.testing.assert_array_equal(out, base[offset: offset + count])
            buf.enqueue_write(offset, base[offset: offset + count], count=count).get()
            np.testing.assert_array_equal(buf.enqueue_read_sync(), base)
        else:
            with pytest.raises(ValueError, match="out of range"):
                buf.enqueue_read(offset, count)
            with pytest.raises(ValueError, match="out of range"):
                buf.enqueue_write(offset, np.zeros(max(count, 0), np.int32), count=count)

    check()


def test_torch_buffer_async_writes_are_ordered(device):
    buf = device.create_buffer(4, np.int32).get()
    futs = [buf.enqueue_write(0, np.full(4, i, np.int32)) for i in range(8)]
    wait_all(futs)
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.full(4, 7))


def test_torch_buffer_free_releases_and_retires_record(device):
    buf = device.create_buffer(8, np.float32).get()
    gid = buf.gid
    assert buf.free() is buf.free()  # one release, however many callers
    buf.free().get()
    with pytest.raises(KeyError):
        registry.placement(gid)
    with pytest.raises(RuntimeError, match="freed"):
        buf.enqueue_read_sync()


@pytest.mark.parametrize("what", ["buffer", "program"])
def test_torch_finalizer_under_the_registry_lock_does_not_deadlock(device, what):
    """A garbage collection can run at any allocation, also on a thread
    that holds the AGAS registry's lock: a collected buffer's or program's
    finalizer must not take that lock (it deadlocked the thread, and then
    every thread asking the registry).  Its record is dropped at the next
    registry call instead."""
    import gc
    import threading

    obj = (device.create_buffer(4, np.float32) if what == "buffer"
           else device.create_program({"k": lambda x: x})).get()
    gid = obj.gid
    cycle = [obj]
    cycle.append(cycle)  # reachable only through a reference cycle
    del obj

    def collect_under_the_lock():
        nonlocal cycle
        with registry._lock:
            cycle = None
            gc.collect()  # the finalizer runs here, on this thread

    t = threading.Thread(target=collect_under_the_lock, daemon=True)
    t.start()
    t.join(timeout=10)
    deadlocked = t.is_alive()
    if deadlocked:  # let the stuck finalizer through, so the tests after this one run
        registry._lock.release()
        t.join(timeout=10)
    assert not deadlocked, "the finalizer deadlocked on the registry lock"
    with pytest.raises(KeyError):
        registry.placement(gid)


def test_torch_program_listing2_workflow(device):
    """The paper's Listing 2, end to end, through both packages: sum of n
    elements."""
    import jax.numpy as jnp

    from repro import core as ref

    n = 1000
    host = np.ones(n, dtype=np.int32)

    def listing2(dev, kernel, dim3):
        futures = []
        inbuf = dev.create_buffer(n, np.int32).get()
        futures.append(inbuf.enqueue_write(0, host))
        resbuf = dev.create_buffer(1, np.int32).get()
        futures.append(resbuf.enqueue_write(0, np.zeros(1, np.int32)))
        prog = dev.create_program({"sum": kernel}, name="sum-prog").get()
        futures.append(prog.build("sum"))
        wait_all(futures)  # Listing 2 line 38
        prog.run([inbuf, resbuf], "sum", grid=dim3(1), block=dim3(32), out=[resbuf]).get()
        return resbuf.enqueue_read_sync(0, 1)

    got = listing2(device, lambda x, r: r + x.sum(dtype=torch.int32), Dim3)
    want = listing2(ref.get_all_devices(1, 0).get()[0],
                    lambda x, r: r + jnp.sum(x, dtype=jnp.int32), ref.Dim3)
    assert int(got[0]) == n
    np.testing.assert_array_equal(got, np.asarray(want))


def test_torch_program_from_file_percolation(device, tmp_path):
    src = textwrap.dedent(
        """
        def scale(x, s):
            return x * s

        KERNELS = {"scale": scale}
        """
    )
    path = tmp_path / "kernel.py"
    path.write_text(src)
    prog = device.create_program_with_file(str(path)).get()
    assert prog.kernel_names() == ["scale"]

    buf = device.create_buffer_from(np.arange(4.0, dtype=np.float32)).get()
    out = prog.run([buf, np.float32(2.0)], "scale").get()
    np.testing.assert_allclose(out.numpy(), [0.0, 2.0, 4.0, 6.0])


def test_torch_program_build_is_cached(device):
    prog = device.create_program({"inc": lambda x: x + 1}, name="cache").get()
    spec = torch.zeros((8,), dtype=torch.float32)
    f1 = prog.build("inc", spec)
    f2 = prog.build("inc", spec)
    assert f1.get() is f2.get()


def test_torch_program_missing_kernel_fails(device):
    prog = device.create_program({"a": lambda x: x}, name="p").get()
    with pytest.raises(KeyError):
        prog.build("nope").get()


def test_torch_kernel_receives_grid_block(device):
    seen = {}

    def k(x, grid=None, block=None):
        seen["grid"], seen["block"] = grid, block
        return x

    prog = device.create_program({"k": k}, name="gb").get()
    buf = device.create_buffer_from(np.zeros(2, np.float32)).get()
    prog.run([buf], "k", grid=Dim3(4, 2, 1), block=(128, 1, 1)).get()
    assert seen["grid"] == (4, 2, 1)
    assert seen["block"] == (128, 1, 1)


def test_torch_copy_to_same_process_device_updates_agas(device):
    buf = device.create_buffer_from(np.arange(6.0, dtype=np.float32)).get()
    moved = buf.copy_to(device).get()
    assert moved.gid != buf.gid
    np.testing.assert_allclose(moved.enqueue_read_sync(), np.arange(6.0))
    assert registry.placement(moved.gid).device_key == device.key


def test_torch_launch_out_rebinds_buffer_to_fresh_tensor(device):
    """``out=[input]`` (fig 3's in-place stencil) rebinds the buffer to the
    kernel's fresh output instead of writing over the input it reads."""
    prog = device.create_program({"shift": lambda x: torch.roll(x, 1)}, name="roll").get()
    buf = device.create_buffer_from(np.arange(5, dtype=np.float32)).get()
    before = buf.array()
    prog.run([buf], "shift", out=[buf]).get()
    assert buf.array() is not before
    np.testing.assert_array_equal(before.numpy(), np.arange(5))
    np.testing.assert_array_equal(buf.enqueue_read_sync(), [4, 0, 1, 2, 3])
