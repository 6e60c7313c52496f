"""The seam under the port's hand-written kernels (`deepcut_tpu_torch.native`):
launch, count, tally, record, device check and load.

A kernel runs only on the card, so here a `native.Kernel` is driven over a
stub library: a Python object in the loaded libraries' place whose entry
logs its arguments and returns a chosen cudaError, and a stub current
stream. What is checked is the seam's own work: the device index and the
stream passed after the caller's arguments, the error named, each launch
counted exactly once from any number of threads, a capture's tally kept
apart from the live counts of other threads, geometries recorded only
while recording is on, and the op modules' counter attributes (read by
`portbench` and the no-JAX test) following the live counts.
"""

import ctypes
import shutil
import sys
import threading
from pathlib import Path

import pytest
import torch

from deepcut_tpu_torch import native, runtime
from deepcut_tpu_torch.ops import conv_epilogue, cuda_decode, int8_conv

STREAM = 0x5EED
CARD = torch.device("cuda", 3)


class _StubLibrary:
    """Stands for a loaded library: `stub_launch` logs its arguments and
    returns `err`."""

    def __init__(self):
        self.calls, self.err = [], 0

    def stub_launch(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def stub(monkeypatch):
    """A kernel over a stub library, on a stub stream; the seam's counts
    and recording restored afterwards."""
    lib = native.NativeLib(Path("stub_kernel.cu"))
    loaded = _StubLibrary()
    monkeypatch.setitem(native._loaded, lib, loaded)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: STREAM, raising=False)
    counts = native.counts()
    yield native.Kernel("stub", lib), loaded
    native.record_geometries(False)
    native.reset_counts()
    native.add_counts(counts)


def _count(name="stub"):
    return native.counts().get(name, 0)


def test_launch_passes_device_and_stream_and_counts_once(stub):
    kernel, lib = stub
    kernel(CARD, 11, None, 2.5)
    assert lib.calls == [(11, None, 2.5, 3, STREAM)] and _count() == 1
    kernel(CARD, 12, count=4)   # a call that launches four times
    assert lib.calls[-1] == (12, 3, STREAM) and _count() == 5
    prob = native.Kernel("stub", kernel.lib, device_arg=False)
    prob(CARD, 13)
    assert lib.calls[-1] == (13, STREAM) and _count() == 6


def test_counts_add_exactly_from_threads(stub):
    kernel, _ = stub
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def launch(n):
        for _ in range(1000):
            kernel(CARD, count=n)

    try:
        threads = [threading.Thread(target=launch, args=(n,)) for n in range(1, 9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _count() == 1000 * sum(range(1, 9))


def test_nonzero_return_raises_naming_the_kernel(stub):
    kernel, lib = stub
    lib.err = 700
    with pytest.raises(RuntimeError, match="^stub kernel launch failed: cudaError 700$"):
        kernel(CARD, 1, geometry=lambda: pytest.fail("a failed launch recorded a geometry"))
    assert _count() == 0


def test_geometries_recorded_only_while_recording(stub):
    kernel, _ = stub
    kernel(CARD, geometry=lambda: pytest.fail("recorded while recording is off"))
    assert native.geometries is None
    native.record_geometries(True)
    for values in ((0.5,), (0.25,)):   # the first call's values are kept
        kernel(CARD, geometry=lambda: (("view", 1), values))
    kernel(CARD, geometry=lambda: (("view", 2), ()))
    kernel(CARD)   # a launch with no geometry
    recorded = native.record_geometries(False)
    assert recorded == {"stub": {("view", 1): (0.5,), ("view", 2): ()}}
    assert native.geometries is None and _count() == 5
    native.record_geometries(True)
    assert native.record_geometries(True) == {}   # each start is afresh


def test_tally_leaves_other_threads_live(stub):
    """A thread's launches inside `tally` go to its tally; another
    thread's launches meanwhile count live; `add_counts` adds the tally
    (a replay)."""
    kernel, _ = stub
    inside, other_done = threading.Event(), threading.Event()

    def other():
        inside.wait(timeout=60)
        kernel(CARD, count=7)
        other_done.set()

    t = threading.Thread(target=other)
    t.start()
    with native.tally() as mine:
        kernel(CARD, count=5)
        inside.set()
        assert other_done.wait(timeout=60)
        kernel(CARD)
    t.join(timeout=60)
    assert mine == {"stub": 6} and _count() == 7
    native.add_counts(mine)
    native.add_counts(mine)
    assert _count() == 7 + 2 * 6


@pytest.mark.parametrize("module,attr,kernel", [
    (conv_epilogue, "launches", conv_epilogue.KERNEL),
    (cuda_decode, "launches", cuda_decode.FUSED),
    (cuda_decode, "prob_launches", cuda_decode.PROB),
    (int8_conv, "im2col_launches", int8_conv.IM2COL),
    (int8_conv, "epilogue_launches", int8_conv.EPILOGUE),
    (int8_conv, "quantize_launches", int8_conv.QUANTIZE),
])
def test_module_counters_follow_the_counts(module, attr, kernel, stub):
    """The counter attributes that `portbench` and the no-JAX test read
    return the live count of their kernel, replays and resets included."""
    before = getattr(module, attr)
    assert before == native.counts().get(kernel.name, 0)
    native.add_counts({kernel.name: 3})
    assert getattr(module, attr) == before + 3
    with native.tally() as mine:
        native.add_counts({kernel.name: 2})
    assert getattr(module, attr) == before + 3 and mine == {kernel.name: 2}
    native.reset_counts()
    assert getattr(module, attr) == 0
    with pytest.raises(AttributeError, match="no attribute 'launches_typo'"):
        getattr(module, "launches_typo")


def test_on_card_sends_cpu_to_plain_and_refuses_other_devices():
    class _OnCard:
        device = torch.device("cuda", 0)

    assert native.on_card(_OnCard(), "k") is True
    assert native.on_card(torch.zeros(1), "k") is False
    with pytest.raises(ValueError, match="^k: no kernel for device meta$"):
        native.on_card(torch.empty(1, device="meta"), "k")


def test_view_geometry():
    t = torch.zeros(2, 3, 4)[:, 1:, ::2]
    assert native.view_geometry(t) == ("torch.float32", (2, 2, 2), (12, 4, 2), 4)
    assert native.view_geometry(None) is None


def test_load_reports_a_missing_compiler_where_asked(monkeypatch):
    monkeypatch.setattr(native, "_loaded", {})
    lib = native.NativeLib(Path("absent.cpp"), (), lambda: "no-such-compiler-for-the-seam")
    assert native.load(lib, missing_ok=True) is None
    assert native._loaded == {lib: None}   # not tried again


def test_load_binds_the_entry_table():
    """The rasterizer through the seam: loaded once, its entry bound from
    its table."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the host library cannot be built")
    lib = runtime.load_library()
    assert lib is native.load(runtime.LIB) and lib is runtime.load_library()
    fn = lib.dc_rasterize
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(runtime.LIB.entries["dc_rasterize"]) == 32
