"""The frozen roofline and operation arithmetic against the bounds that
the port's kernel table states (``chip_smoke.py``'s arithmetic)."""
import pytest

from portbench import flops, roofline
from portbench.tracing import Trace, _function

ENCODE = dict(loop="train", B=4096, T=64, N=4, view=7, tile=8, obs="encode",
              torso="mlp", hidden=128, rnn="", cw=14, epochs=2, minibatches=4)
IMAGE = dict(ENCODE, T=32, obs="image", torso="cnn_s2d", rnn="gru", cw=0)


def us(s):
    return s * 1e6


def test_k1_bound():
    assert us(roofline.k1_s(4096, 196)) == pytest.approx(1.92, abs=0.005)


@pytest.mark.parametrize("R,S,bound", [(4, 4096, 2.91), (2048, 128, 46.55)])
def test_k2f_k2b_bounds(R, S, bound):
    assert us(roofline.k2f_s(R, 147, S, 49, 14, 128)) == pytest.approx(
        bound, abs=0.005)
    if R == 2048:
        assert us(roofline.k2b_s(R, 147, S, 49, 14, 128)) == pytest.approx(
            bound, abs=0.005)


@pytest.mark.parametrize("images,bound", [(262144, 782.21), (16384, 48.89)])
def test_k3_bounds(images, bound):
    assert us(roofline.k3_s(images, 7, 8)) == pytest.approx(bound, abs=0.01)


def test_calls_a_step():
    enc = roofline.calls(ENCODE)
    assert {k: sum(n for _, n in v) for k, v in enc.items()} == {
        "k1": 65, "k2f": 73, "k2b": 8}
    img = roofline.calls(IMAGE)
    assert {k: sum(n for _, n in v) for k, v in img.items()} == {
        "k1": 41, "k3": 41}
    act = roofline.calls(dict(ENCODE, loop="rollout", B=32768, T=16))
    assert {k: sum(n for _, n in v) for k, v in act.items()} == {
        "k1": 17, "k2f": 17}
    # the update's re-render: T * B / M envs a minibatch, N images an env
    assert img["k3"][1][0] == pytest.approx(roofline.k3_s(4 * 32768, 7, 8))


def test_operations():
    # the encode mlp forward: 147 codes x 128 adds, three dense layers
    assert flops.forward_ops(ENCODE) == 147 * 128 + 2 * 128 * 128 \
        + 2 * 128 * 7 + 2 * 128
    f = flops.forward_ops(IMAGE)
    assert 11.5e6 < f < 12.0e6
    step = flops.call_ops(ENCODE)
    assert step == pytest.approx(65 * 4 * 4096 * flops.forward_ops(ENCODE)
                                 + 2 * 64 * 4 * 4096 * 3
                                 * flops.forward_ops(ENCODE))


class _Event:
    def __init__(self, name, cat, start, dur):
        self._n, self._c, self._s, self._d = name, cat, start, dur

    def name(self):
        return self._n

    def activity_type(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_function_names():
    assert _function("void (anonymous namespace)::transpose_bk_kernel("
                     "int const*, int*, int, int)") == "transpose_bk_kernel"
    assert _function("void (anonymous namespace)::compose_kernel<16, "
                     "(anonymous namespace)::Layout>(int const*)") \
        == "compose_kernel"


def test_trace_busy_gaps_and_share():
    k1 = "void (anonymous namespace)::transpose_bk_kernel(int const*)"
    ev = [_Event(k1, "kernel", 0, 1000), _Event(k1, "kernel", 500, 1000),
          _Event("memset", "gpu_memset", 3000, 1000),
          _Event("cudaGraphLaunch", "cuda_runtime", 1000, 2500)]
    tr = Trace([ev])
    assert tr.busy_s == pytest.approx(2500e-9)
    assert tr.gaps == [(pytest.approx(1500e-9), 1500, 3000)]
    assert tr.breakdown()["idle_gaps"][0][0] == "cudaGraphLaunch"
    assert tr.kernel_s("transpose_bk_kernel") == (pytest.approx(2e-6), 2)
    shape = dict(ENCODE, loop="rollout", T=1, B=4096)
    # two K1 launches a call (T + 1 = 2) of 1.92 us least time in 2 us
    share = roofline.share(tr, dict(shape, obs="image"), "k1", 2)
    assert share == pytest.approx(100 * 2 * roofline.k1_s(4096, 196) / 2e-6)
    assert roofline.share(tr, shape, "k1", 3) is None      # miscounted
    assert roofline.share(tr, shape, "k2b", 0) is None     # not on the path
    # the window is the device's own span, 0 to 4000 ns: host time the
    # profiler's buffer flush held after the call is not in it
    late = ev + [_Event("Buffer Flush", "overhead", 4000, 90000)]
    tr = Trace([late, late])
    assert tr.window_s == pytest.approx(2 * 4000e-9)
    assert tr.idle_share() == pytest.approx(1 - 2500e-9 / 4000e-9)
    # nor is a device gap the flush held inside the span (1500 to 3000 ns)
    tr = Trace([ev + [_Event("Buffer Flush", "overhead", 1400, 1700)]])
    assert tr.profiler_s == pytest.approx(1500e-9)
    assert tr.idle_share() == pytest.approx(1 - 2500e-9 / 2500e-9)
