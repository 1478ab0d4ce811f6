"""The benchmark's work arithmetic against torch.utils.flop_counter and
against the kernel bounds PERF.md keeps (section 6)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, TINY
from portbench.harness import arith, flops, runner, weights
from portbench.reference import train as ref_train

FULL = json.loads((ROOT / "portbench/configs/te256_bf16.json").read_text())
TRAIN = FULL["train"]


def tiny_model():
    return dict(FULL["model"], **TINY)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("mapped", [True, False])
def test_generator_forward_macs_equal_flop_counter(mapped):
    m = tiny_model()
    g, _ = weights.make(m, 1, "cpu", discriminator=False)
    z = torch.randn(3, 16, 32)
    p = torch.randn(3, 16, 32)
    got = counted(lambda: g(z, p, plus_space=not mapped))
    assert got == 2 * 3 * arith.generator_macs(m, mapped=mapped)


def test_discriminator_forward_macs_equal_flop_counter():
    m = tiny_model()
    _, d = weights.make(m, 1, "cpu")
    got = counted(lambda: d(torch.randn(4, 32, 32, 3)))
    assert got == 2 * 4 * arith.discriminator_macs(m)


def test_full_width_synthesis_is_the_documented_90_gflop():
    m = FULL["model"]
    convs = sum(c.macs for c in arith.styled_convs(m))
    assert convs == 45_071_990_784
    assert 2 * arith.generator_macs(m) / 1e9 == pytest.approx(90.97, abs=0.01)


@pytest.mark.parametrize("r1,path", [(False, False), (True, True),
                                     (False, True)])
def test_train_step_count_on_meta_equals_real_tensors(r1, path):
    """The meta-device count is flop_counter's rule applied to the
    reference's real step: the same number on real tensors."""
    m = tiny_model()
    g, d = weights.make(m, 1, "cpu")
    st = ref_train.init(g, d, TRAIN)
    real = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    dr = flops.draws(m, 4, 2, "cpu")
    with flops.CountFlops() as c:
        ref_train.step(st, real, dr, TRAIN, r1, path)
    assert c.total == flops.step_flops(m, TRAIN, 4, 2, r1, path)
    # the counting mode agrees with FlopCounterMode where both run
    z = torch.randn(2, 16, 32)
    with flops.CountFlops() as c2:
        g(z, z)
    assert c2.total == counted(lambda: g(z, z))


@pytest.mark.parametrize("transposed", [False, True])
def test_grouped_conv_backward_counts_each_group_once(transposed):
    """A convolution with a group per sample costs what the samples' own
    convolutions cost, forward and backward."""
    b, i, o, k, h = 3, 4, 5, 3, 6
    x = torch.randn(b, i, h, h, requires_grad=True)
    if transposed:
        w = torch.randn(b * i, o, k, k, requires_grad=True)

        def grouped():
            return torch.nn.functional.conv_transpose2d(
                x.reshape(1, b * i, h, h), w, stride=2, groups=b)

        def alone(n):
            return torch.nn.functional.conv_transpose2d(
                x[n:n + 1], w[n * i:(n + 1) * i], stride=2)
    else:
        w = torch.randn(b * o, i, k, k, requires_grad=True)

        def grouped():
            return torch.nn.functional.conv2d(x.reshape(1, b * i, h, h), w,
                                              padding=1, groups=b)

        def alone(n):
            return torch.nn.functional.conv2d(x[n:n + 1],
                                              w[n * o:(n + 1) * o], padding=1)

    with flops.CountFlops() as c:
        grouped().sum().backward()
    with flops.CountFlops() as each:
        for n in range(b):
            alone(n).sum().backward()
    assert c.total == each.total > 0


@pytest.mark.parametrize("model", ["tiny", "full"])
def test_train_step_count_holds_its_forwards(model):
    """A plain step holds at least its forwards (the fakes, D on fakes and
    reals, G and D in the G step) and at most three times each pass
    (forward, input gradient, weight gradient), at a tiny width on real
    tensors' shapes and at the cell's own width and batch on the meta
    device."""
    m, batch = (tiny_model(), 4) if model == "tiny" else (FULL["model"], 16)
    got = flops.step_flops(m, TRAIN, batch, batch // 2, False, False)
    G, D = arith.generator_macs(m), arith.discriminator_macs(m)
    assert got >= 2 * batch * (G + 2 * D + G + D)
    assert got <= 2 * batch * 3 * (G + 2 * D + G + D)


def test_blur_bytes_give_the_kernel_tables_bound():
    per = arith.blur_image_bytes(FULL["model"], "bfloat16")
    assert per == 61_985_536
    assert 64 * per / 3.35e12 * 1e3 == pytest.approx(1.184, abs=5e-4)


def test_rooflines_read_nothing_without_their_kernels():
    from portbench.harness.trace import TraceSummary

    class R:
        traced = TraceSummary(1.0, 0.5, {"other_kernel": [0.5, 3]}, {})
        data = {"traced_steps": {"plain": 1, "path": 0, "r1+path": 0,
                                 "r1": 0},
                "batch": 16, "path_batch": 8}
        cell = type("C", (), {"model": FULL["model"], "config": FULL})()

    assert runner.load_file("metrics", "blur_roofline.train").read(R) is None
