"""The int8 convolution's plan (``transeditor_tpu_torch/ops/quant.py``:
``plan_conv``, ``work_items``), on the CPU.

``conv2d_int8`` launches one of two hand-written kernels on the card,
chosen by ``plan_conv`` per geometry.  The wgmma kernel walks the plan's
work list; these tests check that it takes every main-path shape at the
batches the port serves and trains with, that the general path keeps the
shapes it cannot describe, and that the list covers the work exactly
once, heaviest first.  The kernels themselves are held bit-equal to the
plain version on the card (``tests/test_torch_port_cuda.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from transeditor_tpu_torch.ops import quant

# the 13 quantised convs of a 256px forward: (H, I, O, transposed)
MAIN = [(4, 512, 512, False), (4, 512, 512, True), (8, 512, 512, False),
        (8, 512, 512, True), (16, 512, 512, False), (16, 512, 512, True),
        (32, 512, 512, False), (32, 512, 512, True), (64, 512, 512, False),
        (64, 512, 256, True), (128, 256, 256, False), (128, 256, 128, True),
        (256, 128, 128, False)]
BF16 = quant._OUT_KIND[torch.bfloat16]


def _mode(transposed):
    return dict(stride=2, padding=0, transpose=True) if transposed else \
        dict(stride=1, padding=1, transpose=False)


def _plan(shape, o, k, mode, out_dtype=torch.bfloat16, **kw):
    """The plan ``conv2d_int8`` takes for these operand shapes."""
    xq = torch.zeros(shape, dtype=torch.int8)
    wq = torch.zeros((o, shape[3], k, k), dtype=torch.int8)
    return quant.prepare(xq, wq, out_dtype=out_dtype,
                         **{"padding": 0, "transpose": False, **mode},
                         **kw)[0]


def check_work_list(plan):
    """Every (output pixel, output channel) of every phase once per split
    slice, every (tap, 128-channel chunk) of a phase's K exactly once
    across a split, boxes within TMA's limits, heaviest first."""
    items = quant.work_items(plan).numpy()
    assert items.shape == (plan.n_items, 8) and items.dtype == np.int32
    z, b0, y0, x0, n0, k0, k1, s = items.T
    size = k1 - k0
    assert (size > 0).all()
    assert (np.diff(size) <= 0).all(), "not heaviest first"
    assert ((s >= 0) & (s < plan.split)).all()
    assert (n0 % plan.tile_n == 0).all()
    for p, (f, (nb, th, tw)) in enumerate(zip(plan.phases, plan.boxes)):
        assert nb * th * tw <= plan.tile_m and max(nb, th, tw) <= 256
        mine = items[z == p]
        count = np.zeros((plan.B, f.Hq, f.Wq, -(-plan.O // plan.tile_n)),
                         np.int32)
        for _, b, y, x, n, _, _, _ in mine:
            count[b:b + nb, y:y + th, x:x + tw, n // plan.tile_n] += 1
        assert (count == plan.split).all(), f"phase {p}: pixels not covered"
        # a box's K pieces: slices 0..split-1 in order, tiling [0, K)
        order = np.lexsort((mine[:, 5], mine[:, 4], mine[:, 3], mine[:, 2],
                            mine[:, 1]))
        pieces = mine[order].reshape(-1, plan.split, 8)
        assert (pieces[:, :, 1:5] == pieces[:, :1, 1:5]).all()
        assert (pieces[:, :, 7] == np.arange(plan.split)).all()
        assert (pieces[:, 0, 5] == 0).all()
        assert (pieces[:, 1:, 5] == pieces[:, :-1, 6]).all()
        assert (pieces[:, -1, 6] == f.taps * plan.nchunk).all()


@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("h,i,o,transposed", MAIN,
                         ids=[f"{'T' if t else 's1'}{h}-{i}-{o}"
                              for h, i, o, t in MAIN])
def test_main_path_shapes_take_wgmma_and_cover_the_work(batch, h, i, o,
                                                        transposed):
    plan = _plan((batch, h, h, i), o, 3, _mode(transposed))
    assert plan.path == "wgmma"
    assert len(plan.phases) == (4 if transposed else 1)
    assert plan.stages >= (3 if plan.tile_m * plan.tile_n > 128 ** 2 else 5)
    assert plan.smem <= quant._SMEM_LIMIT
    assert plan.grid == min(plan.n_items, quant.SM_COUNT)
    check_work_list(plan)


# (x shape, O, k, mode, path): the odd cases of chip_smoke.py phase 11a
# and tests/test_torch_port_cuda.py
ODD = [((2, 5, 7, 20), 6, 3, dict(stride=1, padding=1), "general"),
       ((1, 9, 9, 6), 20, 3, dict(stride=2, padding=0), "general"),
       ((1, 9, 7, 20), 6, 3, dict(stride=2, padding=0), "general"),
       ((2, 17, 15, 20), 6, 3, dict(stride=2, padding=0), "general"),
       ((2, 5, 6, 6), 20, 3, dict(stride=2, transpose=True), "general"),
       ((1, 11, 9, 64), 32, 1, dict(stride=1, padding=0), "general"),
       ((1, 7, 7, 512), 512, 3, dict(stride=2, transpose=True), "wgmma"),
       ((1, 5, 7, 20), 16, 3, dict(stride=1, padding=1), "wgmma"),
       ((3, 11, 13, 64), 40, 3, dict(stride=1, padding=1), "wgmma"),
       ((1, 7, 9, 20), 24, 3, dict(stride=2, transpose=True), "wgmma"),
       ((64, 4, 4, 512), 512, 3, dict(stride=1, padding=1), "wgmma")]


@pytest.mark.parametrize("shape,o,k,mode,path", ODD)
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16])
def test_odd_shapes_take_the_planned_path(shape, o, k, mode, path,
                                          out_dtype):
    plan = _plan(shape, o, k, mode, out_dtype)
    assert plan.path == path
    assert plan.Ip % 16 == 0 and plan.Ip >= shape[3]
    if path == "wgmma":
        check_work_list(plan)
    assert _plan(shape, o, k, mode, out_dtype, general=True).path == \
        "general"


@pytest.mark.parametrize("batch,h,transposed,split", [
    (64, 4, False, True), (1, 4, False, True), (1, 8, True, True),
    (64, 4, True, False), (64, 8, False, False), (64, 64, False, False),
    (64, 256, False, False)])
def test_k_is_split_only_where_the_sms_would_idle(batch, h, transposed,
                                                  split):
    row = next(r for r in MAIN if r[0] == h and r[3] == transposed)
    plan = _plan((batch, h, h, row[1]), row[2], 3, _mode(transposed))
    assert (plan.split > 1) == split
    assert plan.grid <= quant.SM_COUNT


@pytest.mark.parametrize("shape,o,out_dtype,tile,stages", [
    ((64, 4, 4, 512), 512, torch.bfloat16, (128, 128), 5),  # split: int32
    ((64, 8, 8, 512), 512, torch.bfloat16, (128, 128), 6),
    ((64, 64, 64, 512), 512, torch.bfloat16, (128, 256), 3),
    ((64, 64, 64, 512), 512, torch.float32, (128, 128), 5),
    ((64, 64, 64, 512), 512, torch.int32, (128, 128), 5),
    ((64, 256, 256, 128), 128, torch.bfloat16, (256, 128), 3),
    ((64, 256, 256, 128), 128, torch.float32, (128, 128), 5),
    ((64, 128, 128, 256), 128, torch.bfloat16, (128, 128), 6)])
def test_tile_and_ring_fit_shared_memory(shape, o, out_dtype, tile, stages):
    """A wide tile only for an unsplit bfloat16 output whose work items
    all have 4 K steps or more: 128 x 256 where O >= 256, 256 x 128 below
    (either stages 64 KB of output; the transposed 128 -> 256 channel
    conv has items of 2 steps); a split stages int32 partial sums
    whatever the output type; the ring takes what is left."""
    plan = _plan(shape, o, 3, _mode(shape[3] == 256 and o == 128),
                 out_dtype)
    assert ((plan.tile_m, plan.tile_n), plan.stages) == (tile, stages)
    assert plan.split == 1 or plan.tile_m * plan.tile_n == 128 ** 2
    assert plan.smem <= quant._SMEM_LIMIT


@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("b,hq,wq", [(64, 4, 4), (64, 9, 9), (1, 129, 129),
                                     (2, 256, 256), (3, 5, 300)])
def test_pixel_box_fills_its_rows(b, hq, wq, rows):
    nb, th, tw = quant.pixel_box(b, hq, wq, rows)
    assert 1 <= nb <= b and 1 <= th <= hq and 1 <= tw <= min(wq, rows)
    assert nb * th * tw <= rows
    boxes = -(-b // nb) * -(-hq // th) * -(-wq // tw)
    # no box of at most `rows` pixels covers the grid in fewer items
    least = min(-(-b // min(b, rows // (t * u))) * -(-hq // u) * -(-wq // t)
                for t in range(1, min(wq, rows) + 1)
                for u in range(1, min(hq, rows // t) + 1))
    assert boxes == least


def test_c_plans_mirror_the_structs():
    """The ctypes structs have the C structs' int fields in order:
    TeiPlan 13, TewPlan 19 + three arrays of 4."""
    assert ctypes.sizeof(quant._CPlan) == 13 * 4
    assert ctypes.sizeof(quant._CWgmmaPlan) == (19 + 12) * 4
    plan = _plan((2, 8, 8, 512), 512, 3, _mode(True))
    c = quant._c_plan(plan)
    assert (c.split, c.tile_m, c.tile_n, c.n_items, c.grid, c.stages,
            c.smem) == (plan.split, plan.tile_m, plan.tile_n, plan.n_items,
                        plan.grid, plan.stages, plan.smem)
    assert [(c.nb[z], c.th[z], c.tw[z]) for z in range(4)] == \
        list(plan.boxes)
    general = quant._c_plan(_plan((1, 9, 9, 6), 20, 3,
                                  dict(stride=2, padding=0)))
    assert (general.stride, general.Ho, general.Wo) == (2, 4, 4)
