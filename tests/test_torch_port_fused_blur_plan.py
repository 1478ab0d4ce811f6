"""``plan_tiles``: how ``fused_blur4`` cuts a call into tiles for the TMA
kernel, checked here on the CPU (the kernel itself runs only on the card,
``tests/test_torch_port_cuda.py``).  Pure arithmetic on shapes: no JAX.
"""

import pytest
import torch

from transeditor_tpu_torch.ops import fused_blur as fb
from torch_port_threads import torch_worker_threads  # noqa: F401

MAIN_SHAPES = [(9, 512), (17, 512), (33, 512), (65, 512), (129, 256),
               (257, 128)]          # fused_blur4 inputs of a 256px forward
MAIN_CASES = [((b, h, h, c), (1, 1), dtype)
              for b in (1, 8, 64) for h, c in MAIN_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
ODD_CASES = [((2, 17, 17, 64), (1, 1), torch.bfloat16),
             ((2, 11, 23, 20), (1, 1), torch.float32),
             ((2, 12, 9, 8), (2, 1), torch.bfloat16),
             ((2, 12, 9, 8), (2, 1), torch.float32),
             ((1, 68, 300, 64), (1, 1), torch.bfloat16),   # ragged edges
             ((1, 68, 300, 64), (1, 1), torch.float32)]
BOX_MAX = 256                  # TMA: each box dim
SMEM_LIMIT = 232_448           # bytes of shared memory a block may use


def _plan(shape, pad, dtype, **kw):
    return fb.plan_tiles(*shape, dtype, pad, **kw)


def _loads(p, i):
    """TMA box origins (c, w, h, b) the kernel's producer asks for in tile
    ``i``: one input row a ring slot (``fused_blur4_tma_kernel``)."""
    b, oy0, rows_out, ox0, _, c0 = p.tile(i)
    return [(c0, ox0 - p.p0, oy0 - p.p0 + j, b) for j in range(rows_out + 3)]


def _box(p):
    """The TMA box, innermost first: (channels, columns, rows, batch)."""
    return (p.cc, p.wt + 3, 1, 1)


def _ids(case):
    shape, pad, dtype = case
    return f"{'x'.join(map(str, shape))}-p{pad[0]}{pad[1]}-{str(dtype)[6:]}"


@pytest.mark.parametrize("case", MAIN_CASES + ODD_CASES, ids=_ids)
def test_tiles_cover_every_output_once(case):
    p = _plan(*case)
    assert p.path == "tma"
    tiles = [p.tile(i) for i in range(p.n_tiles)]
    assert len(set(tiles)) == p.n_tiles == (p.B * p.n_seg * p.n_strip
                                            * p.n_chunk)

    def partition(spans, n):
        covered = sorted(spans)
        assert covered[0][0] == 0
        assert all(a[0] + a[1] == b[0] for a, b in zip(covered, covered[1:]))
        assert covered[-1][0] + covered[-1][1] == n
        assert all(length > 0 for _, length in covered)

    partition({(t[1], t[2]) for t in tiles}, p.Ho)      # row segments
    partition({(t[3], t[4]) for t in tiles}, p.Wo)      # column strips
    partition({(t[5], p.cc) for t in tiles}, p.C)       # channel chunks
    assert {t[0] for t in tiles} == set(range(p.B))
    # every (batch, segment, strip, chunk) once: the spans multiply out
    assert len({(t[0], t[1], t[3], t[5]) for t in tiles}) == p.n_tiles


@pytest.mark.parametrize("case", MAIN_CASES + ODD_CASES, ids=_ids)
def test_loads_reach_exactly_the_halo(case):
    """Each tile asks TMA for its rows and columns, starting p0 before
    the tile and ending 3 after (the 4-tap window), one row a slot."""
    p = _plan(*case)
    for i in range(p.n_tiles):
        b, oy0, rows_out, ox0, cols_out, c0 = p.tile(i)
        loads = _loads(p, i)
        assert len(loads) == rows_out + 3
        assert loads[0] == (c0, ox0 - p.p0, oy0 - p.p0, b)
        assert all(ld[:2] == (c0, ox0 - p.p0) and ld[3] == b
                   and ld[2] == loads[0][2] + j
                   for j, ld in enumerate(loads))
        # the box's columns are the strip's, with its 3-column halo
        assert cols_out <= p.wt


@pytest.mark.parametrize("case", MAIN_CASES + ODD_CASES, ids=_ids)
def test_plan_fits_tma_and_the_sm(case):
    p = _plan(*case)
    item = 4 if p.dtype == torch.float32 else 2
    assert all(1 <= d <= BOX_MAX for d in _box(p))
    assert p.cc * item % 16 == 0 and p.C % p.cc == 0
    slot = -(-p.cc * (p.wt + 3) * item // 128) * 128   # 128-byte aligned
    assert p.stages >= 3
    assert p.smem >= p.stages * slot + 16 * p.stages
    assert p.smem <= SMEM_LIMIT
    assert p.threads % 32 == 0 and 64 <= p.threads <= 288
    assert (p.threads - 32) >= p.wt * p.cc * item // 16   # a thread a vector
    assert 1 <= p.grid <= p.n_tiles
    # even rounds: every block walks the same number of tiles, give or
    # take the last
    rounds = -(-p.n_tiles // p.grid)
    assert p.grid * (rounds - 1) < p.n_tiles <= p.grid * rounds


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("h,c", MAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_fills_the_card_at_batch(batch, h, c, dtype):
    """At batch >= 8 every main-path shape keeps at least 90% of the 132
    SMs busy (a block of 256 computing threads each), with long row
    segments: at batch 64 the four larger shapes are not split at all."""
    p = fb.plan_tiles(batch, h, h, c, dtype, (1, 1))
    assert p.grid >= fb.SM_COUNT * 9 // 10
    if batch == 64 and h >= 33:
        assert p.seg == p.Ho


@pytest.mark.parametrize("h,c", MAIN_SHAPES[2:])
def test_batch_one_spreads_over_the_sms(h, c):
    """At batch 1 the rows are split so that the larger shapes still
    reach 90% of the SMs."""
    p = fb.plan_tiles(1, h, h, c, torch.bfloat16, (1, 1))
    assert p.grid >= fb.SM_COUNT * 9 // 10 and p.seg < p.Ho


@pytest.mark.parametrize("case", MAIN_CASES + ODD_CASES, ids=_ids)
def test_persistent_blocks_walk_every_tile_once(case):
    """Block k walks tiles k, k + grid, ... (the kernel's loop): together
    the blocks take every tile once, in rounds that differ by at most
    one."""
    p = _plan(*case)
    walks = [range(k, p.n_tiles, p.grid) for k in range(p.grid)]
    assert sorted(t for w in walks for t in w) == list(range(p.n_tiles))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


@pytest.mark.parametrize("h,c", MAIN_SHAPES[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_64_blocks_take_several_tiles(h, c, dtype):
    """At batch 64, 17x17 and up, every block walks two or more tiles and
    its ring wraps within them, so the ring's slots and phases run on
    across tile boundaries (the card runs these plans in phase 2b of
    chip_smoke.py and in the batch-64 forward)."""
    p = fb.plan_tiles(64, h, h, c, dtype, (1, 1))
    assert p.n_tiles >= 2 * p.grid
    first = range(0, p.n_tiles, p.grid)           # block 0's walk
    assert sum(len(_loads(p, t)) for t in first) > p.stages


def test_ragged_case_is_ragged():
    """The odd case the card tests use for ragged edges really leaves a
    short last segment and a narrow last strip."""
    p = fb.plan_tiles(1, 68, 300, 64, torch.bfloat16, (1, 1))
    assert p.Ho % p.seg and p.Wo % p.wt


@pytest.mark.parametrize("shape,dtype,aligned", [
    ((2, 11, 23, 20), torch.bfloat16, True),    # 40-byte pixel rows
    ((2, 11, 23, 6), torch.float32, True),      # 24-byte pixel rows
    ((2, 17, 17, 64), torch.bfloat16, False),   # view off a 16-byte line
    ((64, 257, 257, 128), torch.bfloat16, False),
])
def test_shapes_tma_cannot_describe_take_the_general_path(shape, dtype,
                                                          aligned):
    p = fb.plan_tiles(*shape, dtype, (1, 1), aligned)
    assert p.path == "general"
    assert (p.B, p.H, p.W, p.C) == shape and p.n_tiles == 0


def test_plans_are_cached_and_mirrored_for_c():
    p = fb.plan_tiles(64, 65, 65, 512, torch.bfloat16, (1, 1))
    assert fb.plan_tiles(64, 65, 65, 512, torch.bfloat16, (1, 1)) is p
    cp = fb._c_plan(p)
    assert fb._c_plan(p) is cp
    assert cp.path == 1 and cp.dtype == 1
    for name, _ in fb._CPlan._fields_:
        if name not in ("path", "dtype"):
            assert getattr(cp, name) == getattr(p, name), name
    g = fb._c_plan(fb.plan_tiles(2, 11, 23, 20, torch.bfloat16, (1, 1)))
    assert g.path == 0 and g.dtype == 1


def test_launch_counter_counts_by_path():
    c = fb.LaunchCounter()
    c.add("tma")
    c.add("tma")
    c.add("general")
    assert c.value == 3 and c.by_path == {"tma": 2, "general": 1}
    c.reset()
    assert c.value == 0 and c.by_path == {}
