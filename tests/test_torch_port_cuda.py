"""The CUDA kernel against its plain version, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernel has
no CPU mode) and skip without one.  This file imports no JAX, and
tests/conftest.py does, so run it on the card with:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.ops import fused_blur

pytestmark = pytest.mark.cuda
TAPS = tuple((np.asarray([1., 3., 3., 1.]) / 8.0 * 2.0).tolist())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("shape", [(2, 9, 9, 512), (2, 65, 65, 256),
                                   (2, 17, 17, 64), (2, 11, 23, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(dev).manual_seed(0)
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = torch.rand((b, c), generator=g, device=dev) + 0.5
    bias = torch.randn((c,), generator=g, device=dev)
    before = fused_blur.launches.value
    got = fused_blur.fused_blur4(x, TAPS, scale=scale, bias=bias, act=True)
    torch.cuda.synchronize()
    assert fused_blur.launches.value == before + 1
    want = fused_blur.fused_blur4_plain(x.float(), TAPS, scale=scale,
                                        bias=bias, act=True)
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        # bf16 rounding, plus the f32 sum-order allowance near zero
        assert bool((err <= 2 * _bf16_ulp(want) + 1e-5).all())


MAIN_SHAPES = [(9, 512), (17, 512), (33, 512), (65, 512), (129, 256),
               (257, 128)]          # fused_blur4 inputs of a 256px forward


def _check_against_plain(x, pad=(1, 1), **epi):
    """One kernel launch on the path ``plan_tiles`` chooses, held against
    the plain version: f32 at 1e-5, bf16 at 2 ulps beyond 1e-5."""
    plan = fused_blur.plan_tiles(*x.shape, x.dtype, tuple(pad),
                                 x.data_ptr() % 16 == 0)
    before = fused_blur.launches.by_path
    got = fused_blur.fused_blur4(x, TAPS, pad, **epi)
    torch.cuda.synchronize()
    after = fused_blur.launches.by_path
    assert after.get(plan.path, 0) == before.get(plan.path, 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want = fused_blur.fused_blur4_plain(x.float(), TAPS, pad, **epi)
    err = (got.float() - want).abs()
    if x.dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert bool((err <= 2 * _bf16_ulp(want) + 1e-5).all())
    return plan


def _epilogue(dev, b, c, scale_dtype=torch.float32):
    g = torch.Generator(dev).manual_seed(1)
    scale = (torch.rand((b, c), generator=g, device=dev) + 0.5)
    bias = torch.randn((c,), generator=g, device=dev)
    return dict(scale=scale.to(scale_dtype), bias=bias, act=True)


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("h,c", MAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_main_path_shapes_take_tma(dev, batch, h, c, dtype):
    """Batch 1 and 8 as served; at batch 64 the blocks walk several tiles
    each, so the ring runs on across tile boundaries."""
    x = torch.randn((batch, h, h, c), generator=torch.Generator(dev)
                    .manual_seed(h), device=dev).to(dtype)
    plan = _check_against_plain(x, **_epilogue(dev, batch, c, dtype))
    assert plan.path == "tma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_segment_and_strip(dev, dtype):
    x = torch.randn((1, 68, 300, 64), device=dev).to(dtype)
    plan = _check_against_plain(x, **_epilogue(dev, 1, 64))
    assert plan.path == "tma"
    assert plan.Ho % plan.seg and plan.Wo % plan.wt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_asymmetric_pad(dev, dtype):
    x = torch.randn((2, 12, 9, 8), device=dev).to(dtype)
    assert _check_against_plain(x, (2, 1), **_epilogue(dev, 2, 8)).path \
        == "tma"


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_epilogue_operand_dtypes(dev, scale_dtype, bias_dtype):
    x = torch.randn((4, 33, 33, 128), device=dev).to(torch.bfloat16)
    epi = _epilogue(dev, 4, 128, scale_dtype)
    epi["bias"] = epi["bias"].to(bias_dtype)
    _check_against_plain(x, **epi)
    _check_against_plain(x, scale=epi["scale"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_path(dev, dtype):
    """C=20 in bf16 (40-byte pixel rows) and a view whose storage starts
    one element into its buffer take the general path."""
    if dtype == torch.bfloat16:
        x = torch.randn((2, 11, 23, 20), device=dev).to(dtype)
        assert _check_against_plain(x, **_epilogue(dev, 2, 20)).path \
            == "general"
    buf = torch.randn(2 * 17 * 17 * 64 + 1, device=dev).to(dtype)
    x = buf[1:].view(2, 17, 17, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert _check_against_plain(x, **_epilogue(dev, 2, 64)).path \
        == "general"


def test_one_launch_per_call(dev):
    """The wrapper launches the kernel alone: no cast of a bf16 scale."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((2, 17, 17, 64), device=dev).to(torch.bfloat16)
    epi = _epilogue(dev, 2, 64, torch.bfloat16)
    fused_blur.fused_blur4(x, TAPS, **epi)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_blur.fused_blur4(x, TAPS, **epi)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "fused_blur4_tma_kernel" in kernels[0]


def test_generator_f32_card_matches_cpu(dev):
    cfg = ModelConfig(size=32, style_dim=64, param_dim=64, max_channels=64,
                      n_trans=2)
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    p = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    with torch.no_grad():
        want = Generator(cfg, device="cpu")(z, p).image
        g = Generator(cfg, device=dev)
        before = fused_blur.launches.value
        got = g(z.to(dev), p.to(dev)).image.cpu()
    assert fused_blur.launches.value - before == cfg.log_size - 2
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ backward

def _grads(fn, x, scale, bias, gy, create_graph=False):
    """x, scale, bias leaves of the same values; their gradients of
    <fn(x, scale, bias), gy>."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    y = fn(*leaves)
    return leaves, torch.autograd.grad(y, leaves, gy,
                                       create_graph=create_graph)


def _kernel(x, scale, bias):
    return fused_blur.fused_blur4(x, TAPS, scale=scale, bias=bias, act=True)


def _plain(x, scale, bias):
    return fused_blur.fused_blur4_plain(x, TAPS, scale=scale, bias=bias,
                                        act=True)


def _close_grad(got, want, dtype, name):
    """grad_x at 1e-5 (float32) or 2 bf16 ulps; grad_scale and grad_bias,
    sums over H*W (and B) products, at 1e-5 of their largest magnitude."""
    err = (got.float() - want.float()).abs()
    if name != "x":
        assert err.max().item() <= 1e-5 * want.abs().max().item() + 1e-6, \
            name
    elif dtype == torch.float32:
        assert err.max().item() <= 1e-5, name
    else:
        assert bool((err <= 2 * _bf16_ulp(want.float()) + 1e-5).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_reach_x_scale_bias(dev, dtype):
    """On the card the up-conv's blur used to return a tensor without a
    grad_fn, so nothing upstream of it got a gradient."""
    g = torch.Generator(dev).manual_seed(2)
    x = torch.randn((2, 33, 33, 128), generator=g, device=dev).to(dtype)
    scale = (torch.rand((2, 128), generator=g, device=dev) + 0.5).to(dtype)
    bias = torch.randn((128,), generator=g, device=dev)
    gy = torch.randn((2, 32, 32, 128), generator=g, device=dev).to(dtype)
    before = fused_blur.launches.by_role
    leaves, got = _grads(_kernel, x, scale, bias, gy)
    y = _kernel(*leaves)
    assert y.grad_fn is not None
    y.backward(gy)
    assert all(t.grad is not None for t in leaves)
    after = fused_blur.launches.by_role
    for role in ("forward", "adjoint", "recompute"):
        assert after.get(role, 0) > before.get(role, 0), role
    _, want = _grads(_plain, x, scale, bias, gy)
    for name, a, b in zip(("x", "scale", "bias"), got, want):
        _close_grad(a, b, dtype, name)


@pytest.mark.parametrize("misaligned", [False, True])
def test_adjoint_pad22_odd_outputs(dev, misaligned):
    """The adjoint of the 256px up-conv blur: [B,256,256,128] -> 257x257
    at pad (2, 2) (TMA boxes start at -2), on both paths."""
    g = torch.Generator(dev).manual_seed(3)
    for shape in ((2, 32, 32, 128), (1, 256, 256, 128)):
        x = torch.randn(shape, generator=g, device=dev)
        if misaligned:
            buf = torch.empty(x.numel() + 1, device=dev)
            x = buf[1:].view(shape).copy_(x)
        scale = torch.rand((shape[0], shape[-1]), generator=g,
                           device=dev) + 0.5
        plan = _check_against_plain(x, (2, 2), scale=scale)
        assert plan.path == ("general" if misaligned else "tma")
        assert plan.Ho == shape[1] + 1 and plan.Ho % 2 == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_backward_matches_plain(dev, dtype):
    g = torch.Generator(dev).manual_seed(4)
    x = torch.randn((2, 17, 17, 64), generator=g, device=dev).to(dtype)
    scale = (torch.rand((2, 64), generator=g, device=dev) + 0.5).to(dtype)
    bias = torch.randn((64,), generator=g, device=dev)
    gy = torch.randn((2, 16, 16, 64), generator=g, device=dev).to(dtype)
    v = torch.randn(x.shape, generator=g, device=dev)
    w = torch.randn(scale.shape, generator=g, device=dev)
    out = {}
    for name, fn in (("kernel", _kernel), ("plain", _plain)):
        gyl = gy.clone().requires_grad_()
        (xl, sl, _), (gx, gs, _) = _grads(fn, x, scale, bias, gyl, True)
        inner = (gx.float() * v).sum() + (gs.float() * w).sum()
        out[name] = torch.autograd.grad(inner, [gyl, sl, xl])
    for name, a, b in zip(("gy", "scale", "x"), out["kernel"], out["plain"]):
        err = (a.float() - b.float()).abs().max().item()
        tol = (1e-5 if dtype == torch.float32 else 2 ** -6) \
            * b.float().abs().max().item() + 1e-5
        assert err <= tol, (name, err, tol)


def test_small_train_step_on_card(dev):
    from transeditor_tpu_torch.config import TrainConfig
    from transeditor_tpu_torch.train.gan import init_state, make_train_step

    cfg = ModelConfig(size=32, style_dim=64, param_dim=64, max_channels=64,
                      n_trans=2)
    tcfg = TrainConfig(batch_size=4, spatial_regu=True)
    state = init_state(cfg, tcfg, device=dev)
    step = make_train_step(cfg, tcfg)
    rng = torch.Generator(dev).manual_seed(0)
    real = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    fused_blur.launches.reset()
    state, m = step(state, real, rng, do_d_reg=True, do_g_reg=True,
                    do_spatial_reg=True)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).item() for v in m.values()), m
    assert float(m["r1"]) > 0 and float(m["path_length"]) > 0
    roles = fused_blur.launches.by_role
    assert roles.get("adjoint", 0) > 0 and roles.get("recompute", 0) > 0


# ------------------------------------------- the CLI training path's pieces

def test_nccl_group_of_one_reduces_to_the_identity(dev, monkeypatch):
    import socket
    import torch.distributed as dist
    from transeditor_tpu_torch.parallel import data_parallel, multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize(dev)
    try:
        assert dist.get_backend() == "nccl"
        g = torch.Generator(dev).manual_seed(5)
        grads = [torch.randn((300, 7), generator=g, device=dev),
                 torch.randn((5,), generator=g, device=dev).bfloat16(),
                 torch.randn((2, 3), generator=g, device=dev)]
        # a group of one runs no collective ...
        assert not multihost.multi_process()
        assert data_parallel.all_reduce_grads(grads) is grads
        # ... and NCCL's, made to run, are the identity
        monkeypatch.setattr(multihost, "multi_process", lambda: True)
        got = data_parallel.all_reduce_grads(grads)
        for a, b in zip(got, grads):
            assert a.dtype == b.dtype and torch.equal(a, b)
        x = torch.arange(6.0, device=dev, requires_grad=True)
        y = data_parallel.all_reduce_sum(x * x)
        gx, = torch.autograd.grad(y.sum(), x)
        assert torch.equal(gx, 2 * x.detach())
        assert multihost.reduce_loss_dict({"a": torch.tensor(2.0,
                                                             device=dev)}) \
            == {"a": 2.0}
    finally:
        multihost.shutdown()


def test_cli_trains_and_resumes_on_card(dev, tmp_path):
    import json
    from transeditor_tpu_torch.cli import train_gan
    from transeditor_tpu_torch.utils.image import save_png

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        save_png(str(imgs / f"{i}.png"),
                 rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    argv = [str(imgs), "--size", "32", "--num_trans", "1", "--batch", "4",
            "--d_reg_every", "2", "--g_reg_every", "2", "--n_sample", "4",
            "--log_every", "1", "--out_dir", str(tmp_path / "out"),
            "--exp_name", "r"]
    fused_blur.launches.reset()
    assert train_gan.main([*argv, "--iter", "2"]).step == 2
    state = train_gan.main([*argv, "--iter", "3", "--resume",
                            str(tmp_path / "out" / "r" / "checkpoint")])
    torch.cuda.synchronize()
    assert state.g.to_rgbs[0].conv.weight.is_cuda
    log = (tmp_path / "out" / "r" / "log" / "metrics.jsonl").read_text()
    assert [json.loads(s)["step"] for s in log.splitlines()] == [0, 1, 2]
    roles = fused_blur.launches.by_role_path
    assert {p for by in roles.values() for p in by} == {"tma"}
    assert all(roles.get(r) for r in ("forward", "adjoint", "recompute"))


def test_engine_serves_a_train_state_on_card(dev, tmp_path):
    from transeditor_tpu_torch.config import TrainConfig
    from transeditor_tpu_torch.io.checkpoint import save_train_state
    from transeditor_tpu_torch.serve import engine_from_checkpoint
    from transeditor_tpu_torch.train.gan import init_state

    cfg = ModelConfig(size=32, style_dim=64, param_dim=64, max_channels=64,
                      n_trans=2)
    state = init_state(cfg, TrainConfig(batch_size=2), seed=3, device=dev)
    save_train_state(str(tmp_path), 0, state)
    eng = engine_from_checkpoint(cfg, state_dir=str(tmp_path), device=dev)
    g = torch.Generator(dev).manual_seed(1)
    z = torch.randn((2, 16, 64), generator=g, device=dev)
    with torch.inference_mode():
        want = state.g_ema(z, z).image
        got = eng.gen(z, z).image
    assert (got - want).abs().max().item() <= 1e-6


def test_projector_step_on_card_runs_the_kernel_by_role(dev):
    """One projector step at 32px on the card: z+ and p+ move, and the
    step launches the kernel once per up-conv in each role (forward,
    adjoint, recompute), all on the TMA path; the final decode adds one
    forward each.  The kernel has no route to its plain version here."""
    from transeditor_tpu_torch.invert.projector import (ProjectorConfig,
                                                        estimate_latent_stats,
                                                        project)
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cfg = ModelConfig(size=32, max_channels=64, n_trans=1)
    g = Generator(cfg, device=dev, seed=0)
    lpips = LPIPS("vgg", device=dev)
    with torch.no_grad():
        target = g(*(torch.randn((2, 16, 512), generator=torch.Generator(
            dev).manual_seed(s), device=dev) for s in (1, 2))).image
    stats = estimate_latent_stats(g, n_samples=1000)
    fused_blur.launches.reset()
    res = project(g, lpips, target, ProjectorConfig(steps=2, trace_every=1),
                  stats=stats, device=dev)
    torch.cuda.synchronize()
    ups = cfg.log_size - 2
    assert fused_blur.launches.by_role_path == {
        "forward": {"tma": 3 * ups}, "adjoint": {"tma": 2 * ups},
        "recompute": {"tma": 2 * ups}}
    z0 = stats[0].cpu().numpy()
    assert float(np.abs(res["z_plus"] - z0).max()) > 1e-3
    assert np.isfinite(res["image"]).all()
    assert all(p.grad is None for p in g.parameters())


def test_lpips_vgg_card_matches_cpu(dev):
    """The VGG LPIPS distance on the card (cuDNN, TF32 off) against the
    same weights on the CPU, within 1e-4 relative."""
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cpu = LPIPS("vgg", device="cpu", seed=3)
    card = LPIPS("vgg", device=dev, seed=3)
    rng = np.random.RandomState(0)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        want = cpu(x, y)
        got = card(x.to(dev), y.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_irse_card_matches_cpu(dev, train):
    """The IR-SE-50 ArcFace (112px) on the card (cuDNN, TF32 off) against
    the same weights on the CPU, in eval mode and in train mode (batch 8,
    with the running statistics it updates), within 1e-4 of the largest
    magnitude."""
    from transeditor_tpu_torch.models.irse import ArcFaceBackbone, init_weights

    cpu = init_weights(ArcFaceBackbone(), torch.Generator().manual_seed(0))
    card = ArcFaceBackbone()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    cpu.train(train)
    card.train(train)
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (8, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * top
    for k, v in cpu.state_dict().items():
        if "running" in k:
            got_v = card.state_dict()[k].cpu()
            assert (got_v - v).abs().max().item() <= 1e-4 * max(
                v.abs().max().item(), 1e-3), k


def test_ranger_step_card_matches_cpu(dev):
    """Eight Ranger steps (Lookahead syncing at step 6) on the card
    against the CPU, same gradients: parameters within 1e-6 of each
    tensor's largest magnitude (RAdam's rho_t is computed on the host
    either way)."""
    from transeditor_tpu_torch.train.ranger import ranger

    g = torch.Generator().manual_seed(0)
    shapes = [(64, 32, 3, 3), (128, 64), (128,)]
    params = [torch.randn(s, generator=g) * 0.1 for s in shapes]
    cpu = [p.clone().requires_grad_(True) for p in params]
    card = [p.to(dev).requires_grad_(True) for p in params]
    opts = [ranger(cpu, 1e-2), ranger(card, 1e-2)]
    for _ in range(8):
        grads = [torch.randn(s, generator=g) for s in shapes]
        for ps, opt in zip((cpu, card), opts):
            for p, gr in zip(ps, grads):
                p.grad = gr.to(p.device)
            opt.step()
    for a, b in zip(card, cpu):
        err = (a.detach().cpu() - b.detach()).abs().max().item()
        assert err <= 1e-6 * b.abs().max().item()


# ------------------------------------------------------------ editing

def test_svm_solver_card_matches_cpu(dev):
    """The C-SVC solver on the card against itself on the CPU, same
    problem (300 + 300 rows, 8,192 wide, labelled by a direction plus
    noise): both reach the KKT tolerance; normals within 1e-9 of a
    cosine of 1, intercepts within 1e-6."""
    from transeditor_tpu_torch.edit.linear_svc import fit_linear_svc

    rng = np.random.RandomState(0)
    x = rng.randn(600, 8192).astype(np.float32)
    y = (x @ rng.randn(8192) + 20 * rng.randn(600) > 0).astype(np.float64)
    card = fit_linear_svc(x, y, device=dev)
    cpu = fit_linear_svc(x, y, device="cpu")
    assert card.kkt_gap < 1e-6 and cpu.kkt_gap < 1e-6
    a, b = card.coef.cpu().double(), cpu.coef.double()
    assert 1 - float(a @ b / a.norm() / b.norm()) < 1e-9
    assert abs(card.intercept - cpu.intercept) < 1e-6


@pytest.mark.parametrize("attr", ["age", "pose", "Smiling"])
def test_scorer_card_matches_cpu(dev, attr):
    """Each editing classifier (random, seeded; DEX at 256px, the pose
    net at 64px, CelebA-HQ from 64px up to 256) on the card (cuDNN, TF32
    off) against the same weights on the CPU: scores within 1e-4 of the
    largest magnitude."""
    from transeditor_tpu_torch.edit.classifiers import (
        make_attribute_scorer, random_classifier)

    net = random_classifier(attr, torch.Generator().manual_seed(0))
    size = 256 if attr == "age" else 64
    img = np.random.RandomState(1).uniform(-1, 1, (4, size, size, 3)).astype(
        np.float32)
    cpu = make_attribute_scorer(attr, net, "cpu")
    want = cpu(img)
    got = make_attribute_scorer(attr, net, dev)(img).cpu()
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * top


def test_strip_decode_launches_all_on_the_tma_path(dev):
    """An edit strip (7 frames, 32px, bf16) decodes through the kernel:
    one forward launch per up-conv, all on the TMA path, with the scores
    of a plain scorer."""
    from transeditor_tpu_torch.edit.sweep import (edit_sample,
                                                  make_strip_decoder)

    cfg = ModelConfig(size=32, max_channels=64, n_trans=1, dtype="bfloat16")
    g = Generator(cfg, device=dev, seed=0).eval()
    rng = np.random.RandomState(0)
    zp, pp = (rng.randn(16, 512).astype(np.float32) for _ in range(2))
    bounds = {k: rng.randn(1, 16 * 512).astype(np.float32) / 90.0
              for k in "zp"}
    decode = make_strip_decoder(g, lambda img: img.mean(dim=(1, 2, 3)))
    fused_blur.launches.reset()
    strips = edit_sample(decode, zp, pp, bounds, 3.0, 7.0, steps=7)
    torch.cuda.synchronize()
    ups = cfg.log_size - 2
    assert fused_blur.launches.by_role_path == {"forward": {"tma": 3 * ups}}
    for strip in strips.values():
        assert strip.images.shape == (7, 32, 32, 3)
        assert np.isfinite(strip.images).all() and np.isfinite(
            strip.scores).all()


def _he_inception(seed: int = 0):
    """An InceptionV3 on the CPU with He-scaled convs (features O(1); the
    N(0, 0.1) init blows them up to ~1e10) and folded BNs near 1 / 0."""
    from transeditor_tpu_torch.metrics.inception import InceptionV3Features

    net = InceptionV3Features(device="cpu", seed=seed).eval()
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=rng)
                        * (2.0 / fan_in) ** 0.5)
            elif name.endswith("scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=rng))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=rng))
    return net


@pytest.mark.parametrize("size", [64, 256])
def test_inception_card_matches_cpu(dev, size):
    """InceptionV3 features (resized to 299) on the card (cuDNN, TF32 off)
    against the same weights on the CPU: within 1e-4 of the largest."""
    import copy

    cpu = _he_inception(1)
    card = copy.deepcopy(cpu).to(dev)
    x = torch.from_numpy(np.random.RandomState(size).uniform(
        -1, 1, (4, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    assert got.shape == (4, 2048)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_vgg16_fc7_card_matches_cpu(dev):
    """PRDC's VGG16-fc7 at the native 256px, card vs CPU: 1e-4 of the
    largest."""
    import copy

    from transeditor_tpu_torch.zoo.backbones import VGG16Fc7

    torch.manual_seed(0)
    cpu = VGG16Fc7().eval()
    card = copy.deepcopy(cpu).to(dev)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (2, 256, 256, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_prdc_card_equals_cpu(dev):
    """The streamed k-NN on the card (float32, TF32 off) gives the CPU's
    counts: the four values equal, over chunks that do not divide N."""
    from transeditor_tpu_torch.metrics.prdc import compute_prdc

    rng = np.random.default_rng(3)
    real = rng.standard_normal((3000, 256)).astype(np.float32)
    fake = (rng.standard_normal((2500, 256)) * 1.1 + 0.05).astype(np.float32)
    for k in (3, 5):
        assert (compute_prdc(real, fake, k, 700, device=dev)
                == compute_prdc(real, fake, k, 700, device="cpu"))


def test_ppl_distances_card_match_cpu(dev):
    """PPL distances at eps 1e-2 (crop, plus space) of a float32 32px
    generator and a VGG LPIPS, card vs CPU: 1e-3 relative."""
    from transeditor_tpu_torch.metrics.ppl import make_ppl_distance_fn
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cfg = ModelConfig(size=32, max_channels=64, n_trans=1)
    nets = {}
    for d in ("cpu", dev):
        nets[str(d)] = (Generator(cfg, device=d, seed=0).eval(),
                        LPIPS("vgg", device=d, seed=1).eval())
    rng = np.random.RandomState(4)
    z, p = (torch.from_numpy(rng.randn(8, 16, 512).astype(np.float32))
            for _ in range(2))
    out = {}
    for d, (g, lpips) in nets.items():
        fn = make_ppl_distance_fn(g, lpips, "all", True, True, eps=1e-2)
        out[d] = fn(z.to(d), p.to(d), 0.0).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=0)


def test_fid_batch_launches_replayed_through_plain(dev, monkeypatch):
    """A FID batch (bf16 32px decode, batch 4): one forward launch per
    up-conv, all TMA; each launch replayed through the plain version
    within 2 bf16 ulps beyond 1e-5.  (The 2,048-wide Fréchet distance, a
    host sqrtm, is not this test's: its statistics' trace stands in.)"""
    from transeditor_tpu_torch.metrics import evaluator
    from transeditor_tpu_torch.metrics.evaluator import evaluate_fid

    monkeypatch.setattr(evaluator, "frechet_distance",
                        lambda m, c, rm, rc: float(np.trace(c)))

    cfg = ModelConfig(size=32, max_channels=64, n_trans=1, dtype="bfloat16")
    g = Generator(cfg, device=dev, seed=0).eval()
    inc = _he_inception(2).to(dev)
    blur, calls = fused_blur._blur, []

    def recording(x, taps, pad, scale, bias, act, role):
        y = blur(x, taps, pad, scale, bias, act, role)
        calls.append((x, taps, pad, scale, bias, act, y))
        return y

    fused_blur.launches.reset()
    fused_blur._blur = recording
    try:
        fid = evaluate_fid(g, inc, np.zeros(2048), np.eye(2048),
                           n_samples=4, batch=4)
    finally:
        fused_blur._blur = blur
    ups = cfg.log_size - 2
    assert fused_blur.launches.by_role_path == {"forward": {"tma": ups}}
    assert np.isfinite(fid) and len(calls) == ups
    for x, taps, pad, scale, bias, act, y in calls:
        want = fused_blur.fused_blur4_plain(x, taps, pad, scale, bias,
                                            act).float()
        err = (y.float() - want).abs()
        assert bool((err <= 2 * _bf16_ulp(want) + 1e-5).all())


# ------------------------------------------------------------ conv2d_int8

INT8_CASES = [((2, 8, 8, 512), 512, 3, dict(stride=1, padding=1)),
              ((2, 8, 8, 512), 512, 3, dict(stride=2, transpose=True)),
              ((2, 64, 64, 512), 256, 3, dict(stride=2, transpose=True)),
              ((1, 9, 7, 20), 6, 3, dict(stride=2, padding=0)),
              ((2, 5, 6, 6), 20, 3, dict(stride=2, transpose=True)),
              ((1, 11, 9, 64), 32, 1, dict(stride=1, padding=0))]


@pytest.mark.parametrize("shape,out_ch,k,mode", INT8_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32,
                                       torch.bfloat16])
def test_conv2d_int8_bit_equal_to_plain(dev, shape, out_ch, k, mode,
                                        out_dtype):
    """Integer sums are exact: the kernel's output, int32 or dequantised,
    equals the plain version's bit for bit."""
    from transeditor_tpu_torch.ops import quant

    g = torch.Generator(dev).manual_seed(sum(shape) + out_ch)
    xq = torch.randint(-127, 128, shape, generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (out_ch, shape[3], k, k), generator=g,
                       device=dev, dtype=torch.int8)
    sx = torch.rand(shape[0], generator=g, device=dev) * 1e-2
    sw = torch.rand(out_ch, generator=g, device=dev) * 1e-2
    before = quant.launches.value
    got = quant.conv2d_int8(xq, wq, sx=sx, sw=sw, out_dtype=out_dtype,
                            **mode)
    torch.cuda.synchronize()
    assert quant.launches.value == before + 1
    acc = quant.conv2d_int8_plain(xq, wq, **mode)
    want = acc if out_dtype == torch.int32 else \
        quant.dequantize_plain(acc, sx, sw, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


# (x shape, O, k, mode, the path the plan chooses): the cases above, a
# split-K shape (4x4, 512 -> 512, batch 64) and a ragged M and N
INT8_PATH_CASES = [
    ((2, 8, 8, 512), 512, 3, dict(stride=1, padding=1), "wgmma"),
    ((2, 8, 8, 512), 512, 3, dict(stride=2, transpose=True), "wgmma"),
    ((2, 64, 64, 512), 256, 3, dict(stride=2, transpose=True), "wgmma"),
    ((1, 9, 7, 20), 6, 3, dict(stride=2, padding=0), "general"),
    ((2, 5, 6, 6), 20, 3, dict(stride=2, transpose=True), "general"),
    ((1, 11, 9, 64), 32, 1, dict(stride=1, padding=0), "general"),
    ((64, 4, 4, 512), 512, 3, dict(stride=1, padding=1), "wgmma"),
    ((3, 11, 13, 64), 40, 3, dict(stride=1, padding=1), "wgmma")]


@pytest.mark.parametrize("shape,out_ch,k,mode,path", INT8_PATH_CASES)
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32,
                                       torch.bfloat16])
def test_conv2d_int8_paths_bit_equal_to_plain(dev, shape, out_ch, k, mode,
                                              path, out_dtype):
    """``conv2d_int8`` launches the path its plan names, counted by path
    and by mode; that path and, where the wgmma path takes the shape, the
    earlier (general-path) kernel are both bit-equal to the plain
    version."""
    from transeditor_tpu_torch.ops import quant

    g = torch.Generator(dev).manual_seed(sum(shape) + out_ch + 1)
    xq = torch.randint(-127, 128, shape, generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (out_ch, shape[3], k, k), generator=g,
                       device=dev, dtype=torch.int8)
    sx = torch.rand(shape[0], generator=g, device=dev) * 1e-2
    sw = torch.rand(out_ch, generator=g, device=dev) * 1e-2
    full = {"padding": 0, "transpose": False, **mode}
    plan, x, w = quant.prepare(xq, wq, out_dtype=out_dtype, **full)
    assert plan.path == path
    if shape[0] == 64:
        assert plan.split > 1
    by_path, by_mode = quant.launches.by_path, quant.launches.by_role
    got = quant.conv2d_int8(xq, wq, sx=sx, sw=sw, out_dtype=out_dtype,
                            **mode)
    torch.cuda.synchronize()
    m = quant._mode(mode["stride"], full["transpose"])
    assert quant.launches.by_path.get(path, 0) == by_path.get(path, 0) + 1
    assert quant.launches.by_role.get(m, 0) == by_mode.get(m, 0) + 1
    acc = quant.conv2d_int8_plain(xq, wq, **mode)
    want = acc if out_dtype == torch.int32 else \
        quant.dequantize_plain(acc, sx, sw, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if path == "wgmma":
        general, x, w = quant.prepare(xq, wq, out_dtype=out_dtype,
                                      general=True, **full)
        scales = (None, None) if out_dtype == torch.int32 else (sx, sw)
        earlier = quant.launch(general, x, w, *scales)
        torch.cuda.synchronize()
        assert torch.equal(earlier, want)


def test_conv2d_int8_wrapper_refuses(dev):
    from transeditor_tpu_torch.ops import quant

    xq = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device=dev)
    wq = torch.zeros((8, 16, 3, 3), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="cpu"):
        quant.conv2d_int8(xq, wq.cpu(), padding=1)
    with pytest.raises(TypeError):
        quant.conv2d_int8(xq.float(), wq, padding=1)
    with pytest.raises(ValueError, match="contiguous"):
        quant.conv2d_int8(xq.transpose(1, 2), wq, padding=1)
    with pytest.raises(ValueError, match="sx"):
        quant.conv2d_int8(xq, wq, padding=1, sx=torch.ones(1),
                          sw=torch.ones(8, device=dev),
                          out_dtype=torch.float32)
