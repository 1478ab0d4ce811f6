"""Shared pieces of the metric-slice parity tests
(``test_torch_port_{inception,fid_prdc,ppl,evaluator,metrics_cli}.py``).

Weights: random reference-layout state dicts drawn with numpy.
  * InceptionV3 in pytorch-fid's layout (``{name}.conv.weight``,
    ``{name}.bn.{weight,bias,running_mean,running_var,
    num_batches_tracked}``, an ``fc.*`` pair that no loader reads).  The
    JAX package's random init (N(0, 0.1), scale 1) blows the features up
    to ~1e10 at 64px -> 299, so the convs are He-scaled (std
    sqrt(2 / fan_in)) and the BatchNorms carry non-trivial statistics:
    the features stay O(1), and both loaders fold real statistics.
  * torchvision VGG16 (fc6 / fc7 included) and the LPIPS layouts
    (richzhang VGG and AlexNet, heads included), He-scaled.
Draws: the JAX package's own key schedule, reproduced with its
``sample_tokens`` (``fid_draws``, ``diversity_draws``, ``ppl_draws``), so
the port's ``draws=`` takes exactly the codes the JAX code samples.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from transeditor_tpu.utils.sampling import sample_tokens

from transeditor_tpu_torch.metrics.inception import (InceptionV3Features,
                                                     conv_names)
from transeditor_tpu_torch.zoo import lpips as tl


def _he(rng, shape, gain=1.0):
    fan_in = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(gain * np.sqrt(2.0 / fan_in)))


def fid_inception_sd(seed: int = 0) -> dict:
    """A pytorch-fid InceptionV3 state dict (numpy), shapes read from the
    port's module on the meta device."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = InceptionV3Features(device="meta")
    sd = {}
    for name in conv_names(net):
        shape = tuple(net.get_submodule(name).weight.shape)
        c = shape[0]
        sd[f"{name}.conv.weight"] = _he(rng, shape)
        sd[f"{name}.bn.weight"] = 1 + 0.1 * rng.standard_normal(c, np.float32)
        sd[f"{name}.bn.bias"] = 0.1 * rng.standard_normal(c, np.float32)
        sd[f"{name}.bn.running_mean"] = 0.1 * rng.standard_normal(
            c, np.float32)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[f"{name}.bn.num_batches_tracked"] = np.asarray(3, np.int64)
    sd["fc.weight"] = _he(rng, (1008, 2048))
    sd["fc.bias"] = np.zeros(1008, np.float32)
    return sd


def vgg16_sd(seed: int = 0, fc: bool = True) -> dict:
    """torchvision vgg16 ``features.*`` (and ``classifier.{0,3}.*``)."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512, "M"):
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = _he(rng, (v, cin, 3, 3))
        sd[f"features.{idx}.bias"] = 0.1 * rng.standard_normal(v, np.float32)
        idx, cin = idx + 2, v
    if fc:
        for i, (o, n) in ((0, (4096, 512 * 49)), (3, (4096, 4096))):
            sd[f"classifier.{i}.weight"] = _he(rng, (o, n))
            sd[f"classifier.{i}.bias"] = 0.1 * rng.standard_normal(
                o, np.float32)
    return sd


def alex_sd(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, (o, i, k) in zip((0, 3, 6, 8, 10),
                              ((64, 3, 11), (192, 64, 5), (384, 192, 3),
                               (256, 384, 3), (256, 256, 3))):
        sd[f"features.{idx}.weight"] = _he(rng, (o, i, k, k))
        sd[f"features.{idx}.bias"] = 0.1 * rng.standard_normal(o, np.float32)
    return sd


def lpips_sd(net: str, seed: int = 0) -> dict:
    """A richzhang LPIPS checkpoint with its backbone (numpy)."""
    sd = alex_sd(seed) if net == "alex" else vgg16_sd(seed, fc=False)
    rng = np.random.default_rng(seed + 100)
    chans = tl.ALEX_CHANNELS if net == "alex" else tl.VGG_CHANNELS
    for i, c in enumerate(chans):
        sd[f"lin{i}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, c, 1, 1), dtype=np.float32))
    return sd


def torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def save_sd(path, sd: dict) -> str:
    torch.save(torch_sd(sd), path)
    return str(path)


# ---------------------------------------------------------------------
# the JAX package's draws

def fid_draws(n_batches, batch, n_tokens, style_dim, param_dim, seed=0,
              truncation=1.0):
    """``evaluate_fid``'s (z, p) a batch (``evaluate_prdc`` draws the same
    way, without truncation)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i in range(n_batches):
        kz, kp = jax.random.split(jax.random.fold_in(key, i))
        out.append((np.asarray(sample_tokens(kz, batch, n_tokens, style_dim,
                                             truncation)),
                    np.asarray(sample_tokens(kp, batch, n_tokens, param_dim,
                                             truncation))))
    return out


def diversity_draws(n_batches, n_images, n_tokens, style_dim, param_dim,
                    seed=0):
    """``evaluate_lpips_diversity``'s three (z, p) a round, in the order
    all, fix_z (P fixed), fix_p (Z fixed)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for b in range(n_batches):
        ks = jax.random.split(jax.random.fold_in(key, b), 3)
        round_ = []
        for k, (z_same, p_same) in zip(ks, ((False, False), (False, True),
                                            (True, False))):
            kz, kp = jax.random.split(k)
            round_.append((
                np.asarray(sample_tokens(kz, n_images, n_tokens, style_dim,
                                         same=z_same)),
                np.asarray(sample_tokens(kp, n_images, n_tokens, param_dim,
                                         same=p_same))))
        out.append(round_)
    return out


def ppl_draws(n_batches, batch, n_tokens, style_dim, param_dim, space,
              sampling="end", seed=0):
    """``compute_ppl``'s (z, p, t) a batch."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i in range(n_batches):
        kz, kp, kt = jax.random.split(jax.random.fold_in(key, i), 3)
        z = sample_tokens(kz, batch * 2, n_tokens, style_dim,
                          same=(space == "p"))
        p = sample_tokens(kp, batch * 2, n_tokens, param_dim,
                          same=(space == "z"))
        t = (jax.random.uniform(kt, ()) if sampling == "full"
             else np.zeros((), np.float32))
        out.append((np.asarray(z), np.asarray(p), np.asarray(t)))
    return out


def rel_err(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def generator_pair(seed: int = 0, **kw):
    """(JAX config, JAX params, port ``Generator`` on the CPU) holding the
    same weights: the port's seeded init, read by the JAX package's
    ``generator_params_from_torch`` (no flax init to trace)."""
    from transeditor_tpu.config import ModelConfig as JaxConfig
    from transeditor_tpu.io.torch_port import generator_params_from_torch

    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator

    g = Generator(ModelConfig(**kw), device="cpu", seed=seed).eval()
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    jcfg = JaxConfig(**kw)
    return jcfg, generator_params_from_torch(sd, jcfg), g


def lpips_pair(net: str, seed: int = 0):
    """(JAX LPIPS params, port ``LPIPS`` on the CPU) of ``lpips_sd``."""
    from transeditor_tpu.zoo import lpips as jl

    sd = lpips_sd(net, seed)
    port = tl.LPIPS(net, device="cpu")
    port.load_state_dict(tl.load_lpips_params(torch_sd(sd), net),
                         strict=True)
    return jl.load_lpips_params(sd, net=net), port.eval()
