"""Seeded weights in the reference checkpoint's key layout, made on the
device in one draw.

The reference modules (``portbench/reference/model.py``) record how each
parameter is initialised: ``("randn", std)`` or ``("const", value)``.  Every
random tensor, in module order, takes its slice of one ``torch.randn`` of
the total size, drawn by a ``torch.Generator`` on the device from the seed;
the noise buffers are random too.  The same seed gives the same state dict,
so the weights are made again after the window for the reference instead of
being kept through it.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference import model as ref


def templates(mcfg: dict, device, discriminator: bool = True):
    """Uninitialised reference modules on ``device`` (``torch.empty``)."""
    with torch.device(device):
        g = ref.Generator(mcfg)
        d = ref.Discriminator(mcfg) if discriminator else None
    return g, d


def fill_(modules, seed: int, device) -> None:
    """Initialise ``modules`` in place from ``seed``: one randn on the
    device for every random tensor, constants filled."""
    rand, consts = [], []
    for mod in modules:
        for _, m in mod.named_modules():
            if isinstance(m, ref.Param):
                for name, (kind, value) in m.init.items():
                    t = getattr(m, name)
                    (rand if kind == "randn" else consts).append((t, value))
        for name, b in mod.named_buffers():
            if ".noise_" in name or name.startswith("noise_"):
                rand.append((b, 1.0))
    total = sum(t.numel() for t, _ in rand)
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    with torch.no_grad():
        for t, std in rand:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t) * std)
            at += n
        for t, value in consts:
            t.fill_(value)


def make(mcfg: dict, seed: int, device, discriminator: bool = True):
    """(reference generator, reference discriminator or None), float32 on
    ``device``, initialised from ``seed``."""
    g, d = templates(mcfg, device, discriminator)
    fill_([m for m in (g, d) if m is not None], seed, device)
    return g, d


def state_dict(module: nn.Module) -> dict:
    return {k: v.detach() for k, v in module.state_dict().items()}
