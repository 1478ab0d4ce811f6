"""Checkpoints: reference-layout ``.pt`` bundles and the train state.

The reference saves ``{'g', 'd', 'g_ema', 'g_optim', 'd_optim'}``
bundles of state dicts.  The port names its parameters as those keys,
so a generator or discriminator state dict loads unchanged.

``save_train_state`` / ``restore_train_state`` keep the whole train
state (g, d, g_ema, both optimizers, the step and the two path-length
means) in one ``torch.save`` file a step, ``<ckpt_dir>/<step:06d>.pt``.
As in the JAX package (``cli/train_gan.py:114-119``), checkpoint ``i``
is the state after step ``i``, so a resumed run starts at ``i + 1``.
``save_train_state(..., async_save=True)`` copies the state to host
memory and writes the file on a background thread (at most one write
in flight; ``wait_for_saves`` waits for it).  A sharded state
(``train/gan.py::shard_state``) is gathered first, so every file has
the one-process format whatever mesh wrote it.

``save_coach_state`` / ``restore_coach_state`` keep the encoder coach's
state (``train/coach.py``) in one ``torch.save`` file; the JAX coach's
orbax directories are not read (the port has no JAX).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, Optional

import torch

from transeditor_tpu_torch.config import ModelConfig


def _reference_entry(pt_path: str, key: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    if key not in ckpt:
        raise KeyError(f"{pt_path} has no {key!r} (keys: {sorted(ckpt)})")
    return ckpt[key]


def load_reference_generator(pt_path: str, cfg: ModelConfig,
                             key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """The ``key`` generator state dict of a reference ``.pt`` bundle
    (CPU tensors).  Raises if its synthesis depth is not ``cfg.size``'s."""
    sd = _reference_entry(pt_path, key)
    last = cfg.log_size - 3                  # index of the last ToRGB
    if (f"to_rgbs.{last}.conv.weight" not in sd
            or f"to_rgbs.{last + 1}.conv.weight" in sd):
        raise ValueError(f"{pt_path}[{key!r}] is not a {cfg.size}px "
                         f"generator")
    return sd


def load_reference_discriminator(pt_path: str, cfg: ModelConfig
                                 ) -> Dict[str, torch.Tensor]:
    """The ``d`` state dict of a reference ``.pt`` bundle (CPU tensors).
    Raises if its number of res blocks is not ``cfg.size``'s."""
    sd = _reference_entry(pt_path, "d")
    last = cfg.log_size - 2                  # index of the last res block
    if (f"convs.{last}.conv1.0.weight" not in sd
            or f"convs.{last + 1}.conv1.0.weight" in sd):
        raise ValueError(f"{pt_path}['d'] is not a {cfg.size}px "
                         f"discriminator")
    return sd


def full_state_dicts(state: Any) -> Dict[str, Any]:
    """The checkpoint's entries of ``state`` (a ``GANTrainState``): the
    three modules' and two optimizers' state dicts, the step and the
    path-length means, as references to the live tensors.  A sharded
    state is gathered to full tensors first: a collective, which every
    rank calls."""
    sh = state.sharding
    out: Dict[str, Any] = {}
    for key, module, layout in (("g", state.g, sh and sh.g),
                                ("d", state.d, sh and sh.d),
                                ("g_ema", state.g_ema, sh and sh.g_ema)):
        if layout is None:
            out[key] = module.state_dict()
        else:
            with layout.gathered():
                out[key] = module.state_dict()
    for key, opt, layout in (("g_optim", state.opt_g, sh and sh.g),
                             ("d_optim", state.opt_d, sh and sh.d)):
        out[key] = (opt.state_dict() if layout is None
                    else layout.full_optimizer_state(opt))
    out["step"] = int(state.step)
    out["mean_path_length"] = state.mean_path_length.detach()
    out["mean_spatial_path_length"] = \
        state.mean_spatial_path_length.detach()
    return out


def host_copy(obj: Any) -> Any:
    """``obj`` (dicts, lists and tuples of tensors and plain values) with
    every tensor copied into new CPU memory: the copy stays as it is
    while the modules and optimizers change in place."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def _write(bundle: Dict[str, Any], path: str) -> None:
    """``torch.save`` beside ``path``, then rename: whole or absent."""
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)


class AsyncSaver:
    """Runs one write at a time on a background thread.  ``submit``
    waits for the write in flight before it starts the next; ``wait``
    joins it and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None], what: str) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:       # handed to the next wait()
                self._error = RuntimeError(f"background save of {what} "
                                           f"failed: {e!r}")
                self._error.__cause__ = e

        self._thread = threading.Thread(target=run, name="train-state-save")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err


_saver = AsyncSaver()


def save_train_state(ckpt_dir: str, step: int, state: Any,
                     async_save: bool = False) -> str:
    """Write ``state`` (a ``train.gan.GANTrainState``, or the
    ``host_copy`` of its ``full_state_dicts``) as the checkpoint of
    ``step``; returns its path.  The file appears whole or not at all
    (written beside, then renamed).

    ``async_save=True`` returns once the state is copied to host memory
    and writes on a background thread, so training goes on; a new save
    waits for the one in flight first, and ``wait_for_saves()`` waits
    for it (before the process exits or reads the file).  A sharded
    state must be passed gathered (every rank computes
    ``full_state_dicts``; one writes)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:06d}.pt")
    bundle = state if isinstance(state, dict) else host_copy(
        full_state_dicts(state))
    if async_save:
        _saver.submit(lambda: _write(bundle, path), path)
    else:
        _saver.wait()
        _write(bundle, path)
    return path


def wait_for_saves() -> None:
    """Block until the background save in flight, if any, is written;
    raises its error."""
    _saver.wait()


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """Steps with a train-state checkpoint under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"(\d+)\.pt", f) for f in os.listdir(ckpt_dir))
                  if m)


def _checkpoint_path(ckpt_dir: str, step: Optional[int]) -> tuple[str, int]:
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    return os.path.join(ckpt_dir, f"{step:06d}.pt"), step


def load_train_state_bundle(ckpt_dir: str, step: Optional[int] = None
                            ) -> tuple[Dict[str, Any], int]:
    """The whole train-state bundle (CPU tensors) of the latest (or
    ``step``'s) checkpoint under ``ckpt_dir``, and its step."""
    path, step = _checkpoint_path(ckpt_dir, step)
    return torch.load(path, map_location="cpu", weights_only=True), step


def load_train_state_generator(ckpt_dir: str, step: Optional[int] = None
                               ) -> tuple[Dict[str, torch.Tensor], int]:
    """The g_ema state dict (CPU tensors) of the latest (or ``step``'s)
    train-state checkpoint under ``ckpt_dir``, and its step."""
    bundle, step = load_train_state_bundle(ckpt_dir, step)
    return bundle["g_ema"], step


def export_reference_checkpoint(
        path: str, *, g_ema: Optional[Dict[str, torch.Tensor]] = None,
        g: Optional[Dict[str, torch.Tensor]] = None,
        d: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write a reference-layout ``{'g', 'd', 'g_ema'}`` bundle, each state
    dict given as CPU tensors, without optimizer
    states (``transeditor_tpu/io/torch_export.py::
    export_reference_checkpoint``).  The port's names are the reference
    keys, so ``Generator(...).load_state_dict(ckpt['g_ema'])`` of the
    reference code loads it.  Written beside, then renamed."""
    bundle: Dict[str, Any] = {}
    for key, sd in (("g", g), ("d", d), ("g_ema", g_ema)):
        if sd is not None:
            bundle[key] = {k: v.detach().cpu() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)


def restore_train_state(ckpt_dir: str, template: Any,
                        step: Optional[int] = None):
    """Load the latest (or ``step``'s) checkpoint into ``template`` (a
    ``GANTrainState`` of the same configuration, e.g. from
    ``init_state``), in place, on its device.  Returns (state, step)."""
    path, step = _checkpoint_path(ckpt_dir, step)
    dev = template.mean_path_length.device
    bundle = torch.load(path, map_location=dev, weights_only=True)
    template.g.load_state_dict(bundle["g"], strict=True)
    template.d.load_state_dict(bundle["d"], strict=True)
    template.g_ema.load_state_dict(bundle["g_ema"], strict=True)
    template.opt_g.load_state_dict(bundle["g_optim"])
    template.opt_d.load_state_dict(bundle["d_optim"])
    template.step = bundle["step"]
    template.mean_path_length = bundle["mean_path_length"].to(dev)
    template.mean_spatial_path_length = \
        bundle["mean_spatial_path_length"].to(dev)
    return template, step


# ---------------------------------------------------------------------
# coach checkpoints (the JAX CLI writes orbax directories ``best_model``
# and ``ckpt_{step:06d}``; the port writes ``best_model.pt`` and
# ``ckpt_{step:06d}.pt``, one torch.save file each)

def save_coach_state(path: str, state: Any) -> str:
    """Write a ``train.coach.CoachState`` (encoder state dict with its
    BatchNorm buffers, optimizer state dict, step, best validation loss)
    to ``path``, whole or not at all (written beside, then renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    bundle = {"encoder": state.encoder.state_dict(),
              "optimizer": state.optimizer.state_dict(),
              "step": int(state.step),
              "best_val_loss": float(state.best_val_loss)}
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)
    return path


def read_torch_file(path: str) -> Dict[str, Any]:
    """``torch.load`` of ``path`` on the CPU.  A directory, as the JAX
    coach's orbax checkpoints are, raises ``ValueError`` naming the
    format: the port has no JAX to read it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX "
            f"package's coach? The PyTorch port reads torch.save files "
            f"(a pSp .pt / .pth, or its own best_model.pt / ckpt_*.pt)")
    return torch.load(path, map_location="cpu", weights_only=True)


def is_coach_bundle(bundle: Dict[str, Any]) -> bool:
    return "encoder" in bundle and "optimizer" in bundle


def load_coach_bundle(path: str) -> Dict[str, Any]:
    """The dict ``save_coach_state`` wrote (CPU tensors)."""
    bundle = read_torch_file(path)
    if not is_coach_bundle(bundle):
        raise ValueError(f"{path} is not a coach checkpoint "
                         f"(keys: {sorted(bundle)})")
    return bundle


def restore_coach_state(path: str, template: Any):
    """Load ``path`` into ``template`` (a ``CoachState`` of the same
    encoder shape, e.g. from ``make_coach``'s ``init_fn``), in place, on
    its device.  Returns the state."""
    bundle = load_coach_bundle(path)
    template.encoder.load_state_dict(bundle["encoder"], strict=True)
    template.optimizer.load_state_dict(bundle["optimizer"])
    template.step = bundle["step"]
    template.best_val_loss = bundle["best_val_loss"]
    return template
