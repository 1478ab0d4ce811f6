"""The program's configuration objects, built from a configuration file.

The file's ``model`` keys are ``ModelConfig``'s fields and its ``train``
keys ``TrainConfig``'s, so the configuration runs as the file states it."""

from __future__ import annotations


def model_config(config: dict):
    from transeditor_tpu_torch.config import ModelConfig
    m = dict(config["model"])
    m["blur_kernel"] = tuple(m.get("blur_kernel", (1, 3, 3, 1)))
    return ModelConfig(**m, dtype=config["dtype"],
                       quantize=config.get("quantize"))


def train_config(config: dict):
    from transeditor_tpu_torch.config import TrainConfig
    return TrainConfig(**config["train"])
