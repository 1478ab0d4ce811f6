"""JAX parameter trees -> the port's (reference-layout) state dicts.

The port's own copy of the name mapping in
``transeditor_tpu/io/torch_export.py`` (``generator_state_dict`` and
``discriminator_state_dict``); it takes the trees as numpy arrays, so no
JAX is needed here:

  JAX tree                        state dict
  ------------------------------- ------------------------------------
  kernel [in, out]                weight [out, in]              (.T)
  conv weight [kh, kw, I, O]      weight [1, O, I, kh, kw]
  stacked mapping [n, in, out]    {prefix}.{i+1}.weight / .bias
  StyledConv 'bias'               activate.bias
  ToRGB bias [3]                  bias [1, 3, 1, 1]
  ConvLayer conv weight [kh,kw,I,O] {prefix}.{0|1}.weight [O, I, kh, kw]
  ConvLayer 'bias'                {prefix}.{1|2}.bias (the activation)

plus the buffers the reference registers (``token`` and
``token_spatial`` identities, ``blur.kernel`` / ``upsample.kernel``,
``noises.noise_i``, the discriminator's blur ``kernel``s), so the
results load into ``Generator`` and ``Discriminator`` with
``strict=True``.  The encoder zoo (IR-SE trunks, ArcFace, the pSp
encoders) maps flax variables, ``params`` and ``batch_stats``, to the
InsightFace / pSp layouts (``transeditor_tpu/io/zoo_port.py`` read
backwards).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from transeditor_tpu_torch.config import ModelConfig


def _blur_kernel(scale: int = 1) -> np.ndarray:
    k = np.array([1.0, 3.0, 3.0, 1.0], np.float32)
    k = np.outer(k, k)
    return (k / k.sum() * scale).astype(np.float32)


def _lin(sd, prefix, tree):
    sd[f"{prefix}.weight"] = np.asarray(tree["kernel"], np.float32).T
    if "bias" in tree:
        sd[f"{prefix}.bias"] = np.asarray(tree["bias"], np.float32)


def _modconv(sd, prefix, tree, blur_scale=None):
    w = np.transpose(np.asarray(tree["weight"], np.float32),
                     (3, 2, 0, 1))                 # HWIO -> OIHW
    sd[f"{prefix}.weight"] = w[None]
    _lin(sd, f"{prefix}.modulation", tree["modulation"])
    if blur_scale is not None:
        sd[f"{prefix}.blur.kernel"] = _blur_kernel(blur_scale)


def _styled_conv(sd, prefix, tree, upsample=False):
    _modconv(sd, f"{prefix}.conv", tree["conv"],
             blur_scale=4 if upsample else None)
    sd[f"{prefix}.activate.bias"] = np.asarray(tree["bias"], np.float32)
    nw = np.asarray(tree.get("noise_weight", 0.0), np.float32)
    sd[f"{prefix}.noise.weight"] = nw.reshape(1)


def _to_rgb(sd, prefix, tree, upsample=True):
    _modconv(sd, f"{prefix}.conv", tree["conv"])
    sd[f"{prefix}.bias"] = np.asarray(tree["bias"],
                                      np.float32).reshape(1, 3, 1, 1)
    if upsample:
        sd[f"{prefix}.upsample.kernel"] = _blur_kernel(4)


def _token_mapping(sd, prefix, tree):
    ks = np.asarray(tree["kernel"], np.float32)    # [n, in, out]
    bs = np.asarray(tree["bias"], np.float32)      # [n, out]
    for i in range(ks.shape[0]):
        sd[f"{prefix}.{i + 1}.weight"] = ks[i].T
        sd[f"{prefix}.{i + 1}.bias"] = bs[i]


def generator_state_dict_from_jax(params_np: Dict[str, Any],
                                  cfg: ModelConfig,
                                  noise_seed: int = 0
                                  ) -> Dict[str, torch.Tensor]:
    """JAX Generator param tree (numpy leaves, with or without the
    top-level ``'params'``) -> the port's state dict of float32 tensors."""
    p = params_np.get("params", params_np)
    sd: Dict[str, np.ndarray] = {}

    sd["token"] = np.eye(cfg.token_dim, dtype=np.float32)
    sd["token_spatial"] = np.eye(16, dtype=np.float32)

    _token_mapping(sd, "style_mapping_network", p["style_mapping"])
    if cfg.use_spatial_mapping:
        _token_mapping(sd, "spatial_mapping_network", p["spatial_mapping"])

    if not cfg.no_trans:
        for i in range(cfg.n_trans):
            blk = p[f"interact_{i}"]
            pre = f"interact.{i}"
            _lin(sd, f"{pre}.atten.q_transform", blk["atten"]["q"])
            _lin(sd, f"{pre}.atten.k_transform", blk["atten"]["k"])
            _lin(sd, f"{pre}.atten.v_transform", blk["atten"]["v"])
            _lin(sd, f"{pre}.atten.proj", blk["atten"]["proj"])
            _lin(sd, f"{pre}.mlp.0", blk["mlp_0"])
            _lin(sd, f"{pre}.mlp.2", blk["mlp_1"])
            if "proj" in blk:
                _lin(sd, f"{pre}.proj", blk["proj"])

    _lin(sd, "adjust_style", p["adjust_style"])

    _styled_conv(sd, "conv1", p["conv1"])
    _to_rgb(sd, "to_rgb1", p["to_rgb1"], upsample=False)
    for idx, i in enumerate(range(3, cfg.log_size + 1)):
        _styled_conv(sd, f"convs.{2 * idx}", p[f"conv_up_{i}"],
                     upsample=True)
        _styled_conv(sd, f"convs.{2 * idx + 1}", p[f"conv_{i}"])
        _to_rgb(sd, f"to_rgbs.{idx}", p[f"to_rgb_{i}"])

    # noise buffers: layer i lives at resolution 2^((i+5)//2)
    rng = np.random.RandomState(noise_seed)
    for i in range(cfg.num_layers):
        res = 2 ** ((i + 5) // 2)
        sd[f"noises.noise_{i}"] = rng.randn(1, 1, res, res).astype(
            np.float32)
    return {k: torch.from_numpy(np.array(v, np.float32))   # owned copies
            for k, v in sd.items()}


def _conv_layer(sd, prefix, tree, downsample=False, activate=True):
    idx = 0
    if downsample:
        sd[f"{prefix}.0.kernel"] = _blur_kernel(1)
        idx = 1
    sd[f"{prefix}.{idx}.weight"] = np.transpose(
        np.asarray(tree["conv"]["weight"], np.float32), (3, 2, 0, 1))
    if activate and "bias" in tree:
        sd[f"{prefix}.{idx + 1}.bias"] = np.asarray(tree["bias"], np.float32)
    elif "bias" in tree.get("conv", {}):
        sd[f"{prefix}.{idx}.bias"] = np.asarray(tree["conv"]["bias"],
                                                np.float32)


def discriminator_state_dict_from_jax(params_np: Dict[str, Any],
                                      cfg: ModelConfig
                                      ) -> Dict[str, torch.Tensor]:
    """JAX Discriminator param tree (numpy leaves, with or without the
    top-level ``'params'``) -> the port's state dict of float32 tensors."""
    p = params_np.get("params", params_np)
    sd: Dict[str, np.ndarray] = {}
    _conv_layer(sd, "convs.0", p["from_rgb"])
    for j, i in enumerate(range(cfg.log_size, 2, -1)):
        pre = f"convs.{j + 1}"
        blk = p[f"res_{i}"]
        _conv_layer(sd, f"{pre}.conv1", blk["conv1"])
        _conv_layer(sd, f"{pre}.conv2", blk["conv2"], downsample=True)
        _conv_layer(sd, f"{pre}.skip", blk["skip"], downsample=True,
                    activate=False)
    _conv_layer(sd, "final_conv", p["final_conv"])
    _lin(sd, "final_linear.0", p["final_linear_0"])
    _lin(sd, "final_linear.1", p["final_linear_1"])
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


# ---------------------------------------------------------------------
# the encoder zoo: flax variables ({'params', 'batch_stats'}, numpy
# leaves) -> InsightFace / pSp-layout state dicts (conv kernels HWIO ->
# OIHW, Dense / EqualLinear kernels [in, out] -> [out, in]; flax
# BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
# running_var, num_batches_tracked 0)

def _conv_oihw(w) -> np.ndarray:
    return np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))


def _batch_norm(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = np.asarray(params["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"], np.float32)
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"], np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_bias(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _conv_oihw(tree["kernel"])
    if "bias" in tree:
        sd[f"{prefix}.bias"] = np.asarray(tree["bias"], np.float32)


def _torch_sd(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _irse_trunk(sd, params, stats):
    """models/irse.py::IRSEBackbone ('trunk' subtree) -> input_layer.*,
    body.{i}.*; the unit count and SE come from the tree."""
    sd["input_layer.0.weight"] = _conv_oihw(params["input_conv"]["conv"]
                                            ["kernel"])
    _batch_norm(sd, "input_layer.1", params["input_bn"]["bn"],
                stats["input_bn"]["bn"])
    sd["input_layer.2.weight"] = np.asarray(params["input_prelu"]["alpha"],
                                            np.float32)
    i = 0
    while f"body_{i}" in params:
        bp, bs, pre = params[f"body_{i}"], stats[f"body_{i}"], f"body.{i}"
        if "shortcut_conv" in bp:
            sd[f"{pre}.shortcut_layer.0.weight"] = _conv_oihw(
                bp["shortcut_conv"]["conv"]["kernel"])
            _batch_norm(sd, f"{pre}.shortcut_layer.1",
                        bp["shortcut_bn"]["bn"], bs["shortcut_bn"]["bn"])
        _batch_norm(sd, f"{pre}.res_layer.0", bp["res_bn1"]["bn"],
                    bs["res_bn1"]["bn"])
        sd[f"{pre}.res_layer.1.weight"] = _conv_oihw(
            bp["res_conv1"]["conv"]["kernel"])
        sd[f"{pre}.res_layer.2.weight"] = np.asarray(
            bp["res_prelu"]["alpha"], np.float32)
        sd[f"{pre}.res_layer.3.weight"] = _conv_oihw(
            bp["res_conv2"]["conv"]["kernel"])
        _batch_norm(sd, f"{pre}.res_layer.4", bp["res_bn2"]["bn"],
                    bs["res_bn2"]["bn"])
        if "se" in bp:
            for fc in ("fc1", "fc2"):
                sd[f"{pre}.res_layer.5.{fc}.weight"] = _conv_oihw(
                    bp["se"][fc]["conv"]["kernel"])
        i += 1


def irse_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``IRSEBackbone`` variables -> the port's ``IRSEBackbone``
    state dict."""
    sd: Dict[str, np.ndarray] = {}
    _irse_trunk(sd, variables["params"], variables["batch_stats"])
    return _torch_sd(sd)


def arcface_state_dict_from_jax(variables: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``ArcFaceBackbone`` variables -> the port's ``ArcFaceBackbone``
    state dict (``output_layer.{0,3,4}``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _irse_trunk(sd, p["trunk"], s["trunk"])
    _batch_norm(sd, "output_layer.0", p["out_bn1"]["bn"], s["out_bn1"]["bn"])
    _lin(sd, "output_layer.3", p["out_linear"])
    _batch_norm(sd, "output_layer.4", p["out_bn2"], s["out_bn2"])
    return _torch_sd(sd)


def _style_block(sd, prefix, tree):
    n = 0
    while f"conv{n}" in tree:
        _conv_bias(sd, f"{prefix}.convs.{2 * n}", tree[f"conv{n}"])
        n += 1
    _lin(sd, f"{prefix}.linear", tree["linear"])


def gradual_style_encoder_state_dict_from_jax(variables: Dict[str, Any]
                                              ) -> Dict[str, torch.Tensor]:
    """JAX ``GradualStyleEncoder`` variables (any head counts) -> the
    port's ``GradualStyleEncoder`` state dict (pSp layout, no
    ``encoder.`` prefix)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _irse_trunk(sd, p["trunk"], s["trunk"])
    for kind, name in (("style", "styles"), ("spatial", "spatials")):
        j = 0
        while f"{kind}_{j}" in p:
            _style_block(sd, f"{name}.{j}", p[f"{kind}_{j}"])
            j += 1
    _conv_bias(sd, "latlayer1", p["latlayer1"]["conv"])
    _conv_bias(sd, "latlayer2", p["latlayer2"]["conv"])
    _lin(sd, "adjust_style", p["adjust_style"])
    return _torch_sd(sd)


def backbone_encoder_into_w_state_dict_from_jax(variables: Dict[str, Any]
                                                ) -> Dict[str, torch.Tensor]:
    """JAX ``BackboneEncoderIntoW`` variables -> the port's state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _irse_trunk(sd, p["trunk"], s["trunk"])
    _lin(sd, "linear", p["linear"])
    return _torch_sd(sd)


def backbone_encoder_into_wplus_state_dict_from_jax(
        variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``BackboneEncoderIntoWPlus`` variables -> the port's state
    dict (``output_layer_2.{0,3}``, ``linear``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _irse_trunk(sd, p["trunk"], s["trunk"])
    _batch_norm(sd, "output_layer_2.0", p["out_bn"]["bn"], s["out_bn"]["bn"])
    _lin(sd, "output_layer_2.3", p["out_linear"])
    _lin(sd, "linear", p["linear"])
    return _torch_sd(sd)


# ---------------------------------------------------------------------
# the editing classifiers: flax trees (numpy leaves) -> the reference
# layouts (``transeditor_tpu/edit/{classifiers,celebahq_classifier}.py``'s
# ``port_dex_vgg`` / ``port_pose_classifier`` / ``port_celebahq_classifier``
# read backwards)

def dex_vgg_state_dict_from_jax(variables: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``DexVGG`` variables -> the DEX layout (``conv.{b}.conv{i}``,
    ``fc1.0``, ``fc2.0``, ``cls``) of the port's ``DexVGG``."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    b = 0
    while f"b{b}_conv0" in p:
        c = 0
        while f"b{b}_conv{c}" in p:
            _conv_bias(sd, f"conv.{b}.conv{c + 1}", p[f"b{b}_conv{c}"])
            c += 1
        b += 1
    _lin(sd, "fc1.0", p["fc1"])
    _lin(sd, "fc2.0", p["fc2"])
    _lin(sd, "cls", p["cls"])
    return _torch_sd(sd)


def pose_classifier_state_dict_from_jax(variables: Dict[str, Any]
                                        ) -> Dict[str, torch.Tensor]:
    """JAX ``PoseClassifier`` variables -> the ClassifyModel layout
    (``backbone.{0,1,4..7}``, ``extra_layer``) of the port's
    ``PoseClassifier``."""
    p = variables["params"]["backbone"]
    s = variables["batch_stats"]["backbone"]
    sd: Dict[str, np.ndarray] = {}
    sd["backbone.0.weight"] = _conv_oihw(p["conv1"]["kernel"])
    _batch_norm(sd, "backbone.1", p["bn1"], s["bn1"])
    for blk in range(8):             # layer1..4 are Sequential 4..7
        bp, bs = p[f"block{blk}"], s[f"block{blk}"]
        pre = f"backbone.{4 + blk // 2}.{blk % 2}"
        sd[f"{pre}.conv1.weight"] = _conv_oihw(bp["conv1"]["kernel"])
        _batch_norm(sd, f"{pre}.bn1", bp["bn1"], bs["bn1"])
        sd[f"{pre}.conv2.weight"] = _conv_oihw(bp["conv2"]["kernel"])
        _batch_norm(sd, f"{pre}.bn2", bp["bn2"], bs["bn2"])
        if "down_conv" in bp:
            sd[f"{pre}.downsample.0.weight"] = _conv_oihw(
                bp["down_conv"]["kernel"])
            _batch_norm(sd, f"{pre}.downsample.1", bp["down_bn"],
                        bs["down_bn"])
    _lin(sd, "extra_layer", variables["params"]["extra_layer"])
    return _torch_sd(sd)


def celebahq_classifier_state_dict_from_jax(variables: Dict[str, Any]
                                            ) -> Dict[str, torch.Tensor]:
    """JAX ``CelebAHQAttributeClassifier`` variables -> the gan-ensembling
    D layout (``fromrgb_lod0.conv``, ``{R}x{R}.conv{0,1}``, ``4x4.conv``,
    ``4x4.dense{0,1}``) of the port's classifier."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, tree):
        sd[f"{prefix}.conv.weight"] = _conv_oihw(tree["weight"])
        sd[f"{prefix}.wscale.b"] = np.asarray(tree["bias"], np.float32)

    def dense(prefix, tree):
        sd[f"{prefix}.linear.weight"] = np.asarray(tree["weight"],
                                                   np.float32).T
        sd[f"{prefix}.wscale.b"] = np.asarray(tree["bias"], np.float32)

    conv("fromrgb_lod0.conv", p["fromrgb"])
    for name in p:
        if name.startswith("block_") and name.endswith("_conv0"):
            r = name[len("block_"):-len("_conv0")]
            conv(f"{r}x{r}.conv0", p[name])
            conv(f"{r}x{r}.conv1", p[f"block_{r}_conv1"])
    conv("4x4.conv", p["pred_conv"])
    dense("4x4.dense0", p["pred_dense0"])
    dense("4x4.dense1", p["pred_dense1"])
    return _torch_sd(sd)


# ---------------------------------------------------------------------
# the FID InceptionV3: the JAX ``InceptionV3Features`` tree (BN already
# folded) -> the port's ``{name}.{weight,scale,bias}``

def inception_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3Features`` variables (``port_fid_inception_weights``'s
    tree) -> the port's ``InceptionV3Features`` state dict: each ConvBN's
    HWIO ``weight`` to OIHW, its ``scale`` and ``bias`` as they are."""
    sd: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if "weight" in tree:
            sd[f"{prefix}.weight"] = _conv_oihw(tree["weight"])
            sd[f"{prefix}.scale"] = np.asarray(tree["scale"], np.float32)
            sd[f"{prefix}.bias"] = np.asarray(tree["bias"], np.float32)
            return
        for k, v in tree.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(variables["params"], "")
    return _torch_sd(sd)
