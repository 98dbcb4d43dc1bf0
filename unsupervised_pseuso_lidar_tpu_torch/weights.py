"""Weight bridge: the JAX package's flax variables -> the port's state dicts.

``state_dict_from_jax(params, batch_stats, model_name)`` takes the flax
``params`` and ``batch_stats`` trees of one model as nested dicts of numpy
arrays and returns the torch state dict that the port's model of that name
loads with ``load_state_dict(strict=True)``. The mappings are this
package's own copy of unsupervised_pseuso_lidar_tpu/train/checkpoint.py
(_dispresnet_mapping :175 at every depth, _dispnets_mapping :222,
_pose_trunk_mapping :253, _posefc_mapping :261, _stndispnet_mapping :272,
_bts_mapping :349,
chw_to_hwc_permutation :109, _f2t_conv :90, _f2t_convT :98, _f2t_linear
:106, and export_torch_state's (:705) BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var and GroupNorm scale/bias ->
weight/bias rules). PoseDecoder, which the JAX package maps to no torch
schema, maps onto monodepth2's (net.0 = the squeeze conv, net.1-3 = the
pose convs).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import RESNET_STAGE_BLOCKS
from unsupervised_pseuso_lidar_tpu_torch.models.depth.stn_dispnet import stn_identity_state

# (block count, bottleneck) -> DispResNet depth
_RESNET_DEPTH_BY_BLOCKS = {(8, False): 18, (16, False): 34, (16, True): 50,
                           (33, True): 101, (50, True): 152}


def _f2t_conv(w: np.ndarray) -> np.ndarray:  # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _f2t_convT(w: np.ndarray) -> np.ndarray:  # (kh, kw, in, out) -> (in, out, kh, kw)
    return np.transpose(w, (2, 3, 0, 1))


def chw_to_hwc_permutation(channels: int, height: int, width: int) -> np.ndarray:
    """Index permutation p with p[hwc_index] = chw_index for a flattened
    feature map: it maps a Linear's input columns between torch's CHW
    flatten and the JAX package's HWC flatten."""
    idx = np.arange(channels * height * width).reshape(channels, height, width)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


def _dispresnet_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    """flax path -> (torch prefix, kind) for DispResNet at the depth its
    encoder's blocks give."""
    enc = "ResnetEncoder_0"
    names = list(params[enc])
    bottleneck = any(n.startswith("Bottleneck_") for n in names)
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    count = sum(n.startswith(block_name + "_") for n in names)
    if (count, bottleneck) not in _RESNET_DEPTH_BY_BLOCKS:
        raise ValueError(f"Unsupported DispResNet encoder ({count} {block_name} blocks)")
    stage_blocks = RESNET_STAGE_BLOCKS[_RESNET_DEPTH_BY_BLOCKS[(count, bottleneck)]]
    n_convs, expansion = (3, 4) if bottleneck else (2, 1)
    m = {
        f"{enc}/TorchConv_0": ("encoder.encoder.conv1", "conv"),
        f"{enc}/BatchNorm_0": ("encoder.encoder.bn1", "bn"),
    }
    block = 0
    in_ch = 64
    for layer, num_blocks in enumerate(stage_blocks, start=1):
        out_ch = 64 * 2 ** (layer - 1) * expansion
        for b in range(num_blocks):
            t = f"encoder.encoder.layer{layer}.{b}"
            f = f"{enc}/{block_name}_{block}"
            for ci in range(n_convs):
                m[f"{f}/TorchConv_{ci}"] = (f"{t}.conv{ci + 1}", "conv")
                m[f"{f}/BatchNorm_{ci}"] = (f"{t}.bn{ci + 1}", "bn")
            stride = 2 if (layer > 1 and b == 0) else 1
            if b == 0 and (stride != 1 or in_ch != out_ch):
                m[f"{f}/TorchConv_{n_convs}"] = (f"{t}.downsample.0", "conv")
                m[f"{f}/BatchNorm_{n_convs}"] = (f"{t}.downsample.1", "bn")
            block += 1
        in_ch = out_ch
    dec = "DepthDecoder_0"
    # upconv(i, j) -> ModuleList index 2*(4-i)+j; flax ConvBlock_<index>
    for idx in range(10):
        m[f"{dec}/ConvBlock_{idx}/Conv3x3_0"] = (
            f"decoder.decoder.{idx}.conv.conv", "conv"
        )
    # scale-s head -> ModuleList index 10+s; flax Conv3x3_<3-s>
    for s in range(4):
        m[f"{dec}/Conv3x3_{3 - s}"] = (f"decoder.decoder.{10 + s}.conv", "conv")
    return m


def _dispnets_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    m: Dict[str, Tuple[str, str]] = {}
    for i in range(7):
        f = f"DownsampleConvBN_{i}"
        m[f"{f}/TorchConv_0"] = (f"conv{i + 1}.0", "conv")
        m[f"{f}/BatchNorm_0"] = (f"conv{i + 1}.2", "bn")
        m[f"{f}/TorchConv_1"] = (f"conv{i + 1}.3", "conv")
    # flax creation order: TorchConvTranspose_0-3 = upconv7-4 and
    # TorchConv_0-3 = iconv7-4, TorchConv_4 = disp4; then per level 3, 2,
    # 1 an upconv, an iconv and a disparity head
    for j in range(4):
        m[f"TorchConvTranspose_{j}"] = (f"upconv{7 - j}.0", "convT")
        m[f"TorchConv_{j}"] = (f"iconv{7 - j}.0", "conv")
    m["TorchConv_4"] = ("predict_disp4.0", "conv")
    for j, level in enumerate((3, 2, 1)):
        m[f"TorchConvTranspose_{4 + j}"] = (f"upconv{level}.0", "convT")
        m[f"TorchConv_{5 + 2 * j}"] = (f"iconv{level}.0", "conv")
        m[f"TorchConv_{6 + 2 * j}"] = (f"predict_disp{level}.0", "conv")
    return m


def _stndispnet_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    """The live subgraph: with the STN (Dense_0 in the params) the five
    localization blocks and four Linear layers come first in flax's
    creation order."""
    m: Dict[str, Tuple[str, str]] = {}

    def gn_block(f: str, t: str) -> None:
        m[f"{f}/TorchConv_0"] = (f"{t}.0", "conv")
        m[f"{f}/GroupNorm_0"] = (f"{t}.1", "gn")
        m[f"{f}/TorchConv_1"] = (f"{t}.3", "conv")
        m[f"{f}/GroupNorm_1"] = (f"{t}.4", "gn")

    enc_base = 0
    if "Dense_0" in params:
        enc_base = 5
        for j in range(5):
            gn_block(f"DownsampleConvGN_{j}", f"localization.{j}")
        # flax flattens the 32-channel localization map HWC, torch CHW
        m["Dense_0"] = ("fc_loc.0", "linear_chw:32")
        for j in range(1, 4):
            m[f"Dense_{j}"] = (f"fc_loc.{2 * j}", "linear")
    for i in range(4):
        gn_block(f"DownsampleConvGN_{enc_base + i}", f"conv{i + 1}")
    for i in range(4):
        m[f"UpconvGN_{i}/TorchConvTranspose_0"] = (f"upconv_{i + 1}.0", "convT")
        m[f"UpconvGN_{i}/GroupNorm_0"] = (f"upconv_{i + 1}.1", "gn")
    m["TorchConv_0"] = ("predict.0", "conv")
    return m


def _posenet_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    m = {f"TorchConv_{i}": (f"conv{i + 1}.0", "conv") for i in range(7)}
    m["TorchConv_7"] = ("pose_pred", "conv")
    return m


def _posefc_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    m = _posenet_mapping(params)
    # linear_chw:<C>: the flax kernel's rows follow the HWC flatten of a
    # C-channel map (the 12-channel pose_pred output), torch's columns CHW
    m["Dense_0"] = ("fc_loc.0", "linear_chw:12")
    m["Dense_1"] = ("fc_loc.2", "linear")
    m["Dense_2"] = ("fc_loc.4", "linear")
    return m


def _posedecoder_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    return {f"TorchConv_{i}": (f"net.{i}", "conv") for i in range(4)}


def _bts_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    """BtsModel: the encoder under torchvision's densenet161.features
    names (encoder.base_model.*), the decoder under the reference's."""
    m: Dict[str, Tuple[str, str]] = {}
    enc, te = "DenseNet161Encoder_0", "encoder.base_model"
    m[f"{enc}/TorchConv_0"] = (f"{te}.conv0", "conv")
    m[f"{enc}/_BN_0/BatchNorm_0"] = (f"{te}.norm0", "bn")
    layer_idx, bn_idx = 0, 1
    for b, num_layers in enumerate((6, 12, 36, 24)):
        for l in range(num_layers):
            t = f"{te}.denseblock{b + 1}.denselayer{l + 1}"
            f = f"{enc}/DenseLayer_{layer_idx}"
            m[f"{f}/_BN_0/BatchNorm_0"] = (f"{t}.norm1", "bn")
            m[f"{f}/TorchConv_0"] = (f"{t}.conv1", "conv")
            m[f"{f}/_BN_1/BatchNorm_0"] = (f"{t}.norm2", "bn")
            m[f"{f}/TorchConv_1"] = (f"{t}.conv2", "conv")
            layer_idx += 1
        if b < 3:
            t = f"{te}.transition{b + 1}"
            m[f"{enc}/_BN_{bn_idx}/BatchNorm_0"] = (f"{t}.norm", "bn")
            m[f"{enc}/TorchConv_{bn_idx}"] = (f"{t}.conv", "conv")
            bn_idx += 1
    m[f"{enc}/_BN_{bn_idx}/BatchNorm_0"] = (f"{te}.norm5", "bn")

    dec = "BtsDecoder_0"

    def upconv(fi, name):
        m[f"{dec}/UpConv_{fi}/TorchConv_0"] = (f"decoder.{name}.conv", "conv")

    def bn(fi, name):
        m[f"{dec}/_BN_{fi}/BatchNorm_0"] = (f"decoder.{name}", "bn")

    def conv(fi, name):
        m[f"{dec}/TorchConv_{fi}"] = (f"decoder.{name}", "conv")

    def atrous(fi, name, bn_first):
        f, t = f"{dec}/AtrousConv_{fi}", f"decoder.{name}.atrous_conv"
        if bn_first:
            m[f"{f}/_BN_0/BatchNorm_0"] = (f"{t}.first_bn", "bn")
        m[f"{f}/TorchConv_0"] = (f"{t}.aconv_sequence.1", "conv")
        m[f"{f}/_BN_{int(bn_first)}/BatchNorm_0"] = (f"{t}.aconv_sequence.2", "bn")
        m[f"{f}/Conv_0"] = (f"{t}.aconv_sequence.4", "conv")

    def reduction(fi, name, cin, width, is_final):
        f, t = f"{dec}/Reduction1x1_{fi}", f"decoder.{name}.reduc"
        ci = 0
        while width >= 4:
            if width < 8:
                m[f"{f}/TorchConv_{ci}"] = (
                    f"{t}.final.0" if is_final else f"{t}.plane_params", "conv")
                break
            m[f"{f}/TorchConv_{ci}"] = (f"{t}.inter_{cin}_{width}.0", "conv")
            cin, width, ci = width, width // 2, ci + 1

    # the decoder's width from its first conv (num_features)
    nf = int(np.shape(params[dec]["UpConv_0"]["TorchConv_0"]["Conv_0"]["kernel"])[-1])
    upconv(0, "upconv5"); bn(0, "bn5"); conv(0, "conv5.0")
    upconv(1, "upconv4"); bn(1, "bn4"); conv(1, "conv4.0"); bn(2, "bn4_2")
    for fi, d in enumerate((3, 6, 12, 18, 24)):
        atrous(fi, f"daspp_{d}", bn_first=d != 3)
    conv(2, "daspp_conv.0")
    reduction(0, "reduc8x8", nf // 4, nf // 4, False)
    upconv(2, "upconv3"); bn(3, "bn3"); conv(3, "conv3.0")
    reduction(1, "reduc4x4", nf // 4, nf // 8, False)
    upconv(3, "upconv2"); bn(4, "bn2"); conv(4, "conv2.0")
    reduction(2, "reduc2x2", nf // 8, nf // 16, False)
    upconv(4, "upconv1")
    reduction(3, "reduc1x1", nf // 16, nf // 32, True)
    conv(5, "conv1.0")
    conv(6, "get_depth.0")
    return m


_MAPPINGS = {"BtsModel": _bts_mapping, "DispNetS": _dispnets_mapping,
             "DispResNet": _dispresnet_mapping, "StnDispNet": _stndispnet_mapping,
             "PoseNet": _posenet_mapping, "PoseFc": _posefc_mapping,
             "PoseDecoder": _posedecoder_mapping}


def _get_path(tree: Any, path: str) -> Any:
    for part in path.split("/"):
        tree = tree[part]
    return tree


def state_dict_from_jax(
    params: Any, batch_stats: Any, model_name: str
) -> Dict[str, torch.Tensor]:
    """Flax variables of `model_name` (nested dicts of numpy arrays) ->
    the port model's torch state dict (CPU tensors).

    With batch_stats None the BatchNorm buffers are left out, so the
    function also maps a GRADIENT tree (the params' structure): every
    transform of the mapping is linear, and the result holds each
    parameter's gradient under its state-dict key. A StnDispNet without
    the STN gets the JAX export's identity branch (stn_identity_state)
    unless batch_stats is None: a gradient tree has no dead branch."""
    if model_name not in _MAPPINGS:
        raise KeyError(f"No weight mapping for model '{model_name}'")
    out: Dict[str, np.ndarray] = {}
    if model_name == "StnDispNet" and "Dense_0" not in params and batch_stats is not None:
        out.update({k: v.numpy() for k, v in stn_identity_state().items()})
    for flax_path, (prefix, kind) in _MAPPINGS[model_name](params).items():
        leaf = _get_path(params, flax_path)
        if kind == "conv":
            # TorchConv / Conv3x3 hold their kernel under Conv_0
            leaf = leaf.get("Conv_0", leaf)
            out[f"{prefix}.weight"] = _f2t_conv(np.asarray(leaf["kernel"]))
            if "bias" in leaf:
                out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
        elif kind == "convT":
            out[f"{prefix}.weight"] = _f2t_convT(np.asarray(leaf["kernel"]))
            if "bias" in leaf:
                out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
        elif kind.startswith("linear"):
            kernel = np.asarray(leaf["kernel"])  # (in, out)
            if kind.startswith("linear_chw"):
                # only the (C, H*W) split matters, not H and W apart
                channels = int(kind.split(":", 1)[1])
                perm = chw_to_hwc_permutation(channels, 1, kernel.shape[0] // channels)
                kernel = kernel[np.argsort(perm)]
            out[f"{prefix}.weight"] = kernel.T
            out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
        elif kind == "gn":
            out[f"{prefix}.weight"] = np.asarray(leaf["scale"])
            out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
        else:  # bn
            out[f"{prefix}.weight"] = np.asarray(leaf["scale"])
            out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
            if batch_stats is None:
                continue
            stats = _get_path(batch_stats, flax_path)
            out[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
            out[f"{prefix}.running_var"] = np.asarray(stats["var"])
            out[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)
    return {
        k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()
    }
