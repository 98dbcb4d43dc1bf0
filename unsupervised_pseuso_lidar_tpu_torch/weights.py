"""Weight bridge: the JAX package's flax variables -> the port's state dicts.

``state_dict_from_jax(params, batch_stats, model_name)`` takes the flax
``params`` and ``batch_stats`` trees of one model as nested dicts of numpy
arrays and returns the torch state dict that the port's model of that name
loads with ``load_state_dict(strict=True)``. The mapping is this package's
own copy of unsupervised_pseuso_lidar_tpu/train/checkpoint.py
(_dispresnet_mapping :175, _pose_trunk_mapping :253, _posefc_mapping
:261, chw_to_hwc_permutation :109, _f2t_conv :90, _f2t_linear :106, the
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var rule
of export_torch_state :705), limited to the models ported so far.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

# blocks per stage of the ported DispResNet encoder (ResNet-18)
_DISPRESNET_STAGE_BLOCKS = (2, 2, 2, 2)


def _f2t_conv(w: np.ndarray) -> np.ndarray:  # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def chw_to_hwc_permutation(channels: int, height: int, width: int) -> np.ndarray:
    """Index permutation p with p[hwc_index] = chw_index for a flattened
    feature map: it maps a Linear's input columns between torch's CHW
    flatten and the JAX package's HWC flatten."""
    idx = np.arange(channels * height * width).reshape(channels, height, width)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


def _dispresnet_mapping(params: Any) -> Dict[str, Tuple[str, str]]:
    """flax path -> (torch prefix, kind) for DispResNet-18."""
    enc = "ResnetEncoder_0"
    blocks = {n for n in params[enc] if n.startswith(("BasicBlock_", "Bottleneck_"))}
    if blocks != {f"BasicBlock_{i}" for i in range(sum(_DISPRESNET_STAGE_BLOCKS))}:
        raise ValueError(f"Unsupported DispResNet encoder (blocks {sorted(blocks)})")
    m = {
        f"{enc}/TorchConv_0": ("encoder.encoder.conv1", "conv"),
        f"{enc}/BatchNorm_0": ("encoder.encoder.bn1", "bn"),
    }
    block = 0
    in_ch = 64
    for layer, num_blocks in enumerate(_DISPRESNET_STAGE_BLOCKS, start=1):
        out_ch = 64 * 2 ** (layer - 1)
        for b in range(num_blocks):
            t = f"encoder.encoder.layer{layer}.{b}"
            f = f"{enc}/BasicBlock_{block}"
            for ci in range(2):
                m[f"{f}/TorchConv_{ci}"] = (f"{t}.conv{ci + 1}", "conv")
                m[f"{f}/BatchNorm_{ci}"] = (f"{t}.bn{ci + 1}", "bn")
            stride = 2 if (layer > 1 and b == 0) else 1
            if b == 0 and (stride != 1 or in_ch != out_ch):
                m[f"{f}/TorchConv_2"] = (f"{t}.downsample.0", "conv")
                m[f"{f}/BatchNorm_2"] = (f"{t}.downsample.1", "bn")
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


_MAPPINGS = {"DispResNet": _dispresnet_mapping, "PoseNet": _posenet_mapping,
             "PoseFc": _posefc_mapping}


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
    parameter's gradient under its state-dict key."""
    if model_name not in _MAPPINGS:
        raise KeyError(f"No weight mapping for model '{model_name}'")
    out: Dict[str, np.ndarray] = {}
    for flax_path, (prefix, kind) in _MAPPINGS[model_name](params).items():
        leaf = _get_path(params, flax_path)
        if kind == "conv":
            # TorchConv / Conv3x3 hold their kernel under Conv_0
            leaf = leaf.get("Conv_0", leaf)
            out[f"{prefix}.weight"] = _f2t_conv(np.asarray(leaf["kernel"]))
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
