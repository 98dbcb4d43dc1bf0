"""Checkpoints, pretrained init and reference-schema `.pth` interop.

Counterpart of unsupervised_pseuso_lidar_tpu/train/checkpoint.py
(CheckpointManager :42-78, import_torch_state :442 for the depth models
other than DispResNet, normalize_depth_pretrained_state :620,
load_pretrained_depth :676, load_pretrained_pose :688, export_torch_state
:705, export_reference_checkpoint :824, export_bts_serving_checkpoint
:864, load_torch_checkpoint :882, load_serving_weights :891, without
orbax).

A checkpoint is one `.pth` file per epoch,
`<directory>/epoch_<nnnnn>.pth`, holding the reference trainer's schema
{epoch, dpth_mdl_state_dict, pose_mdl_state_dict, optimizer_state_dict}
(the reference's trainer.py:132-137) plus `scheduler_state_dict` and
`step`. The port's models already use the reference's state-dict keys, so
reference tooling loads a port checkpoint's models as they are, and
restoring one gives back every parameter, BatchNorm buffer and Adam
moment bit for bit (JAX's orbax restore is exact too).

The JAX package keeps its checkpoints as orbax directories, which the port
cannot read (it does not import JAX). A JAX-trained model reaches the port
through the JAX package's `cli/export --format torch`, which writes a
reference-schema `.pth`; point `model.depth.pretrained_path` and
`model.pose.pretrained_path` at it.

StnDispNet's STN branch follows the JAX package's rules both ways
(models/depth/stn_dispnet.py): a loader keeps the model's own branch
where the model does not use it or where the blob's is of another
resolution (JAX's import ignores it then), and an export writes the
identity branch at the reference's size where the model's live branch is
of another size (a strict reference load needs the fixed width).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import DispResNet
from unsupervised_pseuso_lidar_tpu_torch.models.depth.stn_dispnet import (
    StnDispNet,
    stn_identity_state,
)

_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pth")


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A `.pth` file (tensors, numbers, dicts and lists only) on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_blob(path: str) -> Dict[str, Any]:
    """`.npz` (numpy arrays) or `.pth` -> dict."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            return {k: torch.from_numpy(blob[k]) for k in blob.files}
    return load_torch_checkpoint(path)


def _strip_module_prefix(state: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DataParallel's 'module.' prefix."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


class CheckpointManager:
    """Per-epoch checkpoints of a TrainState under `directory`."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:05d}.pth")

    def latest_epoch(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        epochs = [int(m.group(1)) for name in os.listdir(self.directory)
                  if (m := _EPOCH_FILE.fullmatch(name))]
        return max(epochs) if epochs else None

    def save(self, state, epoch: int) -> str:
        """Write `state` (a TrainState) as epoch `epoch`; the file appears
        whole or not at all (written aside, then renamed)."""
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(epoch)
        checkpoint = {
            "epoch": int(epoch),
            "dpth_mdl_state_dict": state.depth_model.state_dict(),
            "pose_mdl_state_dict": state.pose_model.state_dict(),
            "optimizer_state_dict": state.optimizer.state_dict(),
            "scheduler_state_dict": state.scheduler.state_dict(),
            "step": int(state.step),
        }
        tmp = path + ".tmp"
        torch.save(checkpoint, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, state, epoch: Optional[int] = None) -> Optional[int]:
        """Load epoch `epoch` (default: the latest) into `state` in place;
        returns the epoch restored, or None when there is no checkpoint."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            return None
        checkpoint = load_torch_checkpoint(self.path(epoch))
        state.depth_model.load_state_dict(checkpoint["dpth_mdl_state_dict"])
        state.pose_model.load_state_dict(checkpoint["pose_mdl_state_dict"])
        state.optimizer.load_state_dict(checkpoint["optimizer_state_dict"])
        place_optimizer(state.optimizer)
        state.scheduler.load_state_dict(checkpoint["scheduler_state_dict"])
        state.step = int(checkpoint["step"])
        return int(checkpoint["epoch"])


def place_optimizer(optimizer: torch.optim.Optimizer) -> None:
    """Make each param group of `optimizer` capturable where its
    parameters lie on a CUDA device, and not elsewhere, its step counts
    0-dim fp32 tensors beside the parameters when capturable (what torch's
    Adam reads then). Capturable Adam keeps its step on the card and takes
    its bias corrections there in fp32, as optax does; the eager step on
    the card runs it too, so a step captured in a CUDA graph and an eager
    one do the same arithmetic. Called when the optimizer is made and after
    a checkpoint, which may come from another device, is loaded into it."""
    for group in optimizer.param_groups:
        capturable = any(p.is_cuda for p in group["params"])
        group["capturable"] = capturable
        for p in group["params"]:
            slots = optimizer.state.get(p, {})
            if "step" in slots:
                slots["step"] = torch.as_tensor(slots["step"], dtype=torch.float32).to(
                    p.device if capturable else "cpu")


# --------------------------------------------------------------------------
# pretrained init (config: model.{depth,pose}.pretrained_path)
# --------------------------------------------------------------------------


def normalize_depth_pretrained_state(state: Dict[str, Any]):
    """Any supported pretrained-depth blob -> (DispResNet-schema state
    dict, encoder_only). Accepts a full reference checkpoint (its
    dpth_mdl_state_dict), a DispResNet state dict (encoder.encoder.* +
    decoder.decoder.*), or a torchvision resnet state dict (conv1.weight,
    layer1.* …: ImageNet weights, encoder only, fc.* dropped)."""
    if "dpth_mdl_state_dict" in state:
        state = state["dpth_mdl_state_dict"]
    state = _strip_module_prefix(dict(state))
    if any(k.startswith("encoder.") for k in state):
        return state, False
    if "conv1.weight" in state and "layer1.0.conv1.weight" in state:
        return ({f"encoder.encoder.{k}": v for k, v in state.items()
                 if not k.startswith("fc.")}, True)
    raise KeyError(
        "Unrecognized pretrained depth state dict: expected a reference "
        "checkpoint (dpth_mdl_state_dict), a DispResNet state dict "
        "(encoder.encoder.*), or a torchvision resnet state dict "
        "(conv1.weight / layer1.*)"
    )


def load_pretrained_depth(model: nn.Module, path: str) -> None:
    """Initialize a depth model from a pretrained `.pth` / `.npz`. A
    DispResNet takes any blob of normalize_depth_pretrained_state: an
    encoder-only blob must cover every encoder tensor and leaves the
    decoder at its init. Another model takes its reference-schema state
    dict: bare, a reference checkpoint's dpth_mdl_state_dict, or the BTS
    serving blob's `model` (DataParallel prefix dropped). Strict."""
    _load_depth_blob(model, _load_blob(path), path)


def _stn_branch(key: str) -> bool:
    return key.startswith(("localization.", "fc_loc."))


def _load_depth_blob(model: nn.Module, blob: Dict[str, Any], path: str) -> None:
    if not isinstance(model, DispResNet):
        state = blob.get("dpth_mdl_state_dict", blob.get("model", blob))
        load_reference_state(model, _strip_module_prefix(dict(state)))
        return
    state, encoder_only = normalize_depth_pretrained_state(blob)
    if not encoder_only:
        model.load_state_dict(state)
        return
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.startswith("decoder.")]
    if missing or unexpected:
        raise KeyError(f"{path}: encoder tensors missing {missing}, "
                       f"unexpected {unexpected}")


def load_reference_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Load a reference-schema state dict into `model`, strictly. A
    StnDispNet keeps its own STN branch where it does not use it or where
    the state's fc_loc.0 is of another width (the JAX import's rules)."""
    if isinstance(model, StnDispNet):
        own = model.state_dict()
        width = state.get("fc_loc.0.weight")
        keep_own = not model.use_stn
        if model.use_stn and width is not None and width.shape != own["fc_loc.0.weight"].shape:
            print("warning: STN branch not imported "
                  "(resolution-fixed fc_loc flatten mismatch)")
            keep_own = True
        if keep_own:
            state = {k: v for k, v in state.items() if not _stn_branch(k)}
            state.update({k: v for k, v in own.items() if _stn_branch(k)})
    model.load_state_dict(state)


def reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's reference-schema state dict on the CPU, as the JAX
    package's export_torch_state writes it: a StnDispNet whose live STN
    branch is not at the reference's fixed width gets the identity branch
    instead (with a warning, as in JAX)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if isinstance(model, StnDispNet) and model.use_stn:
        identity = stn_identity_state()
        width = state["fc_loc.0.weight"].shape[1]
        if width != identity["fc_loc.0.weight"].shape[1]:
            print("warning: STN branch not exported (resolution-fixed fc_loc "
                  f"flatten mismatch: {width} != "
                  f"{identity['fc_loc.0.weight'].shape[1]}); writing identity STN state")
            state.update(identity)
    return state


def load_pretrained_pose(model: nn.Module, path: str) -> None:
    """Initialize a pose net from a full reference checkpoint (its
    pose_mdl_state_dict) or a bare reference-schema pose state dict, as
    `.pth` or `.npz`; strict."""
    blob = _load_blob(path)
    model.load_state_dict(_strip_module_prefix(blob.get("pose_mdl_state_dict", blob)))


def fresh_adam_state_dict(n_params: int, lr: float) -> Dict[str, Any]:
    """A torch.optim.Adam state dict for a fresh optimizer over `n_params`
    tensors in one param group — the reference's optimizer layout."""
    return {
        "state": {},
        "param_groups": [{
            "lr": float(lr), "betas": (0.9, 0.999), "eps": 1e-8,
            "weight_decay": 0, "amsgrad": False,
            "params": list(range(n_params)),
        }],
    }


def export_reference_checkpoint(
    depth_model: nn.Module,
    pose_model: nn.Module,
    path: str,
    *,
    epoch: int = 0,
    loss: Any = None,
    valid_acc: float = 0.0,
    lr: float = 1e-4,
) -> Dict[str, Any]:
    """Write the reference trainer's `.pth` schema {epoch,
    dpth_mdl_state_dict, pose_mdl_state_dict, optimizer_state_dict, loss,
    valid_acc} (the reference's trainer.py:129-152) from two models, with
    a fresh single-group Adam state as the JAX export writes; returns the
    dict."""
    n_params = len(list(depth_model.parameters())) + len(list(pose_model.parameters()))
    checkpoint = {
        "epoch": int(epoch),
        "dpth_mdl_state_dict": reference_state(depth_model),
        "pose_mdl_state_dict": reference_state(pose_model),
        "optimizer_state_dict": fresh_adam_state_dict(n_params, lr),
        "loss": loss,
        "valid_acc": float(valid_acc),
    }
    torch.save(checkpoint, path)
    return checkpoint


def export_bts_serving_checkpoint(model: nn.Module, path: str) -> Dict[str, Any]:
    """Write the `{"model": <BTS state dict, keys prefixed "module.">}`
    blob the reference's ROS serving node loads (it wraps the net in
    nn.DataParallel, whose keys carry that prefix); returns the dict."""
    checkpoint = {"model": {f"module.{k}": v for k, v in reference_state(model).items()}}
    torch.save(checkpoint, path)
    return checkpoint


def load_serving_weights(config, state, torch_checkpoint: Optional[str] = None,
                         checkpoint: Optional[str] = None) -> str:
    """Load the weights a serving entry point serves into `state` (a
    TrainState of the config's models, in place); returns where they came
    from, "init (untrained)" when nothing was restored.

      * torch_checkpoint: a `.pth` or `.npz` blob — a reference checkpoint,
        a bare state dict of the depth model's reference schema, for a
        DispResNet a torchvision resnet state dict (encoder only;
        normalize_depth_pretrained_state), for a BtsModel also the ROS
        node's serving blob (export_bts_serving_checkpoint). A blob with
        pose_mdl_state_dict restores the pose net too; pose weights of
        another schema than model.pose.name leave it at its init, with a
        warning.
      * checkpoint: a CheckpointManager directory (its latest epoch). An
        explicit directory that restores nothing raises FileNotFoundError:
        the init weights would be served under that path's name.
      * neither: the config's checkpoint directory when action.from_scratch
        is False (a warning when it holds none), else the init weights.
    """
    if torch_checkpoint:
        blob = _load_blob(torch_checkpoint)
        _load_depth_blob(state.depth_model, blob, torch_checkpoint)
        if "pose_mdl_state_dict" in blob:
            pose = _strip_module_prefix(blob["pose_mdl_state_dict"])
            own = state.pose_model.state_dict()
            if sorted(pose) == sorted(own) and all(pose[k].shape == own[k].shape for k in own):
                state.pose_model.load_state_dict(pose)
            else:
                print(f"warning: pose weights in {torch_checkpoint} do not match "
                      f"model.pose.name={config.model.pose.name}; pose stays at random init")
        return torch_checkpoint
    if checkpoint or not config.action.from_scratch:
        path = checkpoint or os.path.join(config.action.checkpoint_dir, config.model.name)
        if CheckpointManager(path).restore(state) is not None:
            return path
        if checkpoint:
            raise FileNotFoundError(f"--checkpoint {checkpoint}: no restorable state found")
        print(f"warning: no checkpoint under {path}; using init weights")
    return "init (untrained)"
