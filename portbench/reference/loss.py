"""Plain PyTorch reference of the self-supervised training step's objective
and optimizer: a frozen copy of the published method (monodepth2's
per-pixel minimum reprojection with the joint automask, SfMLearner's
warp, second-order smoothness) as the benchmarked program configures it.

- disparity -> depth: D = 1 / (10 d + 0.01); with depth_norm each image's
  depth is multiplied by the mean of its inverse depth (in float64);
- the warp: target pixels backprojected with the target depth, moved by
  the pose (axis-angle rotation, then translation; float64 matrices),
  projected with K, and the source sampled bilinearly with zeros outside
  (`F.grid_sample`, align_corners=True);
- the photometric error: 0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * L1,
  SSIM over 3x3 reflection-padded windows (C1 = 1e-4, C2 = 9e-4), the
  mean over the colour channels;
- 'min': per pixel the minimum over the two references, held against the
  identity error + 1e-5 (the automask), and the backward leg (the target
  warped into ref0 with the inverse pose), the two averaged;
- smoothness: the mean |.| of the four second differences of the target
  disparity, times the smoothness weight;
- Adam (beta 0.9 / 0.999, eps 1e-8).

A depth net with several outputs (its `scales`, one per output, (0,) where
it names none; BtsModel's five full-resolution maps) is taken by the
program's rules (losses/total.py, losses/reprojection.py's
min_reprojection_loss, losses/smoothness.py's smooth_loss):

- each output is a disparity map of its own, turned into depth and
  normalized on its own;
- 'min' and its backward leg are taken for each output against the one
  identity error, and the reprojection loss is their mean over outputs;
- smoothness is summed over the outputs at weights 1, 1/2.3, 1/2.3^2, ...
  in order (smooth_loss's default decay, which the trainer keeps).

Only outputs at the image's resolution (scale 0) are written here; a net
with a coarser output raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
C1, C2 = 1e-4, 9e-4
# smooth_loss's weight decay from one output to the next
SMOOTH_DECAY = 2.3


def normalize_images(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> ImageNet-normalized float32 [..., 3, H, W]."""
    x = x_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).movedim(-1, -3).contiguous()


def disp_to_depth(disp: torch.Tensor) -> torch.Tensor:
    return 1.0 / (10.0 * disp + 0.01)


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / torch.clamp(depth, min=1e-7)
    mean = inv.mean(dim=tuple(range(1, depth.ndim)), keepdim=True, dtype=torch.float64)
    return depth * mean.to(depth.dtype)


def pose_matrix(vec: torch.Tensor) -> torch.Tensor:
    """[B, 6] (axis-angle, translation) -> [B, 4, 4] float64: T(t) R."""
    vec = vec.double()
    rot_vec, trans = vec[:, :3], vec[:, 3:]
    angle = torch.linalg.vector_norm(rot_vec, dim=-1, keepdim=True)
    axis = rot_vec / (angle + 1e-7)
    cos, sin = torch.cos(angle)[:, :, None], torch.sin(angle)[:, :, None]
    outer = axis[:, :, None] * axis[:, None, :]
    zero = torch.zeros_like(axis[:, 0])
    cross = torch.stack([zero, -axis[:, 2], axis[:, 1],
                         axis[:, 2], zero, -axis[:, 0],
                         -axis[:, 1], axis[:, 0], zero], -1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    rot = cos * eye + (1.0 - cos) * outer + sin * cross
    top = torch.cat([rot, trans[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=vec.dtype,
                          device=vec.device).expand(len(vec), 1, 4)
    return torch.cat([top, bottom], dim=1)


def invert(transform: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(transform)


def warp(src: torch.Tensor, depth: torch.Tensor, transform: torch.Tensor,
         intrinsics: torch.Tensor) -> torch.Tensor:
    """src [N, 3, H, W] sampled at the projection of the target pixels with
    depth [N, H, W] through transform [N, 4, 4] and intrinsics [N, 3, 3]."""
    _, height, width = depth.shape
    k = intrinsics.double()
    m = (k @ transform[:, :3, :3] @ torch.linalg.inv(k)).to(depth.dtype)
    t = (k @ transform[:, :3, 3:])[:, :, 0].to(depth.dtype)
    v, u = torch.meshgrid(torch.arange(height, dtype=depth.dtype, device=depth.device),
                          torch.arange(width, dtype=depth.dtype, device=depth.device),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)]).reshape(3, -1)  # [3, HW]
    cam = (m @ pix) * depth.reshape(len(depth), 1, -1) + t[:, :, None]  # [N, 3, HW]
    z = cam[:, 2] + 1e-5
    x = cam[:, 0] / z
    y = cam[:, 1] / z
    grid = torch.stack([x / (width - 1) * 2.0 - 1.0, y / (height - 1) * 2.0 - 1.0], -1)
    grid = grid.reshape(len(depth), height, width, 2)
    return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def _box(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, 1)


def photometric(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM distance + 0.15 * |pred - target|, averaged over the
    channels: [N, H, W]."""
    mu_x, mu_y = _box(pred), _box(target)
    sigma_x = _box(pred * pred) - mu_x * mu_x
    sigma_y = _box(target * target) - mu_y * mu_y
    sigma_xy = _box(pred * target) - mu_x * mu_y
    ssim = ((2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
            / ((mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)))
    dist = torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)
    return (0.85 * dist + 0.15 * torch.abs(target - pred)).mean(dim=1)


def min_reprojection(tgt, ref0, ref1, depths_tgt, depths_ref0, poses, intrinsics):
    """The 'min' objective with the automask and the backward leg, for each
    output's pair of depths [B, H, W] in `depths_tgt` and `depths_ref0`,
    averaged over the outputs."""
    batch = len(tgt)
    t0, t1 = pose_matrix(poses[:, 0]), pose_matrix(poses[:, 1])
    ident_pair = photometric(torch.cat([ref0, ref1]), torch.cat([tgt, tgt]))
    ident = torch.minimum(ident_pair[:batch], ident_pair[batch:]) + 1e-5
    ident_bwd = ident_pair[:batch] + 1e-5
    k = intrinsics.repeat(3, 1, 1)
    srcs, targets = torch.cat([ref0, ref1, tgt]), torch.cat([tgt, tgt, ref0])
    transforms = torch.cat([t0, t1, invert(t0)])
    per_output = []
    for depth_tgt, depth_ref0 in zip(depths_tgt, depths_ref0):
        warped = warp(srcs, torch.cat([depth_tgt, depth_tgt, depth_ref0]), transforms, k)
        err = photometric(warped, targets)
        err_f = torch.minimum(err[:batch], err[batch:2 * batch])
        forward = torch.minimum(err_f, ident).mean()
        backward = torch.minimum(err[2 * batch:], ident_bwd).mean()
        per_output.append(0.5 * (forward + backward))
    return sum(per_output[1:], per_output[0]) / len(per_output)


def smoothness(disp: torch.Tensor) -> torch.Tensor:
    dy = disp[:, :, 1:] - disp[:, :, :-1]
    dx = disp[:, :, :, 1:] - disp[:, :, :, :-1]
    dx2 = dx[:, :, :, 1:] - dx[:, :, :, :-1]
    dxdy = dx[:, :, 1:] - dx[:, :, :-1]
    dydx = dy[:, :, :, 1:] - dy[:, :, :, :-1]
    dy2 = dy[:, :, 1:] - dy[:, :, :-1]
    return sum(torch.abs(d).mean() for d in (dx2, dxdy, dydx, dy2))


def output_scales(depth_net) -> tuple:
    """The scale of each output of `depth_net` (its map 2**scale times
    smaller than the image): its `scales`, (0,) where it names none."""
    scales = tuple(getattr(depth_net, "scales", (0,)))
    coarse = [s for s in scales if s]
    if coarse:
        raise NotImplementedError(
            f"an output at scale {coarse[0]}: the reference takes full-resolution outputs only")
    return scales


def step_loss(depth_net, pose_net, batch: Dict[str, torch.Tensor], objective: Dict,
              autocast_dtype=None) -> torch.Tensor:
    """The loss of one batch {tgt [B, H, W, 3] uint8, ref_imgs [B, 2, H, W, 3]
    uint8, intrinsics [B, 3, 3]}: the depth net on [tgt; ref0], every one
    of its outputs, and the pose net in train mode (under autocast to
    `autocast_dtype` when given, the loss in float32)."""
    if objective["loss_mode"] != "min" or objective["smooth_on"] != "disp":
        raise ValueError("the reference implements loss_mode 'min', smooth_on 'disp'")
    output_scales(depth_net)
    tgt = normalize_images(batch["tgt"])
    refs = normalize_images(batch["ref_imgs"])
    ref0, ref1 = refs[:, 0], refs[:, 1]
    depth_net.train()
    pose_net.train()
    with torch.autocast(tgt.device.type, autocast_dtype or torch.float32,
                        enabled=autocast_dtype is not None, cache_enabled=False):
        outputs = depth_net(torch.cat([tgt, ref0]))
        poses = pose_net(tgt, [ref0, ref1])
    disps, poses = [d.float() for d in outputs], poses.float()
    depths = [disp_to_depth(d) for d in disps]
    if objective["depth_norm"]:
        depths = [normalize_depth(d) for d in depths]
    batch_size = len(tgt)
    reproj = min_reprojection(tgt, ref0, ref1, [d[:batch_size, 0] for d in depths],
                              [d[batch_size:, 0] for d in depths], poses,
                              batch["intrinsics"].float())
    smooth = smoothness(disps[0][:batch_size])
    for i, disp in enumerate(disps[1:], 1):
        smooth = smooth + smoothness(disp[:batch_size]) / SMOOTH_DECAY ** i
    return reproj + objective["smooth_weight"] * smooth


class Adam:
    """Adam over `params`: m and v from zero, bias-corrected, eps outside
    the square root."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(b1).add_(p.grad, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))


def train_steps(depth_net, pose_net, batches: List[Dict[str, torch.Tensor]],
                objective: Dict, lr: float, autocast_dtype=None):
    """len(batches) optimizer steps from the nets' current weights ->
    (losses [steps], the gradient at step 1 {name: tensor on the host, 0-dim
    zero for a leaf without one}, the norm of each leaf's change after the
    last step {name: norm})."""
    named = [(f"depth.{n}", p) for n, p in depth_net.named_parameters()]
    named += [(f"pose.{n}", p) for n, p in pose_net.named_parameters()]
    start = {n: p.detach().clone() for n, p in named}
    optimizer = Adam([p for _, p in named], lr)
    losses, first_grad = [], {}
    for i, batch in enumerate(batches):
        for _, p in named:
            p.grad = None
        loss = step_loss(depth_net, pose_net, batch, objective, autocast_dtype)
        loss.backward()
        if i == 0:
            first_grad = {n: torch.zeros(()) if p.grad is None else p.grad.detach().cpu()
                          for n, p in named}
        optimizer.step()
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
              for n, p in named}
    return losses, first_grad, change
