"""CPU tests of the benchmark's yardstick: FLOPs, roofline bytes, the
window arithmetic, the trace reading, discovery by name, the look for a
card and the import check."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from torch import nn

from portbench.core import device as dev
from portbench.core import readers, spec, stats
from portbench.core.flops import forward_macs
from portbench.core.outcome import Outcome
from portbench.core.trace import device_busy_us, op_family, read_trace

ROOT = spec.ROOT
CELLS = ("train.r18_1280", "serve.bts1216", "serve.bts1216_rig2")


class TwoConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(3, 8, 3, padding=1)
        self.b = nn.Conv2d(8, 4, 1, stride=2)
        self.fc = nn.Linear(4 * 5 * 6, 10)

    def forward(self, x):
        return self.fc(self.b(self.a(x)).flatten(1))


def test_flop_counter_matches_hand_worked_macs():
    # a: 2 images x 8 x 10 x 12 outputs x 3 x 3 x 3; b: 2 x 4 x 5 x 6 x 8;
    # fc: 2 x 10 x 120
    expected = 2 * 8 * 10 * 12 * 27 + 2 * 4 * 5 * 6 * 8 + 2 * 10 * 120
    assert forward_macs(TwoConv, (2, 3, 10, 12)) == expected


def test_reference_step_flops_are_the_counted_ones():
    from portbench.drivers.train_closed import model_flops_per_step

    config = spec.load_cell("train.r18_1280").config["trainer"]
    flops = model_flops_per_step(config)
    assert 1.5e12 < flops < 1.7e12  # 1.578 TFLOP: 3 x 2 x (255.9 + 7.1) GMAC


@pytest.mark.parametrize("kernel,bound_ms", [
    # PERF.md section 6's bounds at img [12, 3, 384, 1280] (batch 4)
    ("warp_bilinear_fwd", 0.05634), ("warp_bilinear_bwd_grid", 0.07043),
    ("ssim_fwd", 0.1056), ("ssim_bwd", 0.08451)])
def test_roofline_bytes_at_the_table_shape(kernel, bound_ms):
    module = spec.roofline(kernel)
    peaks = spec.peaks()["NVIDIA H100 80GB HBM3"]
    read, written, ops = module.work({"batch": 4, "height": 384, "width": 1280})
    bound_ms_a_step = max((read + written) / peaks["hbm_bytes_per_s"],
                          ops / peaks[module.PRECISION]) * 1e3
    assert bound_ms_a_step == pytest.approx(bound_ms, rel=2e-3)


def test_rate_and_tail_move_with_a_stall():
    steady = [0.05] * 200
    stalled = [0.05] * 190 + [0.5] + [0.05] * 9
    assert stats.rate(len(stalled), sum(stalled)) < stats.rate(len(steady), sum(steady))
    assert stats.percentile(steady, 95) == pytest.approx(50e-3)
    with_stalls = [0.05] * 180 + [0.5] * 20
    assert stats.percentile(with_stalls, 95) > stats.percentile(steady, 95)
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_op_family_and_busy_union():
    assert op_family("void at::native::vectorized_elementwise_kernel<4, at::native::"
                     "FillFunctor<float>>(int, float*)") == \
        "at::native::vectorized_elementwise_kernel"
    assert op_family("ssim_fwd_kernel(float const*, float const*, float*, int)") == \
        "ssim_fwd_kernel"
    assert op_family("_ZN7cutlass6KernelINS_4gemmEEEvT_") == "cutlass::Kernel"
    events = [{"cat": "kernel", "ts": 0, "dur": 10}, {"cat": "kernel", "ts": 5, "dur": 10},
              {"cat": "gpu_memcpy", "ts": 30, "dur": 5}, {"cat": "cpu_op", "ts": 0, "dur": 99}]
    assert device_busy_us(events) == 20.0


def _hand_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 100, "dur": 100,
         "tid": 1, "pid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150, "dur": 30, "tid": 1,
         "pid": 1},
        {"ph": "X", "cat": "kernel", "name": "ssim_fwd_kernel(float const*)", "ts": 100,
         "dur": 40, "tid": 7, "pid": 0},
        {"ph": "X", "cat": "kernel", "name": "void cudnn::conv_kernel<1>(int)", "ts": 120,
         "dur": 20, "tid": 7, "pid": 0},
        {"ph": "X", "cat": "kernel", "name": "void cudnn::conv_kernel<2>(int)", "ts": 190,
         "dur": 30, "tid": 7, "pid": 0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_read_trace_windows_busy_families_and_gaps(tmp_path):
    s = read_trace(_hand_trace(tmp_path), units=2)
    assert s.window_us == 100.0
    assert s.busy_us == 50.0  # [100, 140) and [190, 200) inside the window
    assert s.family_us == {"ssim_fwd_kernel": 40.0, "cudnn::conv_kernel": 30.0}
    assert s.family_counts == {"ssim_fwd_kernel": 1, "cudnn::conv_kernel": 2}
    assert s.gaps == [("aten::copy_", 50.0)]
    out = Outcome({}, 2, 0, 0, slice=s)
    assert readers.idle_share(out) == pytest.approx(50.0)
    assert readers.conv_ms(out) == pytest.approx(0.015)
    assert s.breakdown()["idle_gaps"] == [["aten::copy_", 5e-5]]


def test_a_reader_that_finds_nothing_returns_nothing():
    empty = Outcome({}, 0, 0, 0)
    for name in ("idle_share.train", "mfu.serve", "conv_ms.train", "warp_roofline",
                 "ssim_roofline", "graph_pool_gib.serve"):
        assert spec.metric_reader(name).read(empty) is None


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = spec.load_cell(name)
    assert cell.limits and cell.traffic["driver"] in ("train_closed", "serve_closed")
    assert spec.driver(cell).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert spec.metric_reader(metric["name"]).read


def test_benchmark_json_follows_the_names_rules():
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(metric["name"]) and unit.match(metric["unit"])
    for item in bench["workloads"] + bench["configs"]:
        assert name.match(item["name"]) and len(item["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for metric in bench["per_layer"]:
        assert metric["moves"] in e2e


def test_a_later_change_adds_a_metric_and_a_traffic_by_files_alone(tmp_path):
    """Copy the checkout's benchmark, add a per-layer metric and a traffic
    mix as new files and entries, and find both by name without editing
    any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    (root / "portbench" / "metrics" / "busy_ms.serve.py").write_text(
        "def read(run):\n    s = run.slice\n    return None if s is None else "
        "s.busy_us / s.units / 1e3\n")
    traffic = json.loads((root / "portbench" / "traffic" / "closed_frames16.json").read_text())
    traffic.update(frames=32)
    (root / "portbench" / "traffic" / "closed_frames32.json").write_text(json.dumps(traffic))
    (root / "portbench" / "limits" / "serve.bts1216_f32.json").write_text(
        (root / "portbench" / "limits" / "serve.bts1216.json").read_text())
    bench["workloads"].append({"name": "serve.bts1216_f32", "config": "bts_densenet161",
                               "traffic": "closed_frames32", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "busy_ms.serve", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_frames_per_s",
                               "workloads": ["serve.bts1216_f32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2])\n"
        "from portbench.core import spec\n"
        "cell = spec.load_cell('serve.bts1216_f32', root=sys.argv[1])\n"
        "assert cell.traffic['frames'] == 32, cell.traffic\n"
        "names = [m['name'] for m in cell.per_layer]\n"
        "assert 'busy_ms.serve' in names, names\n"
        "from portbench.core.outcome import Outcome\n"
        "from portbench.core.trace import TraceSlice\n"
        "s = TraceSlice(4, 100.0, 40.0, [], {}, {})\n"
        "assert spec.metric_reader('busy_ms.serve').read(Outcome({}, 0, 0, 0, slice=s)) == 0.01\n"
        "assert spec.PACKAGE_DIR.startswith(sys.argv[1])\n")
    subprocess.run([sys.executable, "-c", script, str(root), ROOT], check=True)
    after = {p: p.read_bytes() for p in before}
    assert after == before


TOY_NET = """
import torch
from torch import nn


class ToyDepth(nn.Module):
    def __init__(self, width=8, max_depth=80.0):
        super().__init__()
        self.max_depth = max_depth
        self.conv1 = nn.Conv2d(3, width, 3, padding=1)
        self.conv2 = nn.Conv2d(width, 1, 3, padding=1)

    def forward(self, x):
        return [self.max_depth * torch.sigmoid(self.conv2(torch.relu(self.conv1(x))))]


def build(kwargs, image_shape):
    return ToyDepth(**kwargs)
"""


def _small_serving_config(model: dict, serving: dict) -> dict:
    """bts_densenet161's file with another model, at 64x96 (the camera
    scaled to the frame) so that the CPU runs it."""
    config = json.loads(json.dumps(spec.load_cell("serve.bts1216").config))
    sy, sx = 64 / config["input"]["height"], 96 / config["input"]["width"]
    config["input"].update(height=64, width=96)
    for key in ("K_02", "P_rect_02"):
        m = config["calib"][key]
        cols = len(m) // 3
        for col in range(cols):
            m[col] *= sx
            m[cols + col] *= sy
    config.update(name="added", model=model, serving=dict(config["serving"], **serving),
                  init={"gain": 2 ** 0.5, "bias_gain": 0.5, "std": {}})
    return config


@pytest.mark.parametrize("model,serving,new_net", [
    # the queued serve.r18_1280_b1: a disparity net the training cell's
    # reference already covers
    ({"name": "DispResNet", "kwargs": {}}, {"metric_output": False}, False),
    # the same through monodepth2's range mapping
    ({"name": "DispResNet", "kwargs": {}},
     {"metric_output": False, "min_depth": 0.1, "max_depth": 100.0}, False),
    # a model with a plain reference of its own, added as a file
    ({"name": "PortbenchToyDepth", "kwargs": {"width": 8, "max_depth": 80.0}},
     {"metric_output": True}, True),
])
def test_a_later_change_adds_a_configuration_with_another_model_by_files_alone(
        tmp_path, model, serving, new_net):
    """Copy the checkout's benchmark, add a configuration that serves
    another model, its traffic, its limits and (for a new model) its plain
    reference as new files and entries; the serving driver then builds the
    program's model and the reference by the configuration's name, counts
    the FLOPs on the reference and runs the cell correct on the CPU, with
    no file that was there edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    (pb / "configs" / "added.json").write_text(json.dumps(_small_serving_config(model, serving)))
    (pb / "traffic" / "closed_frames4.json").write_text(json.dumps(
        {"driver": "serve_closed", "frames": 4, "cameras": 1, "checked_frames": 2,
         "check_stride": 2, "trace_units": 2}))
    (pb / "limits" / "serve.added.json").write_text((pb / "limits" / "serve.bts1216.json")
                                                    .read_text())
    if new_net:
        (pb / "reference" / "nets" / f"{model['name']}.py").write_text(TOY_NET)
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "added", "source": "test", "file":
                             "portbench/configs/added.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve.added", "config": "added",
                               "traffic": "closed_frames4", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2])\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.core import spec\n"
        "cell = spec.load_cell('serve.added', root=sys.argv[1])\n"
        "name = cell.config['model']['name']\n"
        "if sys.argv[3] == '1':\n"
        "    from unsupervised_pseuso_lidar_tpu_torch.models.registry import register_model\n"
        "    register_model(name)(spec.reference_net(name).ToyDepth)\n"
        "driver = spec.driver(cell)\n"
        "flops = driver.model_flops_per_frame(cell.config)\n"
        "if sys.argv[3] == '1':\n"
        "    assert flops == 2 * 64 * 96 * (8 * 27 + 8 * 9), flops\n"
        "else:\n"
        "    assert 7e8 < flops < 9e8, flops  # DispResNet-18: 0.40 GMAC at 64x96\n"
        "out = driver.run(cell, 3000000019, 0.5, False, torch.device('cpu'), time.perf_counter())\n"
        "assert out.correct, out.checks\n"
        "assert spec.PACKAGE_DIR.startswith(sys.argv[1])\n")
    subprocess.run([sys.executable, "-c", script, str(root), ROOT, str(int(new_net))],
                   check=True)
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _small_bts_training_config() -> dict:
    """r18_1280's file with BtsModel (num_features 128) as the depth net, at
    64x128 and batch 2, its heads at the serving configuration's stds."""
    config = json.loads(json.dumps(spec.load_cell("train.r18_1280").config))
    trainer = config["trainer"]
    trainer["model"]["depth"] = {"name": "BtsModel", "num_features": 128, "max_depth": 80.0}
    trainer["datasets"]["augmentation"].update(image_height=64, image_width=128)
    trainer["action"]["batch_size"] = 2
    config["init"]["std"].update(spec.load_cell("serve.bts1216").config["init"]["std"])
    config["name"] = "bts_train_small"
    return config


def test_a_later_change_adds_a_training_configuration_with_several_outputs_by_files_alone(
        tmp_path):
    """Copy the checkout's benchmark, add a configuration that trains
    BtsModel (five full-resolution outputs, each fed to the loss) with
    PoseFc, its traffic and its limits as new files and entries; the
    training driver then runs the cell correct on the CPU against the
    reference's loss over all five outputs, with no file that was there
    edited (a reference that took the first output alone read grad_gap 612
    here).

    On the CPU, which has no TF32, grad_tf32_gap is the whole gradient's
    gap over its floor, 1e-3 of its norm; at this size the five outputs'
    pixel flips alone put it at 0.0009 - 0.88 over nine seeds, and the
    reference moves by up to 0.22 of the floor between thread counts.
    Seed 106 reads 0.0010 in every process tried (PERF.md)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    (pb / "configs" / "bts_train_small.json").write_text(json.dumps(_small_bts_training_config()))
    (pb / "traffic" / "closed_triplets4.json").write_text(json.dumps(
        {"driver": "train_closed", "batches": 4, "checked_steps": 3, "trace_units": 2}))
    (pb / "limits" / "train.bts_small.json").write_text((pb / "limits" / "train.r18_1280.json")
                                                        .read_text())
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "bts_train_small", "source": "test", "file":
                             "portbench/configs/bts_train_small.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "train.bts_small", "config": "bts_train_small",
                               "traffic": "closed_triplets4", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2])\n"
        "import torch\n"
        "torch.set_num_threads(4)\n"
        "from portbench.core import spec\n"
        "cell = spec.load_cell('train.bts_small', root=sys.argv[1])\n"
        "assert spec.reference_net('BtsModel').BtsModel.scales == (0,) * 5\n"
        "out = spec.driver(cell).run(cell, 106, 0.5, False, torch.device('cpu'),\n"
        "                            time.perf_counter())\n"
        "assert out.correct, out.checks\n"
        "assert out.attempted > 0\n"
        "assert spec.PACKAGE_DIR.startswith(sys.argv[1])\n")
    subprocess.run([sys.executable, "-c", script, str(root), ROOT], check=True)
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_the_reference_bts_gives_the_programs_five_training_outputs():
    """BtsModel's plain reference returns the program's five outputs, in its
    order, equal to the program's BtsModel in train mode (batch
    statistics) on the same seeded weights."""
    from portbench.core.weights import fill
    from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import BtsModel

    init = _small_bts_training_config()["init"]
    init["std"] = {k: v for k, v in init["std"].items() if k.startswith("depth.")}
    reference = spec.reference_net("BtsModel").build({"num_features": 128, "max_depth": 80.0},
                                                     (64, 128))
    program = BtsModel(128, 80.0)
    fill({"depth": reference}, 5, init)
    fill({"depth": program}, 5, init)
    reference.train()
    program.train()
    x = torch.randn(4, 3, 64, 128, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ours, theirs = reference(x), program(x)
    assert type(reference).scales == program.scales == (0,) * 5
    assert len(ours) == len(theirs) == 5
    for mine, program_output in zip(ours, theirs):
        assert mine.shape == (4, 1, 64, 128)
        assert torch.equal(mine, program_output)


def _one_output_step_loss(depth_net, pose_net, batch, objective):
    """The one-output objective written out whole: 'min' with its backward
    leg over one warp of the 3 * batch jobs, + w * smoothness, on output
    [0]."""
    from portbench.reference import loss as L

    tgt = L.normalize_images(batch["tgt"])
    refs = L.normalize_images(batch["ref_imgs"])
    ref0, ref1 = refs[:, 0], refs[:, 1]
    depth_net.train()
    pose_net.train()
    disp = depth_net(torch.cat([tgt, ref0]))[0]
    poses = pose_net(tgt, [ref0, ref1])
    disp, poses = disp.float(), poses.float()
    depth = L.disp_to_depth(disp)
    if objective["depth_norm"]:
        depth = L.normalize_depth(depth)
    b = len(tgt)
    depth_tgt, depth_ref0 = depth[:b, 0], depth[b:, 0]
    intrinsics = batch["intrinsics"].float()
    t0, t1 = L.pose_matrix(poses[:, 0]), L.pose_matrix(poses[:, 1])
    ident_pair = L.photometric(torch.cat([ref0, ref1]), torch.cat([tgt, tgt]))
    ident = torch.minimum(ident_pair[:b], ident_pair[b:]) + 1e-5
    ident_bwd = ident_pair[:b] + 1e-5
    warped = L.warp(torch.cat([ref0, ref1, tgt]), torch.cat([depth_tgt, depth_tgt, depth_ref0]),
                    torch.cat([t0, t1, L.invert(t0)]), intrinsics.repeat(3, 1, 1))
    err = L.photometric(warped, torch.cat([tgt, tgt, ref0]))
    err_f = torch.minimum(err[:b], err[b:2 * b])
    forward = torch.minimum(err_f, ident).mean()
    backward = torch.minimum(err[2 * b:], ident_bwd).mean()
    reproj = 0.5 * (forward + backward)
    return reproj + objective["smooth_weight"] * L.smoothness(disp[:b])


def test_a_one_output_step_loss_is_the_one_output_formula_bit_for_bit():
    """With one output the loss over outputs is the one-output objective
    operation for operation: the same loss and gradients, bit for bit."""
    from portbench.core.synthetic import triplet_batch
    from portbench.core.weights import fill
    from portbench.drivers.train_closed import objective, reference_net
    from portbench.reference import loss as L

    config = json.loads(json.dumps(spec.load_cell("train.r18_1280").config))
    config["trainer"]["datasets"]["augmentation"].update(image_height=64, image_width=128)
    batch = triplet_batch(2, 64, 128, 11, torch.device("cpu"))
    results = []
    for formula in (L.step_loss, _one_output_step_loss):
        depth = reference_net(config["trainer"], "depth")
        pose = reference_net(config["trainer"], "pose")
        fill({"depth": depth, "pose": pose}, 11, config["init"])
        loss = formula(depth, pose, batch, objective(config["trainer"]))
        loss.backward()
        grads = [p.grad for p in list(depth.parameters()) + list(pose.parameters())
                 if p.grad is not None]
        results.append((loss.detach(), grads))
    (loss_new, grads_new), (loss_old, grads_old) = results
    assert torch.equal(loss_new, loss_old)
    assert len(grads_new) == len(grads_old) > 0
    assert all(torch.equal(a, b) for a, b in zip(grads_new, grads_old))


class _CoarseDepth(nn.Module):
    scales = (0, 1)

    def forward(self, x):
        return [x[:, :1], x[:, :1, ::2, ::2]]


def test_a_net_with_a_coarser_output_is_refused_by_name_of_its_scale():
    from portbench.reference import loss as L

    with pytest.raises(NotImplementedError, match="scale 1"):
        L.output_scales(_CoarseDepth())
    assert L.output_scales(TwoConv()) == (0,)


@pytest.mark.parametrize("kernel,launches,images", [
    # a 'min' step for S outputs launches A, A', B and C S, S, S + 1 and S
    # times (chip_smoke.expected_launches); B's identity launch is over
    # 2 * batch images, each other launch over 3 * batch. (S = 1, S = 5)
    ("warp_bilinear_fwd", (1, 5), (3, 15)), ("warp_bilinear_bwd_grid", (1, 5), (3, 15)),
    ("ssim_fwd", (2, 6), (5, 17)), ("ssim_bwd", (1, 5), (3, 15))])
def test_rooflines_count_by_output(kernel, launches, images):
    module = spec.roofline(kernel)
    shapes = {"batch": 4, "height": 352, "width": 704}
    assert module.launches(dict(shapes, outputs=1)) == module.launches(shapes)
    assert module.work(dict(shapes, outputs=1)) == module.work(shapes)
    assert (module.launches(shapes), module.launches(dict(shapes, outputs=5))) == launches
    one, five = module.work(shapes), module.work(dict(shapes, outputs=5))
    assert all(b * images[0] == a * images[1] for a, b in zip(one, five))


def test_the_measuring_path_without_a_card_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(dev.NoCard):
        dev.require_cards(1)
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    run = spec.load_module(os.path.join(ROOT, "portbench", "run.py"), "portbench_test_")
    code = run.main(["--workload", "serve.bts1216", "--seed", "3", "--seconds", "1",
                     "--trace", "0"])
    captured = capsys.readouterr()
    assert code != 0
    assert captured.out == ""
    assert "is_available" in captured.err


def test_too_few_cards_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(dev.NoCard):
        dev.require_cards(1)


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    names = {"unsupervised_pseuso_lidar_tpu_torch": 1, "unsupervised_pseuso_lidar_tpu_torch.x": 1,
             "jaxtyping": 1, "numpy": 1}
    assert dev.forbidden_modules(names) == []
    names.update({"unsupervised_pseuso_lidar_tpu.models": 1, "jax.numpy": 1})
    assert dev.forbidden_modules(names) == ["jax.numpy", "unsupervised_pseuso_lidar_tpu.models"]


def _imported_top_levels(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    sources = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(ROOT, "portbench"))
               for f in files if f.endswith(".py")]
    assert len(sources) > 20
    for path in sources:
        assert not (_imported_top_levels(path) & set(dev.FORBIDDEN)), path


@pytest.mark.parametrize("name", CELLS)
def test_what_a_cell_imports_loads_no_jax(name):
    """Import everything a cell's run imports, in a fresh process, and look
    at sys.modules by whole top-level name."""
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.core import spec, device\n"
        "cell = spec.load_cell(sys.argv[2])\n"
        "spec.driver(cell)\n"
        "import unsupervised_pseuso_lidar_tpu_torch.train.trainer\n"
        "import unsupervised_pseuso_lidar_tpu_torch.train.config\n"
        "import unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline\n"
        "import unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export\n"
        "import unsupervised_pseuso_lidar_tpu_torch.models.registry\n"
        "for m in cell.per_layer: spec.metric_reader(m['name'])\n"
        "spec.load_module(spec.PACKAGE_DIR + '/run.py', 'run_')\n"
        "found = device.forbidden_modules()\n"
        "assert not found, found\n"
        "assert 'unsupervised_pseuso_lidar_tpu_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", script, ROOT, name], check=True)
