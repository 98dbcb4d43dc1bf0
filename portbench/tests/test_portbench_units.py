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
