"""CPU tests of the cell train.bts704: BTS (DenseNet-161) trained at its
published 352x704 crop and batch 4 finds its configuration, traffic and
limits by name, reports the training cell's metrics and the saved bytes,
and keeps BTS's published widths."""

from __future__ import annotations

import os

from portbench.core import spec

CELL = "train.bts704"
TRAIN_METRICS = ("idle_share.train", "mfu.train", "conv_ms.train", "warp_roofline",
                 "ssim_roofline", "graph_pool_gib.train", "copy_in_ms.train")


def test_the_cell_finds_its_files_by_name():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "bts_densenet161_train704"
    assert cell.traffic == spec.load_cell("train.r18_1280").traffic
    assert cell.traffic["driver"] == "train_closed" and spec.driver(cell).run
    assert set(cell.limits) == {"grad_gap", "change_gap", "grad_tf32_gap"}
    for metric in cell.per_layer:
        assert spec.metric_reader(metric["name"]).read


def test_the_cell_reports_the_training_metrics_and_the_saved_bytes():
    cell = spec.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "train_samples_per_s", "peak_reserved_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == [*TRAIN_METRICS, "saved_gib.train"]
    r18 = spec.load_cell("train.r18_1280")
    assert "saved_gib.train" in {m["name"] for m in r18.per_layer}
    saved = next(m for m in cell.per_layer if m["name"] == "saved_gib.train")
    assert (saved["unit"], saved["better"], saved["source"], saved["moves"]) == (
        "GiB", "lower", "program_counter", "peak_reserved_gib")


def test_the_configuration_keeps_bts_published_widths():
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    entry = next(c for c in bench["configs"] if c["name"] == "bts_densenet161_train704")
    assert entry["reduced"] == []
    config = spec.load_json(os.path.join(spec.ROOT, entry["file"]))
    trainer = config["trainer"]
    assert trainer["model"]["depth"] == {"name": "BtsModel", "num_features": 512,
                                         "max_depth": 80.0}
    assert trainer["model"]["pose"] == {"name": "PoseFc"}
    aug = trainer["datasets"]["augmentation"]
    assert (aug["image_height"], aug["image_width"], trainer["action"]["batch_size"]) == (
        352, 704, 4)
    assert config["reduced"] == []
    assert {"objective", "optimizer", "pose_net", "data"} <= set(config["assumed"])
    # r18_1280's trainer, changed only in the depth net and the crop
    r18 = spec.load_cell("train.r18_1280").config
    assert trainer["action"] == r18["trainer"]["action"]
    assert config["flags"] == r18["flags"] and config["precision"] == r18["precision"]
    serving = spec.load_cell("serve.bts1216").config
    assert config["init"]["std"] == {**r18["init"]["std"], **serving["init"]["std"]}
    # the reference counts a step of BTS at this size: 4.725 TFLOP
    from portbench.drivers.train_closed import model_flops_per_step

    assert 4.70e12 < model_flops_per_step(trainer) < 4.75e12
