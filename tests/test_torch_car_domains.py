"""The paper's car-only source domains in the port against the JAX package,
on the CPU: the port's converters (simple_sfod_tpu_torch/tools/
{sim10k,kitti}_to_coco.py) against the repo's tools/converters on seeded
annotation files; the Sim10k source YAML's step in lockstep with the JAX
BaseTrainer from JPEG files that each package decodes itself; and the load
of a 1-class source model into the 8-class adaptation model, which must
skip the same keys in both packages.

Tolerances: the converters' JSON and the loaders' batches equal exactly;
each loss within LOSS_TOL relative (below) and each parameter and statistic
by tests/test_torch_trainer.py's `within_tolerance`.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simple_sfod_tpu.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from simple_sfod_tpu.checkpoint.torch_export import export_train_state, save_torch_file
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data import datasets as JD
from simple_sfod_tpu.data.loader import build_train_loader as jax_build_train_loader
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers.base import BaseTrainer as JaxBaseTrainer
from simple_sfod_tpu_torch.checkpoint.checkpointer import load_torch_weights
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.data import datasets as PD
from simple_sfod_tpu_torch.data.loader import build_train_loader
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from simple_sfod_tpu_torch.tools import kitti_to_coco, sim10k_to_coco
from test_torch_data import assert_batches_equal
from test_torch_checkpoint import jax_trainer, numpy_tree
from test_torch_train_loop import SFAT_OPTS, free_disk, tiny_cfg  # noqa: F401  (free_disk: autouse)
from test_torch_trainer import jax_step_draws, rel_err, within_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM10K_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_sim10k_source.yaml")
ADAPT_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_sim10k_to_cityscapes_source_free.yaml")
CANVAS = (128, 256)
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
# each loss's relative error: test_torch_trainer.py's bound at its third
# step. On these textured JPEG frames the box losses sit at 3e-4 (step 0)
# and 9e-4 (step 1), the others at <= 4e-5: proposals carry the RPN deltas'
# rounding scaled by the anchors, and the regression targets scale it again
# by 10 / proposal width, while the weights are still equal at step 0
LOSS_TOL = 1e-3
# the lockstep's cuts of the Sim10k source YAML (canvas, widths, batch)
OPTS = ["TPU.CANVAS", "(128, 256)", "TPU.GT_CAPACITY", "8", "TPU.MESH_DATA", "1", "TPU.DTYPE", "float32",
        "INPUT.MIN_SIZE_TRAIN", "(100, 120)", "INPUT.MAX_SIZE_TRAIN", "256", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "2", "SEED", "3",
        "DATALOADER.NUM_WORKERS", "2"]


def _tools_converter(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", "converters", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def registries(monkeypatch, tmp_path):
    """Both registries emptied, the dataset root at tmp_path; restored after."""
    saved = (dict(JD.DATASET_REGISTRY), dict(PD.DATASET_REGISTRY))
    JD.DATASET_REGISTRY.clear()
    PD.DATASET_REGISTRY.clear()
    monkeypatch.setenv("SFOD_DATASETS", str(tmp_path))
    yield tmp_path
    for reg, old in zip((JD.DATASET_REGISTRY, PD.DATASET_REGISTRY), saved):
        reg.clear()
        reg.update(old)


def frame(h, w, seed):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([120 + 80 * np.sin(x / rs.uniform(5, 20) + y / rs.uniform(5, 20)) for _ in range(3)], -1)
    return np.clip(img + rs.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def seeded_boxes(rs, h, w, k):
    out = []
    for _ in range(k):
        bw, bh = rs.uniform(12, w / 2), rs.uniform(10, h / 2)
        x1, y1 = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
        out.append((round(x1, 1), round(y1, 1), round(x1 + bw, 1), round(y1 + bh, 1)))
    return out


def write_sim10k(root, n=4, hw=(105, 191), seed=0):
    """n Sim10k-style records: JPEG frames (4:2:0, quality 75) and VOC XML
    with cars, other classes and a degenerate car box."""
    img_dir, ann_dir = os.path.join(root, "sim10k", "JPEGImages"), os.path.join(root, "sim10k", "Annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    rs = np.random.RandomState(seed)
    h, w = hw
    for i in range(n):
        name = str(3384645 + 7 * i)
        Image.fromarray(frame(h, w, seed + i)).save(os.path.join(img_dir, name + ".jpg"), quality=75)
        objs = [("car", b) for b in seeded_boxes(rs, h, w, rs.randint(1, 5))]
        objs += [("person", seeded_boxes(rs, h, w, 1)[0]), ("motorbike", seeded_boxes(rs, h, w, 1)[0]),
                 ("car", (30.0, 20.0, 30.0, 50.0))]
        xml = "".join(f"<object><name>{c}</name><pose>Unspecified</pose><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
                      f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>" for c, b in objs)
        with open(os.path.join(ann_dir, name + ".xml"), "w") as f:
            f.write(f"<annotation><folder>VOC2012</folder><filename>{name}.jpg</filename><size><width>{w}</width>"
                    f"<height>{h}</height><depth>3</depth></size>{xml}</annotation>")
    return ann_dir


def write_kitti(root, n=5, seed=1, classes=("Car", "Pedestrian", "Cyclist", "Van", "DontCare", "Car")):
    """n KITTI-style records: PNG frames of varying size and label files with
    a box of each of `classes` (default Car, Pedestrian, Cyclist, Van,
    DontCare, Car) and a degenerate car box."""
    img_dir, lab_dir = os.path.join(root, "image_2"), os.path.join(root, "label_2")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    rs = np.random.RandomState(seed)
    for i in range(n):
        h, w = 40 + 3 * i, 131 - 5 * i
        Image.fromarray(frame(h, w, seed + i)).save(os.path.join(img_dir, f"{2 * i:06d}.png"))
        lines = []
        for cls in classes:
            x1, y1, x2, y2 = seeded_boxes(rs, h, w, 1)[0]
            lines.append(f"{cls} 0.00 0 -1.57 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} 1.5 1.6 3.9 1.0 1.7 20.0 -1.5")
        lines.append("Car 0.00 0 0.0 50.00 10.00 50.00 30.00 1 1 1 1 1 1 0")
        with open(os.path.join(lab_dir, f"{2 * i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lab_dir, img_dir


def test_sim10k_converter_matches_tools(tmp_path, capsys):
    ann_dir = write_sim10k(str(tmp_path))
    out = str(tmp_path / "sim10k" / "annotations" / "sim10k_trainval.json")
    got = sim10k_to_coco.main(["--voc-root", ann_dir, "--output", out])
    want = _tools_converter("sim10k_to_coco").convert(ann_dir)
    with open(out) as f:
        assert json.load(f) == got == want
    assert capsys.readouterr().out.strip() == f"{len(want['images'])} images, {len(want['annotations'])} annotations"
    assert len(want["images"]) == 4 and {a["category_id"] for a in want["annotations"]} == {1}


def test_kitti_converter_matches_tools_without_pil(tmp_path):
    """The port's converter reads the image sizes from the PNG headers: it
    runs as `python -m` with PIL poisoned and writes the tools' JSON."""
    lab_dir, img_dir = write_kitti(str(tmp_path))
    out = str(tmp_path / "kitti_train.json")
    code = ("import sys, runpy; sys.modules['PIL'] = None; sys.argv[1:] = " + repr(
        ["--label-dir", lab_dir, "--image-dir", img_dir, "--output", out])
        + "; runpy.run_module('simple_sfod_tpu_torch.tools.kitti_to_coco', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = _tools_converter("kitti_to_coco").convert(lab_dir, img_dir)
    with open(out) as f:
        assert json.load(f) == want
    assert [(im["height"], im["width"]) for im in want["images"]] == [(40 + 3 * i, 131 - 5 * i) for i in range(5)]
    assert kitti_to_coco.convert(lab_dir, img_dir) == want


def _lockstep_cfgs(tmp_path, yaml=SIM10K_YAML):
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(OPTS)
        cfg.OUTPUT_DIR = str(tmp_path / "out")
        out.append(cfg)
    return out


def test_sim10k_source_lockstep_from_jpeg_files(registries):
    """Two steps of the Sim10k source YAML (1 class) from sim10k_trainval on
    disk: the port's loader (its own JPEG decoder) and the JAX loader
    (libjpeg) give the same batches, and the port's step follows the JAX
    BaseTrainer's _step_fn_raw on the JAX draws."""
    root = str(registries)
    ann_dir = write_sim10k(root, n=4)
    sim10k_to_coco.main(["--voc-root", ann_dir, "--output", os.path.join(root, "sim10k", "annotations",
                                                                         "sim10k_trainval.json")])
    pcfg_node, jcfg = _lockstep_cfgs(registries)
    assert pcfg_node.MODEL.ROI_HEADS.NUM_CLASSES == jcfg.MODEL.ROI_HEADS.NUM_CLASSES == 1
    assert pcfg_node.DATASETS.TRAIN == ("sim10k_trainval",)
    pl, jl = build_train_loader(pcfg_node), jax_build_train_loader(jcfg)
    assert all(r["file_name"].endswith(".jpg") for r in pl.records)

    jtr = JaxBaseTrainer(jcfg)
    jax_step = jax.jit(jtr._step_fn_raw)
    pcfg = detector_config_from_cfg(pcfg_node)
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    ptr = BaseTrainer(pcfg_node, device="cpu", state_dict=state_dict_from_jax(init, pcfg))
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, pcfg_node.TPU.GT_CAPACITY)
    state = jtr.state
    pi, ji = iter(pl), iter(jl)
    for step in range(2):
        batch, jbatch = next(pi), next(ji)
        assert_batches_equal(batch, jbatch)
        assert batch["gt_valid"].any()
        state, jm = jax_step(state, jnp.asarray(jbatch["images"]), jnp.asarray(jbatch["sizes"]),
                             jax_gt_instances(jbatch), jtr.base_rng)
        pm = ptr.run_step(batch, jax_step_draws(jtr.base_rng, step, 2, n, pool))
        for k in LOSSES:
            assert rel_err(float(pm[k]), float(jm[k])) <= LOSS_TOL, (step, k, float(pm[k]), float(jm[k]))
        for k in ("num_fg", "num_sampled"):
            assert int(pm[k]) == int(jm[k]), (step, k)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    start = state_dict_from_jax(init, pcfg)
    got = ptr.state.model.state_dict()
    # the conv biases that feed a BatchNorm have an exact gradient of 0: both
    # packages move them by rounding noise alone (here up to 5.5e-8, beyond
    # within_tolerance's 1e-8 floor), so each must move less than 1e-3 of
    # how far its conv's weight moved
    def next_module(k):
        mod, idx, _ = k.rsplit(".", 2)
        return f"{mod}.{int(idx) + 1}" if idx.isdigit() else None

    bn_fed = {k for k in want if k.endswith(".bias") and want[k[:-4] + "weight"].dim() == 4
              and f"{next_module(k)}.running_mean" in want}
    bad = [k for k in want if not k.endswith("num_batches_tracked") and k not in bn_fed
           and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    assert len(bn_fed) == 13
    for k in bn_fed:
        w = k[:-4] + "weight"
        assert (got[k] - start[k]).abs().max() <= 1e-3 * (got[w] - start[w]).abs().max(), k


@pytest.mark.parametrize("classes", [("Car", "Pedestrian", "DontCare", "Car"),
                                     ("Car", "Pedestrian", "Cyclist", "DontCare")], ids=["pedestrian", "cyclist"])
def test_kitti_labels_beyond_cars(registries, classes):
    """KITTI label files with Pedestrian (and Cyclist) lines under the
    1-class KITTI source YAML. Both converters keep them as categories 2
    and 3, and both packages' records and contiguous ids agree: {1: 0, 2: 1,
    3: 2} beside thing_classes ["car"]. The JAX BaseTrainer's first step
    then trains a pedestrian as background (class 1 is the background
    index: finite losses) and gives a NaN loss_cls on a cyclist (class 2 is
    out of range): faults of the reference (ROADMAP.md). The port refuses
    either batch with a ValueError before the step."""
    from simple_sfod_tpu.data.loader import build_train_loader as jax_loader

    root = str(registries)
    lab_dir, img_dir = write_kitti(os.path.join(root, "kitti", "training"), n=4, classes=classes)
    out = os.path.join(root, "kitti", "annotations", "kitti_train.json")
    got = kitti_to_coco.main(["--label-dir", lab_dir, "--image-dir", img_dir, "--output", out])
    assert got == _tools_converter("kitti_to_coco").convert(lab_dir, img_dir)
    want_ids = {c for c, name in ((1, "Car"), (2, "Pedestrian"), (3, "Cyclist")) if name in classes}
    assert {a["category_id"] for a in got["annotations"]} == want_ids
    pcfg_node, jcfg = _lockstep_cfgs(registries, os.path.join(ROOT, "configs", "faster_rcnn_VGG_kitti_source.yaml"))
    assert pcfg_node.MODEL.ROI_HEADS.NUM_CLASSES == 1 and pcfg_node.DATASETS.TRAIN == ("kitti_train",)
    pd, jd = PD.get_dataset("kitti_train"), JD.get_dataset("kitti_train")
    assert pd["thing_classes"] == jd["thing_classes"] == ["car"]
    assert pd["id_map"] == jd["id_map"] == {1: 0, 2: 1, 3: 2}
    for a, b in zip(pd["records"], jd["records"], strict=True):
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    batch, jbatch = next(iter(build_train_loader(pcfg_node))), next(iter(jax_loader(jcfg)))
    assert_batches_equal(batch, jbatch)
    assert set(batch["gt_classes"][batch["gt_valid"]]) == {c - 1 for c in want_ids}

    jtr = JaxBaseTrainer(jcfg)
    _, jm = jax.jit(jtr._step_fn_raw)(jtr.state, jnp.asarray(jbatch["images"]), jnp.asarray(jbatch["sizes"]),
                                      jax_gt_instances(jbatch), jtr.base_rng)
    assert np.isfinite(float(jm["loss_rpn_cls"])) and np.isfinite(float(jm["loss_box_reg"]))
    assert np.isnan(float(jm["loss_cls"])) == ("Cyclist" in classes)
    ptr = BaseTrainer(pcfg_node, device="cpu")
    with pytest.raises(ValueError, match=f"a training box has class {max(want_ids) - 1}, outside the model's 1 class"):
        ptr.run_step(batch)
    assert ptr.state.step == 0


def test_one_class_source_into_eight_class_model_skips_the_same_keys(tmp_path):
    """A 1-class source model (what the Sim10k/KITTI source YAMLs train)
    loaded into the 8-class adaptation model (the _to_cityscapes_source_free
    YAMLs inherit NUM_CLASSES 8): the JAX Checkpointer and the port's
    adaptation trainer keep the fresh initialisation of exactly cls_score
    and bbox_pred (weight and bias), in the student and the teacher, and
    take every other tensor. configs/synthetic_tiny.yaml's widths."""
    for get in (get_cfg, jax_get_cfg):
        src, dst = get(), get()
        src.merge_from_file(SIM10K_YAML)
        dst.merge_from_file(ADAPT_YAML)
        assert (src.MODEL.ROI_HEADS.NUM_CLASSES, dst.MODEL.ROI_HEADS.NUM_CLASSES) == (1, 8)
    jtr1 = jax_trainer(tmp_path / "j1", "MODEL.ROI_HEADS.NUM_CLASSES", "1")
    path = str(tmp_path / "c1.pth")
    file_sd = export_train_state(numpy_tree(jtr1.state), jtr1.det_cfg)
    save_torch_file(file_sd, path)

    jtr8 = jax_trainer(tmp_path / "j8", "MODEL.ROI_HEADS.NUM_CLASSES", "8")
    loaded = JaxCheckpointer(str(tmp_path / "j8l"), det_cfg=jtr8.det_cfg).resume_or_load(path, jtr8.state, False)
    after = export_train_state(numpy_tree(loaded), jtr8.det_cfg)
    jax_kept = {k for k, v in after.items() if not k.endswith("num_batches_tracked") and k not in ("pixel_mean", "pixel_std")
                and (np.shape(v) != np.shape(file_sd[k]) or not np.array_equal(v, file_sd[k]))}

    ptr = build_trainer(tiny_cfg(get_cfg, tmp_path / "p8", *SFAT_OPTS, "MODEL.ROI_HEADS.NUM_CLASSES", "8"), device="cpu")
    init = {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in (("student", ptr.state.model), ("teacher", ptr.state.teacher))}
    kept = set(ptr.load_weights(load_torch_weights(path)))
    predictor = {f"roi_heads.box_predictor.{m}.{p}" for m in ("cls_score", "bbox_pred") for p in ("weight", "bias")}
    assert kept == jax_kept == predictor
    for name, m in (("student", ptr.state.model), ("teacher", ptr.state.teacher)):
        sd = m.state_dict()
        for k, v in sd.items():
            if k in predictor:
                assert torch.equal(v, init[name][k]), (name, k)
            elif k in file_sd and not k.endswith("num_batches_tracked") and k not in ("pixel_mean", "pixel_std"):
                assert torch.equal(v.float(), torch.as_tensor(np.asarray(file_sd[k])).to(v.dtype).float()), (name, k)
