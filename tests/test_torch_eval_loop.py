"""The port's dataset eval loop and the trainers' `test()` against the JAX
package's, on the CPU in float32, on weights initialised by JAX and carried
across by checkpoint/from_jax.py.

The data: 5 synthetic 100x200 images written as PNG with a COCO JSON
(make_synthetic_records, 8 classes, non-contiguous category ids), read from
disk by both packages' test loaders, resized to 120x240 on a 128x256
canvas, TEST.IMS_PER_BATCH 2 (the final batch padded by repeat). The
weights: VGG16-BN `vgg4`, FC_DIM 64, with class logit biases raised so
that random weights give 100 detections an image above SCORE_THRESH_TEST.

Tolerances and why:
  detections   the dump_json entries (image id, category id, XYWH box,
               score), matched one to one per image by category and nearest
               box: none left over; scores within 1e-5; boxes within 1e-3 px
               with eval-mode BN (test_torch_detector.py's end-to-end bound:
               the backbone sums in another order, and anchors up to 512 px
               scale the deltas' rounding). With train-mode BN, 1e-2 px:
               there each BN divides by the batch's own deviation, which on
               two 120x240 images and the 4x8 feature map is small for some
               channels, and the convs' rounding is amplified: the vgg4
               feature differs from a float64 forward by 1.5e-4 of its
               largest entry in the port and 5.5e-5 in JAX (4.2e-6 and
               1.6e-6 with eval-mode BN), and the boxes by up to 4.6e-3 px
               (all measured on this data)
  metrics      AP, AP50 and F1 within 1e-6 of JAX's. A detection whose IoU
               with its GT sat within the box tolerance of a COCO threshold
               could flip a match; `assert_no_threshold_ties` checks that no
               detection here sits within 1e-4 of any of the ten thresholds
               or of F1's 0.5, so the comparison is exact in law
  depth        pipeline depth 1 and 4 give identical port results
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import match_dumps
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data import datasets as JD
from simple_sfod_tpu.data.loader import build_test_loader as jax_build_test_loader
from simple_sfod_tpu.engine.eval_loop import inference_on_dataset as jax_inference
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.evaluation import COCOEvaluator as JaxCOCO
from simple_sfod_tpu.evaluation import F1Evaluator as JaxF1
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax, teacher_student_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG, config_opts
from simple_sfod_tpu_torch.data import datasets as PD
from simple_sfod_tpu_torch.data.loader import build_test_loader
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_image
from simple_sfod_tpu_torch.engine.eval_loop import inference_on_dataset
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.evaluation import COCOEvaluator, F1Evaluator
from simple_sfod_tpu_torch.evaluation.coco_eval import IOU_THRS, _iou
from simple_sfod_tpu_torch.models.detector import Detector

CANVAS = (128, 256)
NAMES = ("evl_a", "evl_b")
SMALL = {
    "TPU": {"CANVAS": CANVAS, "DTYPE": "float32", "MESH_DATA": 1},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}},
    "INPUT": {"MIN_SIZE_TEST": 120, "MAX_SIZE_TEST": 256, "MIN_SIZE_TRAIN": (120,), "MAX_SIZE_TRAIN": 256},
    "TEST": {"IMS_PER_BATCH": 2},
    "DATASETS": {"TRAIN_TARGET": (NAMES[0],), "TEST": NAMES},
    "DATALOADER": {"NUM_WORKERS": 2},
}
STUDENT_BOOST = {1: 3.0, 4: 1.5}
TEACHER_BOOST = {2: 2.5, 6: 1.0}


def make_cfg(get, out_dir, extra=()):
    cfg = get()
    cfg.merge_from_list(config_opts(MAIN_CONFIG) + config_opts(SMALL) + list(extra))
    cfg.OUTPUT_DIR = str(out_dir)
    return cfg


def write_dataset(root, name, n, seed):
    recs = make_synthetic_records(n, (100, 200), 8, seed=seed)
    os.makedirs(os.path.join(root, name), exist_ok=True)
    images, anns = [], []
    for r in recs:
        fname = f"{name}/{r['image_id']}.png"
        Image.fromarray(np.clip(synthetic_image(r), 0, 255).astype(np.uint8)).save(os.path.join(root, fname))
        images.append({"id": r["image_id"], "file_name": fname, "height": 100, "width": 200})
        for b, c in zip(r["boxes"], r["classes"]):
            anns.append({"id": len(anns) + 1, "image_id": r["image_id"], "category_id": 2 * c + 1,
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "iscrowd": 0})
    cats = [{"id": 2 * k + 1, "name": f"k{k}"} for k in range(8)]
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path


def boosted(det_params, boosts):
    tree = jax.tree_util.tree_map(np.array, det_params)
    for k, v in boosts.items():
        tree["predictor"]["cls_score"]["bias"][k] += v
    return tree


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two datasets on disk registered in both packages, the JAX detector
    and its boosted variables, and the port detector with the same weights."""
    root = str(tmp_path_factory.mktemp("evl"))
    saved = (dict(JD.DATASET_REGISTRY), dict(PD.DATASET_REGISTRY))
    for name, n, seed in ((NAMES[0], 5, 0), (NAMES[1], 3, 1)):
        path = write_dataset(root, name, n, seed)
        for mod in (JD, PD):
            mod.register_dataset(name, path, root)
    jcfg = make_cfg(jax_get_cfg, root)
    pcfg = make_cfg(get_cfg, root)
    jdet = JaxDetector(jax_lower(jcfg))
    v = jdet.init(jax.random.key(0), CANVAS)
    variables = {"params": boosted(v["params"], STUDENT_BOOST), "batch_stats": jax.tree_util.tree_map(np.array, v["batch_stats"])}
    pdc = detector_config_from_cfg(pcfg)
    pdet = Detector(pdc, device="cpu").load_state_dict(state_dict_from_jax(variables, pdc))
    yield dict(root=root, jcfg=jcfg, pcfg=pcfg, jdet=jdet, variables=variables, pdet=pdet, pdc=pdc)
    for reg, old in zip((JD.DATASET_REGISTRY, PD.DATASET_REGISTRY), saved):
        reg.clear()
        reg.update(old)


def run_both(world, tmp_path, train_mode_bn, depth=4):
    classes = [f"k{k}" for k in range(8)]
    jdump, pdump = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    want = jax_inference(world["jdet"], world["variables"], jax_build_test_loader(world["jcfg"], NAMES[0]), classes,
                         [JaxCOCO(classes), JaxF1()], train_mode_bn=train_mode_bn, dump_json=jdump, pipeline_depth=depth)
    got = inference_on_dataset(world["pdet"], build_test_loader(world["pcfg"], NAMES[0]), classes,
                               [COCOEvaluator(classes), F1Evaluator()], train_mode_bn=train_mode_bn, dump_json=pdump,
                               pipeline_depth=depth)
    with open(jdump) as f:
        jd = json.load(f)
    with open(pdump) as f:
        pd = json.load(f)
    return got, want, pd, jd


def assert_dumps_match(pd, jd, box_tol):
    """Per image the same entries, each port entry paired with the JAX entry
    of its category whose box is nearest (chip_smoke.match_dumps: one to
    one, closest pairs first; scores of random weights tie to rounding, so
    an order by score is not stable): box within box_tol px, score within
    1e-5."""
    assert sorted({e["image_id"] for e in pd}) == sorted({e["image_id"] for e in jd}) == [1, 2, 3, 4, 5]
    unpaired, box_err, score_err = match_dumps(pd, jd)
    assert unpaired == 0 and box_err <= box_tol and score_err <= 1e-5, (unpaired, box_err, score_err)


def assert_no_threshold_ties(dump, records, tol=1e-4):
    """No detection's IoU with a GT box of its class lies within tol of a
    COCO IoU threshold or of F1's 0.5 (see the module docstring)."""
    gts = {r["image_id"]: r for r in records}
    thrs = np.concatenate([IOU_THRS, [0.5]])
    for e in dump:
        r = gts[e["image_id"]]
        x, y, w, h = e["bbox"]
        g = np.asarray([b for b, c in zip(r["boxes"], r["classes"]) if 2 * c + 1 == e["category_id"]]).reshape(-1, 4)
        if len(g):
            ious = _iou(np.asarray([[x, y, x + w, y + h]]), g).ravel()
            assert np.abs(ious[:, None] - thrs[None, :]).min() > tol, (e, ious)


@pytest.mark.parametrize("train_mode_bn", [False, True], ids=["eval_bn", "train_mode_bn"])
def test_inference_on_dataset_matches_jax(world, tmp_path, train_mode_bn):
    got, want, pd, jd = run_both(world, tmp_path, train_mode_bn)
    assert len(jd) > 20, "too few detections to compare"
    assert_dumps_match(pd, jd, 1e-2 if train_mode_bn else 1e-3)
    assert_no_threshold_ties(pd, PD.get_dataset(NAMES[0])["records"])
    for k in ("AP", "AP50", "AP75", "F1", "precision", "recall"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, equal_nan=True, err_msg=k)
    assert got["F1_mode"] == want["F1_mode"]


def test_pipeline_depth_gives_identical_results(world, tmp_path):
    classes = [f"k{k}" for k in range(8)]
    outs = []
    for depth in (1, 4):
        dump = str(tmp_path / f"d{depth}.json")
        res = inference_on_dataset(world["pdet"], build_test_loader(world["pcfg"], NAMES[0]), classes,
                                   dump_json=dump, category_ids={k: 2 * k + 1 for k in range(8)}, pipeline_depth=depth)
        with open(dump) as f:
            outs.append((res, json.load(f)))
    assert outs[0][1] == outs[1][1]
    assert json.dumps(outs[0][0], sort_keys=True) == json.dumps(outs[1][0], sort_keys=True)
    assert {e["category_id"] for e in outs[0][1]} <= {2 * k + 1 for k in range(8)}


def assert_eval_results_match(got, want):
    assert list(got) == list(want)
    for name in want:
        for k in ("AP", "AP50", "AP75", "F1", "DECE", "precision", "recall"):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=0, atol=1e-6, err_msg=f"{name} {k}")
        assert set(got[name]["per_class"]) == set(want[name]["per_class"])


def test_sfat_test_matches_jax(world, tmp_path):
    """SourceFreeAdaptiveTeacherTrainer.test(): student and teacher on both
    datasets, eval_results.json with `/student` and `/teacher` entries equal
    to the JAX trainer's on the same two weight sets."""
    jcfg = make_cfg(jax_get_cfg, tmp_path / "jax")
    pcfg = make_cfg(get_cfg, tmp_path / "port")
    jtr = jax_build_trainer(jcfg)
    st = jtr.state
    params = dict(st.params)
    params["det"] = world["variables"]["params"]
    jtr.state = st.replace(params=params, teacher_params=boosted(st.teacher_params, TEACHER_BOOST))
    jtr.test()
    tree = jax.tree_util.tree_map(np.asarray, jtr.state)
    ptr = build_trainer(pcfg, device="cpu", weights=teacher_student_from_jax(tree, world["pdc"]))
    got = ptr.test()
    with open(os.path.join(jcfg.OUTPUT_DIR, "eval_results.json")) as f:
        want = json.load(f)
    with open(os.path.join(pcfg.OUTPUT_DIR, "eval_results.json")) as f:
        written = json.load(f)
    assert list(want) == [f"{n}/{t}" for t in ("student", "teacher") for n in NAMES]
    assert_eval_results_match(written, want)
    assert json.loads(json.dumps(got, default=float).replace("NaN", "null")) == written
    assert written[f"{NAMES[0]}/student"]["AP50"] != written[f"{NAMES[0]}/teacher"]["AP50"]


def test_base_test_writes_results_and_detections(world, tmp_path):
    """BaseTrainer.test(): per-dataset inference/ dumps with the dataset's
    category ids, eval_results.json, equal to the eval loop run directly."""
    pcfg = make_cfg(get_cfg, tmp_path, ["TRAINER", "base"])
    tr = build_trainer(pcfg, device="cpu", state_dict=world["pdet"].model.state_dict())
    res = tr.test()
    with open(tmp_path / "eval_results.json") as f:
        written = json.load(f)
    assert list(written) == list(NAMES)
    for name in NAMES:
        with open(tmp_path / "inference" / name / "coco_instances_results.json") as f:
            dump = json.load(f)
        direct = inference_on_dataset(world["pdet"], build_test_loader(pcfg, name), [f"k{k}" for k in range(8)])
        for k in ("AP", "AP50", "F1"):
            assert res[name][k] == direct[k] == written[name][k]
        assert dump and {e["category_id"] for e in dump} <= {2 * k + 1 for k in range(8)}
    single = make_cfg(get_cfg, tmp_path / "one", ["TRAINER", "base", "DATASETS.TEST", f"('{NAMES[1]}',)"])
    build_trainer(single, device="cpu", state_dict=world["pdet"].model.state_dict()).test()
    assert os.path.exists(tmp_path / "one" / "inference" / "coco_instances_results.json")


def test_sfat_build_train_loader_reads_target(world, tmp_path):
    """The adaptation trainer's loader reads TRAIN_TARGET from disk at
    IMS_PER_BATCH_TARGET, and a step runs on its batch."""
    pcfg = make_cfg(get_cfg, tmp_path, ["SOLVER.IMS_PER_BATCH_TARGET", "2", "SEED", "3"])
    tr = build_trainer(pcfg, device="cpu", state_dict=world["pdet"].model.state_dict())
    loader = tr.build_train_loader()
    assert loader.batch_size == 2 and len(loader.records) == 5 and loader.training
    batch = next(iter(loader))
    assert batch["images"].shape == (2, *CANVAS, 3) and (batch["sizes"] == (120, 240)).all()
    metrics = tr.run_step(batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.parametrize("trainer", ["base", "source_free_adaptive_teacher"])
def test_precise_bn_is_refused(world, tmp_path, trainer):
    """TEST.PRECISE_BN is not ignored: test() first sets the trained
    model's BatchNorm statistics to precise_bn over NUM_ITER batches of the
    train loader (held to the JAX package in test_torch_adabn.py); an
    adaptation teacher keeps its own."""
    from simple_sfod_tpu_torch.engine.hooks import precise_bn

    pcfg = make_cfg(get_cfg, tmp_path, ["TRAINER", trainer, "TEST.PRECISE_BN.ENABLED", "True",
                                        "TEST.PRECISE_BN.NUM_ITER", "2", "DATASETS.TRAIN", repr((NAMES[0],))])
    tr = build_trainer(pcfg, device="cpu", state_dict=world["pdet"].model.state_dict())
    ref = build_trainer(pcfg, device="cpu", state_dict=world["pdet"].model.state_dict())
    teacher = {k: v.clone() for k, v in getattr(tr.state, "teacher", tr.state.model).state_dict().items()}
    tr.test()
    assert precise_bn(ref.detector, ref.build_train_loader(), 2) == 2
    want = ref.state.model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(tr.state.model.state_dict()[k], want[k]) for k in stats)
    assert not all(torch.equal(want[k], teacher[k]) for k in stats)
    if trainer != "base":
        assert all(torch.equal(tr.state.teacher.state_dict()[k], teacher[k]) for k in stats)
