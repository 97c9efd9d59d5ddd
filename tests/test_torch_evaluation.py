"""The port's evaluators against the JAX package's, on the same records from
a numpy seed, and against the independent COCO oracle
(tests/cocoeval_pedantic.py).

Tolerance 1e-12 on every number (AP, AP50, AP75, APs/m/l, AR100, per-class
AP and AP50, F1 and its precision and recall, DECE, VOC AP50): the port
runs the same float64 arithmetic, so only the C++ evaluator's summation
order (against the plain one) can differ, by ~1e-15. NaN must meet NaN.

build_evaluators matches JAX's except for one pinned deviation: a
class_remap registered with the dataset is applied by the port and dropped
by JAX (its `get_dataset` is unbound outside the VOC branch).
"""

import numpy as np
import pytest

from cocoeval_pedantic import pedantic_coco_map
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data import datasets as JD
from simple_sfod_tpu.evaluation.build import build_evaluators as jax_build_evaluators
from simple_sfod_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCO
from simple_sfod_tpu.evaluation.coco_eval import coco_map as jax_coco_map
from simple_sfod_tpu.evaluation.dece import DECEEvaluator as JaxDECE
from simple_sfod_tpu.evaluation.f1 import F1Evaluator as JaxF1
from simple_sfod_tpu.evaluation.f1 import count_confusions_reference as jax_count
from simple_sfod_tpu.evaluation.native import coco_map_native as jax_coco_map_native
from simple_sfod_tpu.evaluation.voc import PascalVOCEvaluator as JaxVOC
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.data import datasets as PD
from simple_sfod_tpu_torch.evaluation import COCOEvaluator, DECEEvaluator, F1Evaluator, coco_map
from simple_sfod_tpu_torch.evaluation.build import CAR_ONLY_REMAP, build_evaluators
from simple_sfod_tpu_torch.evaluation.f1 import count_confusions_reference
from simple_sfod_tpu_torch.evaluation.native import coco_map_native
from simple_sfod_tpu_torch.evaluation.voc import PascalVOCEvaluator
from test_native_eval import random_case

TOL = 1e-12
SEEDS = [0, 1, 2, 3, 4]


def assert_results_equal(got, want, tol=TOL, keys=None):
    keys = keys or want.keys()
    for k in keys:
        a, b = got[k], want[k]
        if isinstance(b, dict):
            assert_results_equal(a, b, tol)
        elif isinstance(b, str):
            assert a == b, k
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=tol,
                                       equal_nan=True, err_msg=k)


def tie_case():
    """A detection with equal IoU to two identical GTs (goes to the later
    one), and a detection at IoU exactly 0.5 (a match at 0.5)."""
    gts = {0: {"boxes": np.asarray([[10.0, 10.0, 30.0, 30.0]] * 2), "classes": np.asarray([0, 0])},
           1: {"boxes": np.asarray([[0.0, 0.0, 20.0, 20.0]]), "classes": np.asarray([0])}}
    dets = {0: {"boxes": np.asarray([[10.0, 10.0, 30.0, 30.0]]), "scores": np.asarray([0.9]), "classes": np.asarray([0])},
            1: {"boxes": np.asarray([[0.0, 0.0, 20.0, 10.0]]), "scores": np.asarray([0.8]), "classes": np.asarray([0])}}
    return dets, gts


@pytest.mark.parametrize("seed", SEEDS)
def test_coco_map_and_native_match_jax_and_oracle(seed):
    dets, gts = random_case(seed, num_images=8, num_classes=3)
    want = jax_coco_map(dets, gts, 3)
    got = coco_map(dets, gts, 3)
    assert_results_equal(got, want)
    assert_results_equal(coco_map_native(dets, gts, 3), want)
    assert_results_equal(coco_map_native(dets, gts, 3), jax_coco_map_native(dets, gts, 3))
    assert_results_equal(got, pedantic_coco_map(dets, gts, 3), tol=1e-9, keys=("AP", "AP50", "AP75"))


def test_tie_and_threshold_semantics():
    dets, gts = tie_case()
    want = pedantic_coco_map(dets, gts, 1)
    for got in (coco_map(dets, gts, 1), coco_map_native(dets, gts, 1)):
        assert_results_equal(got, want, tol=1e-9, keys=("AP", "AP50", "AP75"))
        assert got["AP50"] > 0


def test_max_dets_cap():
    dets, gts = random_case(5, num_images=4, num_classes=2)
    assert_results_equal(coco_map_native(dets, gts, 2, max_dets=3), jax_coco_map(dets, gts, 2, max_dets=3))


def test_native_binding_refuses_bad_records():
    dets, gts = random_case(0)
    bad = dict(dets)
    bad[1] = {"boxes": np.zeros((2, 4)), "scores": np.zeros(2), "classes": np.zeros(3, int)}
    with pytest.raises(ValueError, match="boxes vs"):
        coco_map_native(bad, gts, 3)
    with pytest.raises(TypeError, match="integer image ids"):
        coco_map_native({"a": dets[1]}, {"a": gts[1]}, 3)


def feed(ev, dets, gts, **kw):
    for img_id in sorted(gts):
        d, g = dets.get(img_id, {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0, int)}), gts[img_id]
        ev.process_image(img_id, d["boxes"], d["scores"], d["classes"], g["boxes"], g["classes"], **kw)
    return ev.evaluate()


@pytest.mark.parametrize("remap", [None, {0: 1, 1: -1, 2: 2}])
def test_coco_evaluator_matches_jax(remap):
    dets, gts = random_case(7, num_images=8, num_classes=3)
    got = feed(COCOEvaluator(["a", "b", "c"], class_remap=remap), dets, gts)
    want = feed(JaxCOCO(["a", "b", "c"], class_remap=remap), dets, gts)
    assert_results_equal(got, want)
    assert set(got["per_class"]) == {"a", "b", "c"}


def test_coco_evaluator_string_ids_take_the_plain_route():
    dets, gts = random_case(2)
    sd = {f"img{k}": v for k, v in dets.items()}
    sg = {f"img{k}": v for k, v in gts.items()}
    got = feed(COCOEvaluator(["a", "b", "c"]), sd, sg)
    assert_results_equal(got, feed(JaxCOCO(["a", "b", "c"]), sd, sg))


def f1_case(seed):
    """Detections near GT with int-castable boxes and scores around the
    0.5 threshold, more than 5 per image."""
    dets, gts = random_case(seed, num_images=8, num_classes=3)
    rs = np.random.RandomState(seed + 100)
    for d in dets.values():
        d["scores"] = rs.uniform(0.3, 1.0, len(d["scores"]))
    return dets, gts


@pytest.mark.parametrize("mode", ["reference", "greedy"])
@pytest.mark.parametrize("seed", SEEDS)
def test_f1_matches_jax(mode, seed):
    dets, gts = f1_case(seed)
    got = feed(F1Evaluator(mode=mode), dets, gts)
    want = feed(JaxF1(mode=mode), dets, gts)
    assert got == want


def test_count_confusions_matches_jax():
    rs = np.random.RandomState(3)
    for _ in range(10):
        a = np.sort(rs.randint(0, 50, (6, 4)).reshape(6, 2, 2), axis=1).reshape(6, 4)[:, [0, 2, 1, 3]].astype(float)
        a[:, 2:] += 1  # no empty box
        b = a[rs.permutation(6)[:4]] + rs.randint(-3, 4, (4, 4))
        assert count_confusions_reference(a, b, 0.5) == jax_count(a, b, 0.5)


@pytest.mark.parametrize("bins", [10, 3, "netcal"])
def test_dece_matches_jax(bins):
    dets, gts = f1_case(1)
    assert_results_equal(feed(DECEEvaluator(bins=bins), dets, gts), feed(JaxDECE(bins=bins), dets, gts))
    assert np.isnan(DECEEvaluator().evaluate()["DECE"])


@pytest.mark.parametrize("method,protocol", [("all_point", "d2"), ("11_point", "d2"), ("all_point", "toolkit")])
def test_voc_evaluator_matches_jax(method, protocol):
    dets, gts = random_case(4, num_images=8, num_classes=3)
    rs = np.random.RandomState(9)
    difficult = {k: (rs.rand(len(g["classes"])) < 0.3).astype(int).tolist() for k, g in gts.items()}
    got = feed(PascalVOCEvaluator(["a", "b", "c"], method=method, protocol=protocol, difficult_map=difficult), dets, gts)
    want = feed(JaxVOC(["a", "b", "c"], method=method, protocol=protocol, difficult_map=difficult), dets, gts)
    assert_results_equal(got, want)
    assert_results_equal(feed(PascalVOCEvaluator(["a", "b", "c"]), dets, gts), feed(JaxVOC(["a", "b", "c"]), dets, gts))
    # every GT difficult: no class has a denominator
    every = {k: [1] * len(g["classes"]) for k, g in gts.items()}
    got = feed(PascalVOCEvaluator(["a", "b", "c"], difficult_map=every), dets, gts)
    assert np.isnan(got["VOC_AP50"])
    assert_results_equal(got, feed(JaxVOC(["a", "b", "c"], difficult_map=every), dets, gts))


@pytest.fixture
def registries():
    saved = (dict(JD.DATASET_REGISTRY), dict(PD.DATASET_REGISTRY))
    yield
    for reg, old in zip((JD.DATASET_REGISTRY, PD.DATASET_REGISTRY), saved):
        reg.clear()
        reg.update(old)


def describe(evs):
    out = []
    for ev in evs:
        d = {"type": type(ev).__name__}
        for k in ("thing_classes", "class_remap", "max_dets", "mode", "iou_thresh", "score_thresh", "top_n", "bins",
                  "difficult_map", "method", "protocol"):
            if hasattr(ev, k):
                d[k] = getattr(ev, k)
        out.append(d)
    return out


EVAL_NAMES = [
    ("cityscapes_instancesonly_foggy_val_foggy_beta_0.02", ["c"] * 8, 8),
    ("cityscapes_car_val", ["car"], 8),
    ("sim10k_val", ["car"], 8),
    ("kitti_train", ["car"], 1),
    ("clipart_test", ["a", "b"], 20),
    ("my_set", ["x", "y"], 2),
]


@pytest.mark.parametrize("name,classes,num_classes", EVAL_NAMES, ids=[n for n, _, _ in EVAL_NAMES])
def test_build_evaluators_matches_jax(registries, name, classes, num_classes):
    pcfg, jcfg = get_cfg(), jax_get_cfg()
    for cfg in (pcfg, jcfg):
        cfg.merge_from_list(["MODEL.ROI_HEADS.NUM_CLASSES", str(num_classes), "TEST.F1_MODE", "greedy"])
    assert describe(build_evaluators(pcfg, name, classes)) == describe(jax_build_evaluators(jcfg, name, classes))


def test_registered_remap_applied_unlike_jax(registries):
    """The pinned deviation: on a dataset registered with a class_remap the
    JAX builder drops it (NameError inside its try), the port applies it."""
    remap = {0: 0, 1: 0, 2: -1}
    for mod in (PD, JD):
        mod.register_dataset("remapped_set", "unused.json", "", ["car"], class_remap=remap)
    pcfg, jcfg = get_cfg(), jax_get_cfg()
    got = build_evaluators(pcfg, "remapped_set", ["car"])[0]
    want = jax_build_evaluators(jcfg, "remapped_set", ["car"])[0]
    assert isinstance(got, COCOEvaluator) and got.class_remap == remap
    assert isinstance(want, JaxCOCO) and want.class_remap is None
    # with 8 model classes JAX falls to its car-only name heuristic instead
    pcfg.MODEL.ROI_HEADS.NUM_CLASSES = jcfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    assert build_evaluators(pcfg, "remapped_set", ["car"])[0].class_remap == remap
    assert jax_build_evaluators(jcfg, "remapped_set", ["car"])[0].class_remap == CAR_ONLY_REMAP
