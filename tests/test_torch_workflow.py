"""The port's fixed-pseudo-label workflow on the CPU: its splice
(simple_sfod_tpu_torch/tools/prediction_to_gt.py) against the JAX package's
tools/converters/prediction_to_gt.py, its runner's annotation files against
tools/run_workflow_synthetic.py's, and the runner's five stages through the
port's CLIs on configs/synthetic_workflow.yaml.

The chain is cut to 2 iterations a training stage and 2 AdaBN batches.
Two iterations from random weights leave no detection at the splice's 0.7,
so after stage 1 the test replaces its model_final.pth with seeded weights
whose class-1 logit bias is raised by 4 (chip_smoke.py:write_cli_weights
does the same): every detection of class 1 then scores about 0.87, and the
splice is nonempty at its unchanged threshold.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights
from simple_sfod_tpu_torch.tools import prediction_to_gt, run_workflow_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(*path):
    """A script of the JAX package's tools/ as a module."""
    spec = importlib.util.spec_from_file_location("jax_" + path[-1][:-3], os.path.join(ROOT, "tools", *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def predictions(seed, n=60, image_ids=(101, 102, 103)):
    rs = np.random.RandomState(seed)
    return [{"image_id": int(rs.choice(image_ids)), "category_id": int(rs.randint(1, 9)),
             "bbox": [float(v) for v in rs.uniform(0, 100, 4)], "score": float(rs.uniform(0.3, 1.0))}
            for _ in range(n)]


@pytest.mark.parametrize("thresh", [0.7, 0.5])
def test_convert_equals_jax(tmp_path, thresh):
    """convert() and the CLI write what the JAX converter writes."""
    jax_conv = load_tool("converters", "prediction_to_gt.py")
    preds = predictions(3)
    anns = {"images": [{"id": i, "file_name": f"{i}.png", "height": 128, "width": 256} for i in (101, 102, 103)],
            "annotations": [{"id": 1, "image_id": 101, "category_id": 2, "bbox": [0, 0, 5, 5]}],
            "categories": [{"id": c, "name": f"c{c}"} for c in range(1, 9)], "info": {"k": 1}}
    want = jax_conv.convert(preds, anns, thresh)
    assert prediction_to_gt.convert(preds, anns, thresh) == want
    assert 0 < len(want["annotations"]) < len(preds)
    p, a, o = (str(tmp_path / n) for n in ("p.json", "a.json", "o.json"))
    for path, obj in ((p, preds), (a, anns)):
        with open(path, "w") as f:
            json.dump(obj, f)
    n = prediction_to_gt.main(["--predictions", p, "--annotations", a, "--output", o, "--score-thresh", str(thresh)])
    with open(o) as f:
        assert json.load(f) == json.loads(json.dumps(want)) and n == len(want["annotations"])


def test_annotation_files_equal_jax(tmp_path):
    jax_wf = load_tool("run_workflow_synthetic.py")
    for mod, out in ((jax_wf, tmp_path / "jax.json"), (run_workflow_synthetic, tmp_path / "port.json")):
        mod.make_coco_json(str(out), 16, seed=2, first_id=101)
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(f) == json.load(g)
    assert (run_workflow_synthetic.CLASSES, run_workflow_synthetic.HW) == (jax_wf.CLASSES, jax_wf.HW)


def boosted_source_weights(path):
    """Seeded weights of the workflow config's detector, class-1 logit bias + 4."""
    cfg = get_cfg()
    cfg.merge_from_file(run_workflow_synthetic.CFG)
    model = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += 4.0
    torch.save({"model": model.state_dict()}, path)


def test_five_stages_through_the_port_clis(tmp_path, monkeypatch):
    """Every stage exits 0 through `python -m simple_sfod_tpu_torch.tools...`,
    stage 3 splices a nonzero number of pseudo-GT boxes into the JSON that
    stage 4 trains on, and workflow_summary.json holds all five stages with
    the JAX runner's keys."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    wf = run_workflow_synthetic.Workflow(str(tmp_path / "wf"), iters=2, device="cpu", adabn_batches=2)
    try:
        wf.stage0_datasets()
        wf.stage1_source()
        boosted_source_weights(os.path.join(wf.out("s1_source"), "model_final.pth"))
        wf.stage2_adabn()
        n_pseudo = wf.stage3_splice()
        wf.stage4_wq()
        wf.stage5_sfat()
        with open(wf.write_summary()) as f:
            summary = json.load(f)
        assert list(summary) == ["1_source_train", "2_adabn", "3_splice", "4_wq_retrain", "5_sfat_adapt"]
        assert summary["3_splice"] == {"pseudo_annotations": n_pseudo} and n_pseudo > 0
        for k in ("1_source_train", "2_adabn", "4_wq_retrain", "5_sfat_adapt"):
            assert set(summary[k]) == {"AP", "AP50", "F1"}, (k, summary[k])
            assert all(v is None or np.isfinite(v) for v in summary[k].values())
        spliced = os.path.join(wf.foggy_ann, "instancesonly_filtered_gtFine_train_adabn.json")
        with open(spliced) as f:
            anns = json.load(f)["annotations"]
        assert len(anns) == n_pseudo and all(a["score"] >= 0.7 for a in anns)
        assert os.path.exists(os.path.join(wf.out("s2_adabn"), "adabn.pth"))
        assert os.path.exists(os.path.join(wf.out("s4_wq"), "model_final.pth"))
        log = open(wf.log).read()
        assert "TRAINER base_wq" in log and "cityscapes_instancesonly_foggy_train_adabn" in log
        assert set(wf.walls) == set(summary) and all(w > 0 for w in wf.walls.values())
        # each CLI printed its launches (the NMS kernels' plain versions run on the CPU: none)
        assert set(wf.launches) == {"1_source_train", "2_adabn", "4_wq_retrain", "5_sfat_adapt"}
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
