"""The paper's five-stage chain through the port's CLIs on synthetic data
(the port of the JAX package's `tools/run_workflow_synthetic.py`):

  1. source training                    tools/train_net.py
  2. AdaBN refinement + detections dump tools/train_net_mt.py --eval-only
  3. the splice into pseudo ground truth tools/prediction_to_gt.py
  4. WQ (strong-view) retrain on it     tools/train_net.py  TRAINER base_wq
  5. SFAT source-free adaptation        tools/train_net_mt.py

    python -m simple_sfod_tpu_torch.tools.run_workflow_synthetic [--root DIR]
        [--iters 40] [--retrain-iters N] [--device cpu] [--adabn-batches N]

COCO JSONs are written under <root>/datasets (the SFOD_DATASETS root of the
CLIs) with the reference's Cityscapes and Foggy Cityscapes names; the
loaders synthesize the pixels (--synthetic keeps the annotations of a name
that resolves). Each stage's AP comes from its trainer's evaluation at the
end of the run (TEST.EVAL_PERIOD == MAX_ITER); stage 2 dumps its detections
on the foggy train split, which stage 3 splices at score 0.7. The summary
goes to <root>/workflow_summary.json, in the JAX runner's layout, and each
stage's wall time and NMS launches to the log and `Workflow`. Every CLI's
output is appended to <root>/workflow.log; a stage that fails raises with
the end of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = os.path.join(REPO, "configs", "synthetic_workflow.yaml")
CLASSES = 8
HW = (128, 256)
FOGGY_TRAIN = "cityscapes_instancesonly_foggy_train_foggy_beta_0.02"
SPLICED = "cityscapes_instancesonly_foggy_train_adabn"
SCORE_THRESH = 0.7


def make_coco_json(path: str, num_images: int, seed: int, first_id: int):
    """A synthetic COCO file: random rectangles, classes 1..8 (COCO ids)."""
    rs = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        img_id = first_id + i
        images.append({"id": img_id, "file_name": f"synthetic_{img_id}.png", "height": HW[0], "width": HW[1]})
        for _ in range(rs.randint(2, 5)):
            w = float(rs.uniform(16, 64))
            h = float(rs.uniform(16, 48))
            x = float(rs.uniform(0, HW[1] - w))
            y = float(rs.uniform(0, HW[0] - h))
            annotations.append({"id": ann_id, "image_id": img_id, "category_id": int(rs.randint(1, CLASSES + 1)),
                                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0})
            ann_id += 1
    cats = [{"id": c + 1, "name": f"c{c}"} for c in range(CLASSES)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": cats}, f)


def read_ap(output_dir: str) -> Optional[Dict]:
    """AP, AP50 and F1 of a stage's eval_results.json: its first entry (the
    SFAT trainer's first is the student's)."""
    p = os.path.join(output_dir, "eval_results.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        res = json.load(f)
    _, vals = next(iter(res.items()))
    if isinstance(vals, dict) and "AP50" not in vals:
        vals = list(vals.values())[-1]
    return {k: vals.get(k) for k in ("AP", "AP50", "F1")}


@dataclasses.dataclass
class Workflow:
    """The chain's settings, its directories and what its stages found:
    `summary` (the JSON written), `walls` (s a stage) and `launches` (the
    NMS kernels' launches each CLI printed)."""

    root: str
    iters: int = 40
    retrain_iters: Optional[int] = None
    device: Optional[str] = None
    adabn_batches: Optional[int] = None
    summary: Dict = dataclasses.field(default_factory=dict)
    walls: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

    @property
    def datasets(self) -> str:
        return os.path.join(self.root, "datasets")

    @property
    def foggy_ann(self) -> str:
        return os.path.join(self.datasets, "cityscapes_foggy", "annotations")

    @property
    def log(self) -> str:
        return os.path.join(self.root, "workflow.log")

    def out(self, stage: str) -> str:
        return os.path.join(self.root, stage)

    def _cli(self, stage: str, module: str, *argv: str) -> None:
        """One CLI run through `python -m`, its output appended to the log;
        its wall time and NMS launches (the CLI's last line) kept."""
        cmd = [sys.executable, "-m", f"simple_sfod_tpu_torch.tools.{module}", *argv]
        env = dict(os.environ, SFOD_DATASETS=self.datasets,
                   PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        print(f"\n>>> {' '.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.walls[stage] = self.walls.get(stage, 0.0) + time.perf_counter() - t0
        with open(self.log, "a") as f:
            f.write(f"\n>>> {' '.join(cmd)}\n{proc.stdout}")
        if proc.returncode != 0:
            raise RuntimeError(f"stage {stage}: {module} exited {proc.returncode}\n{proc.stdout[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        if lines and lines[-1].startswith("[launches] "):
            self.launches[stage] = json.loads(lines[-1][len("[launches] "):])

    def _train_argv(self) -> List[str]:
        return ["--config-file", CFG, "--synthetic"] + (["--device", self.device] if self.device else [])

    # -- the stages ----------------------------------------------------------
    def stage0_datasets(self) -> None:
        """Synthetic annotation files under the reference's name patterns."""
        os.makedirs(self.root, exist_ok=True)
        open(self.log, "w").close()
        make_coco_json(os.path.join(self.datasets, "cityscapes", "annotations", "instancesonly_filtered_gtFine_train.json"),
                       16, seed=1, first_id=1)
        make_coco_json(os.path.join(self.foggy_ann, "instancesonly_filtered_gtFine_train_foggy_beta_0.02.json"),
                       16, seed=2, first_id=101)
        make_coco_json(os.path.join(self.foggy_ann, "instancesonly_filtered_gtFine_val_foggy_beta_0.02.json"),
                       8, seed=3, first_id=201)

    def stage1_source(self) -> None:
        """Source training, evaluated at its end."""
        it, out = str(self.iters), self.out("s1_source")
        self._cli("1_source_train", "train_net", *self._train_argv(),
                  "SOLVER.MAX_ITER", it, "TEST.EVAL_PERIOD", it, "OUTPUT_DIR", out)
        self.summary["1_source_train"] = read_ap(out)

    def stage2_adabn(self) -> None:
        """AdaBN on the foggy train split (the target domain's statistics),
        evaluated on it: the detections dumped there feed the splice."""
        out = self.out("s2_adabn")
        flags = ["--eval-only"] + (["--adabn-batches", str(self.adabn_batches)] if self.adabn_batches else [])
        self._cli("2_adabn", "train_net_mt", *self._train_argv(), *flags,
                  "MODEL.WEIGHTS", os.path.join(self.out("s1_source"), "model_final.pth"),
                  "DATASETS.TRAIN", f"('{FOGGY_TRAIN}',)", "DATASETS.TEST", f"('{FOGGY_TRAIN}',)", "OUTPUT_DIR", out)
        self.summary["2_adabn"] = read_ap(out)

    def stage3_splice(self) -> int:
        """The stage-2 detections at score >= 0.7 spliced into the foggy
        train JSON as `cityscapes_instancesonly_foggy_train_adabn`. Raises
        when nothing clears the threshold. -> the pseudo-GT boxes."""
        pseudo_json = os.path.join(self.foggy_ann, "instancesonly_filtered_gtFine_train_adabn.json")
        self._cli("3_splice", "prediction_to_gt",
                  "--predictions", os.path.join(self.out("s2_adabn"), "inference", "coco_instances_results.json"),
                  "--annotations", os.path.join(self.foggy_ann, "instancesonly_filtered_gtFine_train_foggy_beta_0.02.json"),
                  "--output", pseudo_json, "--score-thresh", str(SCORE_THRESH))
        with open(pseudo_json) as f:
            n_pseudo = len(json.load(f)["annotations"])
        self.summary["3_splice"] = {"pseudo_annotations": n_pseudo}
        if n_pseudo == 0:
            raise SystemExit(
                f"stage 3 spliced 0 pseudo-GT annotations: no stage-2 detection cleared the {SCORE_THRESH} score "
                "threshold, so stage 4 would train on an empty dataset. The stage-1 model is too weak at this scale: "
                "raise --iters (the JAX package's recorded run used --iters 1000 --retrain-iters 150).")
        return n_pseudo

    def stage4_wq(self) -> None:
        """The WQ (strong-view) retrain from the AdaBN model on the pseudo-GT."""
        rit, out = str(self.retrain_iters or self.iters), self.out("s4_wq")
        self._cli("4_wq_retrain", "train_net", *self._train_argv(), "TRAINER", "base_wq",
                  "MODEL.WEIGHTS", os.path.join(self.out("s2_adabn"), "adabn.pth"),
                  "DATASETS.TRAIN", f"('{SPLICED}',)",
                  "SOLVER.MAX_ITER", rit, "TEST.EVAL_PERIOD", rit, "OUTPUT_DIR", out)
        self.summary["4_wq_retrain"] = read_ap(out)

    def stage5_sfat(self) -> None:
        """Source-free adaptive-teacher adaptation from the WQ model."""
        rit, out = str(self.retrain_iters or self.iters), self.out("s5_sfat")
        self._cli("5_sfat_adapt", "train_net_mt", *self._train_argv(), "TRAINER", "source_free_adaptive_teacher",
                  "MODEL.WEIGHTS", os.path.join(self.out("s4_wq"), "model_final.pth"),
                  "SOLVER.MAX_ITER", rit, "TEST.EVAL_PERIOD", rit, "OUTPUT_DIR", out)
        self.summary["5_sfat_adapt"] = read_ap(out)

    def write_summary(self) -> str:
        path = os.path.join(self.root, "workflow_summary.json")
        with open(path, "w") as f:
            json.dump(self.summary, f, indent=2)
        return path

    def run(self) -> "Workflow":
        self.stage0_datasets()
        for stage in (self.stage1_source, self.stage2_adabn, self.stage3_splice, self.stage4_wq, self.stage5_sfat):
            stage()
        path = self.write_summary()
        print("\n=== workflow summary ===")
        print(json.dumps(self.summary, indent=2))
        for stage, wall in self.walls.items():
            print(f"[workflow] {stage}: {wall:.2f} s, launches {self.launches.get(stage, {})}")
        print(f"written to {path}")
        return self


def main(argv: Optional[List[str]] = None) -> Workflow:
    ap = argparse.ArgumentParser(description="The five-stage chain through the port's CLIs on synthetic data.")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "wf"))
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--retrain-iters", type=int, default=None,
                    help="stage 4 and 5 iterations (default: --iters); the retrain stages see only the sparse "
                         "pseudo-labels, so long schedules overfit background onto unlabelled objects at this scale")
    ap.add_argument("--device", default=None, help="the CLIs' --device (default: cuda)")
    ap.add_argument("--adabn-batches", type=int, default=None,
                    help="stage 2's refinement batches (default: the CLI's 1400)")
    a = ap.parse_args(argv)
    return Workflow(a.root, a.iters, a.retrain_iters, a.device, a.adabn_batches).run()


if __name__ == "__main__":
    main()
