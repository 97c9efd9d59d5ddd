"""Weights out to the reference stack: the port's export
(checkpoint/torch_export.py, tools/export_weights.py) against the JAX
package's `export_train_state` on the CPU.

A teacher-student state is made in the JAX layout (each detector seeded at
the JAX init's shapes; teacher and
student apart), carried to the port by checkpoint/from_jax.py and written
as a port checkpoint (by the adaptation trainer itself in the tool's round
trip; test_torch_checkpoint.py holds the trainer's file to this layout). The port's
export of that file equals export_train_state of the JAX state key for key
and value for value (float32, num_batches_tracked 0), for student, teacher,
ensemble and auto, on VGG16-BN, VGG16 without BN and ResNet-101 C4 (BN and
FrozenBN; the block plan cut, test_torch_adabn.py:cut_r101). A base
trainer's file exports its detector, and teacher or ensemble raise there as
in the JAX package. The tool writes only "model" and "iteration", its file
loads strictly into the port's detector and into the JAX importer, and an
OUTPUT_DIR is read through its last_checkpoint. The FPN detector, which
the JAX exporter cannot write (tests/test_torch_fpn.py), exports under
Detectron2's FPN names and loads strictly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint.torch_export import export_train_state
from simple_sfod_tpu.checkpoint.torch_import import import_torch_checkpoint, load_torch_file
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from simple_sfod_tpu_torch.checkpoint.checkpointer import Checkpointer
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.checkpoint.torch_export import export_checkpoint, export_model_state
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.tools import export_weights
from test_torch_adabn import R101_OPTS, cut_r101
from test_torch_train_loop import TINY, free_disk, tiny_cfg  # noqa: F401  (free_disk: autouse)

VARIANTS = {
    "vgg16_bn": [],
    "vgg16": ["VGG.BN", "False"],
    "r101_c4_bn": [*R101_OPTS, "MODEL.RESNETS.NORM", "BN"],
    "r101_c4_frozen": [*R101_OPTS, "MODEL.RESNETS.NORM", "FrozenBN"],
}
SFAT = ["TRAINER", "source_free_adaptive_teacher"]
STEP = 7


def seeded_tree(jc, seed):
    """The JAX FasterRCNN's variables at its init's shapes (jax.eval_shape,
    as test_torch_resnet.py:seeded_variables), filled from a seed: normal
    values, variances uniform in (0.5, 2)."""
    shapes = jax.eval_shape(lambda: JaxFasterRCNN(jax_lower(jc)).init(
        jax.random.key(0), jax.numpy.zeros((1, 64, 64, 3), jax.numpy.float32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.standard_normal(leaf.shape, dtype=np.float32) * np.float32(0.05)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def jax_state(jc, teacher=True):
    """A JAX TrainState / TeacherStudentState as the dict orbax restores:
    seeded student, a differently seeded teacher, step STEP."""
    s = seeded_tree(jc, seed=1)
    state = {"params": {"det": s["params"]}, "batch_stats": s.get("batch_stats", {}), "step": STEP}
    if teacher:
        t = seeded_tree(jc, seed=2)
        state.update(teacher_params=t["params"], teacher_stats=t.get("batch_stats", {}))
    return state


def port_models(state, det_cfg):
    """(student, teacher or None) state dicts carried by from_jax."""
    student = state_dict_from_jax({"params": state["params"]["det"], "batch_stats": state["batch_stats"]}, det_cfg)
    if "teacher_params" not in state:
        return student, None
    return student, state_dict_from_jax({"params": state["teacher_params"], "batch_stats": state["teacher_stats"]},
                                        det_cfg)


def port_checkpoint(out, state, det_cfg):
    """`state` as the port's checkpoint OUTPUT_DIR/model_final.pth, in the
    layout of the trainers' checkpoint_state (a teacher-student "model"
    with modelTeacher.* then modelStudent.*) -> the file's path."""
    student, teacher = port_models(state, det_cfg)
    model = student
    if teacher is not None:
        model = {**{f"modelTeacher.{k}": v for k, v in teacher.items()},
                 **{f"modelStudent.{k}": v for k, v in student.items()}}
    Checkpointer(str(out)).save("model_final", {"model": model, "iteration": STEP, "optimizer": {}, "trainer": {}})
    return os.path.join(str(out), "model_final.pth")


def trainer_checkpoint(out, state, det_cfg):
    """The adaptation trainer holding `state`, saved by its own
    checkpoint_state at iteration STEP -> the file's path."""
    tr = build_trainer(tiny_cfg(get_cfg, out, *SFAT), device="cpu")
    student, teacher = port_models(state, det_cfg)
    tr.state.model.load_state_dict(student, strict=True)
    tr.state.teacher.load_state_dict(teacher, strict=True)
    tr.state.step = STEP
    tr.checkpointer.save("model_final", tr.checkpoint_state())
    return os.path.join(str(out), "model_final.pth")


def assert_export_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        w = torch.from_numpy(np.asarray(v))
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    counters = [k for k in got if k.endswith("num_batches_tracked")]
    assert all(int(got[k]) == 0 for k in counters)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_equals_jax_export_train_state(tmp_path, monkeypatch, variant):
    if variant.startswith("r101"):
        cut_r101(monkeypatch)
    opts = VARIANTS[variant]
    pc, jc = tiny_cfg(get_cfg, tmp_path, *opts), tiny_cfg(jax_get_cfg, tmp_path, *opts)
    state = jax_state(jc)
    path = port_checkpoint(tmp_path / "port", state, detector_config_from_cfg(pc))
    got, iteration = export_checkpoint(path, "auto")
    assert iteration == STEP
    assert_export_equal(got, export_train_state(state, jax_lower(jc), "auto"))
    model = torch.load(path, weights_only=True)["model"]
    for which in ("student", "teacher", "ensemble"):
        got = export_model_state(model, which)
        assert_export_equal(got, export_train_state(state, jax_lower(jc), which))
    assert any(k.endswith("num_batches_tracked") for k in got) == (variant != "vgg16")


def test_base_checkpoint_exports_its_detector_and_refuses_a_teacher(tmp_path):
    pc, jc = tiny_cfg(get_cfg, tmp_path), tiny_cfg(jax_get_cfg, tmp_path)
    state = jax_state(jc, teacher=False)
    out = tmp_path / "port"
    port_checkpoint(out, state, detector_config_from_cfg(pc))
    for which in ("auto", "student"):
        got, _ = export_checkpoint(str(out), which)  # OUTPUT_DIR: its last_checkpoint
        assert_export_equal(got, export_train_state(state, jax_lower(jc), which))
    for which in ("teacher", "ensemble"):
        with pytest.raises(ValueError, match="no teacher"):
            export_train_state(state, jax_lower(jc), which)
        with pytest.raises(ValueError, match="no teacher"):
            export_checkpoint(str(out), which)
    with pytest.raises(ValueError, match="expected auto"):
        export_model_state({}, "both")
    with pytest.raises(FileNotFoundError, match="last_checkpoint"):
        export_checkpoint(str(tmp_path))


def test_tool_round_trip_loads_strictly(tmp_path, capsys):
    pc, jc = tiny_cfg(get_cfg, tmp_path), tiny_cfg(jax_get_cfg, tmp_path)
    state = jax_state(jc)
    det_cfg = detector_config_from_cfg(pc)
    ckpt = trainer_checkpoint(tmp_path / "port", state, det_cfg)
    out = str(tmp_path / "d2.pth")
    sd = export_weights.main(["--ckpt", ckpt, "--output", out, "--config-file", TINY])
    assert f"-> {out} (ensemble, {len(sd)} tensors)" in capsys.readouterr().out
    data = torch.load(out, weights_only=True)
    assert set(data) == {"model", "iteration"} and data["iteration"] == STEP
    saved = torch.load(ckpt, weights_only=True)["model"]
    for prefix in ("modelStudent.", "modelTeacher."):
        part = {k[len(prefix):]: v for k, v in data["model"].items() if k.startswith(prefix)}
        Detector(det_cfg, device="cpu").load_state_dict(part)  # strict
        assert all(torch.equal(v, saved[prefix + k]) for k, v in part.items() if not k.endswith("num_batches_tracked"))
    # the JAX importer reads the file's student back into the JAX state's tree
    params, stats = import_torch_checkpoint(load_torch_file(out), jax_lower(jc))
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, state["params"]["det"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, stats, state["batch_stats"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        export_weights.main(["--ckpt", ckpt, "--output", out, "--config-file", TINY, "MODEL.ROI_HEADS.NUM_CLASSES", "3"])


def test_fpn_exports_under_detectron2_names(tmp_path):
    from test_torch_fpn import YAML
    from test_torch_fpn import seeded_variables as fpn_seeded

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(YAML)
    pcfg = get_cfg()
    pcfg.merge_from_file(YAML)
    det_cfg = detector_config_from_cfg(pcfg)
    student, teacher = (state_dict_from_jax(fpn_seeded(jcfg, seed=s), det_cfg) for s in (1, 2))
    model = {**{f"modelTeacher.{k}": v for k, v in teacher.items()}, **{f"modelStudent.{k}": v for k, v in student.items()}}
    path = str(tmp_path / "fpn.pth")
    torch.save({"model": model, "iteration": 3, "optimizer": {}, "trainer": {}}, path)
    out = str(tmp_path / "fpn_d2.pth")
    export_weights.main(["--ckpt", path, "--output", out, "--which", "teacher", "--config-file", YAML])
    got = torch.load(out, weights_only=True)["model"]
    assert "backbone.fpn_lateral2.weight" in got and "backbone.bottom_up.vgg0.0.weight" in got
    assert got.keys() == teacher.keys() and all(torch.equal(got[k], teacher[k]) for k in got)
