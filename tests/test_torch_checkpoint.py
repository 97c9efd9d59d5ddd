"""The port's checkpoints against the JAX package's torch files, both ways,
on the CPU (configs/synthetic_tiny.yaml: VGG16-BN, 128x256, FC_DIM 128).

  - A `.pth` written by the JAX package (export_train_state +
    save_torch_file) and loaded by the port's `resume_or_load` gives the
    port the weights that checkpoint/from_jax.py carries from the tree the
    JAX Checkpointer loads from the same file: the student, and for a
    teacher-student state the teacher too (both from the file's student).
  - The port's files hold under "model" exactly what the JAX package's
    export_train_state writes for the same state (keys and float32 values,
    a bfloat16 fixed teacher included), and the JAX importer reads them
    back into that state's tree.
  - A NUM_CLASSES mismatch keeps the same tensors at initialisation in both
    packages; a failed background save surfaces on wait(); an orbax
    directory is refused; Detectron2 pickles of numpy arrays load, other
    pickles do not; a bfloat16 teacher survives the float32 file bit for bit.
All comparisons are exact: the layouts only transpose.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from simple_sfod_tpu.checkpoint.torch_export import export_train_state, save_torch_file
from simple_sfod_tpu.checkpoint.torch_import import import_torch_checkpoint, load_torch_file
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu_torch.checkpoint import checkpointer as port_checkpointer
from simple_sfod_tpu_torch.checkpoint.checkpointer import Checkpointer, load_torch_weights
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax, teacher_student_from_jax
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from test_torch_train_loop import SFAT_OPTS, free_disk, tiny_cfg  # noqa: F401  (free_disk: autouse)

VARIANTS = {"base": [], "sfat": SFAT_OPTS}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_trainer(out, *opts):
    return jax_build_trainer(tiny_cfg(jax_get_cfg, out, *opts), synthetic=True)


def port_state_dicts(tr):
    """{"student": ..., "teacher": ...} (teacher where the trainer has one)."""
    out = {"student": tr.state.model.state_dict()}
    if hasattr(tr.state, "teacher"):
        out["teacher"] = tr.state.teacher.state_dict()
    return out


def from_jax_state(state, det_cfg):
    """The port's state dicts that checkpoint/from_jax.py carries from a
    JAX TrainState or TeacherStudentState."""
    state = numpy_tree(state)
    if hasattr(state, "teacher_params"):
        w = teacher_student_from_jax(state, det_cfg)
        return {"student": w.student, "teacher": w.teacher}
    return {"student": state_dict_from_jax(state.variables(), det_cfg)}


def assert_equal_dicts(got, want, skip=("num_batches_tracked",)):
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith(skip):
            assert torch.equal(got[k].float(), want[k].float()), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_torch_file_loads_as_from_jax(tmp_path, variant):
    jtr = jax_trainer(tmp_path / "jax", *VARIANTS[variant])
    state = jtr.state
    if variant == "sfat":  # a teacher unlike the student: the file's student must be taken
        state = state.replace(teacher_params=jax.tree_util.tree_map(lambda x: x + 1, state.teacher_params))
    path = str(tmp_path / "from_jax.pth")
    save_torch_file(export_train_state(numpy_tree(state), jtr.det_cfg), path, iteration=0)

    loaded = JaxCheckpointer(str(tmp_path / "jax_load"), det_cfg=jtr.det_cfg).resume_or_load(path, jtr.state, False)
    ptr = build_trainer(tiny_cfg(get_cfg, tmp_path / "port", "MODEL.WEIGHTS", path, *VARIANTS[variant]), device="cpu")
    ptr.resume_or_load(resume=False)
    want = from_jax_state(loaded, ptr.det_cfg)
    got = port_state_dicts(ptr)
    for which in want:
        assert_equal_dicts(got[which], want[which])
    if variant == "sfat":
        assert_equal_dicts(got["teacher"], got["student"])
        assert got["teacher"]["roi_heads.box_predictor.cls_score.bias"].data_ptr() != \
            got["student"]["roi_heads.box_predictor.cls_score.bias"].data_ptr()
    assert ptr.state.step == ptr.storage.iter == 0


@pytest.mark.parametrize("variant,dtype", [("base", "float32"), ("sfat", "float32"), ("sfat", "bfloat16")])
def test_port_file_is_the_jax_export_and_imports(tmp_path, variant, dtype):
    opts = [*VARIANTS[variant], "TPU.DTYPE", dtype]
    jtr = jax_trainer(tmp_path / "jax", *opts)
    state = numpy_tree(jtr.state)
    cfg = tiny_cfg(get_cfg, tmp_path / "port", *opts)
    if variant == "sfat":
        ptr = build_trainer(cfg, device="cpu", weights=teacher_student_from_jax(state, _det(cfg)))
    else:
        ptr = build_trainer(cfg, device="cpu", state_dict=state_dict_from_jax(state.variables(), _det(cfg)))
    ptr.checkpointer.save("model_final", ptr.checkpoint_state())
    path = os.path.join(str(tmp_path / "port"), "model_final.pth")
    data = torch.load(path, weights_only=True)
    assert data["iteration"] == 0 and set(data) == {"model", "iteration", "optimizer", "trainer"}

    want = export_train_state(state, jtr.det_cfg)
    assert data["model"].keys() == want.keys()
    for k, v in want.items():
        assert data["model"][k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(data["model"][k].numpy(), v, err_msg=k)

    det = state.params["det"] if variant == "sfat" else state.params
    params, stats = import_torch_checkpoint(load_torch_file(path), jtr.det_cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, numpy_tree(det))
    jax.tree_util.tree_map(np.testing.assert_array_equal, stats, state.batch_stats)
    if variant == "sfat":
        teacher = {k[len("modelTeacher."):]: v for k, v in load_torch_file(path).items() if k.startswith("modelTeacher.")}
        params, stats = import_torch_checkpoint(teacher, jtr.det_cfg)
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b, np.float32)),
                               params, state.teacher_params)
        assert set(data["trainer"]["dc"]) == {"dc", "dc_ins"}


def _det(cfg):
    from simple_sfod_tpu_torch.config import detector_config_from_cfg

    return detector_config_from_cfg(cfg)


def test_num_classes_mismatch_keeps_the_same_tensors(tmp_path):
    """A 4-class file into 8-class targets: the predictor's four tensors keep
    their initialisation in both packages, and only they do."""
    jtr4 = jax_trainer(tmp_path / "j4")
    path = str(tmp_path / "c4.pth")
    file_sd = export_train_state(numpy_tree(jtr4.state), jtr4.det_cfg)
    save_torch_file(file_sd, path)

    jtr8 = jax_trainer(tmp_path / "j8", "MODEL.ROI_HEADS.NUM_CLASSES", "8")
    loaded = JaxCheckpointer(str(tmp_path / "j8l"), det_cfg=jtr8.det_cfg).resume_or_load(path, jtr8.state, False)
    after = export_train_state(numpy_tree(loaded), jtr8.det_cfg)
    jax_kept = {k for k, v in after.items() if not k.endswith("num_batches_tracked") and k not in ("pixel_mean", "pixel_std")
                and (np.shape(v) != np.shape(file_sd[k]) or not np.array_equal(v, file_sd[k]))}

    ptr = build_trainer(tiny_cfg(get_cfg, tmp_path / "p8", "MODEL.ROI_HEADS.NUM_CLASSES", "8"), device="cpu")
    init = {k: v.clone() for k, v in ptr.state.model.state_dict().items()}
    kept = set(ptr.load_weights(load_torch_weights(path)))
    predictor = {f"roi_heads.box_predictor.{m}.{p}" for m in ("cls_score", "bbox_pred") for p in ("weight", "bias")}
    assert kept == jax_kept == predictor
    for k in kept:
        assert torch.equal(ptr.state.model.state_dict()[k], init[k]), k


def test_failed_background_save_surfaces_on_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def fail(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(port_checkpointer.torch, "save", fail)
    ck.save("model_0000001", {"x": torch.ones(3)}, block=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once
    assert ck.last_checkpoint() is None and not os.path.exists(ck.path("model_0000001"))
    ck.save("model_0000002", {"x": torch.ones(3)}, block=False)
    with pytest.raises(OSError, match="disk full"):
        ck.save("model_0000003", {"x": torch.ones(3)})  # the next save raises the earlier one's error


def test_orbax_directory_and_unknown_weights_are_refused(tmp_path):
    (tmp_path / "model_final").mkdir()
    ck = Checkpointer(str(tmp_path / "out"))
    with pytest.raises(ValueError, match="tools/export_weights.py"):
        ck.resume_or_load(str(tmp_path / "model_final"), resume=False)
    with pytest.raises(ValueError, match="expected a file ending"):
        ck.resume_or_load(str(tmp_path / "weights.npz"), resume=False)
    assert ck.resume_or_load("", resume=True) == ("none", None)


def test_detectron2_pickle_loads_and_other_pickles_do_not(tmp_path):
    path = tmp_path / "d2.pkl"
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    path.write_bytes(pickle.dumps({"model": {"module.w": w}, "__author__": "d2"}))
    got = load_torch_weights(str(path))
    assert list(got) == ["w"] and torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"model": {"w": os.getcwd}}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        load_torch_weights(str(bad))


def test_bfloat16_teacher_resumes_bit_for_bit(tmp_path):
    """The fixed bfloat16 teacher is written as float32 and cast back
    exactly; the domain classifiers stay out of "model"."""
    opts = [*SFAT_OPTS, "TPU.DTYPE", "bfloat16"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu")
    with torch.no_grad():
        for p in tr.state.teacher.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(3)).to(p.dtype) * 1e-2)
    tr.state.step = 7
    tr.checkpointer.save("model_0000006", tr.checkpoint_state())
    data = tr.checkpointer.load("model_0000006")
    assert all(k.startswith(("modelTeacher.", "modelStudent.")) for k in data["model"])
    assert all(v.dtype in (torch.float32, torch.int64) for v in data["model"].values())

    tr2 = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu")
    tr2.resume_or_load(resume=True)
    assert tr2.state.step == 7
    want = tr.state.teacher.state_dict()
    for k, v in tr2.state.teacher.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    assert next(tr2.state.teacher.parameters()).dtype == torch.bfloat16


R101_OPTS = ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.DEPTH", "101",
             "MODEL.ROI_HEADS.IN_FEATURES", "('res4',)", "MODEL.RPN.IN_FEATURES", "('res4',)",
             "MODEL.ROI_BOX_HEAD.FC_DIM", "64"]


@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_detectron2_r101_pth_loads_strictly(tmp_path, norm):
    """A Detectron2 ResNet-101 C4 file at full depth: its keys (without the
    pixel mean and std, which Detectron2 does not persist, and without a
    FrozenBatchNorm2d's counter, which it does not have) are exactly the
    model's, so resume_or_load takes every tensor and keeps no
    initialisation, and a strict load_state_dict takes the file."""
    opts = [*R101_OPTS, "MODEL.RESNETS.NORM", norm]
    src = build_trainer(tiny_cfg(get_cfg, tmp_path / "src", *opts), device="cpu")
    g = torch.Generator().manual_seed(4)
    frozen = {n for n, m in src.state.model.named_modules() if type(m).__name__ == "FrozenBatchNorm2d"}
    sd = {}
    for k, v in src.state.model.state_dict().items():
        if k in ("pixel_mean", "pixel_std") or (k.endswith("num_batches_tracked") and k.rsplit(".", 1)[0] in frozen):
            continue
        sd[k] = v + torch.rand(v.shape, generator=g) if v.is_floating_point() else v
    assert (len(frozen) == 94) == (norm == "FrozenBN")  # the stem, 3 in each of 30 blocks, 3 shortcuts
    path = str(tmp_path / "R-101-C4.pth")
    torch.save({"model": sd, "__author__": "Detectron2"}, path)

    tr = build_trainer(tiny_cfg(get_cfg, tmp_path / "port", *opts, "MODEL.WEIGHTS", path), device="cpu")
    kind, data = tr.checkpointer.resume_or_load(path, resume=False)
    assert kind == "weights" and set(data) == set(sd)
    assert tr.load_weights(data) == []
    got = tr.state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    fresh = build_trainer(tiny_cfg(get_cfg, tmp_path / "fresh", *opts), device="cpu").state.model
    fresh.load_state_dict({**data, "pixel_mean": got["pixel_mean"], "pixel_std": got["pixel_std"]}, strict=True)


def test_r101_teacher_student_resumes_bit_for_bit(tmp_path, monkeypatch):
    """The adaptation state of a cut ResNet-101 (FrozenBN, FREEZE_AT 2, a
    fixed bfloat16 teacher whose FrozenBN affine is bfloat16 too) saved
    after one step and resumed by a new trainer: everything restored bit for
    bit, and the next step of both equal bit for bit."""
    from test_torch_adabn import cut_r101

    cut_r101(monkeypatch)
    opts = [*SFAT_OPTS, *R101_OPTS, "MODEL.RESNETS.NORM", "FrozenBN", "SEMISUPNET.DIS_TYPE", "res4",
            "TPU.DTYPE", "bfloat16"]
    from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch

    batch = synthetic_batch(make_synthetic_records(2, (120, 250), 4, 6, seed=2), (128, 256), 8)
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu")
    teacher_frozen = tr.state.teacher.backbone.stem.conv1.norm
    assert teacher_frozen.weight.dtype == torch.bfloat16 and teacher_frozen.running_var.dtype == torch.float32
    tr.run_step(batch)
    tr.checkpointer.save("model_0000000", tr.checkpoint_state())
    tr2 = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu")
    tr2.resume_or_load(resume=True)
    for a, b in ((tr.state.model, tr2.state.model), (tr.state.teacher, tr2.state.teacher)):
        want = a.state_dict()
        for k, v in b.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    m1, m2 = tr.run_step(batch), tr2.run_step(batch)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    want = tr.state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in tr2.state.model.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(tr.state.optimizer.mu, tr2.state.optimizer.mu))
