"""The port's train loop against the JAX package's, on the CPU.

The bookkeeping: the JAX `BaseTrainer(cfg, synthetic=True).train()` and the
port's on configs/synthetic_tiny.yaml (VGG16-BN, 128x256, FC_DIM 128,
batch 2) with MAX_ITER 5, CHECKPOINT_PERIOD 2, EVAL_PERIOD 3 and the
validation loss on write the same `metrics.json` iterations with the same
keys, save the same checkpoint names in the same order, and call `test()`
at the same iterations. With TPU.STEPS_PER_DISPATCH 2 (staged ahead on a
thread) the port lands on chunk boundaries by the same rule and trains the
same weights bit for bit.

Resume is exact on the CPU in float32: 2 steps, a save, a new trainer that
resumes, 2 more steps equal 4 steps straight bit for bit (weights,
statistics, momentum, generators, threshold statistics), for `base` and
for the main adaptation variant, with a loader that repeats one batch (the
loader restarts from its seed on resume, as the JAX package's does).
SIGTERM saves `model_preempt_*` and a resume completes; an exception saves
`model_crash_*`. SOLVER.REFERENCE_WORLD_SIZE scales as the JAX package's
auto_scale_workers. VIS_PERIOD draws the teacher's pseudo-labels as the JAX
package draws them, and without a TensorBoard backend the loop refuses to
start.
"""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.solver.build import auto_scale_workers as jax_auto_scale_workers
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, register_synthetic, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.solver.build import auto_scale_workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "synthetic_tiny.yaml")
SCHEDULE = ["SOLVER.MAX_ITER", "5", "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "3", "TEST.VAL_LOSS", "True"]
# the adaptation state a resume must restore: strong view (host generator),
# adaptive threshold, domain classifiers
SFAT_OPTS = ["TRAINER", "source_free_adaptive_teacher", "WEAK_STRONG_AUGMENT", "True",
             "ADAPTIVE_THRESHOLD.ENABLED", "True", "ADAPTIVE_THRESHOLD.WARM_UP", "2",
             "DOMAIN_CLASSIFIER.ENABLED", "True", "SEMISUPNET.INS_DC", "True", "SEMISUPNET.DIS_TYPE", "vgg4"]


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """Run the test on 2 threads and remove its directory after it. The
    suite runs several workers on the machine's cores, and torch's default
    of one thread a core oversubscribes them; a synthetic_tiny checkpoint is
    160-235 MiB, and pytest keeps the directories of its last runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_cfg(get, out, *opts):
    cfg = get()
    cfg.merge_from_file(TINY)
    cfg.merge_from_list(list(opts))
    cfg.OUTPUT_DIR = str(out)
    return cfg


def register_tiny():
    for name in ("synthetic_train", "synthetic_target", "synthetic_test"):
        register_synthetic(name, num_images=8, num_classes=4)
        jax_register_synthetic(name, num_images=8, num_classes=4)


def record(trainer, events, stub=False):
    """Log each checkpoint name and each test() iteration of `trainer`
    (with `stub`, instead of saving and evaluating)."""
    save, test = trainer.checkpointer.save, trainer.test

    def saving(name, state, block=True):
        events.append(("save", name))
        return None if stub else save(name, state, block=block)

    def testing(*a, **kw):
        events.append(("test", trainer.storage.iter))
        return {} if stub else test(*a, **kw)

    trainer.checkpointer.save = saving
    trainer.test = testing


def metrics_lines(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def port_loop(out, *opts, stub=False):
    register_tiny()
    tr = build_trainer(tiny_cfg(get_cfg, out, *SCHEDULE, *opts), device="cpu", synthetic=True)
    events = []
    record(tr, events, stub)
    tr.train()
    return tr, events, metrics_lines(out)


@pytest.fixture(scope="module")
def jax_loop(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_loop")
    register_tiny()
    cfg = tiny_cfg(jax_get_cfg, out, *SCHEDULE)
    tr = jax_build_trainer(cfg, synthetic=True)
    events = []
    record(tr, events)
    tr.train()
    tr.checkpointer.wait()
    yield events, metrics_lines(out)
    shutil.rmtree(out, ignore_errors=True)


def test_loop_bookkeeping_equals_jax(jax_loop, tmp_path):
    jax_events, jax_lines = jax_loop
    tr, events, lines = port_loop(tmp_path)
    assert events == jax_events == [("save", "model_0000001"), ("test", 2), ("save", "model_0000003"), ("test", 5),
                                    ("save", "model_final")]
    assert [m["iteration"] for m in lines] == [m["iteration"] for m in jax_lines] == [4]
    assert [set(m) for m in lines] == [set(m) for m in jax_lines]
    assert {"synthetic_test/AP50", "loss_cls_val", "num_sampled_val", "total_loss", "lr", "data_time"} <= set(lines[0])
    assert all(np.isfinite(v) for k, v in lines[0].items() if k.startswith("loss") or k.endswith("_val"))
    assert sorted(f for f in os.listdir(tr.output_dir) if f.endswith(".pth")) == [
        "model_0000001.pth", "model_0000003.pth", "model_final.pth"]
    assert tr.checkpointer.last_checkpoint() == "model_final.pth" and tr.state.step == 5


def test_chunked_loop_keeps_the_trajectory(tmp_path):
    """Two steps a dispatch, staged ahead: chunks end at 1, 3 and 4, so the
    checkpoints fall at 1 and 3, test() and the validation loss at 3 (the
    period's multiple 3 falls in (2, 4]), and the weights equal the
    single-step run's bit for bit (test() and the saves recorded, not run)."""
    tr1 = port_loop(tmp_path / "single", stub=True)[0]
    tr, events, lines = port_loop(tmp_path / "chunked", "TPU.STEPS_PER_DISPATCH", "2", "TPU.CHUNK_STAGE_AHEAD", "1",
                                  stub=True)
    assert events == [("save", "model_0000001"), ("save", "model_0000003"), ("test", 3), ("test", 5),
                      ("save", "model_final")]
    assert [m["iteration"] for m in lines] == [4] and "loss_cls_val" in lines[0]
    want = tr1.state.model.state_dict()
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


class RepeatBatch:
    """A loader that yields one batch forever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def resume_trainer(out, max_iter, sfat, resume=False):
    opts = ["SOLVER.MAX_ITER", str(max_iter), "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            "SOLVER.WARMUP_ITERS", "0"] + (SFAT_OPTS if sfat else [])
    cfg = tiny_cfg(get_cfg, out, *opts)
    state_dict = None
    if sfat:  # random weights that make pseudo-labels: the class-1 logit raised
        from simple_sfod_tpu_torch.config import detector_config_from_cfg
        from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

        model = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0)
        with torch.no_grad():
            model.roi_heads.box_predictor.cls_score.bias[1] += 6.0
        state_dict = model.state_dict()
    tr = build_trainer(cfg, device="cpu", state_dict=state_dict)
    tr.resume_or_load(resume=resume)
    records = make_synthetic_records(2, (120, 250), 4, 6, seed=5)
    tr.train_loader = RepeatBatch(synthetic_batch(records, (128, 256), 8))
    return tr


def full_state(tr):
    """Every tensor a resume restores, by name."""
    st = tr.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    out.update({f"mu.{k}": v for k, v in st.optimizer.state_dict()["mu"].items()})
    out["generator"] = tr.generator.get_state()
    if hasattr(st, "teacher"):
        out.update({f"teacher.{k}": v for k, v in st.teacher.state_dict().items()})
        out.update({f"dc.{n}.{k}": v for n, m in st.dc.items() for k, v in m.state_dict().items()})
        out.update({"reserve": st.thresh.reserve, "acc": st.thresh.classwise_acc,
                    "host_generator": tr.host_generator.get_state()})
    return out


@pytest.mark.parametrize("sfat", [False, True], ids=["base", "sfat_main"])
def test_resume_is_bit_equal(tmp_path, sfat):
    straight = resume_trainer(tmp_path / "straight", 4, sfat)
    straight.train()
    first = resume_trainer(tmp_path / "split", 2, sfat)
    first.train()
    second = resume_trainer(tmp_path / "split", 4, sfat, resume=True)
    assert second.state.step == second.storage.iter == 2
    second.train()
    assert second.state.step == straight.state.step == 4
    assert second.state.optimizer.count == straight.state.optimizer.count == 4
    want, got = full_state(straight), full_state(second)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if sfat:
        assert second.state.thresh.cursor == straight.state.thresh.cursor == 4
        assert int(second.state.thresh.reserve.sum()) > 0  # pseudo-labels were made


def test_sigterm_saves_preempt_and_resume_completes(tmp_path):
    """The port's twin of tests/test_trainers.py::TestPreemption: SIGTERM
    while a chunk runs; the loop finishes it, saves model_preempt_*, returns
    and restores the signal's disposition; --resume runs to MAX_ITER."""
    register_tiny()
    opts = ["SOLVER.MAX_ITER", "4", "TPU.STEPS_PER_DISPATCH", "2", "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    step, fired = tr.step_staged, []

    def step_and_signal(staged, draws=None):
        if not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
        return step(staged, draws)

    tr.step_staged = step_and_signal
    before = signal.getsignal(signal.SIGTERM)
    tr.train()
    assert tr.state.step == 2
    assert tr.checkpointer.last_checkpoint() == "model_preempt_0000001.pth"
    assert not os.path.exists(os.path.join(tmp_path, "model_final.pth"))
    assert signal.getsignal(signal.SIGTERM) == before

    tr2 = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    tr2.resume_or_load(resume=True)
    assert tr2.state.step == 2
    tr2.train()
    assert tr2.state.step == 4 and tr2.checkpointer.last_checkpoint() == "model_final.pth"


def test_exception_saves_crash_checkpoint(tmp_path):
    register_tiny()
    opts = ["SOLVER.MAX_ITER", "4", "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    step = tr.step_staged

    def step_then_fail(staged, draws=None):
        if tr.state.step == 1:
            raise RuntimeError("injected fault")
        return step(staged, draws)

    tr.step_staged = step_then_fail
    with pytest.raises(RuntimeError, match="injected fault"):
        tr.train()
    assert tr.checkpointer.last_checkpoint() == "model_crash_0000001.pth"
    data = tr.checkpointer.load("model_crash_0000001")
    assert data["iteration"] == 1 and data["optimizer"]["count"] == 1


def test_nan_loss_stops_the_loop(tmp_path):
    """A non-finite loss read on a log step raises FloatingPointError (after
    the crash checkpoint)."""
    register_tiny()
    opts = ["SOLVER.MAX_ITER", "1", "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    step = tr.step_staged

    def nan_step(staged, draws=None):
        m = step(staged, draws)
        m["loss_cls"] = torch.tensor(float("nan"))
        return m

    tr.step_staged = nan_step
    with pytest.raises(FloatingPointError, match="loss_cls"):
        tr.train()
    assert tr.checkpointer.last_checkpoint() == "model_crash_0000001.pth"


@pytest.mark.parametrize("reference", [0, 1, 2, 8])
def test_auto_scale_workers_equals_jax(reference):
    """SOLVER.REFERENCE_WORLD_SIZE scaled to one device: LR, both batch
    sizes, MAX_ITER, WARMUP_ITERS, STEPS and both periods as the JAX
    package's function gives them (exact: the same float and int arithmetic)."""
    opts = ["SOLVER.REFERENCE_WORLD_SIZE", str(reference), "SOLVER.IMS_PER_BATCH", "8", "SOLVER.IMS_PER_BATCH_TARGET",
            "8", "SOLVER.MAX_ITER", "1000", "SOLVER.WARMUP_ITERS", "100", "SOLVER.STEPS", "(300, 700)",
            "TEST.EVAL_PERIOD", "50", "SOLVER.CHECKPOINT_PERIOD", "200"]
    ours, theirs = get_cfg(), jax_get_cfg()
    ours.merge_from_list(opts)
    theirs.merge_from_list(opts)
    a, b = auto_scale_workers(ours, 1), jax_auto_scale_workers(theirs, 1)
    for key in ("BASE_LR", "IMS_PER_BATCH", "IMS_PER_BATCH_TARGET", "MAX_ITER", "WARMUP_ITERS", "STEPS",
                "CHECKPOINT_PERIOD", "REFERENCE_WORLD_SIZE"):
        assert a.SOLVER[key] == b.SOLVER[key], key
    assert a.TEST.EVAL_PERIOD == b.TEST.EVAL_PERIOD
    assert (a is ours) == (reference in (0, 1))


def test_trainer_applies_linear_scaling(tmp_path):
    """A trainer built with REFERENCE_WORLD_SIZE 2 runs the schedule of the
    JAX package's auto_scale_workers(cfg, 1): halved LR and batch, doubled
    MAX_ITER and periods. (A JAX trainer is no yardstick: on the suite's 8
    virtual devices its width is the gcd with the batch.)"""
    opts = ["TRAINER", "source_free_adaptive_teacher", "SOLVER.REFERENCE_WORLD_SIZE", "2", "SOLVER.WARMUP_ITERS", "0",
            "SOLVER.IMS_PER_BATCH_TARGET", "2", "SOLVER.CHECKPOINT_PERIOD", "4"]
    want = jax_auto_scale_workers(tiny_cfg(jax_get_cfg, tmp_path, *opts), 1)
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu")
    assert tr.cfg.SOLVER.IMS_PER_BATCH_TARGET == want.SOLVER.IMS_PER_BATCH_TARGET == 1
    assert tr.max_iter == want.SOLVER.MAX_ITER == 10
    assert tr.cfg.SOLVER.CHECKPOINT_PERIOD == want.SOLVER.CHECKPOINT_PERIOD == 8
    assert tr.cfg.TEST.EVAL_PERIOD == want.TEST.EVAL_PERIOD
    assert tr.state.optimizer.lr() == np.float32(want.SOLVER.BASE_LR)
    register_tiny()
    assert tr.build_train_loader().batch_size == 1


def test_draw_detections_equals_jax():
    from simple_sfod_tpu.utils.visualize import draw_detections as jax_draw
    from simple_sfod_tpu_torch.utils.visualize import draw_detections

    rng = np.random.RandomState(0)
    image = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    boxes = np.asarray([[4, 5, 40, 30], [50, 10, 90, 60]], np.float32)
    classes, scores = np.asarray([1, 9]), np.asarray([0.91, 0.5], np.float32)
    for fmt in ("BGR", "RGB"):
        want = jax_draw(image, boxes, classes, scores, [f"c{i}" for i in range(10)], input_format=fmt)
        got = draw_detections(image, boxes, classes, scores, [f"c{i}" for i in range(10)], input_format=fmt)
        np.testing.assert_array_equal(got, want)


def test_vis_period_without_tensorboard_refuses_to_start(tmp_path, monkeypatch):
    from simple_sfod_tpu_torch.utils import visualize

    def no_backend():
        raise ImportError("no tensorboard")

    monkeypatch.setattr(visualize, "tensorboard_summary_writer", no_backend)
    register_tiny()
    opts = ["TRAINER", "source_free_adaptive_teacher", "VIS_PERIOD", "2", "SOLVER.MAX_ITER", "2"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    with pytest.raises(RuntimeError, match="set VIS_PERIOD 0"):
        tr.train()
    assert tr.state.step == 0 and not os.path.exists(os.path.join(tmp_path, "metrics.json"))


def test_vis_period_writes_the_teachers_pseudo_labels(tmp_path, monkeypatch):
    """Every VIS_PERIOD steps of the loop (iterations 1 and 3 at period 2),
    the teacher's detections above BBOX_THRESHOLD on the step's first image
    (model_final recorded, not written)."""
    from simple_sfod_tpu_torch.utils import visualize

    drawn = []
    monkeypatch.setattr(visualize.VisualizationHook, "after_step",
                        lambda self, step, image, boxes, classes=None, scores=None, tag="": drawn.append(
                            (step, tag, np.asarray(scores))))
    register_tiny()
    opts = ["TRAINER", "source_free_adaptive_teacher", "VIS_PERIOD", "2", "SOLVER.MAX_ITER", "4",
            "SEMISUPNET.BBOX_THRESHOLD", "0.1"]
    tr = build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    record(tr, [], stub=True)
    tr.train()
    assert [(s, t) for s, t, _ in drawn] == [(1, "train/teacher_pseudo_labels"), (3, "train/teacher_pseudo_labels")]
    assert all((sc > 0.1).all() for _, _, sc in drawn)
