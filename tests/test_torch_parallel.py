"""The port on several processes (simple_sfod_tpu_torch/parallel/) against
the JAX package's mesh and against itself on one process, on the CPU with
gloo.

Ranks are processes spawned by the port's launcher (parallel/launch.py,
the one the CLIs use) and run tests/torch_parallel_workers.py, which
imports no JAX; the JAX side runs here, on the 8 virtual devices of
tests/conftest.py. Each spawn runs several checks: a bare two-rank spawn
costs a few seconds before any model is built.

What is held, and how closely:
  layout        the data x model width of BaseTrainer._layout equals the
                JAX BaseTrainer's mesh on the same config (auto width, gcd
                over the sharded batches, the linear-scaling rule), and a
                world the layout does not fill raises; `tp_dim` places every
                tensor of a JAX state as `_tp_spec` does, by the port's names
  BatchNorm     cross-rank train-mode BN on 2 ranks against one process on
                the whole batch: output, input/weight/bias gradients and
                running statistics within 1e-5 of each tensor's largest entry
  base step     2 ranks (tiny backbone) against the JAX BaseTrainer on a
                2-device mesh, 2 free steps on the JAX draws: each loss 1e-4
                relative at the first step and 1e-3 at the second (a
                background proposal can flip on rounding once the weights
                have moved: test_torch_trainer.py's later-step bound), the
                fg/sampled counts equal, every parameter and statistic by
                test_torch_trainer.py's movement rule; the ranks' states
                bit-equal (a hash)
  TP step       data 1 x model 2 against the JAX ('data', 'model') mesh of
                1 x 2, the same bounds; the split box head with dropout
                masks against the whole head within 1e-6
  SFAT step     VGG16-BN at 64x128 on 2 ranks against the JAX SFAT trainer
                on a 2-device mesh, each of 2 steps from the JAX state on
                the JAX draws: the bounds of test_torch_sfat_trainer.py
                (losses 1e-4 relative, num_pseudo and the threshold state
                exact, the student by the movement rule, the fixed teacher's
                parameters exact and its statistics within 1e-5)
  eval, AdaBN   2 ranks against one process with an odd batch count:
                records and results equal, rank 0 alone writes; AdaBN's
                variances within 1e-5 of each buffer's largest entry, its
                means within 1e-5 of the largest standard deviation
  resume        2 -> 1, 1 -> 2 and (data 1 x model 2) -> 1: a checkpoint
                loads strictly at any width with the full tensors, and the
                continued runs agree by the movement rule
  preemption    SIGTERM's flag on one rank stops both ranks at the next
                multiple of LOG_PERIOD iterations, where they agree
  batches       a loader batch splits one row an image; draws by the layout
                their class declares, and an undeclared field raises
  CLIs          train_net --num-gpus 2 --device cpu and train_net_mt
                --eval-only on two processes joined by the JAX package's
                spellings; the refusals; dryrun_multigpu(2)
  trainers      the WQ family, da, cda and AT on 2 ranks against one
                process on the trainers' own draws (drawn for the global
                batch), 2 or 3 steps: losses 1e-4 relative at the first step
                and 1e-3 after, the detector by the movement rule, the ranks
                bit-equal
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.models.backbones.tiny import TinyBackbone as JaxTiny
from simple_sfod_tpu.parallel.mesh import _tp_spec, shard_state
from simple_sfod_tpu_torch.checkpoint import from_jax
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax, teacher_student_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import SFAT_BENCH_CONFIG, SOURCE_CONFIG, config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import base as base_mod
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models.backbones.tiny import TinyBackbone
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from simple_sfod_tpu_torch.parallel import mesh
from simple_sfod_tpu_torch.parallel.launch import free_port
from simple_sfod_tpu_torch.tools import train_net
from test_torch_sfat_trainer import BATCH, batches, bn_fed_bias, boost, inert_bias_ok, jax_adapt_draws, load_jax_state
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: removes each test's directory)
from test_torch_trainer import jax_step_draws, rel_err, within_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"MODEL": {"BACKBONE": {"NAME": "build_tiny_backbone"}, "ROI_HEADS": {"IN_FEATURES": ("tiny1",)},
                  "RPN": {"IN_FEATURES": ("tiny1",)}}}
CANVAS = (64, 128)
GT_CAP = 8
# the RPN's top-k cut to a few hundred: the plain NMS of the CPU path costs
# seconds at N = 4096
SMALL_RPN = {"PRE_NMS_TOPK_TRAIN": 256, "POST_NMS_TOPK_TRAIN": 128, "PRE_NMS_TOPK_TEST": 256,
             "POST_NMS_TOPK_TEST": 64}
BASE_OPTS = {
    "TPU": {"CANVAS": CANVAS, "GT_CAPACITY": GT_CAP},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 64, **SMALL_RPN},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 32}},
    "SOLVER": {"IMS_PER_BATCH": 2, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
    "TEST": {"DETECTIONS_PER_IMAGE": 32},
}
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")


def opts_of(*dicts):
    return sum((config_opts(d) for d in dicts), [])


def node(get, opts, out):
    cfg = get()
    cfg.merge_from_list(list(opts))
    cfg.OUTPUT_DIR = str(out)
    return cfg


def movement_bad(got, want, start, skip=()):
    """The keys of `want` that `got` misses by test_torch_trainer.py's
    movement rule (BN-fed conv biases: test_torch_sfat_trainer.py's rule)."""
    bad = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k.startswith(skip) or not w.is_floating_point():
            continue
        ok = inert_bias_ok(got, start, k) if bn_fed_bias(k) else within_tolerance(got[k], w, start[k])
        if not ok:
            bad.append(k)
    return bad


# -- the layout --------------------------------------------------------------------

LAYOUT_CASES = {
    # (TPU.MESH_DATA, TPU.MESH_MODEL, IMS_PER_BATCH, REFERENCE_WORLD_SIZE) on 8 devices / ranks
    "auto": (-1, 1, 8, 0),
    "auto_gcd": (-1, 1, 6, 0),
    "auto_model": (-1, 2, 4, 0),
    "explicit": (2, 2, 4, 0),
    "scaled": (-1, 1, 16, 16),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_layout_width_as_the_jax_mesh(tmp_path, monkeypatch, case):
    data, model, ims, ref = LAYOUT_CASES[case]
    opts = opts_of(SOURCE_CONFIG, BASE_OPTS, TINY, {"TPU": {"MESH_DATA": data, "MESH_MODEL": model},
                                                   "SOLVER": {"IMS_PER_BATCH": ims, "REFERENCE_WORLD_SIZE": ref}})
    jtr = jax_build_trainer(node(jax_get_cfg, opts, tmp_path / "j"))
    want = (jtr.mesh.shape["data"], jtr.mesh.shape.get("model", 1))
    assert jtr.mesh.devices.size == want[0] * want[1]
    seen = []
    monkeypatch.setattr(mesh, "world_size", lambda: want[0] * want[1])
    monkeypatch.setattr(mesh, "make_layout", lambda n, m: seen.append((n, m)))
    ptr = base_mod.BaseTrainer(node(get_cfg, opts, tmp_path / "p"), device="cpu")
    assert seen == [want]
    assert ptr.cfg.SOLVER.IMS_PER_BATCH == jtr.cfg.SOLVER.IMS_PER_BATCH
    assert ptr.cfg.SOLVER.MAX_ITER == jtr.cfg.SOLVER.MAX_ITER


def test_layout_that_leaves_a_rank_idle_raises(monkeypatch, tmp_path):
    """2 ranks of the adaptation trainer at IMS_PER_BATCH_TARGET 1: the auto
    width is 1 and the second rank would idle, so the layout raises (the JAX
    mesh would take a prefix of the devices); a layout without a group
    raises too."""
    opts = opts_of(SFAT_BENCH_CONFIG, TINY, {"TPU": {"CANVAS": CANVAS}, "SOLVER": {"IMS_PER_BATCH_TARGET": 1}})
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match=r"data 1 x model 1 = 1 ranks does not fill the world of 2"):
        build_trainer(node(get_cfg, opts, tmp_path), device="cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs 2 processes"):
        build_trainer(node(get_cfg, opts + ["TPU.MESH_DATA", "2", "SOLVER.IMS_PER_BATCH_TARGET", "2"], tmp_path),
                      device="cpu")


@pytest.mark.parametrize("model", [2, 3])
def test_tp_placement_as_jax_tp_spec(tmp_path, model):
    """Every leaf of a JAX detector tree (its params, the teacher's copy and
    the momentum by name) against `tp_dim` on the port's name and shape:
    column-parallel fc1 rows, row-parallel fc2 columns, everything else and
    every indivisible dimension whole (FC_DIM 64: model 3 divides nothing)."""
    cfg = node(jax_get_cfg, opts_of(SOURCE_CONFIG, BASE_OPTS), tmp_path)
    jtr_det = jax_build_trainer(cfg).state.variables()
    pcfg = detector_config_from_cfg(node(get_cfg, opts_of(SOURCE_CONFIG, BASE_OPTS), tmp_path))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr_det), pcfg)
    leaves = jax.tree_util.tree_flatten_with_path(jtr_det["params"])[0]
    want = {}
    for path, leaf in leaves:
        names = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        spec = tuple(_tp_spec(names, np.shape(leaf), model))
        if "box_head" in names:
            fc = int(names[names.index("box_head") + 1][2:])
            key = f"roi_heads.box_head.fc{fc + 1}.{'weight' if names[-1] == 'kernel' else 'bias'}"
            # a flax kernel is [in, out], torch's weight [out, in]
            want[key] = None if "model" not in spec else (1 - spec.index("model") if names[-1] == "kernel" else 0)
        else:
            assert spec == (), (names, spec)
    assert len(want) == 4
    for key, t in sd.items():
        for name in (key, f"modelTeacher.{key}", f"modelStudent.{key}"):
            assert mesh.tp_dim(name, tuple(t.shape), model) == want.get(key), name
    if model == 2:
        assert [want[k] for k in sorted(want)] == [0, 0, None, 1]


def test_shard_batch_and_box_keep_slices():
    """Rank (d, m) of a data 2 x model 2 layout: rows [d*b, (d+1)*b) of each
    leaf of a loader batch, which must hold one row an image; a step's draws
    by the layout their class declares (the adaptive teacher's: k rows an
    image, the source batch in two blocks, the target batch, nested strong
    views), and a class that declares no layout for a field raises; fc1's
    keep-mask columns of model index m."""
    from simple_sfod_tpu_torch.data.transforms import StrongDraws
    from simple_sfod_tpu_torch.engine.trainers.adaptive_teacher import ATDraws

    lay = mesh.Layout(2, 2, 3, None, None, torch.device("cpu"))
    assert (lay.data_index, lay.model_index) == (1, 1)
    tree = {"images": np.arange(4 * 3).reshape(4, 3), "ids": (torch.arange(4),), "n": 5}
    got = mesh.shard_batch(lay, tree, 4)
    np.testing.assert_array_equal(got["images"], tree["images"][2:])
    assert torch.equal(got["ids"][0], tree["ids"][0][2:]) and got["n"] == 5
    with pytest.raises(ValueError, match="one row an image"):
        mesh.shard_batch(lay, {"keep": torch.zeros(8, 6)}, 4)  # k rows an image: draws declare theirs
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(lay, {"images": np.zeros((3, 2))}, 3)

    def rows(n, k=1):
        return torch.arange(n * k * 2).reshape(n * k, 2)

    def strong(n):
        return StrongDraws(*(rows(n) for _ in StrongDraws._fields))

    r = 3  # ROIs an image
    draws = ATDraws(flip=rows(4), strong=strong(4), rpn=rows(8), roi=rows(8), flip_t=rows(2), strong_t=strong(2),
                    rpn_t=rows(2), roi_t=rows(2), dropout=(rows(4, r), rows(4, r), rows(2, r), rows(2, r)),
                    box_keep=(rows(8, r), rows(8, r)), box_keep_t=(rows(2, r),))
    got = mesh.shard_draws(lay, draws, {"batch": 4, "target": 2})
    assert torch.equal(got.flip, draws.flip[2:]) and torch.equal(got.rpn_t, draws.rpn_t[1:])
    assert all(torch.equal(a, b[2:]) for a, b in zip(got.strong, draws.strong))
    assert all(torch.equal(a, b[1:]) for a, b in zip(got.strong_t, draws.strong_t))
    for name in ("rpn", "roi"):  # the strong view's block, then the weak view's
        assert torch.equal(getattr(got, name), getattr(draws, name)[[2, 3, 6, 7]])
    assert torch.equal(got.box_keep[0], torch.cat([draws.box_keep[0][6:12], draws.box_keep[0][18:24]]))
    assert [tuple(t.shape) for t in got.dropout] == [(6, 2), (6, 2), (3, 2), (3, 2)]
    assert torch.equal(got.dropout[0], draws.dropout[0][6:]) and torch.equal(got.dropout[3], draws.dropout[3][3:])
    assert torch.equal(got.box_keep_t[0], draws.box_keep_t[0][3:])
    with pytest.raises(ValueError, match="not 2 block"):
        mesh.shard_draws(lay, draws._replace(rpn=rows(6)), {"batch": 4, "target": 2})

    class Undeclared(NamedTuple):
        flip: torch.Tensor
        masks: torch.Tensor
        SHARD = {"flip": "batch"}

    with pytest.raises(TypeError, match=r"declares no layout \(SHARD\) for \['masks'\]"):
        mesh.shard_draws(None, Undeclared(rows(4), rows(8)), {"batch": 4})

    keep = (torch.ones(4, 64, dtype=torch.bool), torch.zeros(4, 64, dtype=torch.bool))
    keep[0][:, 32:] = False
    mine = mesh.slice_box_keep(keep, lay)
    assert mine[0].shape == (4, 32) and not mine[0].any() and mine[1].shape == (4, 64)


def test_tiny_backbone_as_jax():
    """The tiny backbone against the JAX TinyBackbone on the same weights
    (state_dict_from_jax): eval and train mode within 1e-5 of each map's
    largest entry; the running statistics after a train-mode update, the
    means within 1e-5 and the variances within 1e-4 (flax's variance is
    E[x^2] - E[x]^2 in float32, which cancels on these features near 25)."""
    x = np.random.RandomState(0).uniform(-100, 100, (2, 32, 64, 3)).astype(np.float32)
    jm = JaxTiny()
    variables = jm.init(jax.random.key(3), jnp.asarray(x))
    rs = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda v: np.asarray(v) + rs.uniform(0, 0.5, np.shape(v)).astype(np.float32),
                                       variables)
    pt = TinyBackbone()
    sd = {}
    from_jax._tiny(sd, variables["params"], variables["batch_stats"], True)  # state_dict_from_jax's backbone part
    pt.load_state_dict({k[len("backbone."):]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for train in (False, True):
        if train:
            want, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = jm.apply(variables, jnp.asarray(x))
        got = pt(xt, train=train)
        for k in ("tiny0", "tiny1"):
            w = np.asarray(want[k]).transpose(0, 3, 1, 2)
            assert np.abs(got[k].detach().numpy() - w).max() <= 1e-5 * np.abs(w).max(), (train, k)
    for i in range(2):
        for ours, theirs, tol in (("running_mean", "mean", 1e-5), ("running_var", "var", 1e-4)):
            w = np.asarray(new["batch_stats"][f"bn{i}"][theirs])
            assert np.abs(getattr(getattr(pt, f"bn{i}"), ours).numpy() - w).max() <= tol * np.abs(w).max()





# -- steps against the JAX mesh ----------------------------------------------------

def base_case(tmp_path, data, model, spatial=False):
    """The JAX BaseTrainer (tiny backbone) on a data x model mesh for 2 free
    steps (`spatial`: TPU.SPATIAL_SHARD); the port's jobs for the same on
    data x model ranks."""
    opts = opts_of(SOURCE_CONFIG, BASE_OPTS, TINY,
                   {"TPU": {"MESH_DATA": data, "MESH_MODEL": model, "SPATIAL_SHARD": spatial}})
    jtr = jax_build_trainer(node(jax_get_cfg, opts, tmp_path / "jax"))
    assert jtr.mesh.devices.size == data * model
    pcfg = detector_config_from_cfg(node(get_cfg, opts, tmp_path / "p"))
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.variables()), pcfg)
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_CAP)
    records = make_synthetic_records(4, (60, 120), 8, 6, seed=3)
    steps, jax_out = [], []
    for step in range(2):
        batch = synthetic_batch(records[2 * step:2 * step + 2], CANVAS, GT_CAP)
        jm = jtr.run_step(batch)
        jax_out.append({k: float(v) for k, v in jm.items()})
        steps.append((batch, jax_step_draws(jtr.base_rng, step, 2, n, pool)))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.variables()), pcfg)
    job = dict(job="steps", opts=opts, output_dir=str(tmp_path / "port"), batches=[s[0] for s in steps],
               draws=[s[1] for s in steps], weights=init)
    return job, jax_out, want, init


def check_base(ranks, name, jax_out, want, init):
    for r in ranks:
        assert r[name][-1]["state"]["hash"] == ranks[0][name][-1]["state"]["hash"]
    for step, (got, jm) in enumerate(zip(ranks[0][name], jax_out)):
        for k in LOSSES:
            assert rel_err(got["metrics"][k], jm[k]) <= (1e-4, 1e-3)[step], (name, step, k, got["metrics"][k], jm[k])
        for k in ("num_fg", "num_sampled"):
            assert got["metrics"][k] == jm[k], (name, step, k)
    final = ranks[0][name][-1]["state"]["model"]
    assert not movement_bad(final, want, init), movement_bad(final, want, init)
    assert sum(np.abs((want[k] - init[k]).numpy()).max() > 1e-3 * np.abs(want[k].numpy()).max() for k in want) > 10


def test_two_ranks_base_step_as_the_jax_two_device_step(tmp_path):
    """Data parallelism: 2 ranks against the JAX BaseTrainer on a 2-device
    mesh; and cross-rank BatchNorm against one process."""
    job, jax_out, want, init = base_case(tmp_path, 2, 1)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.normal(3.0, 2.0, (4, 5, 6, 7)).astype(np.float32))
    bn = dict(job="bn", x=x, weight=torch.from_numpy(rs.uniform(0.5, 1.5, 5).astype(np.float32)),
              bias=torch.from_numpy(rs.normal(0, 1, 5).astype(np.float32)),
              gy=torch.from_numpy(rs.normal(0, 1, (4, 5, 6, 7)).astype(np.float32)))
    ranks = W.spawn(tmp_path / "jobs.pt", [("base", job), ("bn", bn)])
    check_base(ranks, "base", jax_out, want, init)
    one = W.one_process([("bn", bn)])["bn"]
    for k in ("y", "gx"):
        got = torch.cat([r["bn"][k] for r in ranks])
        assert (got - one[k]).abs().max() <= 1e-5 * one[k].abs().max(), k
    for k in ("gw", "gb", "mean", "var"):
        for r in ranks:
            assert (r["bn"][k] - one[k]).abs().max() <= 1e-5 * one[k].abs().max(), k


def test_tensor_parallel_step_as_the_jax_two_d_mesh(tmp_path):
    """Data 1 x model 2: the box head split over 2 ranks against the JAX
    base step on a ('data', 'model') mesh of 1 x 2; and the split head with
    dropout masks against the whole head."""
    job, jax_out, want, init = base_case(tmp_path, 1, 2)
    ranks = W.spawn(tmp_path / "jobs.pt", [("tp", job), ("head", dict(job="tp_head"))])
    check_base(ranks, "tp", jax_out, want, init)
    for r in ranks:
        assert set(r["head"]) == {"y", "x", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
        assert max(r["head"].values()) <= 1e-6, r["head"]


def test_two_ranks_sfat_step_as_the_jax_two_device_step(tmp_path):
    """The main path: VGG16-BN, strong view, adaptive threshold, 2 ranks
    against the JAX SFAT trainer on a 2-device mesh, each step from the JAX
    state (test_torch_sfat_trainer.py explains why) on the JAX draws."""
    sfat_steps_as_jax(tmp_path, {"MESH_DATA": 2}, {"data": 2})


def sfat_steps_as_jax(tmp_path, tpu, mesh_shape):
    """The SFAT main path's 2 steps on 2 ranks laid out by the TPU options
    `tpu` against the JAX SFAT trainer on the mesh they build (of
    `mesh_shape`), each step from the JAX state on the JAX draws."""
    from test_torch_sfat_trainer import LOCKSTEP_OPTS

    opts = opts_of(SFAT_BENCH_CONFIG, LOCKSTEP_OPTS, {"ADAPTIVE_THRESHOLD": {"WARM_UP": 1, "RESERVE": 2},
                                                     "TPU": tpu})
    jtr = jax_build_trainer(node(jax_get_cfg, opts, tmp_path / "jax"))
    assert dict(jtr.mesh.shape) == mesh_shape
    state = jtr.state
    params = dict(state.params)
    params["det"] = boost(state.params["det"], {1: 5.0, 5: 2.5}, 1e-2)
    state = dataclasses.replace(state, params=params, teacher_params=boost(state.teacher_params, {1: 5.0, 5: 2.5}))
    pnode = node(get_cfg, opts_of(SFAT_BENCH_CONFIG, LOCKSTEP_OPTS, {"ADAPTIVE_THRESHOLD": {"WARM_UP": 1,
                                                                                            "RESERVE": 2}}),
                 tmp_path / "one")
    pcfg = detector_config_from_cfg(pnode)
    ptr = build_trainer(pnode, device="cpu", weights=teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state),
                                                                              pcfg))
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, pcfg.detections_per_image)
    states, draws, jax_out, starts, wants = [], [], [], [], []
    for step, batch in enumerate(batches(2)):
        load_jax_state(ptr, state, pcfg)  # the port's checkpoint content of the JAX state
        states.append(copy.deepcopy(ptr.checkpoint_state()))
        starts.append(teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg))
        jtr.state = shard_state(jtr.mesh, state)
        jm = jtr.run_step(batch)
        state = jax.tree_util.tree_map(np.asarray, jtr.state)
        jax_out.append({k: float(v) for k, v in jm.items()})
        wants.append(teacher_student_from_jax(state, pcfg))
        draws.append(jax_adapt_draws(jtr.base_rng, step, BATCH, CANVAS, n, pool, True))
    job = dict(job="steps", opts=opts, output_dir=str(tmp_path / "port"), batches=batches(2), draws=draws,
               states=states)
    ranks = W.spawn(tmp_path / "jobs.pt", [("sfat", job)])
    assert ranks[0]["sfat"][-1]["state"]["hash"] == ranks[1]["sfat"][-1]["state"]["hash"]
    counts = []
    for step in range(2):
        got, jm, start, want = ranks[0]["sfat"][step], jax_out[step], starts[step], wants[step]
        assert set(got["metrics"]) == set(jm)
        for k in ("loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo", "loss_cls_pseudo", "loss_box_reg_pseudo",
                  "loss_bpc_pseudo", "total_loss"):
            assert rel_err(got["metrics"][k], jm[k]) <= 1e-4, (step, k, got["metrics"][k], jm[k])
        for k in ("num_pseudo", "num_fg_pseudo", "num_sampled_pseudo"):
            assert got["metrics"][k] == jm[k], (step, k)
        np.testing.assert_allclose(got["metrics"]["pseudo_mean_conf"], jm["pseudo_mean_conf"], rtol=1e-5)
        counts.append(jm["num_pseudo"])
        th = got["state"]["thresh"]
        np.testing.assert_array_equal(th["reserve"].numpy(), want.thresh["reserve"].numpy())
        np.testing.assert_array_equal(th["classwise_acc"].numpy(), want.thresh["classwise_acc"].numpy())
        model = got["state"]["model"]
        student = {k[len("modelStudent."):]: v for k, v in model.items() if k.startswith("modelStudent.")}
        teacher = {k[len("modelTeacher."):]: v for k, v in model.items() if k.startswith("modelTeacher.")}
        assert not movement_bad(student, want.student, start.student)
        for k, w in want.teacher.items():
            if k.endswith("num_batches_tracked") or k.startswith("pixel_") or bn_fed_bias(k):
                continue
            if k.endswith(("running_mean", "running_var")):
                assert (teacher[k] - w).abs().max() <= 1e-5 * w.abs().max(), (step, k)
            else:
                assert torch.equal(teacher[k], w), (step, k)
    assert counts[1] > counts[0] > 0, counts


# -- the other trainers -------------------------------------------------------------

CLI_SFAT_YAML = "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml"
TRAINERS = {  # case: (YAML, extra opts, steps)
    # the WQ family: every rank augments the whole batch (mosaic and mixup mix its images), then keeps its rows
    "base_wq": ("faster_rcnn_VGG_cityscapes_foggy_source_wq.yaml", {}, 2),
    "base_mosaic": ("faster_rcnn_VGG_cityscapes_foggy_source_mosaic.yaml",
                    {"INPUT": {"MOSAIC": {"RANDOM_AFFINE": True}}}, 2),
    "base_mixup": ("faster_rcnn_VGG_cityscapes_foggy_source_mixup.yaml", {}, 2),
    "base_mosaic_wq_new": ("faster_rcnn_VGG_cityscapes_foggy_source_mosaic_wq_new.yaml", {}, 2),
    # a labelled source batch and an unlabelled target batch a step
    "da": ("faster_rcnn_VGG_cityscapes_da.yaml", {"TRAINER": "da"}, 2),
    "cda": ("faster_rcnn_VGG_cityscapes_da.yaml", {"TRAINER": "cda", "DA_FASTER": {"ENTROPY_CONDITIONING": True}},
            2),
    # burn-in, the boundary's copy, then the EMA; the instance classifier on
    "adaptive_teacher": ("faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml",
                         {"SEMISUPNET": {"BURN_UP_STEP": 1, "INS_DC": True, "DIS_TYPE": "tiny1",
                                         "EMA_KEEP_RATE": 0.99}}, 3),
}
PAIRED = ("da", "cda", "adaptive_teacher")
# the source-free variants beyond the main one (tested against the JAX mesh above): `_single` with both
# domain classifiers weighted over split views, and `_mosaic` (EMA teacher)
TRAINERS.update({
    "sfat_single_weighted": (CLI_SFAT_YAML, {"TRAINER": "source_free_adaptive_teacher_single",
                                             "SEMISUPNET": {"SPLIT_VIEW_BN": True, "DIS_TYPE": "tiny1"},
                                             "DOMAIN_CLASSIFIER": {"IMAGE": True, "INSTANCE": True}}, 2),
    "sfat_mosaic": (CLI_SFAT_YAML, {"TRAINER": "source_free_adaptive_teacher_mosaic",
                                    "SEMISUPNET": {"DIS_TYPE": "tiny1"}}, 2),
})


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_trainers_on_two_ranks_as_one(tmp_path, trainer):
    """The WQ family (each YAML; mosaic with its affine), da, cda
    (entropy-conditioned: its instance weights normalised by the global
    mean) and the source-available adaptive teacher on 2 ranks against one
    process, from the same seeded weights (class-1 logit bias +4, so the
    teacher makes pseudo-labels; regression kernels 0, so its boxes are
    decoded from the biases alone, test_torch_sfat_trainer.py says why) on
    the trainers' own draws (drawn for the global batch), a labelled batch
    of 2 a step (and for the paired trainers an unlabelled target batch of
    2)."""
    job, sd = trainer_job(tmp_path, trainer)
    ranks = W.spawn(tmp_path / "jobs.pt", [("t", job)])
    one = W.one_process([("t", dict(job, output_dir=str(tmp_path / "one")))])["t"]
    check_trainer(trainer, [r["t"] for r in ranks], one, sd)


def trainer_job(tmp_path, trainer, layout=()):
    """The steps job of a TRAINERS case with the TPU options `layout`
    (opts), and its seeded weights (the docstring above)."""
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    yaml, extra, steps = TRAINERS[trainer]
    yaml = os.path.join(ROOT, "configs", yaml)
    opts = opts_of(BASE_OPTS, TINY, {"TPU": {"DTYPE": "float32"}, "SEED": 0, "SOLVER": {"IMS_PER_BATCH_TARGET": 2}},
                   extra)
    cfg = get_cfg()
    cfg.merge_from_file(yaml, allow_new=True)
    cfg.merge_from_list(opts)
    model = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += 4.0
        model.roi_heads.box_predictor.bbox_pred.weight.zero_()
        model.proposal_generator.rpn_head.anchor_deltas.weight.zero_()
    sd = model.state_dict()
    records = make_synthetic_records(4 * steps, (60, 120), 8, 6, seed=5)
    pairs = []
    for i in range(steps):
        src = synthetic_batch(records[4 * i:4 * i + 2], CANVAS, GT_CAP)
        tgt = synthetic_batch(records[4 * i + 2:4 * i + 4], CANVAS, GT_CAP)
        pairs.append((src, {"images": tgt["images"], "sizes": tgt["sizes"]}) if trainer in PAIRED else src)
    job = dict(job="steps", yaml=yaml, opts=opts + list(layout), output_dir=str(tmp_path / "two"), batches=pairs,
               draws=[None] * steps, weights=sd)
    return job, sd


def check_trainer(trainer, ranks, one, sd):
    """Every rank's steps (`ranks`: each the steps job's result) against
    one process's (`one`) by the bounds of the docstring above."""
    assert all(r[-1]["state"]["hash"] == ranks[0][-1]["state"]["hash"] for r in ranks)
    for step, (got, want) in enumerate(zip(ranks[0], one)):
        m, w = got["metrics"], want["metrics"]
        assert set(m) == set(w)
        for k in w:
            if k.startswith("num_"):
                assert m[k] == w[k], (step, k)
            elif k.startswith("loss") or k == "total_loss":
                tol = 1e-4 if step == 0 else 1e-3
                assert abs(m[k] - w[k]) <= tol * max(abs(w[k]), 1e-3), (step, k, m[k], w[k])
    got, want = ranks[0][-1]["state"]["model"], one[-1]["state"]["model"]
    if "modelTeacher.pixel_mean" in want:  # a teacher-student state
        assert one[-1]["metrics"]["num_pseudo"] > 0
        start = {f"{p}.{k}": v for p in ("modelTeacher", "modelStudent") for k, v in sd.items()}
    else:
        start = sd
    assert trainer not in ("da", "cda", "sfat_single_weighted") or one[-1]["metrics"]["loss_DC_ins" if "da" in trainer
                                                                                      else "loss_DC_ins_t"] > 0
    assert not movement_bad(got, want, start), movement_bad(got, want, start)


# -- evaluation, AdaBN, resume -------------------------------------------------------

EVAL_OPTS = opts_of(TINY, {
    "TRAINER": "base",
    "MODEL": {"ROI_HEADS": {"NUM_CLASSES": 4}, "ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": SMALL_RPN},
    "TEST": {"EVAL_PERIOD": 0, "IMS_PER_BATCH": 2, "DETECTIONS_PER_IMAGE": 32},
    "DATASETS": {"TRAIN": ("parallel_train",), "TRAIN_TARGET": ("parallel_target",), "TEST": ("parallel_test",)},
    "INPUT": {"MIN_SIZE_TRAIN": (128,), "MIN_SIZE_TEST": 128},
    "SOLVER": {"IMS_PER_BATCH": 2, "IMS_PER_BATCH_TARGET": 2, "MAX_ITER": 2, "CHECKPOINT_PERIOD": 0,
               "WARMUP_ITERS": 0, "BASE_LR": 0.01},
    "TPU": {"CANVAS": (128, 256), "GT_CAPACITY": 8, "DTYPE": "float32"},
    "VIS_PERIOD": 0,
    "SEED": 0,
})


def test_eval_and_adabn_on_two_ranks_as_one(tmp_path):
    """5 test images at batch 2 (3 batches, the last padded) dealt over 2
    ranks: the same results as one process, written by rank 0 alone; then
    AdaBN over 2 global batches: the same statistics."""
    job = dict(job="eval_adabn", opts=EVAL_OPTS, output_dir=str(tmp_path / "two"), per_rank_dir=True)
    ranks = W.spawn(tmp_path / "jobs.pt", [("e", job)])
    one = W.one_process([("e", dict(job, output_dir=str(tmp_path / "one"), per_rank_dir=False))])["e"]
    assert ranks[0]["e"]["test"] == ranks[1]["e"]["test"] == one["test"]
    assert ranks[0]["e"]["files"] == one["files"] and "adabn.pth" in one["files"]
    assert "inference/coco_instances_results.json" in one["files"] and "eval_results.json" in one["files"]
    assert ranks[1]["e"]["files"] == [] and ranks[1]["e"]["dump"] is None
    assert json.loads(ranks[0]["e"]["dump"]) == json.loads(one["dump"]) and len(json.loads(one["dump"])) > 10
    for k, v in one["bn"].items():
        # a mean to 1e-5 of its channels' spread (it cancels: features near
        # 100 average to means near 0.1), a variance to 1e-5 of the largest
        scale = one["bn"][k.replace("running_mean", "running_var")].sqrt().max() if "mean" in k else v.max()
        for r in ranks:
            assert (r["e"]["bn"][k] - v).abs().max() <= 1e-5 * scale, k
    assert set(one["adabn"]) == set(ranks[0]["e"]["adabn"])


def test_resume_across_widths(tmp_path):
    """Checkpoints have no topology: 2 ranks -> 1 process, 1 -> 2, and data
    1 x model 2 -> 1. Each continued run (1 step past a 2-step checkpoint)
    agrees with the same continuation at the other width by the movement
    rule, and every file loads strictly into one process."""
    tp = EVAL_OPTS + ["TPU.MESH_DATA", "1", "TPU.MESH_MODEL", "2"]
    go_on = ["SOLVER.MAX_ITER", "3"]
    W.one_process([("o", dict(job="train", opts=EVAL_OPTS, output_dir=str(tmp_path / "one")))])
    jobs = [
        ("two", dict(job="train", opts=EVAL_OPTS, output_dir=str(tmp_path / "two"))),
        ("two_on", dict(job="train", opts=EVAL_OPTS + go_on, output_dir=str(tmp_path / "two_on"), resume=True,
                        copy_from=str(tmp_path / "two"))),
        ("one_on", dict(job="train", opts=EVAL_OPTS + go_on, output_dir=str(tmp_path / "one_on2"), resume=True,
                        copy_from=str(tmp_path / "one"))),
        ("tp", dict(job="train", opts=tp, output_dir=str(tmp_path / "tp"))),
        ("tp_on", dict(job="train", opts=tp + go_on, output_dir=str(tmp_path / "tp_on"), resume=True,
                       copy_from=str(tmp_path / "tp"))),
    ]
    ranks = W.spawn(tmp_path / "jobs.pt", jobs)
    for name, _ in jobs:
        assert ranks[0][name]["hash"] == ranks[1][name]["hash"], name
    for src, twin in (("two", "two_on"), ("one", "one_on"), ("tp", "tp_on")):
        # the continuation on one process from the file the other width wrote
        out = tmp_path / f"{src}_1"
        cont = W.one_process([("c", dict(job="train", opts=EVAL_OPTS + go_on, output_dir=str(out), resume=True,
                                         copy_from=str(tmp_path / src)))])["c"]
        start = torch.load(tmp_path / src / "model_final.pth", weights_only=True)
        other = ranks[0][twin]["model"]
        assert cont["iteration"] == 3 == ranks[0][twin]["iteration"]
        assert not movement_bad(cont["model"], other, start["model"]), (src, movement_bad(cont["model"], other,
                                                                                          start["model"]))
        assert cont["optimizer"]["count"] == 3
    # the tensor-parallel file holds the full box head
    data = torch.load(tmp_path / "tp" / "model_final.pth", weights_only=True)
    assert data["model"]["roi_heads.box_head.fc1.weight"].shape[0] == 64
    assert data["optimizer"]["mu"]["roi_heads.box_head.fc2.weight"].shape == (64, 64)
    for k, v in ranks[0]["tp"]["model"].items():
        assert torch.equal(data["model"][k], v), k


def test_preemption_stops_every_rank_together(tmp_path):
    """SIGTERM's flag on one rank alone: both ranks stop at the next
    multiple of LOG_PERIOD iterations, where they agree on it (no step
    in between waits for the device), and rank 0 saves model_preempt; one
    process stops after the step in flight."""
    opts = EVAL_OPTS + ["SOLVER.MAX_ITER", str(base_mod.LOG_PERIOD + 5)]
    job = dict(job="preempt", opts=opts, output_dir=str(tmp_path / "two"))
    ranks = W.spawn(tmp_path / "jobs.pt", [("p", job)])
    name = f"model_preempt_{base_mod.LOG_PERIOD - 1:07d}.pth"
    assert [r["p"]["step"] for r in ranks] == [base_mod.LOG_PERIOD] * 2
    assert name in ranks[0]["p"]["files"] and "model_final.pth" not in ranks[0]["p"]["files"]
    one = W.one_process([("p", dict(job, output_dir=str(tmp_path / "one"), flag_rank=0))])["p"]
    assert one["step"] == 4 and "model_preempt_0000003.pth" in one["files"]


# -- the CLIs --------------------------------------------------------------------------

CLI = ["--config-file", os.path.join(ROOT, "configs", "synthetic_tiny.yaml"), "--synthetic", "--device", "cpu"]
CLI_CUTS = ["SOLVER.MAX_ITER", "2", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "VIS_PERIOD", "0"]


def run_cli(module, *argv, env=None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **(env or {}))
    return subprocess.Popen([sys.executable, "-m", f"simple_sfod_tpu_torch.tools.{module}", *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_cli_on_two_processes(tmp_path):
    """train_net --num-gpus 2 on the CPU (spawned gloo ranks), then
    train_net_mt --eval-only as two processes joined by --num-processes /
    --process-id / --coordinator (the JAX package's spellings): each rank
    prints its [launches] line; rank 0 alone writes metrics, checkpoints and
    results."""
    out = tmp_path / "run"
    p = run_cli("train_net", *CLI, "--num-gpus", "2", "OUTPUT_DIR", str(out), *CLI_CUTS)
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr[-3000:]
    # the ranks share the pipe, so their lines may interleave: count strings
    assert stdout.count("[launches] ") == 2 and stdout.count("[state] rank ") == 2
    assert all(stdout.count(f"[launch] rank {r} of 2: backend gloo, device cpu") == 1 for r in (0, 1))
    assert stdout.count("iter 1/2") == 1  # the console writer of rank 0
    hashes = {ln.split("sha256 ")[1][:64] for ln in stdout.split("[state] rank ")[1:]}
    assert len(hashes) == 1, hashes
    with open(out / "metrics.json") as f:
        assert [json.loads(line)["iteration"] for line in f] == [1]
    assert torch.load(out / "model_final.pth", weights_only=True)["iteration"] == 2

    port = free_port()
    procs = [run_cli("train_net_mt", *CLI, "--eval-only", "--adabn-batches", "2", "--num-processes", "2",
                     "--process-id", str(r), "--coordinator", f"127.0.0.1:{port}", "MODEL.WEIGHTS",
                     str(out / "model_final.pth"), "OUTPUT_DIR", str(tmp_path / "eval"), *CLI_CUTS) for r in (0, 1)]
    outs = [q.communicate(timeout=600) for q in procs]
    for q, (so, se) in zip(procs, outs):
        assert q.returncode == 0, se[-3000:]
        assert so.splitlines()[-1].startswith("[launches] ")
        assert "[adabn] BatchNorm statistics refined over 2 batches" in so
    assert sorted(os.listdir(tmp_path / "eval")) == ["adabn.pth", "eval_results.json", "inference", "last_checkpoint"]


@pytest.mark.parametrize("case", ["spatial_shard", "idle_rank", "gpus_beyond_devices", "machines_without_url"])
def test_cli_refusals(tmp_path, monkeypatch, case):
    """TPU.SPATIAL_SHARD without TPU.MESH_MODEL > 1 raises ValueError in the
    JAX package's words; a world the layout does not fill raises in the
    ranks; --num-gpus beyond the visible GPUs and --num-machines without
    --dist-url raise before any process starts (all three before any
    process starts but the idle rank's)."""
    opts = ["OUTPUT_DIR", str(tmp_path), *CLI_CUTS]

    def parse(*flags, extra=()):
        return train_net.default_argument_parser().parse_args(CLI + list(flags) + opts + list(extra))

    if case == "spatial_shard":
        with pytest.raises(ValueError, match=r"TPU.SPATIAL_SHARD=True requires TPU.MESH_MODEL > 1"):
            train_net.main(parse("--num-gpus", "2", extra=["TPU.SPATIAL_SHARD", "True"]))
    elif case == "idle_rank":
        p = run_cli("train_net", *CLI, "--num-gpus", "2", *opts, "SOLVER.IMS_PER_BATCH", "1")
        _, stderr = p.communicate(timeout=600)
        assert p.returncode != 0 and "does not fill the world of 2 processes" in stderr, stderr[-3000:]
    elif case == "gpus_beyond_devices":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        a = parse("--num-gpus", "2")
        a.device = "cuda"
        with pytest.raises(ValueError, match="--num-gpus 2 exceeds the 1 visible CUDA device"):
            train_net.main(a)
    else:
        with pytest.raises(ValueError, match="--num-machines 2 needs --dist-url"):
            train_net.main(parse("--num-machines", "2"))


def test_dryrun_multigpu_two_ranks(capfd):
    from simple_sfod_tpu_torch.parallel.dryrun import dryrun_multigpu

    dryrun_multigpu(2, device="cpu")
    assert "dryrun_multigpu(2): total_loss=" in capfd.readouterr().out
