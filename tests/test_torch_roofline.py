"""The roofline slice on the CPU: the benchmark's configuration, the cost
counter, the multi-step trainer calls and the two tools.

  - `utils/bench.py:sfat_bench_cfg` equals the JAX package's key for key;
  - `utils/cost.py` counts one conv (stride 1 and 2), one linear and one
    bmm, forward and backward, as the hand formulas say;
  - its `flops` for `Detector.infer` and for one SFAT step equal 2 x the
    multiply-adds of the `conv_general_dilated` and `dot_general` equations
    of the JAX functions' jaxprs (`Detector.infer`, the trainer's
    `_step_fn_raw`) within 0.5%, on VGG16-BN at 64x128, FC_DIM 64 and 128
    sampled ROIs an image, from the
    same seeded weights (checkpoint/from_jax.py). One rule counts a
    convolution on both sides: its multiply-adds are the forward's, so a
    JAX convolution over an lhs-dilated input (the input gradient of a
    strided convolution) is divided by its dilation, as the port counts
    `convolution_backward` (VGG16 has no strided convolution: the rule
    does not bite here). The JAX step also counts a few products the port
    makes elementwise (the strong view's colour operations), 2e-5 of the
    total. At 32x64 (a 2x4 map) the JAX step's transposed ROIAlign einsum
    also contracts a batch axis of size 1, 2.6e7 multiply-adds of outer
    products that the port does not make (0.5% there); at 64x128 the two
    programs run the same products. XLA's
    CPU `cost_analysis()` flops (of the lowered program) are printed
    beside, not held;
  - `run_steps(batch, 3)` and `run_step_chunk` leave a state and last
    metrics bit-equal to 3 `run_step` calls, for SFAT, AT, Base and DA
    (32x64, 64 sampled anchors and ROIs an image: the plumbing, cheaply);
  - `tools/roofline.py --device cpu` prints its keys on a tiny config and
    refuses --measure; `tools/profile_step.py --parse-only` sums a CPU trace
    that `device_trace` wrote.

Every test runs on 2 torch threads (test_torch_train_loop.py:free_disk).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.models import detector as jax_detector
from simple_sfod_tpu.utils.bench import sfat_bench_cfg as jax_sfat_bench_cfg
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import SFAT_BENCH_CONFIG, config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.tools import profile_step, roofline
from simple_sfod_tpu_torch.utils import cost as C
from simple_sfod_tpu_torch.utils.bench import sfat_bench_cfg
from simple_sfod_tpu_torch.utils.profiling import device_trace
from test_torch_fpn import seeded_variables
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 4
PARITY_CANVAS, PARITY_HW = (64, 128), (60, 120)
PARITY_OPTS = config_opts(SFAT_BENCH_CONFIG) + [
    "TPU.CANVAS", str(PARITY_CANVAS), "TPU.DTYPE", "float32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128"]
FLOP_REL = 5e-3


def plain(node):
    return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}


@pytest.mark.parametrize("batch,trainer", [(1, "source_free_adaptive_teacher"), (4, "source_free_adaptive_teacher"),
                                           (1, "adaptive_teacher")])
def test_sfat_bench_cfg_equals_jax_key_for_key(batch, trainer):
    ours = sfat_bench_cfg(batch, trainer, output_dir="./output/x")
    assert plain(ours) == plain(jax_sfat_bench_cfg(batch, trainer, output_dir="./output/x"))
    assert ours.SOLVER.IMS_PER_BATCH_TARGET == batch and ours.TRAINER == trainer
    with pytest.raises(AttributeError, match="frozen"):
        ours.SEED = 1


# ---------------------------------------------------------------- hand formulas
def conv_case(stride):
    x, w, b = torch.randn(2, 3, 16, 20), torch.randn(8, 3, 3, 3), torch.randn(8)
    y = torch.nn.functional.conv2d(x, w, b, stride=stride, padding=1)
    macs = y.numel() * 3 * 9
    fwd_bytes = F32 * (x.numel() + w.numel() + b.numel() + y.numel())
    # convolution_backward reads dy, x, w and writes dx, dw, db
    bwd_bytes = F32 * (y.numel() + 2 * (x.numel() + w.numel()) + b.numel())
    return (lambda x, w, b: torch.nn.functional.conv2d(x, w, b, stride=stride, padding=1)), (x, w, b), macs, \
        fwd_bytes, bwd_bytes, 0


def linear_case():
    m, k, n = 6, 5, 4
    x, w, b = torch.randn(m, k), torch.randn(n, k), torch.randn(n)
    # addmm(b, x, w^T) forward; mm(dy, w), mm(dy^T, x) and db = sum(dy) backward
    fwd_bytes = F32 * (n + m * k + k * n + m * n)
    bwd_bytes = F32 * ((m * n + n * k + m * k) * 2 + m * n + n)
    return torch.nn.functional.linear, (x, w, b), m * k * n, fwd_bytes, bwd_bytes, n


def bmm_case():
    bt, m, k, n = 3, 6, 5, 7
    a, c = torch.randn(bt, m, k), torch.randn(bt, k, n)
    one = bt * (m * k + k * n + m * n)
    return torch.bmm, (a, c), bt * m * k * n, F32 * one, F32 * 2 * one, 0


UNIT = {"conv_stride1": lambda: conv_case(1), "conv_stride2": lambda: conv_case(2), "linear": linear_case,
        "bmm": bmm_case}


@pytest.mark.parametrize("name", list(UNIT))
def test_counter_equals_hand_formulas(name):
    torch.manual_seed(0)
    fn, args, macs, fwd_bytes, bwd_bytes, bwd_elementwise = UNIT[name]()
    with torch.no_grad():
        _, fwd = C.count(fn, *args)
    assert (fwd.flops, fwd.bytes_eager, fwd.elementwise_ops, fwd.ops) == (2 * macs, fwd_bytes, 0, 1)
    args = [a.clone().requires_grad_() for a in args]
    y = fn(*args)
    g = torch.randn_like(y)
    grads, bwd = C.count(torch.autograd.grad, y, args, g)
    assert (bwd.flops, bwd.bytes_eager, bwd.elementwise_ops) == (4 * macs, bwd_bytes, bwd_elementwise)
    kind = "conv" if name.startswith("conv") else "matmul"
    assert bwd.flops_by_dtype == {"float32": 4 * macs}
    assert bwd.compute_floor_s == pytest.approx(4 * macs / C._flop_rate(torch.float32, kind))
    # the counted call's results are the plain call's
    for got, want in zip(grads, torch.autograd.grad(fn(*args), args, g)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bytes_min_and_floor():
    """bytes_min: state and arguments read once, results written once, the
    saved storages twice, trained parameters three times, optimizer state
    twice; the floor is the larger term plus the NMS bound."""
    w = torch.randn(16, 8, requires_grad=True)
    x, mu = torch.randn(4, 8), torch.zeros(16, 8)

    def step(x):
        h = torch.relu(x @ w.t())  # saves x (an argument: read anyway) and relu's output
        h.sum().backward()
        return h

    h, c = C.count(step, x, state=[w], trained=[w], optimizer_state=[mu])
    relu_out = h.numel() * F32
    assert c.bytes_min == F32 * (w.numel() + x.numel()) + relu_out + 2 * relu_out + 3 * w.numel() * F32 + \
        2 * mu.numel() * F32
    compute = c.flops / C._flop_rate(torch.float32, "matmul")
    assert c.bound_by == ("operations" if compute >= c.bytes_min / C.PEAK_BYTES_S else "bytes")
    assert c.floor_s == pytest.approx(max(compute, c.bytes_min / C.PEAK_BYTES_S))
    n, kept = 130, np.asarray([0, 3, 70, 129])
    _, ops, s1, _ = C.relation_bound(n, 100)
    assert ops == C.OPS_PER_PAIR * 100 * 99 // 2 and s1 == max((n * 17 + n * 3 * 8) / C.PEAK_BYTES_S,
                                                                ops / C.PEAK_F32_S)
    assert C.keep_bound(n, kept)[0] == 8 * (n + 2 + 2 + 1 + 0) + 2 * n


# ---------------------------------------------------------------- parity with the JAX package
def jaxpr_flops(closed) -> int:
    """2 x the multiply-adds of every conv_general_dilated and dot_general
    of a jaxpr and the jaxprs inside it (scan bodies times their length;
    none inside a while loop, where the trip count is unknown)."""
    total = 0

    def walk(jaxpr, mult, in_while):
        nonlocal total
        for e in jaxpr.eqns:
            p = e.primitive.name
            if p == "conv_general_dilated":
                assert not in_while
                rhs, spec = e.invars[1].aval.shape, e.params["dimension_numbers"].rhs_spec
                macs = int(np.prod(e.outvars[0].aval.shape)) * rhs[spec[1]] * int(np.prod([rhs[i] for i in spec[2:]]))
                total += 2 * mult * macs // int(np.prod(e.params["lhs_dilation"]))
            elif p == "dot_general":
                assert not in_while
                (lc, _), _ = e.params["dimension_numbers"]
                lhs = e.invars[0].aval.shape
                total += 2 * mult * int(np.prod(e.outvars[0].aval.shape)) * int(np.prod([lhs[i] for i in lc]))
            for v in e.params.values():
                for sub in v if isinstance(v, (tuple, list)) else [v]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner, mult * (e.params["length"] if p == "scan" else 1), in_while or p == "while")

    walk(closed.jaxpr, 1, False)
    return total


@pytest.fixture(scope="module")
def parity():
    """The JAX config and seeded variables at the JAX init's shapes, the
    port's config, and a batch of 2 uint8 images."""
    jc, pc = jax_get_cfg(), get_cfg()
    jc.merge_from_list(PARITY_OPTS)
    pc.merge_from_list(PARITY_OPTS)
    variables = seeded_variables(jc, seed=3)  # VGG16-BN's shapes do not depend on the canvas
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (2, *PARITY_CANVAS, 3)).astype(np.uint8)
    sizes = np.asarray([PARITY_CANVAS, PARITY_HW], np.int32)
    return dict(jc=jc, pc=pc, variables=variables, images=images, sizes=sizes)


def held(port, theirs, xla, what):
    print(f"{what}: port {port}, JAX jaxpr {theirs} (rel {port / theirs - 1:+.2e}), XLA cost_analysis {xla}")
    assert abs(port - theirs) <= FLOP_REL * theirs


def test_infer_flops_equal_jax_jaxpr(parity):
    from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower

    jdet = jax_detector.Detector(jax_lower(parity["jc"]))
    traced = jax.jit(lambda v, x, s: jdet.infer(v, x, s)).trace(
        parity["variables"], jnp.asarray(parity["images"]), jnp.asarray(parity["sizes"]))
    pcfg = detector_config_from_cfg(parity["pc"])
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(parity["variables"], pcfg))
    dets, c = C.count(det.infer, parity["images"], parity["sizes"], state=C.module_tensors(det.model))
    held(c.flops, jaxpr_flops(traced.jaxpr), traced.lower().cost_analysis().get("flops"), "infer")
    # one launch an image of each for the RPN's NMS and the class-wise one
    assert c.nms_launches == {"suppress_relation_bits": 4, "greedy_keep_from_bits": 4}
    assert c.elementwise_ops > 0 and c.bytes_eager > c.bytes_min > 0 and int(dets.valid.sum()) > 0


def test_sfat_step_flops_equal_jax_jaxpr(parity, monkeypatch, tmp_path):
    variables = parity["variables"]
    # the trainer's own init runs every layer eagerly (tens of seconds): it
    # takes the seeded variables, which have its shapes
    monkeypatch.setattr(jax_detector.Detector, "init", lambda self, rng, canvas_hw, batch=1: variables)
    jc = parity["jc"].clone()
    jc.OUTPUT_DIR = str(tmp_path)
    jtr = jax_build_trainer(jc)
    images, sizes = parity["images"][:1], parity["sizes"][1:]
    traced = jax.jit(jtr._step_fn_raw).trace(jtr.state, jnp.asarray(images), jnp.asarray(sizes), jtr.base_rng)
    pc = parity["pc"].clone()
    pc.OUTPUT_DIR = str(tmp_path)
    tr = build_trainer(pc, device="cpu", state_dict=state_dict_from_jax(variables, detector_config_from_cfg(pc)))
    state, trained, opt_state = C.trainer_tensors(tr)
    metrics, c = C.count(tr.step_staged, tr.stage({"images": images, "sizes": sizes}), state=state, trained=trained,
                         optimizer_state=opt_state)
    held(c.flops, jaxpr_flops(traced.jaxpr), traced.lower().cost_analysis().get("flops"), "SFAT step")
    assert c.nms_launches == {"suppress_relation_bits": 3, "greedy_keep_from_bits": 3}  # teacher RPN, class-wise, student RPN
    assert np.isfinite(float(metrics["total_loss"])) and tr.state.step == 1
    assert c.bytes_min > sum(C.tensor_bytes(t) for t in state) + 3 * sum(C.tensor_bytes(t) for t in trained)


# ---------------------------------------------------------------- the multi-step calls
CHUNK_CANVAS, CHUNK_HW = (32, 64), (30, 60)
CHUNK_OPTS = ["TPU.CANVAS", str(CHUNK_CANVAS), "TPU.DTYPE", "float32", "TPU.GT_CAPACITY", "4", "TPU.MESH_DATA", "1",
              "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
              "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.01", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
              "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64"]
VGG = ["MODEL.BACKBONE.NAME", "build_vgg_backbone", "MODEL.RPN.IN_FEATURES", "('vgg4',)",
       "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)", "MODEL.ROI_HEADS.NUM_CLASSES", "8", "VGG.BN", "True"]
TRAINERS = {  # name: (YAML or None, opts, steps on a paired target batch, has run_steps)
    "source_free_adaptive_teacher": (None, config_opts(SFAT_BENCH_CONFIG), False, True),
    "adaptive_teacher": ("faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml",
                         ["SEMISUPNET.BURN_UP_STEP", "1", "SEMISUPNET.EMA_KEEP_RATE", "0.99"], True, True),
    "base": (None, VGG + ["TRAINER", "base"], False, False),
    "da": ("faster_rcnn_VGG_cityscapes_da.yaml", ["TRAINER", "da"], True, False),
}


def chunk_trainer(name, tmp_path):
    yaml, opts, _, _ = TRAINERS[name]
    cfg = get_cfg()
    if yaml:
        cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    cfg.merge_from_list(opts + CHUNK_OPTS)
    cfg.OUTPUT_DIR = str(tmp_path)
    return build_trainer(cfg, device="cpu")


def assert_same(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(TRAINERS))
def test_multi_step_calls_equal_single_steps(name, tmp_path):
    _, _, paired, has_run_steps = TRAINERS[name]
    recs = make_synthetic_records(2, CHUNK_HW, 8, 3, seed=5)
    batch = synthetic_batch(recs[:1], CHUNK_CANVAS, 4)
    target = synthetic_batch(recs[1:], CHUNK_CANVAS, 4)
    if not paired:  # the source-free trainers step on the target batch alone
        batch = batch if name == "base" else {k: batch[k] for k in ("images", "sizes")}
    ref = chunk_trainer(name, tmp_path / "ref")
    for _ in range(3):
        want = ref.run_step(batch, target=target) if paired else ref.run_step(batch)
    runs = {"run_step_chunk": lambda tr: tr.run_step_chunk([batch] * 3)}
    if has_run_steps:
        runs["run_steps"] = lambda tr: tr.run_steps(batch, 3)
    for label, run in runs.items():
        tr = chunk_trainer(name, tmp_path / label)
        if paired:  # the target loader's next batches
            tr.target_loader = iter([copy.deepcopy(target) for _ in range(3)])
        got = run(tr)
        assert tr.state.step == ref.state.step == 3, label
        assert_same(got, want, f"{label} metrics")
        # weights, statistics, momentum, the teacher, classifiers, threshold state and generators
        assert_same(tr.checkpoint_state(), ref.checkpoint_state(), label)
    assert np.isfinite(float(want["total_loss"]))


# ---------------------------------------------------------------- the tools on the CPU
TINY = ["TPU.CANVAS", "(64, 128)", "TPU.DTYPE", "float32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64"]
LINE_KEYS = {"flops", "elementwise_ops", "bytes_min", "bytes_eager", "nms_ops", "nms_bytes", "nms_launches",
             "peak_flops", "peak_bytes_per_s", "machine_balance", "bound_by", "bandwidth_floor_ms",
             "compute_floor_ms", "floor_ms", "arith_intensity_flop_per_byte", "device", "gpu_name", "power_limit",
             "workload", "canvas", "batch"}


def test_roofline_tool_on_the_cpu(tmp_path, capsys):
    out = ["--device", "cpu", "--output-dir", str(tmp_path)]
    (head,) = roofline.main(["--headline", *out, *TINY])
    stages = roofline.main(["--eval", "--stages", "--batches", "1", *out, *TINY])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == [head, *stages]
    for ln in printed:
        assert LINE_KEYS <= set(ln), LINE_KEYS - set(ln)
        assert ln["device"] == "cpu" and ln["gpu_name"] is None and ln["power_limit"] is None
        assert not {k for k in ln if k.startswith(("measured", "pct", "windows", "v5e"))}
        assert ln["flops"] > 0 and ln["bytes_eager"] > ln["bytes_min"] > 0 and ln["bound_by"] in ("operations", "bytes")
    assert head["workload"] == "sfat_headline" and head["flops_per_step"] == head["flops"]
    assert head["nms_launches"] == {"suppress_relation_bits": 3, "greedy_keep_from_bits": 3}
    assert [ln["stage"] for ln in stages] == ["features", "raw", "full"]
    assert stages[0]["flops"] < stages[1]["flops"] == stages[2]["flops"]
    assert stages[1]["nms_launches"]["suppress_relation_bits"] == 1 and stages[2]["nms_launches"][
        "suppress_relation_bits"] == 2
    with pytest.raises(ValueError, match="CUDA"):
        roofline.main(["--measure", *out, *TINY])
    with pytest.raises(ValueError, match="--artifact"):
        roofline.main(["--serving", *out])


def test_profile_step_parse_only_sums_a_cpu_trace(tmp_path, capsys):
    x = torch.randn(32, 32)
    with device_trace(str(tmp_path)):
        for _ in range(3):
            torch.relu(x @ x).sum()
    summary = profile_step.main(["--parse-only", "--out", str(tmp_path), "--top", "1000"])
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert summary["host"]["events"] == len(events) > 0
    assert summary["host"]["total_ms"] == pytest.approx(sum(float(e["dur"]) for e in events) / 1e3, rel=1e-12)
    assert sum(ms for _, ms, _ in summary["host"]["top"]) == pytest.approx(summary["host"]["total_ms"], rel=1e-12)
    assert {name for name, _, _ in summary["host"]["top"]} >= {"aten::mm", "aten::relu", "aten::sum"}
    assert summary["device"]["events"] == 0 and summary["device"]["busy_share"] is None
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == summary
