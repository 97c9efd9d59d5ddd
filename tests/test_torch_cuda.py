"""The port's Hopper kernels on the card: each against its plain PyTorch
version, bit for bit, and the detector's card path against its CPU path.

These tests need an NVIDIA GPU with nvcc (marker `cuda`) and skip without
one. They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import chip_smoke
from simple_sfod_tpu_torch.ops import _kernels, nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def case(seed, n, n_valid, classes=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 1000, (n, 2))
    wh = rng.uniform(0, 200, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[::9, 3] = boxes[::9, 1]  # zero height
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    out = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    if classes:
        cls = torch.from_numpy(rng.randint(0, classes, n).astype(np.int32))
        max_coord = torch.where(out[2][:, None], out[0], torch.zeros(())).max() + 1.0
        out[0] = out[0] + (cls.to(torch.float32) * max_coord)[:, None]
    return out


@pytest.mark.parametrize(
    "n,n_valid,thr,classes",
    [(4096, 4000, 0.7, 0), (1024, 1000, 0.5, 8), (1000, 1000, 0.5, 0), (65, 60, 0.5, 0), (1, 1, 0.5, 0), (200, 0, 0.7, 0),
     (8192, 8000, 0.7, 0), (4097, 4000, 0.7, 0), (_kernels.GREEDY_MAX_N, 8800, 0.7, 0),
     (12288, 12000, 0.7, 0), (16384, 16000, 0.7, 0)],
)
def test_kernels_bit_equal_to_plain(cuda, n, n_valid, thr, classes):
    """Both kernels through the call that picks the keep route by N (the
    row walk above GREEDY_MAX_N), against the plain versions."""
    boxes, scores, valid = case(n, n, n_valid, classes)
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    rel = nms.suppress_relation_plain(sb, sv, thr)
    _kernels.reset_launches()
    bits = _kernels.launch_suppress_relation_bits(sb.to(cuda), sv.to(cuda), thr)
    keep = nms.greedy_keep_from_bits(bits, sv.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), nms.pack_bits(rel))
    assert torch.equal(keep.cpu(), nms.greedy_keep_plain(rel, sv))
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 1, "greedy_keep_from_bits": 1}
    got = nms.nms_mask_matrix(boxes.to(cuda), scores.to(cuda), valid.to(cuda), thr)
    assert torch.equal(got.cpu(), nms.nms_mask_matrix(boxes, scores, valid, thr))


@pytest.mark.parametrize("label", list(chip_smoke.EDGE_CASES))
def test_kernels_on_edge_cases(cuda, label):
    """Cases built to break the kernels: IoUs at the threshold's rounding
    boundaries, a suppression chain (also above GREEDY_MAX_N, on the keep's
    row-walk route), identical and disjoint boxes."""
    build, thr = chip_smoke.EDGE_CASES[label]
    boxes, scores, valid, want = (torch.from_numpy(a) for a in build())
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    rel = nms.suppress_relation_plain(sb.to(cuda), sv.to(cuda), thr)
    bits = _kernels.launch_suppress_relation_bits(sb.to(cuda), sv.to(cuda), thr)
    keep = nms.greedy_keep_from_bits(bits, sv.to(cuda))
    assert torch.equal(bits, nms.pack_bits(rel))
    assert torch.equal(keep, nms.greedy_keep_plain(rel, sv.to(cuda)))
    got = nms.nms_mask_matrix(boxes.to(cuda), scores.to(cuda), valid.to(cuda), thr)
    assert torch.equal(got.cpu(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    n = _kernels.GREEDY_MAX_N + 1
    words = (n + 63) // 64
    sv = torch.ones(n, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="N <="):
        _kernels.launch_greedy_keep_from_bits(torch.zeros((n, words), dtype=torch.int64, device=cuda), sv)
    sb = torch.zeros((8, 4), device=cuda)
    for thr in (float("nan"), float("inf"), float(np.finfo(np.float32).max)):
        with pytest.raises(ValueError, match="iou_threshold"):
            _kernels.launch_suppress_relation_bits(sb, sv[:8], thr)


def test_detector_card_matches_cpu(cuda):
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_main_cfg
    from simple_sfod_tpu_torch.models.detector import Detector
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    cfg = get_main_cfg()
    cfg.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", "(128, 256)"])
    dcfg = detector_config_from_cfg(cfg)
    sd = init_weights(FasterRCNN(dcfg), 0).state_dict()
    img = np.random.RandomState(0).randint(0, 256, (1, 128, 256, 3)).astype(np.uint8)
    sizes = np.asarray([[128, 256]], np.int32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = Detector(dcfg, device=cuda).load_state_dict(sd).infer(img, sizes)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = Detector(dcfg, device="cpu").load_state_dict(sd).infer(img, sizes)
    gv = got.valid.cpu()
    assert torch.equal(gv, want.valid) and gv.any()
    assert torch.equal(got.classes.cpu()[gv], want.classes[gv])
    torch.testing.assert_close(got.boxes.cpu()[gv], want.boxes[gv], rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(got.scores.cpu()[gv], want.scores[gv], rtol=0, atol=1e-4)


def test_train_step_card_matches_cpu(cuda):
    """One float32 training step (TF32 off) on the card against the same
    step on the CPU: same weights, batch and draws; chip_smoke's
    tolerances."""
    err = chip_smoke.card_vs_cpu_step(canvas=(128, 256), image_hw=(120, 250))
    assert chip_smoke.card_step_ok(err), err


def test_train_steps_launch_the_kernels_on_train_mode_nms_inputs(cuda):
    """Train-mode RPN NMS runs on both kernels, once per image and step, and
    they agree bit for bit with the plain versions on its inputs."""
    from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer

    cfg = chip_smoke.train_cfg("bfloat16", canvas=(256, 512))
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "2"])
    trainer = BaseTrainer(cfg)
    recs = chip_smoke.make_synthetic_records(2, (250, 500), 8, 6, seed=1)
    batch = chip_smoke.synthetic_batch(recs, (256, 512), cfg.TPU.GT_CAPACITY)
    captured = []  # one entry an image: the detector calls NMS on the batch
    orig, record = chip_smoke.capture_nms(captured)
    _kernels.reset_launches()
    nms.nms_mask_matrix = record
    try:
        metrics = trainer.run_step(batch)
    finally:
        nms.nms_mask_matrix = orig
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 2, "greedy_keep_from_bits": 2}
    assert all(torch.isfinite(metrics[k]) for k in chip_smoke.TRAIN_LOSSES)
    assert len(captured) == 2
    for b, s, v, thr in captured:
        assert b.is_cuda and thr == 0.7
        assert torch.equal(nms.nms_mask_matrix(b, s, v, thr), chip_smoke.plain_keep(b, s, v, thr))


def test_adaptation_step_launches_three_of_each_kernel_per_image(cuda):
    """The main variant's adaptation step (strong view, adaptive threshold,
    bfloat16 with a bfloat16 fixed teacher) at batch 2 and 256x512: finite
    losses, pseudo-labels, and 3 launches of each NMS kernel per image (the
    teacher's RPN and detection NMS, the student's RPN NMS)."""
    cfg = chip_smoke.adapt_cfg(chip_smoke.SFAT_BENCH_CONFIG, canvas=(256, 512))
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH_TARGET", "2"])
    trainer = chip_smoke.adapt_trainer(cfg)
    batch = chip_smoke.synthetic_bench_batch(cfg)
    batch["sizes"][:] = (250, 500)
    for _ in range(2):
        _kernels.reset_launches()
        metrics = trainer.run_step(batch)
        assert _kernels.LAUNCHES == {"suppress_relation_bits": 6, "greedy_keep_from_bits": 6}
        assert all(torch.isfinite(metrics[k]) for k in chip_smoke.ADAPT_LOSSES)
    assert int(metrics["num_pseudo"]) > 0


def test_adaptation_step_card_matches_cpu(cuda):
    """One float32 adaptation step (TF32 off) on the card against the same
    step on the CPU: chip_smoke's tolerances."""
    err = chip_smoke.card_vs_cpu_adapt_step(canvas=(128, 256), image_hw=(120, 250))
    assert chip_smoke.card_step_ok(err), err


def test_eval_loop_card_matches_cpu(cuda, tmp_path):
    """The float32 eval loop (TF32 off) on 4 PNG images at 128x256 on the
    card against the CPU's: every detection paired, boxes 1e-2 px, scores
    1e-4, AP/AP50/F1 1e-6 (chip_smoke's eval phase)."""
    res_card, res_cpu, (unpaired, box_err, score_err), n = chip_smoke.card_vs_cpu_eval(str(tmp_path))
    assert n > 0 and unpaired == 0 and box_err <= 1e-2 and score_err <= 1e-4, (unpaired, box_err, score_err)
    for k in ("AP", "AP50", "F1"):
        assert abs(res_card[k] - res_cpu[k]) <= 1e-6, k


def test_native_decode_and_resize_of_written_frames(cuda, tmp_path):
    """On the card's host: PNG frames written with every filter type decode
    to the arrays written, and the native resize of a 1024x2048 frame to
    600x1200 is within one uint8 step of torch's antialiased bilinear (an
    independent implementation of PIL's filter, rounded differently)."""
    from simple_sfod_tpu_torch.data import native_codec

    path, recs, first = chip_smoke.write_eval_dataset(str(tmp_path), 2, chip_smoke.FRAME_HW)
    np.testing.assert_array_equal(native_codec.decode(str(tmp_path / "frame_0001.png")), first)
    out = native_codec.resize_bilinear(first, 600, 1200)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(first).permute(2, 0, 1)[None].float(), size=(600, 1200), mode="bilinear",
        antialias=True, align_corners=False,
    )[0].permute(1, 2, 0).round().clamp(0, 255).numpy()
    assert out.shape == (600, 1200, 3)
    assert np.abs(out.astype(np.float32) - ref).max() <= 1.0
    # the committed JPEG fixtures decode to libjpeg's digests on this host
    for name, rec in chip_smoke.jpeg_fixtures().items():
        path = os.path.join(chip_smoke.JPEG_FIXTURES, name)
        if rec["sha256"] is None:
            with pytest.raises(ValueError, match="progressive"):
                native_codec.decode(path)
        else:
            assert hashlib.sha256(native_codec.decode(path).tobytes()).hexdigest() == rec["sha256"], name


def test_train_loop_saves_reloads_and_resumes(cuda, tmp_path):
    """The adaptation loop on the card (main variant on the main YAML's
    keys, bfloat16 with its bfloat16 fixed teacher, 256x512, a repeated
    batch): 2 steps end in model_final.pth; a new trainer resumes it, every
    restored tensor equals the file's bit for bit, and it runs on to 4."""
    cfg = chip_smoke.adapt_cfg(chip_smoke.MAIN_CONFIG, canvas=(256, 512))
    cfg.merge_from_list(["SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0",
                         "VIS_PERIOD", "0"])
    cfg.OUTPUT_DIR = str(tmp_path)
    batch = chip_smoke.synthetic_bench_batch(cfg)
    batch["sizes"][:] = (250, 500)
    tr = chip_smoke.adapt_trainer(cfg)
    tr.train_loader = chip_smoke.RepeatBatch(batch)
    tr.train()
    saved = chip_smoke.host_state(torch.load(tmp_path / "model_final.pth", weights_only=True))
    cfg.SOLVER.MAX_ITER = 4
    tr2 = chip_smoke.build_trainer(cfg)
    tr2.resume_or_load(resume=True)
    restored = chip_smoke.host_state(tr2.checkpoint_state())
    assert saved.keys() == restored.keys()
    for k, v in saved.items():
        assert torch.equal(restored[k], v) if isinstance(v, torch.Tensor) else restored[k] == v, k
    assert next(tr2.state.teacher.parameters()).dtype == torch.bfloat16
    tr2.train_loader = chip_smoke.RepeatBatch(batch)
    tr2.train()
    assert tr2.state.step == 4 and tr2.checkpointer.last_checkpoint() == "model_final.pth"


def test_resnet101_card_matches_cpu(cuda):
    """ResNet-101 C4 features and detections on the card against the CPU
    (chip_smoke.r101_card_vs_cpu: BN in eval and train mode, FrozenBN)."""
    chip_smoke.r101_card_vs_cpu("")


def test_resnet101_sfat_step_keeps_frozen_stages(cuda):
    """Two full-width bfloat16 adaptation steps of the R101 YAML: three
    launches of each kernel a step, stem and res2 bit-identical."""
    cfg = chip_smoke.r101_cfg(chip_smoke.R101_SFAT_YAML, **chip_smoke.ADAPT_CUTS)
    init = chip_smoke.frozen_state(chip_smoke.init_weights(
        chip_smoke.FasterRCNN(chip_smoke.detector_config_from_cfg(cfg)), chip_smoke.SEED))
    tr, _, metrics, _, per_step, teacher0, _ = chip_smoke.adapt_run(cfg, 2, [])
    chip_smoke.check_adapt_run("r101", tr, metrics, per_step, teacher0)
    after = chip_smoke.frozen_state(tr.state.model)
    assert len(init) == 33 and all(torch.equal(after[k], v) for k, v in init.items())


def test_mosaic_mixup_and_affine_card_match_cpu(cuda):
    """mosaic_batch and mixup_batch on the card equal the CPU's bit for bit
    on the same draws (content-aware, mixup's flip on); the bilinear warp
    (mixup's scale jitter, random_affine_batch) within chip_smoke's stated
    tolerance; masks, classes and scores equal."""
    err = chip_smoke.wq_ops_card_vs_cpu()
    assert chip_smoke.wq_ops_ok(err), err


def test_nms_ops_on_cuda_equal_plain_at_batch_3(cuda):
    """sfod::suppress_relation_bits and sfod::greedy_keep_from_bits on a
    batch of 3 on the card: one launch of each kernel an image, bit-equal to
    the plain versions (and the CPU implementations) image by image; the
    batched NMS entry equals its CPU path."""
    cases = [case(10 + i, 1024, 1000, classes=8) for i in range(3)]
    boxes, scores, valid = (torch.stack(t) for t in zip(*cases))
    order = nms.score_order(scores, valid)
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    sv = torch.gather(valid, 1, order).contiguous()
    _kernels.reset_launches()
    bits = torch.ops.sfod.suppress_relation_bits(sb.to(cuda), sv.to(cuda), 0.5)
    keep = torch.ops.sfod.greedy_keep_from_bits(bits, sv.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 3, "greedy_keep_from_bits": 3}
    assert torch.equal(bits.cpu(), torch.ops.sfod.suppress_relation_bits(sb, sv, 0.5))
    for i in range(3):
        rel = nms.suppress_relation_plain(sb[i], sv[i], 0.5)
        assert torch.equal(bits[i].cpu(), nms.pack_bits(rel))
        assert torch.equal(keep[i].cpu(), nms.greedy_keep_plain(rel, sv[i]))
    got = nms.nms_mask_matrix(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.5)
    assert torch.equal(got.cpu(), nms.nms_mask_matrix(boxes, scores, valid, 0.5))


def test_cuda_export_round_trip_equals_eager(cuda, tmp_path):
    """A poly-batch artifact exported on the card, reloaded on the card,
    equals eager Detector.infer there at batch 1 and 3 (after an eager call
    first: the anchor cache), launching each kernel twice an image; one
    exported on the CPU and moved to the card agrees with the card's eager
    detections."""
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_main_cfg
    from simple_sfod_tpu_torch.engine import export
    from simple_sfod_tpu_torch.models.detector import Detector
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    cfg = get_main_cfg()
    cfg.merge_from_list(["TPU.CANVAS", "(128, 256)", "TPU.DTYPE", "float32"])
    dcfg = detector_config_from_cfg(cfg)
    sd = init_weights(FasterRCNN(dcfg), 0).state_dict()
    det = Detector(dcfg, device=cuda).load_state_dict(sd)
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randint(0, 256, (3, 128, 256, 3)).astype(np.uint8)).to(cuda)
    sizes = torch.tensor([[128, 256], [100, 200], [128, 180]], dtype=torch.int32, device=cuda)
    det.infer(img[:1], sizes[:1])
    for where in ("cuda", "cpu"):
        path = str(tmp_path / f"{where}.sfodx")
        export.save_exported(export.export_inference(det, sd, (128, 256), batch=None, device=where), path)
        program, _ = export.load_exported(path, device=cuda)
        for n in (1, 3):
            _kernels.reset_launches()
            with torch.inference_mode():
                got = program.module()(img[:n], sizes[:n])
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES == {"suppress_relation_bits": 2 * n, "greedy_keep_from_bits": 2 * n}
            want = det.infer(img[:n], sizes[:n])
            assert torch.equal(got["valid"], want.valid) and want.valid.any()
            assert torch.equal(got["classes"], want.classes)
            if where == "cuda":
                assert torch.equal(got["boxes"], want.boxes) and torch.equal(got["scores"], want.scores)
            else:
                torch.testing.assert_close(got["boxes"], want.boxes, rtol=1e-5, atol=1e-2)
                torch.testing.assert_close(got["scores"], want.scores, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", list(chip_smoke.DA_KINDS))
def test_domain_adversarial_step_card_matches_cpu(cuda, kind):
    """One float32 step of da, cda (ENTROPY_CONDITIONING), adaptive_teacher
    (the boundary step, with the instance classifier) and the source-free
    step with both classifiers weighted, on the card against the CPU at
    128x256 on the same draws and dropout masks: chip_smoke's tolerances."""
    err = chip_smoke.da_card_vs_cpu(kind)
    assert chip_smoke.card_step_ok(err), err


@pytest.mark.parametrize("kind", list(chip_smoke.DA_KINDS))
def test_domain_adversarial_step_launches_as_counted(cuda, tmp_path, kind):
    """A step at batch 1 + 1 and 256x512 launches each NMS kernel as
    counted from the code (3 for da/cda, 7 for adaptive_teacher with the
    instance classifier, 5 for the weighted source-free step), with finite
    losses and nothing read back (set_sync_debug_mode("error"))."""
    cfg = chip_smoke.da_cfg(kind, str(tmp_path), canvas=(256, 512))
    tr = chip_smoke.build_trainer(cfg, state_dict=chip_smoke.da_weights(chip_smoke.detector_config_from_cfg(cfg)))
    args, kw, _ = chip_smoke.da_step_args(tr, kind, (256, 512), (250, 500))
    tr.run_step(*args, **kw)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = tr.run_step(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = chip_smoke.da_launches_per_step(kind, cfg)
    assert _kernels.LAUNCHES == {"suppress_relation_bits": want, "greedy_keep_from_bits": want}
    assert all(torch.isfinite(v) for k, v in metrics.items() if k.startswith("loss"))


def test_infer_raw_kernel_equals_plain(cuda):
    """The raw path (Detector.infer_raw: no score filter, no class-wise NMS)
    through the NMS ops and through their plain versions on the card, bit
    for bit, with one launch of each op an image (the RPN's) and nothing
    read back (set_sync_debug_mode("error"))."""
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_main_cfg
    from simple_sfod_tpu_torch.models.detector import Detector
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    cfg = get_main_cfg()
    cfg.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", "(128, 256)"])
    dcfg = detector_config_from_cfg(cfg)
    det = Detector(dcfg, device=cuda).load_state_dict(init_weights(FasterRCNN(dcfg), 0).state_dict())
    images = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 128, 256, 3)).astype(np.uint8)).to(cuda)
    sizes = torch.tensor([[128, 256], [120, 250]], dtype=torch.int32, device=cuda)
    got, want, launches = chip_smoke.infer_raw_vs_plain(det, images, sizes, topk=64)
    assert launches == {"suppress_relation_bits": 2, "greedy_keep_from_bits": 2}
    assert chip_smoke.same_detections(got, want) and bool(got.valid.all())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = det.infer_raw(images, sizes, topk=64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert chip_smoke.same_detections(again, got)
