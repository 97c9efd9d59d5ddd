"""The port's Hopper kernels on the card: each against its plain PyTorch
version, bit for bit, and the detector's card path against its CPU path.

These tests need an NVIDIA GPU with nvcc (marker `cuda`) and skip without
one. They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

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
    [(4096, 4000, 0.7, 0), (1024, 1000, 0.5, 8), (1000, 1000, 0.5, 0), (65, 60, 0.5, 0), (1, 1, 0.5, 0), (200, 0, 0.7, 0)],
)
def test_kernels_bit_equal_to_plain(cuda, n, n_valid, thr, classes):
    boxes, scores, valid = case(n, n, n_valid, classes)
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    rel = nms.suppress_relation_plain(sb, sv, thr)
    _kernels.reset_launches()
    bits = _kernels.launch_suppress_relation_bits(sb.to(cuda), sv.to(cuda), thr)
    keep = _kernels.launch_greedy_keep_from_bits(bits, sv.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), nms.pack_bits(rel))
    assert torch.equal(keep.cpu(), nms.greedy_keep_plain(rel, sv))
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 1, "greedy_keep_from_bits": 1}
    got = nms.nms_mask_matrix(boxes.to(cuda), scores.to(cuda), valid.to(cuda), thr)
    assert torch.equal(got.cpu(), nms.nms_mask_matrix(boxes, scores, valid, thr))


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
