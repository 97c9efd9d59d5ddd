"""DA-Faster R-CNN and its conditional variant (the port of
`simple_sfod_tpu/engine/trainers/da.py`): supervised source training with
image- and instance-level domain classifiers behind gradient reversal, and
an image/instance consistency loss.

One step, on a labelled source batch and an unlabelled target batch:

  1. the weak flip of both views (the target's GT is empty);
  2. one train-mode backbone pass per domain: source, then target, each
     moving the BatchNorm running statistics (the JAX package threads them
     source -> target);
  3. the supervised losses on the source feature;
  4. `dc_losses` on each domain's feature (source label 0, target 1);
  5. total = supervised + 0.5 * (source + target) of each DC term; SGD over
     the detector and both DA heads.

`cda` (CDATrainer) conditions the instance head on the class probabilities:
its input is the box feature (x) the stop-gradient softmax, fc_dim * (C + 1)
dimensions, and DA_FASTER.ENTROPY_CONDITIONING weights each instance by
1 + e^-H, normalised to mean 1. `da` refuses ENTROPY_CONDITIONING.

Every random decision of a step is a `DADraws` input. The target batches
come from base.py:PairedTargetMixin (DATASETS.TRAIN_TARGET, one pulled for
each source batch in step order). The loop, checkpoints (the DA heads under "trainer"), MODEL.WEIGHTS (the
detector only), AdaBN and `test` (the detector) are BaseTrainer's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ...checkpoint.from_jax import DAWeights
from ...models.dann import DAImgHead, DAInsHead, dropout_masks, gradient_scalar, init_dc_weights
from ...models.detector import DetectionBatch, Detector
from ...models.faster_rcnn import (
    anchors_for,
    dc_image_feature,
    pool_rois,
    proposal_counts,
    propose,
    roi_pool_size,
)
from ...ops.losses import sigmoid_ce
from ...solver.build import build_optimizer
from ..train_state import DAState
from . import register_trainer
from .base import BaseTrainer, PairedTargetMixin, weak_flip

NUM_INS = 64  # proposals an image that the instance and consistency losses take (the top by objectness)


def dc_losses(
    detector: Detector,
    img_head: DAImgHead,
    ins_head: DAInsHead,
    feature: torch.Tensor,
    canvas_hw: Tuple[int, int],
    sizes: torch.Tensor,
    domain_label: float,
    keep: Optional[Sequence[torch.Tensor]],
    *,
    w_img: float,
    w_ins: float,
    w_cst: float,
    conditional: bool,
    entropy_conditioning: bool,
    num_ins: int = NUM_INS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One domain's discriminator losses on its train-mode backbone feature
    [B, C, h, w] -> (loss_img, loss_ins, loss_cst):

      loss_img  the image head's BCE against `domain_label` behind GRL(-w_img)
      loss_ins  the instance head's BCE on the box features of the top
                `num_ins` training proposals (boxes detached) behind
                GRL(-w_ins); conditional: features (x) stop-gradient softmax;
                entropy_conditioning: each BCE times 1 + e^-H, mean 1
      loss_cst  L1 between the ROI-aligned mean of the image head's sigmoid
                map over the same boxes and the instance probabilities, the
                two paths entering through GRL(+w_cst * w_img) and
                GRL(+w_cst * w_ins)

    `keep`: the instance head's dropout masks, the instance call's two then
    the consistency call's two (bool [B * num_ins, 1024]); None runs it in
    eval mode."""
    cfg = detector.cfg
    model = detector.model
    b = feature.shape[0]
    df = dc_image_feature(cfg, feature)
    img_out = img_head(gradient_scalar(df, -w_img))
    loss_img = torch.mean(sigmoid_ce(img_out, torch.full_like(img_out, domain_label)))

    with torch.no_grad():  # the boxes carry no gradient
        anchors = anchors_for(cfg, canvas_hw, feature.device)
        boxes = propose(cfg, anchors, model.rpn(feature), sizes, training=True).boxes[:, :num_ins]
    k = boxes.shape[1]
    pooled = pool_rois(cfg, feature, boxes)
    feats = model.box_feature(pooled)
    probs = None
    if conditional:
        with torch.no_grad():
            probs = torch.softmax(model.box(pooled)[0], dim=-1)
        feats = (feats[:, :, None] * probs[:, None, :]).reshape(feats.shape[0], -1)
    ins_out = ins_head(gradient_scalar(feats, -w_ins), None if keep is None else keep[:2])
    ins_bce = sigmoid_ce(ins_out, torch.full_like(ins_out, domain_label))
    if entropy_conditioning:
        ent = -torch.sum(probs * torch.log(probs + 1e-5), dim=-1)
        w = 1.0 + torch.exp(-ent)
        ins_bce = ins_bce * (w / torch.mean(w)).reshape(ins_out.shape)
    loss_ins = torch.mean(ins_bce)

    prob_map = torch.sigmoid(img_head(gradient_scalar(df, w_cst * w_img)))  # [B, 1, h, w]
    roi_img_prob = pool_rois(cfg, prob_map, boxes).mean(dim=(1, 2, 3)).reshape(b, k)
    ins_out_c = ins_head(gradient_scalar(feats, w_cst * w_ins), None if keep is None else keep[2:])
    ins_prob = torch.sigmoid(ins_out_c).reshape(b, k)
    loss_cst = torch.mean(torch.abs(roi_img_prob - ins_prob))
    return loss_img, loss_ins, loss_cst


class DADraws(NamedTuple):
    """Every random decision of one DA step."""

    flip: torch.Tensor  # [B] bool: flip source image i
    rpn: torch.Tensor  # [B, N_anchors] float32: the supervised RPN sampler's priorities
    roi: torch.Tensor  # [B, pool] float32: the supervised ROI sampler's priorities
    flip_t: torch.Tensor  # [B_t] bool: flip target image i
    dropout_s: Tuple[torch.Tensor, ...]  # the source dc_losses' 4 keep masks [B * num_ins, 1024]
    dropout_t: Tuple[torch.Tensor, ...]  # the target's, [B_t * num_ins, 1024]

    def to(self, device) -> "DADraws":
        return DADraws(*(tuple(t.to(device) for t in x) if isinstance(x, tuple) else x.to(device) for x in self))


class _DATrainerBase(PairedTargetMixin, BaseTrainer):
    """The DA trainer. `device=None` means CUDA and raises without a GPU;
    tests pass `device="cpu"`. Weights: `weights` (DAWeights, for example
    from checkpoint/from_jax.py:da_state_from_jax), or `state_dict` (a
    detector) with seeded DA heads, or seeded random weights."""

    conditional = False

    def __init__(
        self,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        state_dict=None,
        weights: Optional[DAWeights] = None,
        synthetic: bool = False,
    ):
        if cfg.DA_FASTER.ENTROPY_CONDITIONING and not self.conditional:
            raise ValueError(
                "DA_FASTER.ENTROPY_CONDITIONING requires the conditional "
                "trainer (TRAINER: cda) — the plain 'da' instance "
                "discriminator has no class-probability condition to weight by"
            )
        self._weights = weights
        super().__init__(cfg, device=device, state_dict=weights.detector if weights is not None else state_dict,
                         synthetic=synthetic)
        self._weights = None
        d = cfg.DA_FASTER
        self.w_img = float(d.DC_IMG_GRL_WEIGHT)
        self.w_ins = float(d.DC_INS_GRL_WEIGHT)
        self.w_cst = float(d.DC_CONSISTENCY_WEIGHT)
        self.entropy_conditioning = self.conditional and bool(d.ENTROPY_CONDITIONING)

    def _init_state(self) -> DAState:
        det_cfg, dev = self.det_cfg, self.device
        ins_dim = det_cfg.fc_dim * ((det_cfg.num_classes + 1) if self.conditional else 1)
        heads = {
            "da_img": DAImgHead(det_cfg.feature_channels, dtype=det_cfg.dtype),
            "da_ins": DAInsHead(ins_dim, dtype=det_cfg.dtype),
        }
        for name, module in heads.items():
            if self._weights is not None:
                module.load_state_dict(self._weights.heads[name], strict=True)
            else:
                init_dc_weights(module, max(self.cfg.SEED, 0))
            heads[name] = module.to(dev)
        model = self.detector.model
        return DAState(step=0, model=model, optimizer=build_optimizer(self.cfg, model, extra=heads), heads=heads)

    # -- checkpoints -------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        """BaseTrainer's file with the DA heads under "trainer"."""
        data = super().checkpoint_state()
        data["trainer"]["heads"] = {name: m.state_dict() for name, m in self.state.heads.items()}
        return data

    def load_checkpoint(self, data: Dict) -> None:
        super().load_checkpoint(data)
        for name, m in self.state.heads.items():
            m.load_state_dict(data["trainer"]["heads"][name], strict=True)

    # -- the step ------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int], gt_capacity: int,
                   target_size: Optional[int] = None) -> DADraws:
        """One step's draws from the trainer's generator, on the device."""
        target_size = batch_size if target_size is None else target_size
        n = anchors_for(self.det_cfg, canvas_hw, torch.device("cpu")).shape[0]
        pool = roi_pool_size(self.det_cfg, n, gt_capacity)
        k = min(NUM_INS, proposal_counts(self.det_cfg, n, True)[1])  # the instances dc_losses takes
        g, dev = self.generator, self.device
        return DADraws(
            flip=torch.rand((batch_size,), generator=g, device=dev) < 0.5,
            rpn=torch.rand((batch_size, n), generator=g, device=dev),
            roi=torch.rand((batch_size, pool), generator=g, device=dev),
            flip_t=torch.rand((target_size,), generator=g, device=dev) < 0.5,
            dropout_s=dropout_masks(batch_size * k, 2, g, dev),
            dropout_t=dropout_masks(target_size * k, 2, g, dev),
        )

    def step_staged(self, staged, draws: Optional[DADraws] = None) -> Dict[str, torch.Tensor]:
        """One DA step on a staged (source, target) pair. Returns the
        metrics (the supervised ones, loss_DC_img, loss_DC_ins,
        loss_consistency, total_loss) as tensors on the device."""
        images, sizes, gt, t_images, t_sizes = staged
        images, t_images = images.to(torch.float32), t_images.to(torch.float32)
        canvas, t_canvas = tuple(images.shape[1:3]), tuple(t_images.shape[1:3])
        if draws is None:
            draws = self.make_draws(images.shape[0], canvas, gt.boxes.shape[1], t_images.shape[0])
        images, sizes, gt = self.augment(images, sizes, gt, draws)
        t_images = weak_flip(draws.flip_t, t_images, t_sizes, self.flip)

        st, det = self.state, self.detector
        for p in st.optimizer.params:
            p.grad = None
        feat_s = det.model.features(images, train=True, update_bn=True)
        total, metrics = det.losses_from_feature(feat_s, DetectionBatch(images, sizes, gt), draws.rpn, draws.roi)
        feat_t = det.model.features(t_images, train=True, update_bn=True)
        kw = dict(w_img=self.w_img, w_ins=self.w_ins, w_cst=self.w_cst, conditional=self.conditional,
                  entropy_conditioning=self.entropy_conditioning)
        img, ins = st.heads["da_img"], st.heads["da_ins"]
        src = dc_losses(det, img, ins, feat_s, canvas, sizes, 0.0, draws.dropout_s, **kw)
        tgt = dc_losses(det, img, ins, feat_t, t_canvas, t_sizes, 1.0, draws.dropout_t, **kw)
        for name, s, t in zip(("loss_DC_img", "loss_DC_ins", "loss_consistency"), src, tgt):
            metrics[name] = 0.5 * (s + t)
            total = total + metrics[name]
        total.backward()
        st.optimizer.step()
        st.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return metrics


@register_trainer("da")
class DATrainer(_DATrainerBase):
    conditional = False


@register_trainer("cda")
class CDATrainer(_DATrainerBase):
    conditional = True
