#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the Hopper kernels,
hold each against its plain PyTorch version, serve full-width detections
over HTTP, and check what comes out.

    python3 chip_smoke.py

Phases (each prints one progress line with its wall time):
  1. device   the card's name and power limit; fails without CUDA
  2. build    nvcc builds simple_sfod_tpu_torch/ops/csrc/nms.cu while g++
              builds the host libraries (the image codec, the C++ COCO
              evaluator); each kernel's registers, shared memory and spills
              (-Xptxas -v)
  3. kernels  suppress_relation_bits and greedy_keep_from_bits against their
              plain versions on seeded boxes (ties, invalid and zero-area
              boxes, class-offset boxes, N up to 8192 and N = 4097, and
              N = 12288, above the keep kernel's shared-memory route) and on
              cases built to break them (IoUs at the threshold's rounding
              boundaries, a suppression chain, identical boxes, disjoint
              boxes); bitmasks and keep masks must be equal bit for bit
  4. serve    the main configuration (VGG16-BN, 8 classes, 608x1216 canvas,
              bfloat16) with seeded weights behind the HTTP server; 4
              requests of seeded 600x1200 uint8 images, two of them
              concurrent, then a 1024x2048 frame sent as a PNG file (decoded
              and resized by the native codec); both NMS kernels must launch
              for every image, and on the NMS inputs captured from one
              request kernel and plain keep masks must be equal
  5. profile  the served detector without HTTP: median latency at batch 1
              and 2, then one image under torch.profiler (device time, busy
              share, top kernels and ops, peak memory)
  6. check    the same weights in float32 on a small canvas: the card's
              detections agree with the port's CPU path (which the CPU tests
              hold to the JAX package)
  7. timing   each kernel on the captured inputs: its device time (profiler),
              its time a call (CUDA events over back-to-back calls), its
              plain version's time and its bound
  8. train    the supervised source-training configuration
              (configs/faster_rcnn_VGG_cityscapes_source_new.yaml: base
              trainer, VGG16-BN, 608x1216, batch 1) at full width and depth
              from seeded weights, with synthetic ground truth on a
              600x1200 image: 12 steps on one repeated batch in float32 and
              in bfloat16 (finite losses every step, a lower total loss
              after 10 steps, one launch of each NMS kernel per image and
              step, median step time of the last 10), the train-mode RPN
              NMS inputs bit-equal between kernel and plain version, one
              bfloat16 step under torch.profiler, and one float32 step on
              the card against the same step on the CPU at 256x512
  9. adapt    the main path: the source-free adaptive-teacher step at full
              width from seeded weights (the class-1 logit bias raised by 4,
              so random weights give pseudo-labels above 0.8; the student's
              bbox_pred bias offset by 1e-2 from the teacher's) on one
              synthetic 600x1200 target image: 12 bfloat16 steps of the main
              variant on the adaptation benchmark's configuration (strong
              view, adaptive threshold, fixed bfloat16 teacher), 12 on the
              main configuration (domain classifiers built and zero-weighted),
              6 of `source_free_adaptive_teacher_single` (EMA, float32
              teacher); finite losses, pseudo-labels, the fixed teacher's
              parameters unchanged and its statistics moved, the EMA rule,
              exactly 3 launches of each NMS kernel per image and step, the
              three NMS inputs of one step bit-equal between kernel and plain
              version, the strong view against the CPU's on the same draws,
              one step under set_sync_debug_mode("error"), one step under
              torch.profiler, and one float32 step on the card against the
              CPU's at 128x256 (and at 256x512, reported: random weights'
              tied scores make the top-k cuts there differ)
 10. eval     the target domain from disk: 16 synthetic
              1024x2048 records written as PNG with a COCO JSON, registered
              as the main configuration's two DATASETS.TEST names and its
              TRAIN_TARGET; the first PNG decode bit-equal to the array
              written; 4 bfloat16 adaptation steps of the main variant on
              MAIN_CONFIG from trainer.build_train_loader() (decoded and
              resized natively to 600x1200 on the 608x1216 canvas); then
              trainer.test(): student and teacher on both datasets, exactly
              2 launches of each NMS kernel per image and evaluated model
              (128 of each), eval_results.json with 4 entries of finite AP,
              AP50 and F1; the native COCO result equal to the plain
              coco_map on the same records (1e-9); a dispatch under
              set_sync_debug_mode("error"); images/s of the whole eval loop
              at pipeline depth 1 and 4, one pass under torch.profiler (busy
              share), peak memory, host decode+resize ms an image; and a
              float32 eval loop on 4 images at 128x256 on the card against
              the CPU's. The teacher's detections on the first TEST set are
              written as a COCO results file for the tools phase
 11. cli      the adaptation CLI on the main YAML, as a user runs it:
              `python -m simple_sfod_tpu_torch.tools.train_net_mt
              --config-file configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml`
              (no YAML package needed) in subprocesses, on 16 synthetic
              1024x2048 PNG frames written where register_all_datasets
              finds the YAML's TRAIN_TARGET under a temporary SFOD_DATASETS,
              and 4 of them as each of its two TEST sets; MODEL.WEIGHTS a
              .pth of seeded weights (class-1 logit bias raised by 4); the
              eval phase's cuts with MAX_ITER 24, CHECKPOINT_PERIOD 8,
              EVAL_PERIOD 12, VIS_PERIOD 0 (8 where a TensorBoard backend
              imports). Run 1: metrics.json at 19 and 23 with finite losses,
              model_0000007/15/23 and model_final with the marker, two
              test() passes with their AP50 scalars, the validation loss at
              11 and 23, and each NMS kernel launched exactly as counted
              from the code. The restored state equals model_final.pth bit
              for bit; run 2 resumes to MAX_ITER 32; run 3 is stopped by
              SIGTERM after its first metrics line, saves model_preempt_*,
              exits 0 and resumes for 4 steps (run 3 beside run 1, run 2
              beside AdaBN and the determinism runs: nothing timed runs
              beside a process of its own). In the script: AdaBN on the
              base trainer (16 batches: statistics moved from reset,
              adabn.pth, eval_results.json); two 4-step loops against one
              saved and resumed after step 2 (the resumed run within the
              spread of the two); the loop's ms a step from disk and from a
              repeated batch beside the bare step, host syncs a step,
              a non-blocking save's blocking and write time, the file's
              size, the resume's load time, peak memory
 12. tools    the last modules, on the main YAML's detector (VGG16-BN,
              608x1216, bfloat16, seeded weights) and the earlier phases'
              outputs: Detector.infer_raw (no score filter, no class-wise
              NMS) on 2 synthetic 600x1200 frames, exactly one launch of
              each NMS op an image (the RPN's), bit-equal to the same call
              through the ops' plain versions on the card, and again under
              set_sync_debug_mode("error"); infer(score_thresh=0.0,
              topk=300) at the config's NMS and at nms_thresh 1.0 (a looser
              NMS keeps no fewer); in processes of their own beside those,
              `python -m simple_sfod_tpu_torch.tools.metrics_tool` (coco,voc,f1
              and --html) on the eval phase's teacher detections (a COCO
              results file of its first TEST set) and COCO GT, its AP50
              equal to test()'s to 1e-6, and `python -m
              simple_sfod_tpu_torch.tools.export_weights --which auto` on
              the cli phase's teacher-student model_final.pth (a file of
              "model" and "iteration" alone, its student loaded strictly on
              the card and bit-equal to the checkpoint's); the metrics GUI
              (serve_in_thread): 200 on the form, the statistics and the
              run page, whose AP50 is test()'s; device_trace around one
              infer_raw call, a trace naming both sfod:: ops; StepTimer's
              median of 10 infer_raw calls at batch 1. inspect_coco is a CPU
              tool (it draws with PIL, which this machine may lack) and is
              not run here
 13. r101     ResNet-101 C4 (full depth, seeded weights): features and
              detections on the card against the CPU's at 128x256 (FC_DIM
              64, float32) for NORM BN in eval and train mode and FrozenBN;
              AdaBN from the CLI in a process of its own, beside those cells
              (train_net_mt --eval-only on configs/r_101_c4_cs_foggy_adabn.yaml,
              the cli phase's 1024x2048 PNG datasets, a seeded R101 .pth,
              the refinement cut to 8 batches and each TEST set to 4 frames):
              live BN statistics moved from reset and finite, both TEST sets
              in eval_results.json, finite detections, NMS launches as
              counted; the refinement's batches/s and test()'s images/s in
              this process; 8 SFAT steps on
              configs/r101_c4_cs_foggy_adaptive_teacher_source_free.yaml
              (bfloat16, 608x1216, batch 1): finite losses, 3 launches of
              each kernel a step, stem and res2 bit-identical, a step under
              set_sync_debug_mode("error"), run_step median, a profiled
              step, peak memory, the three NMS inputs kernel == plain and
              timed; 6 base steps on configs/r_101_c4_cs_source_frozen.yaml
              (FrozenBN, IMS_PER_BATCH 4): finite losses, stem, res2 and
              every FrozenBN buffer bit-identical
 14. wq       fixed-pseudo-label self-training: mosaic_batch, mixup_batch
              (content-aware, with the companion flip, without and with the
              scale jitter) and random_affine_batch on the card against the
              CPU at 128x256 on the same draws (gathers and blends bit for
              bit, the bilinear warp within 1e-4*255 and 1e-3 px); an AdaBN
              dump (8 batches) of seeded weights on the cli phase's PNG
              frames, spliced at 0.7 by the port's prediction_to_gt into
              cityscapes_instancesonly_foggy_train_adabn; the four WQ YAMLs
              (configs/faster_rcnn_VGG_cityscapes_foggy_source_{wq,mosaic,
              mixup,mosaic_wq_new}.yaml: batch 4, 608x1216, float32) and
              mosaic with INPUT.MOSAIC.RANDOM_AFFINE, 6 steps each from the
              loader (no LR warmup, seed 0): finite losses, the weights
              moved, 4 launches of each kernel a step, the first step's NMS
              inputs kernel == plain, a step under
              set_sync_debug_mode("error"), the step's median, peak memory,
              a profiled step and the augmentation's device time alone;
              the _mosaic_wq_new YAML through `python -m
              simple_sfod_tpu_torch.tools.train_net` (8 steps, test() at
              8, launches as counted); the 5-stage run_workflow_synthetic
              at --iters 1000 --retrain-iters 50 --adabn-batches 64 (stages
              4 and 5 cut from 150, stage 2's AdaBN from 1400 batches;
              every stage exits 0, a nonzero splice; AP/AP50 and wall of
              each stage), beside the WQ CLI, the NMS checks and the ops
              against the CPU, after the timed runs, and on beside the
              export phase's exports, which wait for it before timing
 15. export   the detector as a standalone artifact: seeded weights (the
              cli phase's .pth, and a seeded ResNet-101 .pth) through
              `python -m simple_sfod_tpu_torch.tools.export_model`, five runs
              at once, each with --selfcheck (the reloaded artifact against
              eager Detector.infer on the card, their largest difference
              printed): the main YAML's teacher with --batch poly
              (VGG16-BN, 608x1216, bfloat16), the student at batch 1 in
              float32 and with --params-dtype bfloat16 (the sizes), the
              teacher with --no-bundle-params, and
              configs/r_101_c4_cs_foggy_adabn.yaml at full depth and width
              with --train-mode-bn (the AdaBN probe);
              the poly artifact behind `python -m
              simple_sfod_tpu_torch.tools.serve_model --artifact` in a
              subprocess, started beside the R101 server below (both loaded
              before any request) (GET /, a first pass of 1, 2 and 3 requests, then
              7 600x1200 requests: 2 alone, 2 and 3 concurrent, and a
              1024x2048 PNG; p50 latency of the second pass); in this
              process, once the wq phase's workflow has ended, its load
              time and first call, each of batch 1, 2, 4, 8
              against eager inference of the teacher (valid and classes
              equal, boxes and scores within 1e-5) with 2 launches of each
              kernel an image and the steady ms a call of both, a profiled
              call (busy share), one call's NMS inputs captured where the
              op launches (RPN N = 4096) kernel == plain, and
              DetectionService over the artifact (the tool's answers, one
              gated call padded to 4, launches); the R101 artifact served by
              serve_model's main with the port's models, config and
              trainers poisoned in sys.modules
 16. roofline the steps' and forward paths' floors on the card through
              `simple_sfod_tpu_torch/tools/roofline.py` (operations and bytes
              counted by utils/cost.py against the card's published peaks):
              the SFAT step (--headline) and the FPN supervised step with
              --measure (3 windows of 5 steps), the eval stages (features,
              raw, full) at batch 1 and 4 with --measure, and the export
              phase's poly artifact (--serving) at batch 1, each line's
              pct_of_roofline in (0, 100]; the stages' operations rising
              features < raw < full; the headline step's counted NMS
              launches equal to the kernels' counters (3 of each an image);
              then `tools/profile_step.py --steps 3` on the SFAT step, both
              NMS kernels among its device kernels
 17. car      the paper's car-only source domains: the committed image
              fixtures (tests/torch_jpeg/: baseline, progressive, CMYK,
              YCCK, arithmetic-coded, block-smoothed and lossless JPEG;
              tests/torch_containers/: BMP, GIF, TIFF; tests/torch_webp/:
              lossy, lossless, ALPH, VP8X, animated WebP; tests/torch_tiff/:
              BigTIFF, JPEG-compressed, CCITT, YCbCr, CIELab, float and
              signed TIFF, LZMA and ZSTD with predictor 2;
              tests/torch_raster/: Netpbm, PFM, DIB, ICO, CUR, QOI, SGI,
              PCX, DCX, TGA) decoded by the port's codec bit-equal to the
              recorded SHA-256 of Pillow's RGB; decode (and decode + resize) ms of a 1914x1052 JPEG,
              baseline and progressive, beside a 1024x2048 PNG and KITTI's
              Adam7 and 16-bit PNGs on one thread, and of the Sim10k frame
              arithmetic-coded (the committed transcoding), block-smoothed
              (its progressive file cut after 6 scans), as BMP and as TIFF
              uncompressed, PackBits, LZW and Deflate (written here, each
              decoded back to the frame), and as TIFF JPEG-compressed (16-row
              strips, shared JPEGTables), Group 4, YCbCr 2x2 PackBits and
              old-style JPEG (the last two written here), and its 960x528
              crop as LZMA and ZSTD with predictor 2 (ms and MB/s), each
              equal to Pillow's recorded digest, and as raw PPM, 16-bit PGM,
              DIB, QOI, SGI RLE, PCX and RLE TGA (written here, each decoded
              back to the frame; ms and MB/s); 16 Sim10k records (the fixture frames, the
              progressive one among them, with seeded VOC boxes,
              converted by `python -m simple_sfod_tpu_torch.tools.sim10k_to_coco`'s
              main) and 16 KITTI records (seeded 375x1242 PNGs, two
              Adam7-interlaced and two 16-bit, and label files, converted
              by kitti_to_coco from the PNG headers), and 8
              Cityscapes 1024x2048 PNG frames (the first 4 as
              cityscapes_car_val) under a temporary SFOD_DATASETS; for each
              domain: its source YAML (configs/faster_rcnn_VGG_{sim10k,kitti}
              _source.yaml: 1 class, 608x1120 / 608x2016, batch 4, float32)
              for 6 steps in this process from the loader (ms a step from
              disk, peak memory, a profiled step's busy share, the first
              step's RPN NMS inputs kernel == plain), then through train_net
              (4 steps, test() on cityscapes_car_val), then
              train_net_mt on its _to_cityscapes_source_free YAML from that
              model_final (1 class into 8: cls_score and bbox_pred skipped
              and nothing else; 4 steps, test() through the car-only
              remap; both domains' CLIs at once, after the timed runs,
              beside the NMS checks): exit 0, finite losses in metrics.json, finite AP/AP50
              in eval_results.json, launches as counted from the code;
              test() images/s of the Sim10k source model; and its test()
              on 4 Sim10k frames rewritten as arithmetic-coded JPEG, BMP
              and TIFF beside the same frames as the original JPEG files,
              and on 4 Sim10k records as the committed WebP frames (lossy
              quality 80, lossy + ALPH, a lossless 957x526 crop; their
              decode and decode + resize ms beside the baseline JPEG's)
              and on 8 Sim10k records as TIFF (4 JPEG-compressed, 4 LZW
              with Orientation 6, read turned), on 4 as old-style JPEG TIFF
              and on 2 as the LZMA and ZSTD crops, and on 4 as raw PPM,
              QOI, PCX and RLE TGA, each beside PNG twins of
              their decoded pixels: the loader's
              batches and the detections equal, 2 launches of each kernel
              an image
 18. da       domain-adversarial training: one float32 step of da, cda
              (ENTROPY_CONDITIONING), adaptive_teacher (the boundary step,
              with the instance classifier) and the source-free main YAML
              with DOMAIN_CLASSIFIER.IMAGE and INSTANCE on the card against
              the CPU's at 128x256 on the same draws and dropout masks;
              16 foggy and 8 clear synthetic 1024x2048 PNG frames with
              COCO GT under a temporary SFOD_DATASETS (the YAMLs'
              TRAIN_TARGET and TEST, and the labelled
              cityscapes_instancesonly_train), MODEL.WEIGHTS the cli
              phase's seeded .pth (class-1 logit bias raised by 4); at
              608x1216, full depth, batch 1 + 1, from the loaders:
              configs/faster_rcnn_VGG_cityscapes_da.yaml for 6 da steps
              (float32) and 4 cda steps with ENTROPY_CONDITIONING (finite
              losses with all three DC terms, every DA head tensor moved,
              3 launches of each kernel a step);
              configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml
              for 8 bfloat16 steps with BURN_UP_STEP cut from 20000 to 3,
              from weights with the class-1 logit bias raised by 6 and
              BASE_LR 0.0001 (0.0025), so that the student copied at the
              boundary still gives pseudo-labels (the teacher's parameters fixed in burn-in while its
              statistics move, the student's copy at the start of step 3,
              the EMA rule after it; the total equal to the supervised
              losses before step 3 and above them after; 5 launches a
              step); the source-free main YAML with both classifiers
              weighted for 6 steps (finite DC losses, the classifiers
              moved, 5 launches a step); each run's first-step NMS inputs
              kernel == plain, a step under set_sync_debug_mode("error"), a
              profiled step (device ms, busy share), the median step ms and
              peak memory; then train_net on the DA YAML and train_net_mt on
              the AT YAML in two subprocesses at once (4 steps each,
              WARMUP_ITERS 0, the AT burn-in cut to 2; checkpoints,
              test(), metrics.json, eval_results.json, launches as
              counted), the DA model_final.pth restored bit for bit in this
              process and `--resume` to 8 steps
 19. zoo      the rest of the model zoo: VGG16 without BN, the VGG-FPN
              detector and AdaIN style enhancement, at 608x1216 in each
              YAML's dtype (bfloat16) from the loaders on the PNG frames
              under a temporary SFOD_DATASETS, BASE_LR cut to 0.0025 (0.04
              in the bare-VGG source YAMLs), no LR warmup:
              configs/faster_rcnn_VGG_cityscapes_foggy_source_nobn.yaml for
              6 base steps at batch 4 (4 launches of each kernel a step),
              configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_nobn.yaml
              for 6 SFAT steps at batch 4 (12), and
              configs/vgg16_fpn_cityscapes_to_foggy_source.yaml for 6 base
              steps at batch 4 (4: one merged NMS an image, N <= 2000), then
              its test() on 8 frames (2 an image); then `python -m
              simple_sfod_tpu_torch.tools.train_net_mt` on
              configs/faster_rcnn_VGG_cityscapes_foggy_enhance.yaml (seeded
              pytorch-AdaIN .pth files, a seeded baseline JPEG fixture as
              the style image; 4 steps, test(); launches as counted) in a
              process of its own beside the untimed work: the FPN
              detector's artifact (torch.export in this process) held to
              eager and served over HTTP for 2 requests (2 an image), and
              one float32 step of the FPN detector and one of the style
              step on the card against the CPU's at 128x256 (the da
              phase's bounds; the stylised view within 1e-2 on 0-255);
              then the enhance YAML for 6 SFAT steps (3), every one under
              set_sync_debug_mode("error"), and stylize alone timed. Each
              run's ms a step, busy share, peak memory and launches; each
              run's first-step NMS inputs kernel == plain
 20. settings every model setting of the JAX package: box-head dropout, MC
              dropout, ResNet-50 under FPN and ImageNet initialisation, at
              608x1216 (1120 for Sim10k) from seeded weights and the PNG and
              JPEG frames under a temporary SFOD_DATASETS: the main SFAT YAML
              with MODEL.ROI_BOX_HEAD.DROPOUT 0.5 for 6 bfloat16 steps at
              batch 1 from the loader (3 launches a step, pseudo-labels),
              then mc_dropout_box_outputs with K 10 on 2 images of the
              trained student (1 launch an image; finite mean and std, the
              mean a distribution, std > 0; ms a call, profiled); ResNet-50
              (NORM BN) under the FPN of
              configs/vgg16_fpn_cityscapes_to_foggy_source.yaml, built from
              its DetectorConfig, for 6 base steps at batch 2 (2 launches a
              step; peak memory), `bn_update` on 4 images (every statistic
              moved and finite), inference on 4 (2 launches an image); then,
              beside the untimed work, `python -m
              simple_sfod_tpu_torch.tools.train_net` on
              configs/faster_rcnn_VGG_sim10k_source.yaml with a seeded
              torchvision-named vgg16_bn.pth as MODEL.WEIGHTS, and `python -m
              simple_sfod_tpu_torch.tools.import_weights` of a seeded
              vgg16.pth on the bare-VGG source YAML followed by train_net
              from its output (4 steps at batch 4 and test() each; 0
              backbone tensors kept at their initialisation, launches as
              counted); in this process both files as MODEL.WEIGHTS (every
              backbone tensor equal to the file's), one float32 R50-FPN step
              and MC dropout on the same masks on the card against the CPU
              at 128x256, and every captured NMS input kernel == plain
 21. dist     more than one rank (parallel/) on the one GPU: two ranks are two
              processes of `train_net --num-machines 2 --machine-rank r
              --dist-url ... --dist-backend gloo` (NCCL refuses two ranks on
              one device), from seeded weights (class-1 logit bias raised by
              4), batch 2 (one image a rank), all at 608x1216. First, alone
              on the card, two SFAT steps through the collective code path
              of a world of 1 over NCCL against the same steps without a
              group: in float32 from weights whose regression kernels are 0
              (boxes decoded from the biases), the first step held by
              card_step_ok's bound; in bfloat16 beside a control, the steps
              without a group with only BatchNorm's summation order changed,
              the first step held to within 4 times the control's errors;
              each step timed, one profiled (device time, and the host's
              time in synchronising calls, launches and collectives). Then,
              alone, the main YAML
              (configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml)
              in bfloat16 on two ranks for 6 steps and test() on 16 PNG
              frames of each TEST set (each rank's step ms, host clock).
              Then beside each other, untimed: held, one float32 step of the
              main YAML on two ranks and on one process (regression kernels
              0), by card_step_ok's bound; the full-width run's one-process
              twin, reported (losses, final states, AP50); the source YAML
              (configs/faster_rcnn_VGG_cityscapes_source_new.yaml) in
              float32 on data 1 x model 2 ranks (the box head split) and on
              one process for 4 steps and test(), step 1 held by
              card_step_ok's bound, the rest reported (losses, detection
              dumps); in height bands (TPU.SPATIAL_SHARD, data 1 x model
              2: 320 and 288 rows for VGG16) the same source YAML run, its
              step 1 held to the same twin by card_step_ok's bound (a), and
              the main YAML for 6 steps and test(), step 1 within 4 times
              the control (b), each rank's peak memory beside the unbanded
              runs'; and two processes asking NCCL for two ranks on the one
              device (NCCL's answer logged). Every run: the ranks' state
              hashes equal, launches summed over the ranks as counted,
              finite losses and AP50; the tensor-parallel and the banded
              model_final.pth loaded strictly into a one-process trainer;
              every rank's first-step NMS inputs kernel == plain. Then (c),
              two processes: VGG16-BN, ResNet-101 C4 and VGG16-BN-FPN in
              float32 at 608x1216 in bands against the whole image
              (parallel/dryrun.py:compare_bands), maps and statistics by
              their largest difference, gradients by their norm, each kind
              within 4 times a control (the whole pass in the other memory
              format) or a floor (BANDS_CASES)

Prints the card's name and power limit and a JSON line of the kernels'
numbers, then, as the last line, {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
import warnings
import zlib

import numpy as np
import torch

from simple_sfod_tpu_torch import host_libs
from simple_sfod_tpu_torch.checkpoint.checkpointer import Checkpointer
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg, get_main_cfg, get_source_cfg
from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG, SFAT_BENCH_CONFIG, config_opts
from simple_sfod_tpu_torch.data import mosaic, native_codec, transforms
from simple_sfod_tpu_torch.data.datasets import CITYSCAPES_THING_CLASSES, DATASET_REGISTRY, get_dataset, register_dataset
from simple_sfod_tpu_torch.engine.events import tensorboard_summary_writer
from simple_sfod_tpu_torch.data.loader import build_test_loader, d2_output_shape
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch, synthetic_image
from simple_sfod_tpu_torch.engine.eval_loop import Staging, inference_on_dataset
from simple_sfod_tpu_torch.engine.export import load_exported
from simple_sfod_tpu_torch.engine.serve import DetectionService, serve_in_thread
from simple_sfod_tpu_torch.evaluation import COCOEvaluator, F1Evaluator, coco_map
from simple_sfod_tpu_torch.evaluation.native import coco_map_native
from simple_sfod_tpu_torch.engine.train_state import ema_tensors
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import anchor_counts, empty_model, init_weights, proposal_counts
from simple_sfod_tpu_torch.ops import _kernels, nms
from simple_sfod_tpu_torch.structures.instances import Instances
from simple_sfod_tpu_torch.tools import kitti_to_coco, prediction_to_gt, run_workflow_synthetic, sim10k_to_coco, train_net
from simple_sfod_tpu_torch.utils.bench import synthetic_bench_batch
# the NMS kernels' bounds and the card's peaks, one definition for the
# per-kernel bounds here and the step's floor (tools/roofline.py)
from simple_sfod_tpu_torch.utils.cost import kernel1_bound_ms, kernel2_bound_ms

SEED = 0
N_REQUESTS = 4
IMAGE_HW = (600, 1200)  # Cityscapes' 1024x2048 after the shortest-edge-600 resize
FRAME_HW = (1024, 2048)  # a Cityscapes frame
# training: steps on one repeated batch, of which the last TIMED are timed;
# the loss must fall over the first 10 updates
TRAIN_STEPS = 12
TIMED = 10
# the solver of the training phase: the source config's own, without its
# 1000-step warmup (which would keep the LR near 0 for the whole phase)
TRAIN_SOLVER = {"SOLVER.WARMUP_ITERS": "0", "SOLVER.BASE_LR": "0.01"}
TRAIN_LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
# the card's float32 step against the CPU's: per-loss relative error (the
# proposals inherit the RPN deltas' rounding scaled by anchors up to 512 px,
# and the box-regression targets scale that again by 10 / proposal width);
# each other parameter within PARAM_REL of its tensor's largest entry plus
# PARAM_MOVE of how far the step moved it (a ReLU that flips sign on
# rounding moves a channel's gradient by percents on small feature maps);
# BatchNorm running statistics relative to their largest entry
# (the conv biases that feed a BatchNorm have an exact gradient of 0: each
# must move less than BN_FED_BIAS_TOL times as far as its conv's weight)
LOSS_TOL = 1e-3
PARAM_REL, PARAM_MOVE = 1e-4, 0.25
BN_TOL = 1e-4
BN_FED_BIAS_TOL = 1e-3
# adaptation: steps of the main variant (the last TIMED timed) and of
# `_single`; the cuts of the configurations: the adaptive threshold's warm-up
# at 4 steps (100 in the configuration), so that its branch runs; no
# 1000-step LR warmup, at the main YAML's LR 0.0025
ADAPT_STEPS = 12
SINGLE_STEPS = 6
ADAPT_CUTS = {"ADAPTIVE_THRESHOLD.WARM_UP": "4", "SOLVER.WARMUP_ITERS": "0", "SOLVER.BASE_LR": "0.0025"}
ADAPT_LOSSES = ("loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo", "loss_cls_pseudo", "loss_box_reg_pseudo",
                "loss_bpc_pseudo", "total_loss")
CLS_BIAS_BOOST = 4.0  # added to the class-1 logit bias: softmax ~0.87 > BBOX_THRESHOLD 0.8
BBOX_OFFSET = 1e-2  # the student's regression biases against the teacher's
# eval: the target domain on disk, Cityscapes-sized; steps adapted from the
# loader before trainer.test(); the float32 card-vs-CPU eval loop's size
EVAL_IMAGES = 16
EVAL_STEPS = 4
EVAL_SMALL = dict(images=4, hw=(100, 200), canvas=(128, 256), min_size=120)
# cli: the adaptation CLI on the main YAML; TRAIN_TARGET frames, and the
# frames of each TEST set (cut from Cityscapes val's 500); the eval phase's
# cuts and the loop's schedule
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml"
CLI_TRAIN_FRAMES = 16
CLI_TEST_FRAMES = 4
CLI_OPTS = {"SEED": "0", **ADAPT_CUTS, "SOLVER.MAX_ITER": "24", "SOLVER.CHECKPOINT_PERIOD": "8", "TEST.EVAL_PERIOD": "12"}
CLI_VIS_PERIOD = 8  # where a TensorBoard backend imports
CLI_TIMEOUT_S = 300
LOOP_STEPS, LOOP_WINDOW = 24, (4, 24)  # the loop timing: steps run, the window timed
DET_STEPS, DET_SPLIT = 4, 2  # the determinism runs: steps, and where one saves and resumes
ADABN_BATCHES = 16  # the refinement's batches (1400 in the reference)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[phase] {self.name}: ok in {time.perf_counter() - self.t0:.2f} s")


class Background(threading.Thread):
    """fn(*args) on a thread of its own: a CLI run in another process that
    overlaps what this process does meanwhile (work whose time is not
    measured). result() joins it and returns fn's value or raises its
    exception; a phase's `finally` joins it, so no process outlives it."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._call, self._value, self._exc = (fn, args), None, None
        self.start()

    def run(self):
        fn, args = self._call
        try:
            self._value = fn(*args)
        except BaseException as e:  # re-raised by result()
            self._exc = e

    def result(self):
        self.join()
        if self._exc is not None:
            raise self._exc
        return self._value


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernel cases
def case_boxes(rng: np.random.RandomState, n: int, n_valid: int, extent=(608.0, 1216.0), classes=0):
    """Seeded boxes with exact score ties, zero-area and invalid boxes, and
    (classes > 0) the class-offset shift of batched_class_nms."""
    h, w = extent
    cx = rng.uniform(0, w, n)
    cy = rng.uniform(0, h, n)
    bw = rng.uniform(4, 300, n)
    bh = rng.uniform(4, 200, n)
    # clusters of near-duplicates, as an RPN produces around objects
    dup = rng.rand(n) < 0.5
    src = rng.randint(0, max(n // 8, 1), n)
    cx[dup] = cx[src[dup]] + rng.normal(0, 6, dup.sum())
    cy[dup] = cy[src[dup]] + rng.normal(0, 6, dup.sum())
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)
    boxes[::11, 2] = boxes[::11, 0]  # zero width
    scores = np.round(rng.uniform(0, 1, n), 3).astype(np.float32)  # many exact ties
    scores[::13] = scores[0]
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    t = lambda a: torch.from_numpy(a).cuda()
    boxes_t, scores_t, valid_t = t(boxes), t(scores), t(valid)
    if classes:
        cls = t(rng.randint(0, classes, n).astype(np.int32))
        zero = torch.zeros((), device="cuda")
        max_coord = torch.where(valid_t[:, None], boxes_t, zero).max() + 1.0
        boxes_t = boxes_t + (cls.to(torch.float32) * max_coord)[:, None]
    return boxes_t, scores_t, valid_t


def borderline_case(thr: float, pairs: int = 256, seed: int = 0):
    """Box pairs whose float32 IoU lands on t, one ulp below and one above
    it, each as close to its rounding midpoints as integer boxes get.

    Pair k is [0, 2k, L, 2k+1] and [s, 2k, s+L, 2k+1] (L + s < 2^24, so the
    intersection L - s, the areas L and the union L + s are exact and only
    the division rounds): IoU = (L - s) / (L + s). Pairs lie in disjoint
    bands, the first box of each scores higher, and the second is
    suppressed iff fl(IoU) > t. -> boxes, scores, valid, expected keep."""
    t = np.float32(thr)
    targets = (np.nextafter(t, np.float32(-np.inf)), t, np.nextafter(t, np.float32(np.inf)))
    L = np.arange(9_000_000, 9_400_000, dtype=np.int64)
    s0 = np.round(L * (1 - float(t)) / (1 + float(t))).astype(np.int64)
    L = np.tile(L, 7)
    s = np.concatenate([s0 + d for d in range(-3, 4)])
    ok = L + s < 2**24
    L, s = L[ok], s[ok]
    q32 = (L - s).astype(np.float32) / (L + s).astype(np.float32)
    q64 = (L - s) / (L + s)
    picked = []
    for v in targets:
        hit = np.nonzero(q32 == v)[0]
        lo = (float(v) + float(np.nextafter(v, np.float32(-np.inf)))) / 2
        hi = (float(v) + float(np.nextafter(v, np.float32(np.inf)))) / 2
        picked += [hit[np.argmin(q64[hit] - lo)], hit[np.argmin(hi - q64[hit])]]
    rng = np.random.RandomState(seed)
    near = np.nonzero(np.isin(q32, np.asarray(targets)))[0]
    picked = np.concatenate([picked, rng.choice(near, pairs - len(picked), replace=False)])
    L, s, q32 = L[picked], s[picked], q32[picked]
    band = 2.0 * np.arange(pairs)
    a = np.stack([np.zeros(pairs), band, L, band + 1], 1)
    b = np.stack([s, band, s + L, band + 1], 1)
    boxes = np.stack([a, b], 1).reshape(-1, 4).astype(np.float32)
    scores = np.linspace(1.0, 0.01, 2 * pairs).astype(np.float32)
    keep = np.stack([np.ones(pairs, bool), q32 <= t], 1).reshape(-1)
    perm = rng.permutation(2 * pairs)
    return boxes[perm], scores[perm], np.ones(2 * pairs, bool), keep[perm]


def chain_case(n: int, thr: float):
    """n boxes of width 16 in a row, each shifted by d from the one before:
    every box suppresses the next and not the one after (IoU (16-d)/(16+d)
    above thr, (16-2d)/(16+2d) below), scores falling along the row. Greedy
    NMS keeps every other box; the fixpoint needs n/2 rounds."""
    d = {0.5: 4.0, 0.7: 2.0}[thr]
    x = d * np.arange(n)
    boxes = np.stack([x, np.zeros(n), x + 16.0, np.full(n, 16.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.01, n).astype(np.float32)
    return boxes, scores, np.ones(n, bool), np.arange(n) % 2 == 0


def identical_case(n: int, seed: int = 0):
    """n copies of one box, with tied scores: greedy NMS keeps one, the
    first of the highest score."""
    rng = np.random.RandomState(seed)
    boxes = np.tile(np.float32([[10.0, 20.0, 110.0, 220.0]]), (n, 1))
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)
    keep = np.zeros(n, bool)
    keep[np.argmax(scores)] = True
    return boxes, scores, np.ones(n, bool), keep


def disjoint_case(n: int, seed: int = 0):
    """n boxes on a grid, none touching another: greedy NMS keeps all."""
    rng = np.random.RandomState(seed)
    k = np.arange(n)
    x, y = 10.0 * (k % 64), 10.0 * (k // 64)
    boxes = np.stack([x, y, x + 8.0, y + 8.0], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    return boxes, scores, np.ones(n, bool), np.ones(n, bool)


# label -> (function making boxes, scores, valid, expected keep; IoU threshold)
EDGE_CASES = {
    "borderline thr=0.5": (lambda: borderline_case(0.5), 0.5),
    "borderline thr=0.7": (lambda: borderline_case(0.7), 0.7),
    "chain N=4096 thr=0.7": (lambda: chain_case(4096, 0.7), 0.7),
    "chain N=12288 thr=0.7": (lambda: chain_case(12288, 0.7), 0.7),
    "identical N=4096 thr=0.7": (lambda: identical_case(4096), 0.7),
    "disjoint N=4096 thr=0.5": (lambda: disjoint_case(4096), 0.5),
}


def edge_cases():
    """(label, boxes, scores, valid, thr, expected keep) of the cases built
    to break the kernels: rounding at the threshold, a suppression chain,
    all boxes equal, no box overlapping another."""
    out = []
    for label, (build, thr) in EDGE_CASES.items():
        boxes, scores, valid, keep = build()
        out.append((label, boxes, scores, valid, thr, keep))
    return out


def sorted_inputs(boxes, scores, valid):
    order = nms.score_order(scores, valid)
    return boxes[order].contiguous(), valid[order].contiguous()


def plain_keep(boxes, scores, valid, thr):
    """nms_mask_matrix through the plain versions, on the tensors' device."""
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    keep_sorted = nms.greedy_keep_plain(nms.suppress_relation_plain(sb, sv, thr), sv)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep


def check_kernels_against_plain(boxes, scores, valid, thr, label, expected=None, cpu=True):
    """Both kernels against their plain versions on the card, bit for bit;
    the whole NMS against the plain path, the CPU path (unless cpu=False)
    and, where given, the expected keep mask."""
    order = nms.score_order(scores, valid)
    sb, sv = boxes[order].contiguous(), valid[order].contiguous()
    rel = nms.suppress_relation_plain(sb, sv, thr)
    bits_k = _kernels.launch_suppress_relation_bits(sb, sv, thr)
    bits_p = nms.pack_bits(rel)
    torch.cuda.synchronize()
    if not torch.equal(bits_k, bits_p):
        bad = (bits_k != bits_p).sum().item()
        raise AssertionError(f"{label}: suppress_relation_bits differs from plain in {bad} words")
    keep_k = nms.greedy_keep_from_bits(bits_k, sv)  # the route N picks
    keep_p = nms.greedy_keep_plain(rel, sv)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError(f"{label}: greedy_keep_from_bits differs from plain")
    full_k = nms.nms_mask_matrix(boxes, scores, valid, thr)
    # the plain path of plain_keep, its sorted keep computed once above (the
    # chain's fixpoint takes N/2 rounds: seconds a call)
    full_p = torch.zeros_like(valid)
    full_p[order] = keep_p
    if not torch.equal(full_k, full_p):
        raise AssertionError(f"{label}: nms_mask_matrix on the card differs from the plain path")
    if cpu and not torch.equal(full_k.cpu(), nms.nms_mask_matrix(boxes.cpu(), scores.cpu(), valid.cpu(), thr)):
        raise AssertionError(f"{label}: nms_mask_matrix on the card differs from the CPU path")
    if expected is not None and not np.array_equal(full_k.cpu().numpy(), expected):
        raise AssertionError(f"{label}: keep mask differs from the expected one")
    return int(keep_k.sum().item())


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(fn, reps: int, host: bool = False, ops: bool = False):
    """Run fn reps times under torch.profiler. Returns (wall ms per rep,
    device kernel ms per rep, {kernel name: ms per rep}, {op: self device ms
    per rep}, empty unless `ops`: key_averages takes a second on a step's
    events); the kernels run on one stream, so their sum over the wall is
    the device's busy share. With `host`, a fifth item: the host's ms per
    rep in CUDA calls that wait for the device (`*Synchronize`), in kernel
    launches (and their count) and in c10d's collectives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    ops = {
        e.key: e.self_device_time_total / 1e3 / reps
        for e in prof.key_averages()
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
    } if ops else {}
    if not host:
        return wall, sum(kernels.values()), kernels, ops
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    launch = [e for e in cpu if e.name.startswith(("cudaLaunch", "cuLaunch"))]
    times = {"sync_ms": sum(e.cpu_time_total for e in cpu if "Synchronize" in e.name) / 1e3 / reps,
             "launch_ms": sum(e.cpu_time_total for e in launch) / 1e3 / reps, "launches": len(launch) / reps,
             "collective_ms": sum(e.cpu_time_total for e in cpu if e.name.startswith("c10d::")) / 1e3 / reps}
    return wall, sum(kernels.values()), kernels, ops, times


def top(d, k=6):
    return ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in sorted(d.items(), key=lambda kv: -kv[1])[:k])


# ---------------------------------------------------------------- training
def train_cfg(dtype: str, canvas=(608, 1216)):
    """The source-training configuration with the phase's solver, seed 0."""
    cfg = get_source_cfg()
    opts = {"SEED": "0", "TPU.DTYPE": dtype, "TPU.CANVAS": repr(tuple(canvas)), **TRAIN_SOLVER}
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    return cfg


def train_batch(cfg, image_hw, seed: int):
    """One synthetic image of image_hw (1..6 boxes) on the config's canvas."""
    recs = make_synthetic_records(1, tuple(image_hw), cfg.MODEL.ROI_HEADS.NUM_CLASSES, 6, seed=seed)
    return synthetic_batch(recs, tuple(cfg.TPU.CANVAS), cfg.TPU.GT_CAPACITY)


def card_vs_cpu_step(canvas=(256, 512), image_hw=(250, 500), seed: int = SEED):
    """One float32 step (TF32 off, which the trainer sets) from the same
    weights, batch and draws on the card and on the CPU. -> the errors:
    each loss's relative error, whether the sample counts are equal, the
    worst parameter difference relative to its tensor's largest entry and
    the worst ratio of a parameter difference to its bound (with the
    tensors' names), the worst BatchNorm statistic difference relative to
    its largest entry, and the largest movement of a conv bias that feeds a
    BatchNorm relative to its weight's movement (its exact gradient is 0)."""
    cfg = train_cfg("float32", canvas)
    state = init_weights(empty_model(detector_config_from_cfg(cfg)), SEED).state_dict()
    batch = train_batch(cfg, image_hw, seed)
    cpu = BaseTrainer(cfg, device="cpu", state_dict=state)
    card = BaseTrainer(cfg, device="cuda", state_dict=state)
    draws = cpu.make_draws(1, tuple(canvas), cfg.TPU.GT_CAPACITY)
    mc = {k: float(v) for k, v in cpu.run_step(batch, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(batch, draws).items()}
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in TRAIN_LOSSES},
           "counts_equal": all(mg[k] == mc[k] for k in ("num_fg", "num_sampled")),
           "losses_cpu": mc}
    out.update(state_errors(state, cpu.state.model.state_dict(), card.state.model.state_dict()))
    return out


def bn_fed_bias(key: str, state: dict) -> bool:
    """A conv bias whose next module (Detectron2's VGG-BN layout: conv j at
    index i, its BatchNorm at i + 1) is a BatchNorm: its exact gradient is 0."""
    parts = key.split(".")
    return parts[-2].isdigit() and ".".join(parts[:-2] + [str(int(parts[-2]) + 1), "running_mean"]) in state


def state_errors(start, after_cpu, after_cuda):
    """The card's state after a step against the CPU's, from the same start:
    the worst parameter difference relative to its tensor's largest entry,
    the worst ratio of a parameter difference to its bound, the worst
    BatchNorm statistic difference relative to its largest entry, and the
    largest movement of a conv bias that feeds a BatchNorm relative to its
    weight's movement (with the tensors' names). On the device of
    `after_cpu`'s tensors."""
    after = {"cpu": after_cpu, "cuda": {k: v.to(after_cpu[k].device) for k, v in after_cuda.items()}}
    state = {k: v.to(after_cpu[k].device).float() for k, v in start.items() if k in after_cpu}
    out = {"param": (0.0, ""), "param_bound": (0.0, ""), "bn": (0.0, ""), "bn_fed_bias": (0.0, "")}
    for k, c in after["cpu"].items():
        if k.endswith("num_batches_tracked") or k in ("pixel_mean", "pixel_std"):
            continue
        c = c.float()
        err = (after["cuda"][k].float() - c).abs().max().item()
        scale = max(c.abs().max().item(), 1e-12)
        if k.endswith(("running_mean", "running_var")):
            out["bn"] = max(out["bn"], (err / scale, k))
        elif k.endswith(".bias") and bn_fed_bias(k, after["cpu"]):
            w = k[:-4] + "weight"
            for side in ("cpu", "cuda"):
                moved = (after[side][k].float() - state[k]).abs().max().item()
                moved_w = (after[side][w].float() - state[w]).abs().max().item()
                out["bn_fed_bias"] = max(out["bn_fed_bias"], (moved / max(moved_w, 1e-30), f"{k} ({side})"))
        else:
            moved = (c - state[k]).abs().max().item()
            out["param"] = max(out["param"], (err / scale, k))
            out["param_bound"] = max(out["param_bound"], (err / (PARAM_REL * scale + PARAM_MOVE * moved + 1e-8), k))
    return out


def card_step_ok(err) -> bool:
    return (
        max(err["loss"].values()) <= LOSS_TOL and err["counts_equal"] and err["param_bound"][0] <= 1.0
        and err["bn"][0] <= BN_TOL and err["bn_fed_bias"][0] <= BN_FED_BIAS_TOL
        and err.get("teacher_bn", (0.0, ""))[0] <= BN_TOL
    )


def format_errors(err, losses) -> str:
    return (", ".join(f"{k} {err['loss'][k]:.3g}" for k in losses) + f" (tol {LOSS_TOL}); counts equal "
            f"{err['counts_equal']}; param max rel diff {err['param'][0]:.3g} ({err['param'][1]}); worst diff / bound "
            f"{err['param_bound'][0]:.3g} ({err['param_bound'][1]}; bound {PARAM_REL} x largest entry + {PARAM_MOVE} x "
            f"movement + 1e-8, tol 1); BN stats rel err {err['bn'][0]:.3g} ({err['bn'][1]}, tol {BN_TOL}); "
            f"BN-fed conv bias movement / weight movement {err['bn_fed_bias'][0]:.3g} ({err['bn_fed_bias'][1]}, "
            f"tol {BN_FED_BIAS_TOL})")


# ---------------------------------------------------------------- adaptation
def adapt_cfg(base, trainer: str = "source_free_adaptive_teacher", dtype: str = "bfloat16", canvas=(608, 1216)):
    """An adaptation configuration (`SFAT_BENCH_CONFIG` or `MAIN_CONFIG`) with
    the phase's cuts, seed 0."""
    cfg = get_cfg()
    opts = {"TRAINER": trainer, "SEED": "0", "TPU.DTYPE": dtype, "TPU.CANVAS": repr(tuple(canvas)), **ADAPT_CUTS}
    cfg.merge_from_list(config_opts(base) + [x for kv in opts.items() for x in kv])
    return cfg


def adapt_start(cfg) -> dict:
    """Seeded weights with the class-1 logit bias raised."""
    model = init_weights(empty_model(detector_config_from_cfg(cfg)), SEED)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
    return model.state_dict()


def adapt_trainer(cfg, device=None, start=None):
    """The trainer from `start` (default `adapt_start(cfg)`) for teacher and
    student, the student's bbox_pred bias offset from the teacher's."""
    tr = build_trainer(cfg, device=device, state_dict=start if start is not None else adapt_start(cfg))
    with torch.no_grad():
        tr.state.model.roi_heads.box_predictor.bbox_pred.bias += BBOX_OFFSET
    return tr


def capture_nms(captured: list):
    """A stand-in for nms.nms_mask_matrix, the entry that the detector calls
    with a batch ([B, N]), that records its inputs one image at a time."""
    orig = nms.nms_mask_matrix

    def record(boxes, scores, valid, thr):
        if valid.dim() == 1:
            captured.append((boxes.clone(), scores.clone(), valid.clone(), thr))
        else:
            captured.extend((b.clone(), s.clone(), v.clone(), thr) for b, s, v in zip(boxes, scores, valid))
        return orig(boxes, scores, valid, thr)

    return orig, record


def adapt_run(cfg, steps: int, captured: list):
    """`steps` adaptation steps on the synthetic bench image (the draws the
    trainer makes). Captures the NMS inputs of the first step, checks the
    EMA rule (where the trainer has EMA) at the second. -> (trainer, batch,
    per-step metrics, wall ms, launches, teacher parameters before, EMA
    error)."""
    tr = adapt_trainer(cfg)
    batch = synthetic_bench_batch(cfg)
    teacher0 = {k: v.clone() for k, v in tr.state.teacher.state_dict().items()}
    orig, record = capture_nms(captured)
    metrics, wall, launches, ema_err = [], [], [], None
    try:
        for i in range(steps):
            before = dict(_kernels.LAUNCHES)
            if i == 0:
                nms.nms_mask_matrix = record
            if i == 1 and tr.ema_enabled:
                t_before = [t.clone() for t in ema_tensors(tr.state.teacher)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(tr.run_step(batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            nms.nms_mask_matrix = orig
            launches.append({k: c - before[k] for k, c in _kernels.LAUNCHES.items()})
            if i == 1 and tr.ema_enabled:
                keep = np.float32(cfg.SEMISUPNET.EMA_KEEP_RATE)
                ema_err = max(
                    ((t1 - (keep * t0 + (np.float32(1) - keep) * s1)).abs().max() / s1.abs().max().clamp_min(1e-30)).item()
                    for t0, t1, s1 in zip(t_before, ema_tensors(tr.state.teacher), ema_tensors(tr.state.model))
                )
    finally:
        nms.nms_mask_matrix = orig
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return tr, batch, metrics, wall, launches, teacher0, ema_err


def check_adapt_run(label, tr, metrics, launches, teacher0, batch_size: int = 1):
    for i, m in enumerate(metrics):
        if not all(np.isfinite(m[k]) for k in ADAPT_LOSSES):
            raise AssertionError(f"{label} step {i}: non-finite loss {m}")
    for i, d in enumerate(launches):
        if any(c != 3 * batch_size for c in d.values()):
            raise AssertionError(f"{label} step {i}: kernel launches {d}, expected 3 of each per image")
    if not any(m["num_pseudo"] > 0 for m in metrics):
        raise AssertionError(f"{label}: no pseudo-labels in any step")
    if not tr.ema_enabled:
        after = tr.state.teacher.state_dict()
        for k, v in teacher0.items():
            if k.endswith(("running_mean", "running_var")):
                check(not torch.equal(after[k], v) and after[k].dtype == torch.float32, f"{label}: teacher {k} did not move")
            elif not k.endswith("num_batches_tracked"):
                check(torch.equal(after[k], v), f"{label}: fixed teacher {k} changed")


def strong_view_card_vs_cpu(image, size, draws):
    """The strong view of one image on the card and on the CPU from the same
    draws. -> (max difference, pixels more than 1 step apart, pixels)."""
    got = transforms.strong_augment(image, draws, 0, size).cpu()
    want = transforms.strong_augment(image.cpu(), draws.to("cpu"), 0, size.cpu())
    err = (got - want).abs()
    return float(err.max()), int((err > 1.0).sum()), err.numel()


def card_vs_cpu_adapt_step(canvas=(128, 256), image_hw=(120, 250)):
    """One float32 main-variant step (strong view, adaptive threshold; TF32
    off, which the trainer sets) on the card and on the CPU from the same
    weights, batch and draws. -> the errors of `state_errors`, the losses'
    and the pseudo-label counts', and the teacher statistics' (which its
    pseudo forward moved).

    Held at 128x256: there every top-k of the step keeps all its candidates.
    At 256x512 the teacher's 1000 test-mode proposals are cut from about
    1400 kept by NMS and its 100 detections from more than 100 above the
    threshold, among scores of random weights that tie to rounding, so the
    card and the CPU keep sets that differ by a box or two: the counts stay
    equal and loss_box_reg or loss_rpn_loc moves by 0.5-4% (measured)."""
    cfg = adapt_cfg(SFAT_BENCH_CONFIG, dtype="float32", canvas=canvas)
    cpu = adapt_trainer(cfg, device="cpu")
    card = adapt_trainer(cfg, device="cuda")
    start = {k: v.clone() for k, v in cpu.state.model.state_dict().items()}
    batch = synthetic_bench_batch(cfg)
    batch["sizes"][:] = image_hw
    batch["images"][:, image_hw[0]:] = 0
    batch["images"][:, :, image_hw[1]:] = 0
    draws = cpu.make_draws(1, tuple(canvas))
    mc = {k: float(v) for k, v in cpu.run_step(batch, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(batch, draws.to("cuda")).items()}
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in ADAPT_LOSSES},
           "counts_equal": all(mg[k] == mc[k] for k in ("num_fg_pseudo", "num_sampled_pseudo", "num_pseudo")),
           "losses_cpu": mc}
    out.update(state_errors(start, cpu.state.model.state_dict(), card.state.model.state_dict()))
    tc, tg = cpu.state.teacher.state_dict(), card.state.teacher.state_dict()
    out["teacher_bn"] = max(
        (((tg[k].cpu() - tc[k]).abs().max() / tc[k].abs().max().clamp_min(1e-12)).item(), k)
        for k in tc if k.endswith(("running_mean", "running_var"))
    )
    return out


# ---------------------------------------------------------------- eval data
def png_bytes(rgb: np.ndarray, level: int = 1, adam7: bool = False) -> bytes:
    """An RGB PNG of rgb [H, W, 3] (uint8: 8 bits a sample, uint16: 16),
    written with the standard library (zlib, struct): the rows filtered by
    types 0-4 in turn, so that a decoder meets every filter; with `adam7`,
    interlaced, each of the seven passes filtered on its own."""
    h, w, _ = rgb.shape
    depth = 16 if rgb.dtype == np.uint16 else 8
    passes = native_codec.ADAM7 if adam7 else ((0, 0, 1, 1),)
    raw = b"".join(_filtered_rows(rgb[y0::dy, x0::dx], depth) for x0, y0, dx, dy in passes
                   if x0 < w and y0 < h)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, int(adam7))
    return native_codec.PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b"")


def _filtered_rows(rgb: np.ndarray, depth: int) -> bytes:
    """The scanlines of rgb [h, w, 3] at `depth` bits, row y behind filter
    type y % 5."""
    h = rgb.shape[0]
    bpp = 3 * depth // 8
    x = (rgb.astype(">u2").view(np.uint8) if depth == 16 else rgb).reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) // 2, paeth)
    ft = np.arange(h) % 5
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    rows[:, 0] = ft
    for t, pred in enumerate(preds):
        rows[ft == t, 1:] = ((x - pred)[ft == t] % 256).astype(np.uint8)
    return rows.tobytes()


# the frames of write_eval_dataset by (n, hw, seed): (records, [(file name,
# PNG bytes)], the first image), encoded once and written by every phase
# that asks for the same frames
_FRAMES = {}


def write_eval_dataset(root: str, n: int, hw, seed: int = SEED):
    """n synthetic records of size hw (1..6 boxes of Cityscapes' 8 classes),
    rendered as the loader's synthetic images, written as PNG files with a
    COCO JSON (category ids 1..8) under root. -> (JSON path, records, the
    first image as written, RGB uint8)."""
    key = (n, tuple(hw), seed)
    if key not in _FRAMES:
        recs = make_synthetic_records(n, tuple(hw), len(CITYSCAPES_THING_CLASSES), 6, seed=seed)
        files, first = [], None
        for r in recs:
            rgb = np.clip(synthetic_image(r), 0, 255).astype(np.uint8)
            first = rgb if first is None else first
            files.append((f"frame_{r['image_id']:04d}.png", png_bytes(rgb)))
        _FRAMES[key] = recs, files, first
    recs, files, first = _FRAMES[key]
    images, anns = [], []
    for r, (fname, data) in zip(recs, files):
        with open(os.path.join(root, fname), "wb") as f:
            f.write(data)
        images.append({"id": r["image_id"], "file_name": fname, "height": hw[0], "width": hw[1]})
        for box, cls in zip(r["boxes"], r["classes"]):
            x1, y1, x2, y2 = box
            anns.append({"id": len(anns) + 1, "image_id": r["image_id"], "category_id": cls + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "iscrowd": 0})
    cats = [{"id": k + 1, "name": name} for k, name in enumerate(CITYSCAPES_THING_CLASSES)]
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path, recs, first


def match_dumps(a, b):
    """Two COCO detection dumps of the same images, paired per image one to
    one by category and nearest box (closest pairs first). -> (entries
    without a partner, largest box difference in px, largest score
    difference)."""
    def by_image(dump):
        out = {}
        for e in dump:
            out.setdefault(e["image_id"], []).append(e)
        return out

    ai, bi = by_image(a), by_image(b)
    unpaired, box_err, score_err = 0, 0.0, 0.0
    for img in set(ai) | set(bi):
        p, q = ai.get(img, []), bi.get(img, [])
        unpaired += abs(len(p) - len(q))
        if not p or not q:
            continue
        pb, qb = np.asarray([e["bbox"] for e in p]), np.asarray([e["bbox"] for e in q])
        pc, qc = np.asarray([e["category_id"] for e in p]), np.asarray([e["category_id"] for e in q])
        dist = np.abs(pb[:, None] - qb[None]).max(-1) + np.where(pc[:, None] != qc[None], np.inf, 0.0)
        taken = np.zeros(len(q), bool)
        for i in np.argsort(dist.min(axis=1), kind="stable")[: min(len(p), len(q))]:
            k = int(np.argmin(np.where(taken, np.inf, dist[i])))
            if not np.isfinite(dist[i, k]):
                unpaired += 1
                continue
            taken[k] = True
            box_err = max(box_err, float(dist[i, k]))
            score_err = max(score_err, abs(p[i]["score"] - q[k]["score"]))
    return unpaired, box_err, score_err


def card_vs_cpu_eval(root: str):
    """A float32 eval loop (TF32 off) on EVAL_SMALL's 4 PNG images at
    128x256 (100x200 files resized to 120x240) on the card and on the CPU,
    seeded weights. -> (card results, CPU results, match_dumps of the two
    dumps, detections on the CPU)."""
    path, _, _ = write_eval_dataset(root, EVAL_SMALL["images"], EVAL_SMALL["hw"], seed=SEED + 5)
    register_dataset("eval_small", path, root, CITYSCAPES_THING_CLASSES)
    cfg = get_main_cfg()
    ms = EVAL_SMALL["min_size"]
    cfg.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", repr(EVAL_SMALL["canvas"]), "INPUT.MIN_SIZE_TEST", str(ms),
                         "INPUT.MAX_SIZE_TEST", str(EVAL_SMALL["canvas"][1]), "TEST.IMS_PER_BATCH", "2"])
    dcfg = detector_config_from_cfg(cfg)
    sd = init_weights(empty_model(dcfg), SEED).state_dict()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            dump = os.path.join(root, f"dump_{dev}.json")
            det = Detector(dcfg, device=dev).load_state_dict(sd)
            res = inference_on_dataset(det, build_test_loader(cfg, "eval_small"), CITYSCAPES_THING_CLASSES,
                                       dump_json=dump, pipeline_depth=2)
            with open(dump) as f:
                out[dev] = (res, json.load(f))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out["cuda"][0], out["cpu"][0], match_dumps(out["cuda"][1], out["cpu"][1]), len(out["cpu"][1])


def train_run(dtype: str, captured: list):
    """TRAIN_STEPS steps of the full-width trainer on one repeated batch.
    Captures the RPN NMS inputs of the first step. -> (trainer, batch,
    per-step metrics, per-step wall ms, per-step kernel launches)."""
    cfg = train_cfg(dtype)
    trainer = BaseTrainer(cfg)
    batch = train_batch(cfg, IMAGE_HW, SEED + 3)
    orig_nms, record = capture_nms(captured)
    metrics, wall, launches = [], [], []
    try:
        for i in range(TRAIN_STEPS):
            before = dict(_kernels.LAUNCHES)
            if i == 0:
                nms.nms_mask_matrix = record
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(trainer.run_step(batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            nms.nms_mask_matrix = orig_nms
            launches.append({k: c - before[k] for k, c in _kernels.LAUNCHES.items()})
    finally:
        nms.nms_mask_matrix = orig_nms
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return trainer, batch, metrics, wall, launches


def kernel_device_ms(fn, kernel: str, reps: int = 50, tries: int = 5):
    """The device ms a call of the kernels whose name holds `kernel`, from
    the profiler's kernel events over `reps` calls of fn. -> (ms, every
    kernel's ms). A window in which the profiler recorded no event of the
    kernel (it happened on the card, with the kernel launched: CUPTI's
    buffers can come back empty) is profiled again, up to `tries` windows."""
    for _ in range(tries):
        _, _, kern, _ = profile(fn, reps)
        ms = sum(v for name, v in kern.items() if kernel in name)
        if ms > 0:
            break
    return ms, kern


def kernel_rows(b, s, v, thr, site, plain_reps=(20, 5)):
    """Both kernels on one NMS call's inputs: device time (profiler), time a
    call (CUDA events), plain version's time (over plain_reps calls of each,
    after a warm-up call), bound, and the differences from the plain
    version."""
    sb, sv = sorted_inputs(b, s, v)
    bits = _kernels.launch_suppress_relation_bits(sb, sv, thr)
    keep = nms.greedy_keep_from_bits(bits, sv)  # the route N picks
    rel = nms.suppress_relation_plain(sb, sv, thr)
    call1 = time_ms(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), 200)
    p1 = time_ms(lambda: nms.pack_bits(nms.suppress_relation_plain(sb, sv, thr)), plain_reps[0])
    call2 = time_ms(lambda: nms.greedy_keep_from_bits(bits, sv), 200)
    keep_plain = nms.greedy_keep_plain(rel, sv)  # the plain version's warm-up call, kept for the check
    p2 = time_ms(lambda: nms.greedy_keep_plain(rel, sv), plain_reps[1], warmup=0)
    # the kernels' own device time, from the profiler's kernel events
    k1, kern1 = kernel_device_ms(lambda: _kernels.launch_suppress_relation_bits(sb, sv, thr), "suppress_relation_bits_kernel")
    k2, kern2 = kernel_device_ms(lambda: nms.greedy_keep_from_bits(bits, sv), "greedy_keep_from_bits")
    check(k1 > 0 and k2 > 0, f"profiler saw no kernel time: {kern1} {kern2}")
    b1, by1 = kernel1_bound_ms(sv)
    b2, by2 = kernel2_bound_ms(keep)
    err1 = int((bits != nms.pack_bits(rel)).sum().item())
    err2 = int((keep != keep_plain).sum().item())
    n = int(sb.shape[0])
    log(f"  {site} N={n} valid={int(sv.sum())} kept={int(keep.sum())}: suppress_relation_bits {k1 * 1e3:.2f} us on the device, "
        f"{call1 * 1e3:.1f} us a call (plain {p1 * 1e3:.1f} us, bound {b1 * 1e3:.2f} us {by1}); "
        f"greedy_keep_from_bits {k2 * 1e3:.2f} us on the device, {call2 * 1e3:.1f} us a call "
        f"(plain {p2 * 1e3:.1f} us, bound {b2 * 1e3:.3f} us {by2})")
    return (
        dict(site=site, n=n, thr=thr, ms=k1, call_ms=call1, plain_ms=p1, bound_ms=b1, bound_by=by1, err=err1),
        dict(site=site, n=n, thr=thr, ms=k2, call_ms=call2, plain_ms=p2, bound_ms=b2, bound_by=by2, err=err2),
    )


# ---------------------------------------------------------------- cli
def write_cli_datasets(root: str, test_frames: int = CLI_TEST_FRAMES) -> None:
    """CLI_TRAIN_FRAMES synthetic 1024x2048 PNG frames under
    root/cityscapes_foggy/leftImg8bit_foggy, with COCO JSONs where
    register_all_datasets looks for the main YAML's TRAIN_TARGET (every
    frame) and its two TEST sets (the first `test_frames`)."""
    frames = os.path.join(root, "cityscapes_foggy", "leftImg8bit_foggy")
    os.makedirs(frames)
    path, _, _ = write_eval_dataset(frames, CLI_TRAIN_FRAMES, FRAME_HW)
    with open(path) as f:
        coco = json.load(f)
    for base, split, prefix, n in (
        ("cityscapes_foggy", "train_foggy_beta_0.02", "leftImg8bit_foggy/", CLI_TRAIN_FRAMES),
        ("cityscapes_foggy", "val_foggy_beta_0.02", "leftImg8bit_foggy/", test_frames),
        ("cityscapes", "val", "../cityscapes_foggy/leftImg8bit_foggy/", test_frames),
    ):
        images = coco["images"][:n]
        ids = {im["id"] for im in images}
        out = os.path.join(root, base, "annotations", f"instancesonly_filtered_gtFine_{split}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"images": [dict(im, file_name=prefix + im["file_name"]) for im in images],
                       "annotations": [a for a in coco["annotations"] if a["image_id"] in ids],
                       "categories": coco["categories"]}, f)


def register_cli_datasets(root: str) -> None:
    """The main YAML's dataset names in this process, at write_cli_datasets'
    paths (register_all_datasets keeps names registered before)."""
    for name, base, split in (
        ("cityscapes_instancesonly_foggy_train_foggy_beta_0.02", "cityscapes_foggy", "train_foggy_beta_0.02"),
        ("cityscapes_instancesonly_foggy_val_foggy_beta_0.02", "cityscapes_foggy", "val_foggy_beta_0.02"),
        ("cityscapes_instancesonly_val", "cityscapes", "val"),
    ):
        register_dataset(name, os.path.join(root, base, "annotations", f"instancesonly_filtered_gtFine_{split}.json"),
                         os.path.join(root, base), CITYSCAPES_THING_CLASSES)


def write_cli_weights(path: str, boost: float = CLS_BIAS_BOOST, boxes_from_biases: bool = False) -> None:
    """A source detector's .pth: seeded weights with the class-1 logit bias
    raised by `boost` (random weights then make pseudo-labels). With
    `boxes_from_biases` the RPN's and the box predictor's regression
    kernels are 0, so proposals and pseudo boxes are decoded from the
    biases alone, the same float32 operations on the same anchors however
    the features were summed (tests/test_torch_sfat_trainer.py: pseudo
    boxes a rounding apart flip RPN labels)."""
    model = init_weights(empty_model(detector_config_from_cfg(get_main_cfg())), SEED)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += boost
        if boxes_from_biases:
            model.proposal_generator.rpn_head.anchor_deltas.weight.zero_()
            model.roi_heads.box_predictor.bbox_pred.weight.zero_()
    torch.save({"model": model.state_dict()}, path)


def cli_argv(out: str, weights: str, vis: int, *opts: str, flags=()) -> list:
    """train_net's arguments: the main YAML, `flags`, then the phase's
    KEY VALUE opts, MODEL.WEIGHTS, OUTPUT_DIR, VIS_PERIOD and `opts` (later
    keys override earlier ones)."""
    kv = {**CLI_OPTS, "MODEL.WEIGHTS": weights, "OUTPUT_DIR": out, "VIS_PERIOD": str(vis)}
    return ["--config-file", os.path.join(ROOT, CLI_YAML), *flags, *[x for item in kv.items() for x in item], *opts]


def cli_env(data_root: str) -> dict:
    return dict(os.environ, SFOD_DATASETS=data_root, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def cli_cmd(argv: list) -> list:
    return [sys.executable, "-m", "simple_sfod_tpu_torch.tools.train_net_mt", *argv]


def cli_launches(stdout: str) -> dict:
    """The NMS launch counts that the CLI prints as its last line."""
    last = stdout.strip().splitlines()[-1]
    check(last.startswith("[launches] "), f"CLI's last line: {last!r}")
    return json.loads(last[len("[launches] "):])


def run_cli(argv: list, data_root: str, label: str):
    """One CLI run to its end. -> (stdout, wall s, launches)."""
    t0 = time.perf_counter()
    out = subprocess.run(cli_cmd(argv), cwd=ROOT, env=cli_env(data_root), capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{label}: exit code {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, wall, cli_launches(out.stdout)


def metrics_lines(out: str) -> list:
    path = os.path.join(out, "metrics.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def expected_cli_launches(steps: int, tests: int, val_images: int, vis_images: int) -> int:
    """Launches of each NMS kernel, counted from the code: 3 an adaptation
    step (teacher RPN, teacher detection, student RPN), 2 an image and
    model in test() (RPN, detection) over student and teacher on both TEST
    sets, 1 a validation-loss image (train-mode RPN), 2 a visualised image
    (the teacher's inference)."""
    return 3 * steps + 2 * 2 * 2 * CLI_TEST_FRAMES * tests + val_images + 2 * vis_images


def cli_trainer(argv: list, resume: bool):
    """The CLI's trainer, in this process: setup, build, resume_or_load."""
    cfg = train_net.setup(train_net.default_argument_parser().parse_args(argv))
    tr = build_trainer(cfg)
    tr.resume_or_load(resume=resume)
    return tr


def host_state(data) -> dict:
    """Every tensor of a checkpoint's content, by path, on the host."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, torch.Tensor):
            out[prefix] = v.detach().cpu()
        else:
            out[prefix] = v

    walk("", data)
    return out


def state_diff(a: dict, b: dict) -> float:
    """max over the floating tensors of max |a - b| / max |b|."""
    check(a.keys() == b.keys(), "checkpoint contents differ in their keys")
    worst = 0.0
    for k, y in b.items():
        if isinstance(y, torch.Tensor) and y.is_floating_point():
            worst = max(worst, ((a[k].float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-30)).item())
    return worst


class RepeatBatch:
    """A train loader that yields one batch forever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def timed_loop(tr, window):
    """tr.train() with a synchronise before step window[0] and after step
    window[1] - 1, and the implicit host syncs of every step counted under
    set_sync_debug_mode("warn"). -> (ms a step over the window, syncs by
    step)."""
    step, marks, starts = tr.step_staged, {}, {}
    caught = []

    def wrapped(staged, draws=None):
        i = tr.state.step
        starts[i] = len(caught)
        if i == window[0]:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        out = step(staged, draws)
        if i == window[1] - 1:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
        return out

    tr.step_staged = wrapped
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ends = {i: starts.get(i + 1, len(caught)) for i in starts}
    syncs = {i: sum("synchroniz" in str(w.message) for w in caught[starts[i]:ends[i]]) for i in starts}
    return (marks["t1"] - marks["t0"]) * 1e3 / (window[1] - window[0]), syncs



def sigterm_run(out: str, weights: str, vis: int, data_root: str, log_path: str) -> tuple:
    """Run 3 of the cli phase: train_net_mt stopped by SIGTERM after its
    first metrics line (it must save model_preempt_* and exit 0), then
    --resume for 4 steps. -> (the stopped run's output, its marker, the
    step it stopped at, and run_cli's (stdout, wall s, launches) of the
    resume)."""
    argv = cli_argv(out, weights, vis, "SOLVER.MAX_ITER", "100000")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(cli_cmd(argv), cwd=ROOT, env=cli_env(data_root), stdout=log_f,
                                stderr=subprocess.STDOUT)
        try:
            while not metrics_lines(out):
                check(proc.poll() is None, f"run 3 ended before its first metrics line: rc {proc.returncode}")
                check(time.perf_counter() - t0 < CLI_TIMEOUT_S, "run 3: no metrics line in time")
                time.sleep(0.1)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        stopped_out = f.read()
    check(rc == 0, f"run 3 after SIGTERM: exit code {rc}\n{stopped_out[-3000:]}")
    with open(os.path.join(out, "last_checkpoint")) as f:
        marker = f.read()
    check(marker.startswith("model_preempt_") and os.path.exists(os.path.join(out, marker)), f"run 3 marker {marker}")
    stopped = int(marker[len("model_preempt_"):-len(".pth")]) + 1
    resumed = run_cli(cli_argv(out, weights, vis, "SOLVER.MAX_ITER", str(stopped + 4), flags=("--resume",)),
                      data_root, "run 3 resume")
    return stopped_out, marker, stopped, resumed


def cli_phase(smi: str, adapt_step_ms: dict, keep: dict) -> dict:
    """The cli phase (module docstring); `adapt_step_ms` the adapt phase's
    step medians by run; run 2's model_final.pth is moved into keep["dir"]
    for the tools phase (keep["model_final"]). -> the NMS launches of the
    path."""
    try:
        tensorboard_summary_writer()
        vis = CLI_VIS_PERIOD
    except ImportError:
        vis = 0
    log(f"  TensorBoard backend: {'found, VIS_PERIOD ' + str(vis) if vis else 'none, VIS_PERIOD 0'}")
    cli_dir = tempfile.TemporaryDirectory(prefix="sfod_cli_")
    root = cli_dir.name
    data_root = os.path.join(root, "datasets")
    weights = os.path.join(root, "source.pth")
    cli_launch_total = {k: 0 for k in _kernels.LAUNCHES}
    background = []

    def add_launches(d):
        for k in cli_launch_total:
            cli_launch_total[k] += d[k]

    try:
        t0 = time.perf_counter()
        write_cli_datasets(data_root)
        write_cli_weights(weights)
        log(f"  wrote {CLI_TRAIN_FRAMES} {FRAME_HW[0]}x{FRAME_HW[1]} PNG frames, 3 COCO JSONs and {weights} in "
            f"{time.perf_counter() - t0:.2f} s")

        # run 3 (SIGTERM after its first metrics line, then --resume) in the
        # background, beside run 1 (adapt, evaluate, checkpoint)
        out3 = os.path.join(root, "run3")
        run3 = Background(sigterm_run, out3, weights, vis, data_root, os.path.join(root, "run3.log"))
        background.append(run3)
        out1 = os.path.join(root, "run1")
        argv1 = cli_argv(out1, weights, vis)
        stdout, wall, got = run_cli(argv1, data_root, "run 1")
        add_launches(got)
        lines = metrics_lines(out1)
        check([m["iteration"] for m in lines] == [19, 23], f"run 1 metrics.json iterations {[m['iteration'] for m in lines]}")
        for m in lines:
            check(all(np.isfinite(v) for k, v in m.items() if k.startswith("loss") or k == "total_loss"),
                  f"run 1: non-finite loss in {m}")
        names = sorted(f for f in os.listdir(out1) if f.endswith(".pth"))
        check(names == ["model_0000007.pth", "model_0000015.pth", "model_0000023.pth", "model_final.pth"],
              f"run 1 checkpoints {names}")
        with open(os.path.join(out1, "last_checkpoint")) as f:
            check(f.read() == "model_final.pth", "run 1 marker")
        n_eval = {tag: sum(line.startswith(f"[eval:{tag}]") for line in stdout.splitlines()) for tag in ("student", "teacher")}
        check(n_eval == {"student": 4, "teacher": 4}, f"run 1 eval lines {n_eval}: expected 2 test() passes x 2 sets")
        test_names = ("cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02")
        ap_keys = {f"{n}/{t}/AP50" for n in test_names for t in ("student", "teacher")}
        val_keys = {"loss_rpn_cls_val", "loss_rpn_loc_val", "loss_cls_val", "loss_box_reg_val"}
        check(all(ap_keys | val_keys <= set(m) for m in lines), f"run 1 scalars: {sorted(lines[0])}")
        check(all(np.isfinite(m[k]) for m in lines for k in val_keys), "run 1: non-finite validation loss")
        # the writers run before test() and the validation loss of their own
    # iteration (the JAX loop's order): both lines carry iteration 11's
    # scalars, and the firings at 23 show in the eval lines and the launches
        want = expected_cli_launches(24, 2, 2, 3 if vis else 0)
        check(all(c == want for c in got.values()), f"run 1 launches {got}, expected {want} of each")
        log(f"  run 1 (train_net_mt, 24 steps) [{smi}]: rc 0 in {wall:.2f} s; metrics at 19 and 23, total loss "
            f"{[round(m['total_loss'], 4) for m in lines]}, AP50 " +
            ", ".join(f"{k.rsplit('/', 1)[0]} {lines[1][k]:.4f}" for k in sorted(ap_keys)) +
            f"; checkpoints {names}; launches {got} (expected {want})")

        stopped_out, marker, stopped, (stdout, wall, got) = run3.result()
        add_launches(cli_launches(stopped_out))
        add_launches(got)
        check(f"resumed from {marker} at iteration {stopped}" in stdout, "run 3 did not resume from its preempt file")
        check(metrics_lines(out3)[-1]["iteration"] == stopped + 3, "run 3 resume did not reach its MAX_ITER")
        log(f"  run 3 (SIGTERM after the first metrics line, beside run 1) [{smi}]: rc 0, {marker} at {stopped} "
            f"steps, resumed for 4 steps in {wall:.2f} s")
        for f in os.listdir(out3):
            if f.endswith(".pth"):
                os.remove(os.path.join(out3, f))

        # the restored state equals model_final.pth bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = cli_trainer(argv1, resume=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        saved = host_state(torch.load(os.path.join(out1, "model_final.pth"), weights_only=True))
        restored = host_state(tr.checkpoint_state())
        check(saved.keys() == restored.keys(), "restored checkpoint keys differ")
        for k, v in saved.items():
            same = torch.equal(restored[k], v) if isinstance(v, torch.Tensor) else restored[k] == v
            check(same, f"restored {k} differs from model_final.pth")
        check(tr.state.step == 24 and next(tr.state.teacher.parameters()).dtype == tr.det_cfg.dtype, "restored step/teacher dtype")
        # a non-blocking save's cost to the loop, and its write
        ck = Checkpointer(os.path.join(root, "save_timing"))  # not run 1's directory: its marker stays
        ck.save("timing", tr.checkpoint_state(), block=False)
        ck.wait()
        save = ck.last_save
        log(f"  resume [{smi}]: trainer built and model_final.pth restored in {load_s:.2f} s, {len(saved)} entries "
            f"bit-equal; a non-blocking save: loop blocked {save['blocking_s'] * 1e3:.1f} ms (snapshot to host), "
            f"write {save['write_s']:.2f} s on its thread, {save['bytes'] / 2**20:.1f} MiB")
        del tr, saved, restored

        # run 2 (--resume to 32) in the background, beside AdaBN and the
        # determinism runs in this process; the timed loops run after it
        run2 = Background(run_cli, cli_argv(out1, weights, vis, "SOLVER.MAX_ITER", "32", flags=("--resume",)),
                          data_root, "run 2")
        background.append(run2)

        # in this process: the datasets, then AdaBN on the base trainer
        register_cli_datasets(data_root)
        out_a = os.path.join(root, "adabn")
        train_set = '("cityscapes_instancesonly_foggy_train_foggy_beta_0.02",)'
        tr = cli_trainer(cli_argv(out_a, weights, 0, "TRAINER", "base", "DATASETS.TRAIN", train_set), resume=False)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = tr.adabn_refinement(max_batches=ADABN_BATCHES)
        torch.cuda.synchronize()
        adabn_s = time.perf_counter() - t0
        got = dict(_kernels.LAUNCHES)
        add_launches(got)
        want = 2 * 2 * CLI_TEST_FRAMES
        check(all(c == want for c in got.values()), f"AdaBN test(): launches {got}, expected {want}")
        bns = [m for m in tr.detector.model.modules() if hasattr(m, "running_var")]
        check(all(m.running_mean.abs().max() > 0 and (m.running_var - 1).abs().max() > 0 for m in bns),
              "AdaBN: running statistics did not move from reset")
        check(os.path.exists(os.path.join(out_a, "adabn.pth")) and os.path.exists(os.path.join(out_a, "eval_results.json")),
              "AdaBN: adabn.pth or eval_results.json missing")
        log(f"  AdaBN (base trainer, reset + {ADABN_BATCHES} batches + test() + adabn.pth) [{smi}]: {adabn_s:.2f} s, "
            f"{len(bns)} BatchNorms moved from reset, AP50 " +
            ", ".join(f"{k} {v['AP50']:.4f}" for k, v in res.items()))
        del tr

        # determinism: two 4-step loops, and one saved and resumed after 2
        first_batch = next(iter(build_test_loader(get_main_cfg(), "cityscapes_instancesonly_foggy_val_foggy_beta_0.02")))
        _kernels.reset_launches()
        finals = {}
        for label in ("a", "b", "split"):
            out_d = os.path.join(root, f"det_{label}")
            steps = DET_SPLIT if label == "split" else DET_STEPS
            opts = ("SOLVER.MAX_ITER", str(steps), "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0")
            tr = cli_trainer(cli_argv(out_d, weights, 0, *opts), resume=False)
            tr.train_loader = RepeatBatch(first_batch)
            tr.train()
            if label == "split":
                tr = cli_trainer(cli_argv(out_d, weights, 0, *opts[:1], str(DET_STEPS), *opts[2:]), resume=True)
                check(tr.state.step == DET_SPLIT, "determinism: resume step")
                tr.train_loader = RepeatBatch(first_batch)
                tr.train()
            check(tr.state.step == DET_STEPS, "determinism: steps")
            finals[label] = host_state(tr.checkpoint_state())
            del tr
        det_launches = dict(_kernels.LAUNCHES)
        add_launches(det_launches)
        check(all(c == 3 * 3 * DET_STEPS for c in det_launches.values()), f"determinism launches {det_launches}")
        spread = state_diff(finals["b"], finals["a"])
        resumed = state_diff(finals["split"], finals["a"])
        gens = all(torch.equal(finals[x]["/trainer/generator"], finals["a"]["/trainer/generator"]) for x in finals)
        log(f"  determinism [{smi}]: two {DET_STEPS}-step loops differ by {spread:.3g} (relative to each tensor's "
            f"largest entry: the spread), the one saved and resumed after step {DET_SPLIT} by {resumed:.3g}; "
            f"generator states equal: {gens}")
        check(gens and resumed <= 2 * spread, f"resumed run off by {resumed}, spread {spread}")
        del finals

        stdout, wall, got = run2.result()
        add_launches(got)
        check("[checkpoint] resumed from model_final.pth at iteration 24" in stdout, "run 2 did not resume at 24")
        lines = metrics_lines(out1)
        check([m["iteration"] for m in lines] == [19, 23, 31], f"run 2 metrics iterations {[m['iteration'] for m in lines]}")
        names = sorted(f for f in os.listdir(out1) if f.endswith(".pth"))
        check("model_0000031.pth" in names, f"run 2 checkpoints {names}")
        want = expected_cli_launches(8, 1, 0, 1 if vis else 0)
        check(all(c == want for c in got.values()), f"run 2 launches {got}, expected {want} of each")
        log(f"  run 2 (--resume, to 32, beside AdaBN and the determinism runs) [{smi}]: rc 0 in {wall:.2f} s, "
            f"iterations 24-31, final test(); launches {got}")
        # run 2's model_final.pth (teacher and student, iteration 32) goes to
        # the tools phase
        keep["model_final"] = shutil.move(os.path.join(out1, "model_final.pth"), keep["dir"])
        for f in names:
            if f != "model_final.pth":
                os.remove(os.path.join(out1, f))

        # the loop's time a step, from disk and from a repeated batch
        loop = {}
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        for label in ("disk", "repeated batch"):
            opts = ("SOLVER.MAX_ITER", str(LOOP_STEPS), "TEST.EVAL_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "0")
            tr = cli_trainer(cli_argv(os.path.join(root, f"loop_{len(loop)}"), weights, 0, *opts), resume=False)
            if label == "repeated batch":
                tr.train_loader = RepeatBatch(first_batch)
            loop[label] = timed_loop(tr, LOOP_WINDOW)
            del tr
        peak_loop = torch.cuda.max_memory_allocated() / 2**30
        loop_launches = dict(_kernels.LAUNCHES)
        add_launches(loop_launches)
        check(all(c == 3 * 2 * LOOP_STEPS for c in loop_launches.values()), f"loop launches {loop_launches}")
        log_steps = {i for i in range(LOOP_STEPS) if (i + 1) % 20 == 0 or i == LOOP_STEPS - 1}
        for label, (ms, syncs) in loop.items():
            other = [syncs[i] for i in range(*LOOP_WINDOW) if i not in log_steps]
            log(f"  train loop, {label} [{smi}]: {ms:.2f} ms a step over steps {LOOP_WINDOW[0]}-{LOOP_WINDOW[1] - 1} "
                "(the adapt phase's run_step medians: " +
                ", ".join(f"{k} {v:.2f} ms" for k, v in adapt_step_ms.items()) + "); host syncs a step: "
                f"{max(other)} on steps without a log, {[syncs[i] for i in sorted(log_steps)]} on the log steps "
                f"{sorted(log_steps)} (one a metric read; the last step's count includes model_final's snapshot, "
                "one copy a tensor)")
        log(f"  peak memory over the two loops [{smi}]: {peak_loop:.2f} GiB")
    finally:
        for b in background:
            b.join()
        cli_dir.cleanup()
    log(f"  launches on the cli path: {cli_launch_total}")
    return cli_launch_total


# ---------------------------------------------------------------- r101
R101_ADABN_YAML = "configs/r_101_c4_cs_foggy_adabn.yaml"
R101_SFAT_YAML = "configs/r101_c4_cs_foggy_adaptive_teacher_source_free.yaml"
R101_SOURCE_YAML = "configs/r_101_c4_cs_source_frozen.yaml"
R101_ADABN_BATCHES = 8  # the CLI's refinement batches (1400 in the reference)
R101_TIMED_BATCHES = 16  # the in-script refinement's timed batches
R101_SFAT_STEPS = 8
R101_BASE_STEPS = 6
R101_CALIBRATION = 30  # train-mode forwards that give the FrozenBN weights their statistics
# the card-vs-CPU cells: a 128x256 canvas, a narrow box head, float32
R101_SMALL = {"MODEL.ROI_BOX_HEAD.FC_DIM": "64", "TPU.DTYPE": "float32", "TPU.CANVAS": "(128, 256)"}


def r101_cfg(yaml: str, **opts):
    """A ResNet-101 YAML of configs/ with KEY VALUE overrides, seed 0."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml))
    cfg.merge_from_list([x for kv in {"SEED": "0", **opts}.items() for x in kv])
    return cfg


def frozen_norms(model) -> set:
    return {n for n, m in model.named_modules() if type(m).__name__ == "FrozenBatchNorm2d"}


def frozen_state(model) -> dict:
    """The stem's and res2's parameters, and every FrozenBN buffer but its
    counter, on the host: what FREEZE_AT 2 and FrozenBN leave bit-identical
    (33 parameters under BN; 11 under FrozenBN, whose affine is buffers, and
    4 buffers in each of its 94 norms)."""
    out = {k: v.detach().cpu().clone() for k, v in model.named_parameters() if k.startswith(("backbone.stem.", "backbone.res2."))}
    norms = frozen_norms(model)
    out.update({k: v.detach().cpu().clone() for k, v in model.named_buffers()
                if k.rsplit(".", 1)[0] in norms and not k.endswith("num_batches_tracked")})
    return out


def pair_detections(g, c):
    """Card detections against the CPU's, per image: equal counts, each card
    detection paired with the CPU detection of its class nearest in box.
    -> (unpaired, max box difference px, max score difference, pairs)."""
    unpaired, box_err, score_err, pairs = 0, 0.0, 0.0, 0
    for i in range(c.valid.shape[0]):
        gv, cv = g.valid[i].cpu(), c.valid[i]
        gb, gs, gc = g.boxes[i].cpu()[gv], g.scores[i].cpu()[gv], g.classes[i].cpu()[gv]
        cb, cs, cc = c.boxes[i][cv], c.scores[i][cv], c.classes[i][cv]
        unpaired += abs(int(gv.sum()) - int(cv.sum()))
        for j in range(gb.shape[0]):
            same = (cc == gc[j]).nonzero().flatten()
            if same.numel() == 0:
                unpaired += 1
                continue
            d = (cb[same] - gb[j]).abs().max(dim=1).values
            k = int(same[int(d.argmin())])
            box_err = max(box_err, float(d.min()))
            score_err = max(score_err, abs(float(cs[k] - gs[j])))
            pairs += 1
    return unpaired, box_err, score_err, pairs


def r101_card_vs_cpu(smi: str) -> None:
    """ResNet-101 (full depth) features and detections on the card against
    the CPU's, from one set of seeded weights with random running
    statistics and norm scales: NORM BN in eval and train mode, FrozenBN.
    Held: res4 in every mode, detections with running statistics. With
    batch statistics the detections are reported, not held: normalising by
    the batch's statistics through 33 blocks leaves res4 about 2e-4 apart
    (measured), and the top-100 cut among random weights' near-tied scores
    then keeps different boxes on the two devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 7)
    img = rng.randint(0, 256, (2, 128, 256, 3)).astype(np.uint8)
    sizes = np.asarray([[120, 250], [128, 200]], np.int32)
    for norm, train in (("BN", False), ("BN", True), ("FrozenBN", False)):
        det_cfg = detector_config_from_cfg(r101_cfg(R101_ADABN_YAML, **R101_SMALL, **{"MODEL.RESNETS.NORM": norm}))
        model = init_weights(empty_model(det_cfg), SEED)
        g = torch.Generator().manual_seed(SEED + 5)
        with torch.no_grad():
            model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
            for m in model.modules():
                if isinstance(getattr(m, "running_var", None), torch.Tensor):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
                    # scales below 1 keep 33 residual blocks from growing the
                    # activations until the head's logits drown the class bias
                    m.weight.uniform_(0.2, 0.5, generator=g)
        sd = model.state_dict()
        outs = {}
        for dev in ("cuda", "cpu"):
            d = Detector(det_cfg, device=dev).load_state_dict(sd)
            with torch.inference_mode():
                feat = d.model.features(torch.from_numpy(img).to(dev), train=train, update_bn=False).float().cpu()
            outs[dev] = (feat, d.infer(img, sizes, train_mode_bn=train))
        fg, fc = outs["cuda"][0], outs["cpu"][0]
        ferr = ((fg - fc).abs().max() / fc.abs().max().clamp_min(1e-12)).item()
        ftol = 1e-3 if train else 1e-4
        unpaired, berr, serr, pairs = pair_detections(outs["cuda"][1], outs["cpu"][1])
        log(f"  card vs CPU, R101 {norm} {'train' if train else 'eval'}-mode norms, float32 at 128x256: res4 "
            f"{tuple(fg.shape)} rel err {ferr:.3g} (tol {ftol}); {pairs} detections paired, {unpaired} unpaired, "
            f"box err {berr:.3g} px, score err {serr:.3g}")
        check(bool(torch.isfinite(fg).all()) and ferr <= ftol, f"R101 {norm} res4: card vs CPU {ferr}")
        if not train:  # train mode: reported (see the docstring)
            check(pairs > 0 and unpaired == 0 and berr <= 1e-2 and serr <= 1e-4, f"R101 {norm} detections: card vs CPU")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def r101_phase(smi: str):
    """The r101 phase (module docstring). -> (launches of each kernel on the
    path, kernel rows on the SFAT step's three NMS inputs)."""
    total = {k: 0 for k in _kernels.LAUNCHES}
    background = []

    def add(d):
        for k in total:
            total[k] += d[k]

    tmp = tempfile.TemporaryDirectory(prefix="sfod_r101_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    try:
        # AdaBN from the CLI, in a process of its own, beside the card-vs-CPU
        # cells of this process
        t0 = time.perf_counter()
        write_cli_datasets(data_root)
        weights = os.path.join(root, "r101_source.pth")
        model = init_weights(empty_model(detector_config_from_cfg(r101_cfg(R101_ADABN_YAML))), SEED)
        with torch.no_grad():
            model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
        torch.save({"model": model.state_dict()}, weights)
        del model
        log(f"  wrote {CLI_TRAIN_FRAMES} {FRAME_HW[0]}x{FRAME_HW[1]} PNG frames, 3 COCO JSONs and a seeded R101 .pth "
            f"({os.path.getsize(weights) / 2**20:.1f} MiB) in {time.perf_counter() - t0:.2f} s")
        out = os.path.join(root, "adabn")
        argv = ["--config-file", os.path.join(ROOT, R101_ADABN_YAML), "--eval-only", "--adabn-batches",
                str(R101_ADABN_BATCHES), "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out, "SEED", "0", "VIS_PERIOD", "0"]

        def adabn_cli():
            t0 = time.perf_counter()
            res = subprocess.run(cli_cmd(argv), cwd=ROOT, env=cli_env(data_root), capture_output=True, text=True,
                                 timeout=CLI_TIMEOUT_S)
            return res, time.perf_counter() - t0

        cli = Background(adabn_cli)
        background.append(cli)
        r101_card_vs_cpu(smi)  # meanwhile, in this process
        res, wall = cli.result()
        check(res.returncode == 0, f"R101 AdaBN CLI: exit code {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        got = cli_launches(res.stdout)
        add(got)
        test_names = ("cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02")
        want = 2 * len(test_names) * CLI_TEST_FRAMES  # test(): RPN and detection NMS an image; refining has none
        check(all(c == want for c in got.values()), f"R101 AdaBN CLI launches {got}, expected {want} of each")
        check(f"refined over {R101_ADABN_BATCHES} batches" in res.stdout, "R101 AdaBN CLI: refinement batches")
        saved = torch.load(os.path.join(out, "adabn.pth"), weights_only=True)["model"]
        stats = {k: v for k, v in saved.items() if k.startswith("backbone.") and k.endswith(("running_mean", "running_var"))}
        check(len(stats) == 2 * 94 and all(bool(torch.isfinite(v).all()) for v in stats.values()) and
              all(not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))
                  for k, v in stats.items()), "R101 AdaBN: live BN statistics not moved from reset, or not finite")
        with open(os.path.join(out, "eval_results.json")) as f:
            written = json.load(f)
        check(set(written) == set(test_names) and all(
            isinstance(v.get(k), (int, float)) and np.isfinite(v[k]) for v in written.values() for k in ("AP", "AP50", "F1")
        ), f"R101 AdaBN eval_results.json: {written}")
        n_dets = 0
        for name in test_names:
            with open(os.path.join(out, "inference", name, "coco_instances_results.json")) as f:
                dets = json.load(f)
            check(all(np.isfinite(d["bbox"]).all() and np.isfinite(d["score"]) for d in dets), f"{name}: non-finite detections")
            n_dets += len(dets)
        check(n_dets > 0, "R101 AdaBN: no detections")
        log(f"  R101 AdaBN CLI (train_net_mt --eval-only on {R101_ADABN_YAML}, {R101_ADABN_BATCHES} batches, 2 TEST "
            f"sets of {CLI_TEST_FRAMES}) [{smi}]: rc 0 in {wall:.2f} s; 94 BatchNorms moved from reset; {n_dets} finite "
            f"detections; AP50 " + ", ".join(f"{k} {v['AP50']:.4f}" for k, v in written.items()) + f"; launches {got}")
        del saved, stats

        # the same AdaBN in this process: the refinement's and test()'s rates
        register_cli_datasets(data_root)
        cfg = train_net.setup(train_net.default_argument_parser().parse_args(argv))
        tr = build_trainer(cfg)
        tr.resume_or_load(resume=False)
        tr.reset_bn_stats()
        batch = next(iter(tr.build_train_loader()))
        rates = {}
        for label, loader, n in (("repeated batch", RepeatBatch(batch), R101_TIMED_BATCHES),
                                 ("from disk", None, R101_ADABN_BATCHES)):
            tr.refine_bn_stats(max_batches=1, loader=RepeatBatch(batch))  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            taken = tr.refine_bn_stats(max_batches=n, loader=loader)
            torch.cuda.synchronize()
            rates[label] = taken / (time.perf_counter() - t0)
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.test()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        got = dict(_kernels.LAUNCHES)
        add(got)
        check(all(c == want for c in got.values()), f"R101 test(): launches {got}, expected {want}")
        n_img = len(test_names) * CLI_TEST_FRAMES
        log(f"  R101 AdaBN refinement (bfloat16, batch 1, 608x1216) [{smi}]: {rates['repeated batch']:.2f} batches/s on "
            f"a repeated batch, {rates['from disk']:.2f} batches/s from disk; test() {n_img} images in {test_s:.2f} s "
            f"({n_img / test_s:.2f} images/s, the host decode included), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tr

        # SFAT steps on the R101 adaptation YAML (bfloat16, 608x1216, batch 1)
        cfg = r101_cfg(R101_SFAT_YAML, **ADAPT_CUTS)
        det_cfg = detector_config_from_cfg(cfg)
        check(det_cfg.backbone == "resnet101" and det_cfg.dtype == torch.bfloat16 and det_cfg.resnet_norm == "BN",
              f"R101 SFAT config: {det_cfg}")
        init = frozen_state(init_weights(empty_model(det_cfg), SEED))  # adapt_trainer's student before any step
        captured = []
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        tr, sbatch, metrics, wall, per_step, teacher0, _ = adapt_run(cfg, R101_SFAT_STEPS, captured)
        check_adapt_run("R101 SFAT", tr, metrics, per_step, teacher0)
        images, sizes = tr.stage(sbatch)
        draws = tr.make_draws(1, tuple(images.shape[1:3]))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = tr.step_on_device(images, sizes, draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(all(np.isfinite(float(m[k])) for k in ADAPT_LOSSES), "R101 sync-checked step: non-finite loss")
        wall_p, dev_p, kern_p, _ = profile(lambda: tr.run_step(sbatch), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = dict(_kernels.LAUNCHES)
        add(got)
        n_steps = R101_SFAT_STEPS + 1 + 4  # the steps, the sync-checked one, the profiler's warm-up and 3
        check(all(c == 3 * n_steps for c in got.values()), f"R101 SFAT launches {got}, expected {3 * n_steps}")
        after = frozen_state(tr.state.model)
        check(init.keys() == after.keys() and len(init) == 33 and all(torch.equal(after[k], v) for k, v in init.items()),
              "R101 SFAT: stem or res2 parameters changed")
        med = float(np.median(wall[1:]))
        nms_p = sum(v for k, v in kern_p.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
        log(f"  R101 SFAT ({R101_SFAT_YAML}, main variant, fixed bfloat16 teacher) [{smi}]: run_step {med:.2f} ms "
            f"(median of steps 1-{R101_SFAT_STEPS - 1}; first {wall[0]:.1f} ms); num_pseudo {[int(x['num_pseudo']) for x in metrics]}; "
            f"step {R101_SFAT_STEPS - 1}: " + ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in ADAPT_LOSSES) +
            f"; stem and res2 bit-identical; step_on_device ran under set_sync_debug_mode('error'); profile: wall "
            f"{wall_p:.2f} ms, device kernels {dev_p:.2f} ms, busy {dev_p / wall_p:.1%}, NMS kernels {nms_p:.3f} ms; "
            f"peak memory {peak:.2f} GiB; launches {got}")
        log(f"  top kernels (ms/step): {top(kern_p)}")
        del tr

        sites = ("r101 teacher rpn (test mode)", "r101 teacher detection", "r101 student rpn (train mode)")
        check(len(captured) == 3, f"R101: captured {len(captured)} NMS calls in one adaptation step, expected 3")
        for (b, s_, v, thr), site in zip(captured, sites):
            keep_k = nms.nms_mask_matrix(b, s_, v, thr)
            check(torch.equal(keep_k, plain_keep(b, s_, v, thr)), f"{site} NMS: kernel and plain keep masks differ")
        r101_rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for (b, s_, v, thr), site in zip(captured, sites):
            r1, r2 = kernel_rows(b, s_, v, thr, site)
            r101_rows["suppress_relation_bits"].append(r1)
            r101_rows["greedy_keep_from_bits"].append(r2)

        # base steps on the R101 FrozenBN source YAML (IMS_PER_BATCH 4)
        cfg = r101_cfg(R101_SOURCE_YAML)
        n_img = cfg.SOLVER.IMS_PER_BATCH
        recs = make_synthetic_records(n_img, IMAGE_HW, cfg.MODEL.ROI_HEADS.NUM_CLASSES, 6, seed=SEED + 9)
        bbatch = synthetic_batch(recs, tuple(cfg.TPU.CANVAS), cfg.TPU.GT_CAPACITY)
        # frozen statistics that normalise, as a source checkpoint's do: the
        # seeded weights with live BN, their statistics accumulated over
        # R101_CALIBRATION train-mode forwards on the batch (FrozenBN at
        # mean 0, var 1 would let 30 residual blocks grow the activations
        # until the first steps diverge)
        calib = Detector(detector_config_from_cfg(r101_cfg(R101_SOURCE_YAML, **{"MODEL.RESNETS.NORM": "BN"})))
        init_weights(calib.model, SEED)
        images = torch.from_numpy(bbatch["images"]).cuda()
        with torch.no_grad():
            for _ in range(R101_CALIBRATION):
                calib.bn_update(images)
        tr = BaseTrainer(cfg, state_dict=calib.model.state_dict())
        del calib
        check(tr.det_cfg.resnet_norm == "FrozenBN" and n_img == 4 and len(frozen_norms(tr.state.model)) == 94,
              f"R101 source config: {tr.det_cfg.resnet_norm}, batch {n_img}")
        before = frozen_state(tr.state.model)
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        metrics, wall = [], []
        for _ in range(R101_BASE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append({k: float(v) for k, v in tr.run_step(bbatch).items()})
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = dict(_kernels.LAUNCHES)
        add(got)
        check(all(c == n_img * R101_BASE_STEPS for c in got.values()), f"R101 base launches {got}")
        check(all(np.isfinite(x[k]) for x in metrics for k in TRAIN_LOSSES), f"R101 base losses {metrics}")
        after = frozen_state(tr.state.model)
        check(len(before) == 11 + 4 * 94 and all(torch.equal(after[k], v) for k, v in before.items()),
              "R101 base: stem, res2 or FrozenBN buffers changed")
        med = float(np.median(wall[1:]))
        log(f"  R101 base ({R101_SOURCE_YAML}, FrozenBN, batch {n_img}) [{smi}]: step {med:.2f} ms (median of steps "
            f"1-{R101_BASE_STEPS - 1}; first {wall[0]:.1f} ms; {n_img * 1e3 / med:.2f} images/s); step "
            f"{R101_BASE_STEPS - 1}: " + ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in TRAIN_LOSSES) +
            f"; stem, res2 and 376 FrozenBN buffers bit-identical; peak memory {peak:.2f} GiB; launches {got}")
        del tr
    finally:
        for b in background:
            b.join()
        tmp.cleanup()
    log(f"  launches on the r101 path: {total}")
    return total, r101_rows


# ---------------------------------------------------------------- wq
WQ_AUGS = ("wq", "mosaic", "mixup", "mosaic_wq_new")
WQ_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_source_{}.yaml"
WQ_STEPS = 6
# the cuts of the phase's runs: seed 0 (42), no LR warmup (1000 steps, which
# would keep the weights all but still for 6 steps)
WQ_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0"]
WQ_CLI_AUG = "mosaic_wq_new"
WQ_CLI_ITERS = 8
WQ_ADABN_BATCHES = 8  # the AdaBN dump's refinement (1400 in the reference)
WQ_OPS_CANVAS = (128, 256)
# the bilinear warp on the card against the CPU (mixup's scale jitter, the
# affine): the same float32 formula, whose last bits the card's kernels may
# round otherwise; gathers and blends are held bit for bit
WARP_IMAGE_TOL = 1e-4 * 255
WARP_BOX_TOL = 1e-3
# the 5-stage workflow on the card: the JAX package's recorded run (WORKFLOWS.md
# section 10) with stages 4 and 5 cut from 150 iterations to 50 and stage 2's
# AdaBN from 1400 batches to 64 (eight passes over its 16 images)
WORKFLOW_ARGS = ["--iters", "1000", "--retrain-iters", "50", "--adabn-batches", "64"]
FOGGY_TRAIN = "cityscapes_instancesonly_foggy_train_foggy_beta_0.02"
SPLICED = "cityscapes_instancesonly_foggy_train_adabn"


def wq_ops_card_vs_cpu(seed: int = SEED) -> dict:
    """mosaic_batch (content-aware), mixup_batch (content-aware with the
    companion flip, without and with the scale jitter) and
    random_affine_batch on the card and on the CPU, at 128x256 with 4
    images whose content is smaller than the canvas, from the same draws.
    -> {op: (max image difference, max box difference, masks equal)}."""
    rs = np.random.RandomState(seed)
    b, n = 4, 16
    h, w = WQ_OPS_CANVAS
    sizes = np.asarray([(120, 250), (128, 256), (100, 200), (90, 256)], np.int32)
    images = rs.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    for i, (sh, sw) in enumerate(sizes):
        images[i, sh:] = 0
        images[i, :, sw:] = 0
    xy = rs.uniform(0, 1, (b, n, 2)) * (sizes[:, None, ::-1] - 20)
    boxes = np.concatenate([xy, np.minimum(xy + rs.uniform(3, 60, (b, n, 2)), sizes[:, None, ::-1])], -1)
    gt = (boxes.astype(np.float32), rs.uniform(0.5, 1, (b, n)).astype(np.float32), rs.randint(0, 8, (b, n)).astype(np.int32),
          rs.uniform(size=(b, n)) < 0.8)
    g = torch.Generator().manual_seed(seed)
    u = {k: torch.rand(shape, generator=g) for k, shape in
         (("centre", (b, 2)), ("affine", (b, 6)), ("jitter", (b,)), ("offset", (b, 2)), ("crop", (b, 2)))}
    flip = torch.tensor([True, False, True, False])

    def run(dev):
        t = lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(dev)  # noqa: E731
        im, sz, inst = t(images), t(sizes), Instances(*(t(a) for a in gt))
        d = {k: v.to(dev) for k, v in u.items()}
        return {
            "mosaic": mosaic.mosaic_batch(d["centre"], im, inst, sizes=sz),
            "mixup": mosaic.mixup_batch(im, inst, flip=t(flip), crop=d["crop"], sizes=sz),
            "mixup_jitter": mosaic.mixup_batch(im, inst, flip=t(flip), scale_jitter=(0.5, 1.5), jitter=d["jitter"],
                                               jitter_offset=d["offset"], crop=d["crop"], sizes=sz),
            "affine": mosaic.random_affine_batch(d["affine"], im, inst),
        }

    cpu, card = run("cpu"), run("cuda")
    out = {}
    for k, (im_c, gt_c) in cpu.items():
        im_g, gt_g = card[k]
        out[k] = (float((im_g.cpu() - im_c).abs().max()), float((gt_g.boxes.cpu() - gt_c.boxes).abs().max()),
                  torch.equal(gt_g.valid.cpu(), gt_c.valid) and torch.equal(gt_g.scores.cpu(), gt_c.scores)
                  and torch.equal(gt_g.classes.cpu(), gt_c.classes))
    return out


def wq_ops_ok(err: dict) -> bool:
    """Gathers and blends bit-equal; the warp within its tolerance; masks,
    classes and scores equal."""
    exact = all(err[k][0] == 0.0 and err[k][1] == 0.0 for k in ("mosaic", "mixup"))
    warp = all(err[k][0] <= WARP_IMAGE_TOL and err[k][1] <= WARP_BOX_TOL for k in ("mixup_jitter", "affine"))
    return exact and warp and all(e[2] for e in err.values())


def wq_cfg(aug: str, out: str, weights: str, *opts: str):
    """A WQ YAML of configs/ with the phase's cuts, MODEL.WEIGHTS and OUTPUT_DIR."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, WQ_YAML.format(aug)), allow_new=True)
    cfg.merge_from_list([*WQ_OPTS, "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out, *opts])
    return cfg


def wq_run(cfg, smi: str, label: str) -> dict:
    """WQ_STEPS steps of the trainer of `cfg` on batches from its train
    loader (the spliced pseudo-GT, decoded from disk), each timed alone;
    finite losses, 4 launches of each kernel a step, the weights moved, a
    step under set_sync_debug_mode("error"), and one step and its
    augmentation alone under torch.profiler. -> the first step's NMS
    inputs (that step's wall includes the capture)."""
    tr = build_trainer(cfg)
    tr.resume_or_load()
    b = cfg.SOLVER.IMS_PER_BATCH
    check(b == 4 and tuple(cfg.TPU.CANVAS) == (608, 1216) and tr.det_cfg.dtype == torch.float32,
          f"{label}: batch {b}, canvas {cfg.TPU.CANVAS}, {tr.det_cfg.dtype}")
    before = {k: v.clone() for k, v in tr.state.model.named_parameters()}
    it = iter(tr.build_train_loader())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, wall, launches, captured = [], [], [], []
    orig, record = capture_nms(captured)
    for i in range(WQ_STEPS):
        batch = next(it)
        staged = tr.stage(batch)
        start = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms.nms_mask_matrix = record if i == 0 else orig  # the first step's NMS inputs
        try:
            m = tr.step_staged(staged)
        finally:
            nms.nms_mask_matrix = orig
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        launches.append({k: c - start[k] for k, c in _kernels.LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(x[k]) for x in metrics for k in TRAIN_LOSSES), f"{label}: losses {metrics}")
    check(all(c == b for d in launches for c in d.values()), f"{label}: launches a step {launches}, expected {b} of each")
    after = dict(tr.state.model.named_parameters())
    moved = sum(not torch.equal(after[k], v) for k, v in before.items())
    check(moved >= 0.9 * len(before), f"{label}: {moved} of {len(before)} parameters moved")
    # a step reads nothing back to the host
    staged = tr.stage(next(it))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.step_staged(staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # one step, and its augmentation alone on the same batch and draws
    wall_p, dev_p, kern_p, ops_p = profile(lambda: tr.step_staged(staged), 1)
    images, sizes, gt = staged
    draws = tr.make_draws(images.shape[0], tuple(images.shape[1:3]), gt.boxes.shape[1])
    imf = images.to(torch.float32)
    _, dev_a, kern_a, _ = profile(lambda: tr.augment(imf, sizes, gt, draws), 3)
    it.close()
    med = float(np.median(wall[1:]))
    log(f"  {label} ({tr.__class__.__name__}, aug {tr.aug}, batch {b}, 608x1216, float32) [{smi}]: step "
        f"{med:.2f} ms (median of steps 1-{WQ_STEPS - 1}; first {wall[0]:.1f} ms; {b * 1e3 / med:.2f} images/s), "
        f"peak {peak:.2f} GiB; total loss {[round(x['total_loss'], 4) for x in metrics]}; {moved}/{len(before)} "
        f"parameters moved; launches "
        f"{b} of each a step; a step under set_sync_debug_mode('error'); profiled step: wall {wall_p:.2f} ms, device "
        f"{dev_p:.2f} ms, busy {dev_p / wall_p:.1%}; augmentation alone {dev_a:.3f} ms on the device "
        f"({dev_a / dev_p:.1%} of the step's)")
    log(f"    top kernels of the step (ms): {top(kern_p)}")
    log(f"    top kernels of the augmentation (ms/call): {top(kern_a)}")
    del tr
    return captured


class PendingWorkflow:
    """run_workflow_synthetic on a thread of its own, in a directory of its
    own, started by the wq phase and ended by `finish` in the export phase,
    beside whose exports it runs."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory(prefix="sfod_workflow_")
        self.t0 = time.perf_counter()
        self.run = Background(run_workflow_synthetic.main, ["--root", self.tmp.name, *WORKFLOW_ARGS])

    def finish(self, smi: str) -> dict:
        """Wait, check and log it. -> its launches."""
        try:
            wf = self.run.result()
            wf_s = time.perf_counter() - self.t0
            n_wf = wf.summary["3_splice"]["pseudo_annotations"]
            check(n_wf > 0 and len(wf.summary) == 5, f"workflow summary {wf.summary}")
            total = {k: sum(d[k] for d in wf.launches.values()) for k in _kernels.LAUNCHES}
            log(f"  run_workflow_synthetic {' '.join(WORKFLOW_ARGS)} (from the wq phase, beside its WQ CLI and "
                f"checks and the export runs) [{smi}]: {wf_s:.2f} s, every stage exit 0, {n_wf} pseudo-GT boxes "
                f"spliced")
            for stage, wall in wf.walls.items():
                ap = ", ".join(f"{k} {v}" for k, v in wf.summary[stage].items())
                log(f"    {stage}: {ap}; {wall:.2f} s")
            return total
        finally:
            self.close()

    def close(self) -> None:
        self.run.join()
        self.tmp.cleanup()


def wq_phase(smi: str):
    """The wq phase (module docstring). -> (the launches of each kernel on
    the path in this phase, the workflow it leaves running)."""
    total = {k: 0 for k in _kernels.LAUNCHES}
    workflow = None

    def add(d):
        for k in total:
            total[k] += d[k]

    tmp = tempfile.TemporaryDirectory(prefix="sfod_wq_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    captured = {}
    try:
        t0 = time.perf_counter()
        write_cli_datasets(data_root)
        register_cli_datasets(data_root)
        weights = os.path.join(root, "source.pth")
        write_cli_weights(weights)
        log(f"  wrote {CLI_TRAIN_FRAMES} {FRAME_HW[0]}x{FRAME_HW[1]} PNG frames, their COCO JSONs and a seeded "
            f".pth in {time.perf_counter() - t0:.2f} s")
        # the pseudo-GT: an AdaBN model's detections on the foggy train split, spliced
        _kernels.reset_launches()
        adabn_out = os.path.join(root, "adabn")
        cfg = wq_cfg("wq", adabn_out, weights, "DATASETS.TRAIN", f"('{FOGGY_TRAIN}',)", "DATASETS.TEST", f"('{FOGGY_TRAIN}',)")
        tr = build_trainer(cfg)
        tr.resume_or_load()
        t0 = time.perf_counter()
        res = tr.adabn_refinement(max_batches=WQ_ADABN_BATCHES)[FOGGY_TRAIN]
        adabn_s = time.perf_counter() - t0
        del tr
        got = dict(_kernels.LAUNCHES)
        add(got)
        check(all(c == 2 * CLI_TRAIN_FRAMES for c in got.values()), f"AdaBN dump: launches {got}")
        ann = os.path.join(data_root, "cityscapes_foggy", "annotations", "instancesonly_filtered_gtFine_{}.json")
        n_pseudo = prediction_to_gt.main(["--predictions", os.path.join(adabn_out, "inference", "coco_instances_results.json"),
                                          "--annotations", ann.format("train_foggy_beta_0.02"),
                                          "--output", ann.format("train_adabn")])
        check(n_pseudo > 0, "the splice found no detection at score 0.7")
        register_dataset(SPLICED, ann.format("train_adabn"), os.path.join(data_root, "cityscapes_foggy"),
                         CITYSCAPES_THING_CLASSES)
        log(f"  AdaBN ({WQ_ADABN_BATCHES} batches) and test() on the foggy train split in {adabn_s:.2f} s (AP50 "
            f"{res['AP50']:.4f}); prediction_to_gt spliced {n_pseudo} pseudo-GT boxes at 0.7 into {SPLICED}")

        # the four YAMLs, and mosaic with the affine, in this process
        _kernels.reset_launches()
        for aug, opts in [(a, ()) for a in WQ_AUGS] + [("mosaic", ("INPUT.MOSAIC.RANDOM_AFFINE", "True"))]:
            label = aug + ("+affine" if opts else "")
            cfg = wq_cfg(aug, os.path.join(root, label), weights, *opts)
            check(cfg.DATASETS.TRAIN == (SPLICED,), f"{label}: DATASETS.TRAIN {cfg.DATASETS.TRAIN}")
            captured[label] = wq_run(cfg, smi, label)
        add(dict(_kernels.LAUNCHES))

        # the 5-stage workflow through the port's CLIs, in the background
        # beside the WQ CLI and the checks below, which are not timed, and
        # the export phase's exports
        workflow = PendingWorkflow()

        # one YAML through the CLI
        out = os.path.join(root, "cli")
        argv = ["--config-file", os.path.join(ROOT, WQ_YAML.format(WQ_CLI_AUG)), *WQ_OPTS, "MODEL.WEIGHTS", weights,
                "OUTPUT_DIR", out, "SOLVER.MAX_ITER", str(WQ_CLI_ITERS), "TEST.EVAL_PERIOD", str(WQ_CLI_ITERS)]
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "simple_sfod_tpu_torch.tools.train_net", *argv], cwd=ROOT,
                             env=cli_env(data_root), capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        cli_s = time.perf_counter() - t1
        check(res.returncode == 0, f"WQ CLI: exit code {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        got = cli_launches(res.stdout)
        add(got)
        # 4 a step, 2 an image of the two TEST sets in test(), 1 for the
        # validation loss's one batch of one image (TEST.IMS_PER_BATCH 1)
        want = 4 * WQ_CLI_ITERS + 2 * 2 * CLI_TEST_FRAMES + 1
        check(all(c == want for c in got.values()), f"WQ CLI: launches {got}, expected {want} of each")
        lines = metrics_lines(out)
        check(lines and lines[-1]["iteration"] == WQ_CLI_ITERS - 1 and np.isfinite(lines[-1]["total_loss"]),
              f"WQ CLI metrics.json: {lines[-1:]}")
        with open(os.path.join(out, "eval_results.json")) as f:
            ev = json.load(f)
        check(len(ev) == 2 and all(np.isfinite(v["AP50"]) for v in ev.values()), f"WQ CLI eval_results.json: {ev}")
        check(os.path.exists(os.path.join(out, "model_final.pth")), "WQ CLI: no model_final.pth")
        log(f"  train_net on {WQ_YAML.format(WQ_CLI_AUG)} ({WQ_CLI_ITERS} steps, test() at {WQ_CLI_ITERS}) [{smi}]: "
            f"{cli_s:.2f} s, total loss {lines[-1]['total_loss']:.4f}, AP50 "
            f"{[round(v['AP50'], 4) for v in ev.values()]}, launches {got}")

        # each run's first-step NMS inputs (the train-mode RPN of each image):
        # kernels against the plain versions, after the count was taken
        for label, calls in captured.items():
            check(len(calls) == 4, f"{label}: {len(calls)} NMS calls captured in a step")
            kept = [check_kernels_against_plain(b, s, v, thr, f"{label} image {i}", cpu=i == 0)
                    for i, (b, s, v, thr) in enumerate(calls)]
            log(f"  {label}: the step's 4 RPN NMS inputs (N {[int(c[0].shape[0]) for c in calls]}), kernels bit-equal "
                f"to the plain versions, kept {kept}")
        err = wq_ops_card_vs_cpu()
        log(f"  card vs CPU at {WQ_OPS_CANVAS[0]}x{WQ_OPS_CANVAS[1]}, 4 images, content < canvas (max image / box "
            f"difference, masks equal): " + "; ".join(f"{k} {e[0]:.3g} / {e[1]:.3g} / {e[2]}" for k, e in err.items()) +
            f" (mosaic and mixup held to 0, the warp to {WARP_IMAGE_TOL:.4g} / {WARP_BOX_TOL:g})")
        check(wq_ops_ok(err), f"mosaic/mixup/affine on the card differ from the CPU's: {err}")

    except BaseException:
        if workflow is not None:
            workflow.close()
        raise
    finally:
        tmp.cleanup()
    log(f"  launches on the wq path in this phase: {total} (the workflow's are added when it ends)")
    return total, workflow


# ---------------------------------------------------------------------------
# car: the paper's car-only source domains (Sim10k -> Cityscapes and
# KITTI -> Cityscapes) through the CLIs, from JPEG and PNG files on disk
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(ROOT, "tests", "torch_jpeg")
CONTAINER_FIXTURES = os.path.join(ROOT, "tests", "torch_containers")
WEBP_FIXTURES = os.path.join(ROOT, "tests", "torch_webp")
TIFF_FIXTURES = os.path.join(ROOT, "tests", "torch_tiff")
RASTER_FIXTURES = os.path.join(ROOT, "tests", "torch_raster")
# the Sim10k frame as TIFF, timed beside the baseline JPEG: committed
# fixtures (tests/test_torch_tiff.py writes them; the LZMA and ZSTD files
# are the frame's central 960x528 crop) and files this script writes
# (TIFF_WRITTEN), each held to Pillow's digest in fixtures.json
TIFF_FRAMES = {"JPEG YCbCr 4:2:0, 16-row strips": "sim10k_frame_0_jpeg.tif", "Group 4": "sim10k_frame_0_g4.tif",
               "YCbCr 2x2 PackBits": "sim10k_frame_0_ycbcr22_packbits.tif",
               "old-style JPEG": "sim10k_frame_0_ojpeg.tif",
               "LZMA 960x528 crop, predictor 2": "sim10k_crop_lzma_pred2.tif",
               "ZSTD 960x528 crop, predictor 2": "sim10k_crop_zstd_pred2.tif"}
# the crops' decoded bytes, for their MB/s
TIFF_CROP_BYTES = 528 * 960 * 3
# the Sim10k frame as WebP (tests/test_torch_webp.py writes them): timed
# beside the baseline JPEG and read by test() beside their PNG twins
WEBP_FRAMES = {"lossy q80": "sim10k_frame_0_q80.webp", "lossy + ALPH": "sim10k_frame_0_alpha.webp",
               "lossless 957x526 crop": "sim10k_crop_lossless.webp"}
# the TIFF compressions timed and decoded on the card
TIFF_CODES = {"uncompressed": 1, "PackBits": 32773, "LZW": 5, "Deflate": 8}
SMOOTHED_SCANS = 6  # scans of the progressive Sim10k frame kept for the block-smoothed timing
# each source domain: its source YAML, its adaptation YAML, its frames and
# the YAML's canvas; Sim10k's frames are the committed 1914x1052 JPEG
# fixtures, KITTI's seeded PNGs at KITTI's ~1242x375
CAR_DOMAINS = {
    "sim10k": dict(source="configs/faster_rcnn_VGG_sim10k_source.yaml",
                   adapt="configs/faster_rcnn_VGG_sim10k_to_cityscapes_source_free.yaml", hw=(1052, 1914),
                   canvas=(608, 1120)),
    "kitti": dict(source="configs/faster_rcnn_VGG_kitti_source.yaml",
                  adapt="configs/faster_rcnn_VGG_kitti_to_cityscapes_source_free.yaml", hw=(375, 1242),
                  canvas=(608, 2016)),
}
CAR_FRAMES = 16  # source-domain records written
KITTI_ADAM7 = (1, 3)  # the KITTI frames written Adam7-interlaced
KITTI_16BIT = (2, 3)  # and at 16 bits a sample
CAR_TEST_FRAMES = 4  # cityscapes_car_val frames (the cli phase's 1024x2048 PNGs)
CAR_TARGET_FRAMES = 8  # cityscapes_instancesonly_train frames, the adaptation's target
CAR_BATCH = 4  # the source runs' IMS_PER_BATCH
CAR_STEPS = 6  # steps of the in-process timed source run (the first excluded from the median)
CAR_ITERS = 4  # steps of each CLI run, test() after the last
CAR_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0", "VIS_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "100000"]
# the layers that a 1-class source model cannot give an 8-class one: the
# loader skips their weights on the shape mismatch and keeps the fresh init
CAR_SKIPPED = {"roi_heads.box_predictor.cls_score.weight", "roi_heads.box_predictor.cls_score.bias",
               "roi_heads.box_predictor.bbox_pred.weight", "roi_heads.box_predictor.bbox_pred.bias"}


def jpeg_fixtures(directory: str = JPEG_FIXTURES) -> dict:
    """<directory>/fixtures.json: each committed image's shape, kind and the
    SHA-256 of the RGB that Pillow decodes from it (tests/torch_jpeg/ and
    tests/torch_containers/)."""
    with open(os.path.join(directory, "fixtures.json")) as f:
        return json.load(f)


def check_jpeg_fixtures() -> dict:
    """Each committed JPEG, BMP, GIF, TIFF, WebP, Netpbm, DIB, ICO, CUR,
    QOI, SGI, PCX, DCX and TGA fixture decoded by the
    port's codec on this host, its RGB's SHA-256 equal to Pillow's recorded
    one. -> {name: kind} of the files checked."""
    import hashlib

    done = {}
    for directory in (JPEG_FIXTURES, CONTAINER_FIXTURES, WEBP_FIXTURES, TIFF_FIXTURES, RASTER_FIXTURES):
        for name, rec in sorted(jpeg_fixtures(directory).items()):
            if not rec.get("committed", True):
                continue  # a file this script writes (write_tiff_frames)
            rgb = native_codec.decode(os.path.join(directory, name))
            check(list(rgb.shape) == rec["shape"] and hashlib.sha256(rgb.tobytes()).hexdigest() == rec["sha256"],
                  f"{name}: decode differs from Pillow's recorded digest")
            done[name] = rec.get("sampling") or rec["kind"]
    return done


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """A 24-bit BI_RGB BMP of rgb [H, W, 3]: BITMAPINFOHEADER, rows
    bottom-up in BGR, padded to 4 bytes."""
    h, w, _ = rgb.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, -1)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()


def tiff_strip(raw: bytes, compression: int) -> bytes:
    """One strip coded as TIFF compression 1, 32773 (PackBits: literal runs
    of 128 bytes), 5 (LZW: a 9-bit code a byte, a clear code every 250,
    MSB first) or 8 (Deflate)."""
    if compression == 32773:
        return b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128] for i in range(0, len(raw), 128))
    if compression == 8:
        return zlib.compress(raw, 1)
    if compression == 5:
        data = np.frombuffer(raw, np.uint8).astype(np.uint16)
        pad = -len(data) % 250
        body = np.concatenate([data, np.zeros(pad, np.uint16)]).reshape(-1, 250)
        codes = np.concatenate([np.full((len(body), 1), 256, np.uint16), body], axis=1).reshape(-1)
        codes = np.concatenate([codes[:len(codes) - pad], [257]]).astype(np.uint16)
        bits = ((codes[:, None] >> np.arange(8, -1, -1, dtype=np.uint16)) & 1).astype(np.uint8).reshape(-1)
        return np.packbits(bits).tobytes()
    return raw


def tiff_container(strips: list, tags: list) -> bytes:
    """A little-endian TIFF of `strips` (each stored as given) with the IFD
    `tags` [(tag, type 3 or 4, values)] and its StripOffsets and
    StripByteCounts."""
    offsets, body = [], bytearray(b"II*\x00\x00\x00\x00\x00")
    for st in strips:
        offsets.append(len(body))
        body += st + bytes(len(st) % 2)
    tags = sorted(tags + [(273, 4, offsets), (279, 4, [len(st) for st in strips])])
    ifd_at = len(body)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, extra = bytearray(struct.pack("<H", len(tags))), bytearray()
    for tag, typ, vals in tags:
        blob = struct.pack("<" + ("I" if typ == 4 else "H") * len(vals), *vals)
        if len(blob) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + blob.ljust(4, b"\x00")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += blob
    body[4:8] = struct.pack("<I", ifd_at)
    return bytes(body + ifd + b"\x00\x00\x00\x00" + extra)


def tiff_bytes(rgb: np.ndarray, compression: int, rows: int = 64, orientation: int = 1) -> bytes:
    """An 8-bit chunky RGB TIFF (little-endian) of rgb [H, W, 3] in strips of
    `rows` rows, each coded by tiff_strip, with an Orientation tag unless 1."""
    h, w, _ = rgb.shape
    strips = [tiff_strip(rgb[y:y + rows].tobytes(), compression) for y in range(0, h, rows)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [compression]), (262, 3, [2]),
            (277, 3, [3]), (278, 4, [rows]), (284, 3, [1])]
    return tiff_container(strips, tags + ([(274, 3, [orientation])] if orientation != 1 else []))


def jpeg_tiff_bytes(jpeg: bytes) -> bytes:
    """A baseline JPEG file as a JPEG-compressed TIFF of one strip
    (compression 7, YCbCr, YCbCrSubsampling from the frame header): libtiff
    reads the whole stream, its tables included, as the strip."""
    at = next(i for i in range(2, len(jpeg) - 1) if jpeg[i] == 0xFF and jpeg[i + 1] in (0xC0, 0xC1))
    h, w = struct.unpack(">HH", jpeg[at + 5:at + 9])
    factors = jpeg[at + 11]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [7]), (262, 3, [6]), (277, 3, [3]),
            (278, 4, [h]), (284, 3, [1]), (530, 3, [factors >> 4, factors & 15])]
    return tiff_container([jpeg], tags)


def ojpeg_tiff_bytes(jpeg: bytes) -> bytes:
    """A baseline JPEG file as an old-style JPEG TIFF (compression 6) of
    one strip, with no encoder: the file stored once, named by
    JPEGInterchangeFormat (513, 514) and by the strip, which starts at the
    stream's start (libtiff's tif_ojpeg.c reads the markers there and the
    scan after them); YCbCr, YCbCrSubsampling from the frame header."""
    at = next(i for i in range(2, len(jpeg) - 1) if jpeg[i] == 0xFF and jpeg[i + 1] in (0xC0, 0xC1))
    h, w = struct.unpack(">HH", jpeg[at + 5:at + 9])
    factors = jpeg[at + 11]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [6]), (262, 3, [6]), (277, 3, [3]),
            (278, 4, [h]), (284, 3, [1]), (513, 4, [8]), (514, 4, [len(jpeg)]), (530, 3, [factors >> 4, factors & 15])]
    return tiff_container([jpeg], tags)


def ycbcr_tiff_bytes(rgb: np.ndarray, rows: int = 64) -> bytes:
    """rgb [H, W, 3] as a YCbCr TIFF subsampled 2x2 (photometric 6,
    YCbCrSubsampling 2 2), PackBits, in strips of `rows` rows: each 2x2 block
    a data unit of its four Y samples and its mean Cb and Cr, by integer BT.601
    arithmetic (edges replicated to whole blocks)."""
    h, w, _ = rgb.shape
    p = np.pad(rgb.astype(np.int64), ((0, -h % 2), (0, -w % 2), (0, 0)), mode="edge")
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = np.clip((77 * r + 150 * g + 29 * b + 128) >> 8, 0, 255)
    cb = np.clip(((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128, 0, 255)
    cr = np.clip(((128 * r - 107 * g - 21 * b + 128) >> 8) + 128, 0, 255)
    hh, ww = p.shape[0] // 2, p.shape[1] // 2

    def mean(c):
        return (c.reshape(hh, 2, ww, 2).sum(axis=(1, 3)) + 2) >> 2

    units = np.concatenate([y.reshape(hh, 2, ww, 2).transpose(0, 2, 1, 3).reshape(hh, ww, 4), mean(cb)[..., None],
                            mean(cr)[..., None]], axis=2).astype(np.uint8)
    strips = [tiff_strip(units[y0 // 2:(y0 + rows) // 2].tobytes(), 32773) for y0 in range(0, h, rows)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [32773]), (262, 3, [6]), (277, 3, [3]),
            (278, 4, [rows]), (284, 3, [1]), (530, 3, [2, 2])]
    return tiff_container(strips, tags)


def jpeg_first_scans(data: bytes, keep: int) -> bytes:
    """A progressive JPEG cut before its scan keep + 1, then EOI: the
    decoder (libjpeg-turbo's, and the port's) smooths what the first scans
    leave unrefined."""
    at = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:at[keep]] + b"\xff\xd9"


# ---- the Sim10k frame as Netpbm, DIB, QOI, SGI, PCX and TGA, written here (the
# card's machine has no Pillow); each writer is vectorised, a few hundred ms
# at 1914x1052


def ppm_bytes(rgb: np.ndarray) -> bytes:
    """A raw PPM (P6, maxval 255) of rgb [H, W, 3]."""
    h, w, _ = rgb.shape
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def pgm16_values(rgb: np.ndarray) -> np.ndarray:
    """The 16-bit grey samples pgm16_bytes stores: twice the frame's luma,
    0..510, so that Pillow's mode I clips about half of them at 255."""
    c = rgb.astype(np.int64)
    luma = (c[..., 0] * 299 + c[..., 1] * 587 + c[..., 2] * 114 + 500) // 1000
    return (2 * luma).astype(np.uint16)


def pgm16_bytes(rgb: np.ndarray) -> bytes:
    """A raw PGM (P5, maxval 65535: Pillow reads it as I;16B) of
    pgm16_values(rgb)."""
    h, w, _ = rgb.shape
    return b"P5\n%d %d\n65535\n" % (w, h) + pgm16_values(rgb).astype(">u2").tobytes()


def dib_bytes(rgb: np.ndarray) -> bytes:
    """bmp_bytes without its 14-byte file header: a DIB."""
    return bmp_bytes(rgb)[14:]


def _variable_ops(keys: np.ndarray, ops: np.ndarray, lens: np.ndarray) -> bytes:
    """The first lens[i] bytes of each row of ops [n, k], in the order of keys."""
    order = np.argsort(keys, kind="stable")
    ops, lens = ops[order], lens[order]
    return ops[np.arange(ops.shape[1])[None, :] < lens[:, None]].tobytes()


def qoi_bytes(rgb: np.ndarray) -> bytes:
    """A QOI file (3 channels) of rgb: QOI_OP_RUN over repeats of the
    previous pixel (62 at most an op), QOI_OP_DIFF, QOI_OP_LUMA or
    QOI_OP_RGB otherwise (this writer leaves the index op out)."""
    h, w, _ = rgb.shape
    px = rgb.reshape(-1, 3).astype(np.int16)
    prev = np.vstack([np.zeros((1, 3), np.int16), px[:-1]])
    same = np.all(px == prev, axis=1)
    d = (px - prev + 128) % 256 - 128
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    is_diff = np.all((d >= -2) & (d <= 1), axis=1)
    is_luma = ~is_diff & (dg >= -32) & (dg <= 31) & (dr - dg >= -8) & (dr - dg <= 7) & (db - dg >= -8) & (db - dg <= 7)
    ops = np.zeros((len(px), 4), np.uint8)
    lens = np.full(len(px), 4, np.int64)
    ops[:, 0] = 0xFE
    ops[:, 1:] = px
    ops[is_luma, 0] = (0x80 | (dg + 32))[is_luma]
    ops[is_luma, 1] = (((dr - dg + 8) << 4) | (db - dg + 8))[is_luma]
    lens[is_luma] = 2
    ops[is_diff, 0] = (0x40 | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2))[is_diff]
    lens[is_diff] = 1
    keep = ~same
    # the runs: each block of repeats coded 62 pixels an op
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    n_ops = -(-(ends - starts) // 62)
    run_start = np.repeat(starts, n_ops) + 62 * (np.arange(n_ops.sum()) - np.repeat(np.cumsum(n_ops) - n_ops, n_ops))
    run_len = np.minimum(62, np.repeat(ends, n_ops) - run_start)
    run_ops = np.zeros((len(run_start), 4), np.uint8)
    run_ops[:, 0] = 0xC0 | (run_len - 1)
    body = _variable_ops(np.concatenate([np.flatnonzero(keep), run_start]), np.concatenate([ops[keep], run_ops]),
                         np.concatenate([lens[keep], np.ones(len(run_start), np.int64)]))
    return b"qoif" + struct.pack(">IIBB", w, h, 3, 0) + body + bytes(7) + b"\x01"


def _chunked_rows(rows: np.ndarray, k: int, head) -> np.ndarray:
    """Each row of rows [n, m] as literal chunks of up to k samples, each
    after its header byte head(count) -> [n, bytes]."""
    n, m = rows.shape
    full, rest = divmod(m, k)
    parts = []
    for c in range(full + (rest > 0)):
        cnt = min(k, m - c * k)
        parts += [np.full((n, 1), head(cnt), np.uint8), rows[:, c * k:c * k + cnt]]
    return np.concatenate(parts, axis=1)


def sgi_rle_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB SGI file, RLE: each row of each channel (bottom row
    first) as copy chunks of up to 127 samples and a zero chunk, after the
    offset and length tables."""
    h, w, _ = rgb.shape
    planes = np.ascontiguousarray(rgb[::-1].transpose(2, 0, 1)).reshape(3 * h, w)
    rows = np.concatenate([_chunked_rows(planes, 127, lambda c: 0x80 | c), np.zeros((3 * h, 1), np.uint8)], axis=1)
    n = rows.shape[1]
    head = struct.pack(">HBBHHHH", 474, 1, 1, 3, w, h, 3).ljust(512, b"\x00")
    first = 512 + 8 * 3 * h
    tables = np.concatenate([first + n * np.arange(3 * h), np.full(3 * h, n)]).astype(">u4")
    return head + tables.tobytes() + rows.tobytes()


def pcx_bytes(rgb: np.ndarray) -> bytes:
    """A PCX (version 5, 8 bits x 3 planes) of rgb: each line the R, G and B
    planes, each byte of 0xC0 or above coded as a run of one, the rest as
    literals."""
    h, w, _ = rgb.shape
    stride = w + w % 2
    lines = np.zeros((h, 3, stride), np.uint8)
    lines[:, :, :w] = rgb.transpose(0, 2, 1)
    flat = lines.reshape(-1)
    hi = flat >= 0xC0
    lens = 1 + hi.astype(np.int64)
    ends = np.cumsum(lens)
    out = np.empty(ends[-1], np.uint8)
    out[(ends - lens)[hi]] = 0xC1
    out[ends - 1] = flat
    head = bytearray(128)
    head[0:4] = bytes([10, 5, 1, 8])
    struct.pack_into("<HHHHHH", head, 4, 0, 0, w - 1, h - 1, 72, 72)
    head[65] = 3
    struct.pack_into("<HH", head, 66, stride, 1)
    return bytes(head) + out.tobytes()


def tga_rle_bytes(rgb: np.ndarray) -> bytes:
    """A 24-bit run-length TGA (type 10, bottom row first) of rgb: each row
    as literal packets of up to 128 pixels."""
    h, w, _ = rgb.shape
    rows = np.ascontiguousarray(rgb[::-1, :, ::-1]).reshape(h, w, 3)
    parts = []
    for c in range(0, w, 128):
        cnt = min(128, w - c)
        parts += [np.full((h, 1), cnt - 1, np.uint8), rows[:, c:c + cnt].reshape(h, -1)]
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0) + np.concatenate(parts, 1).tobytes()


# the raster forms timed on the card: kind -> writer
RASTER_WRITERS = {"PPM raw": ppm_bytes, "PGM 16-bit": pgm16_bytes, "DIB": dib_bytes, "QOI": qoi_bytes,
                  "SGI RLE": sgi_rle_bytes, "PCX 8-bit x 3 planes": pcx_bytes, "TGA RLE": tga_rle_bytes}


def decode_resize_ms(path: str, reps: int = 5) -> tuple:
    """Median ms of one decode, and of decode + the shortest-edge-600 resize,
    of a file on this thread."""
    dec, both = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        rgb = native_codec.decode(path)
        t1 = time.perf_counter()
        native_codec.resize_bilinear(rgb, *d2_output_shape(*rgb.shape[:2], 600, 2016))
        t2 = time.perf_counter()
        dec.append((t1 - t0) * 1e3)
        both.append((t2 - t0) * 1e3)
    return float(np.median(dec)), float(np.median(both))


def write_format_frames(directory: str) -> dict:
    """The Sim10k frame (sim10k_frame_0.jpg) in each new form under
    directory: arithmetic-coded (the committed transcoding), block-smoothed
    (its progressive file cut after SMOOTHED_SCANS scans), BMP and TIFF
    with each of TIFF_CODES; the BMP and TIFF files decoded back to the
    frame, the arithmetic one to the frame's pixels. -> {kind: path}."""
    os.makedirs(directory)
    frame = native_codec.decode(os.path.join(JPEG_FIXTURES, "sim10k_frame_0.jpg"))
    out = {"arithmetic JPEG": os.path.join(JPEG_FIXTURES, "arithmetic_sim10k_frame_0.jpg")}
    with open(os.path.join(JPEG_FIXTURES, "sim10k_frame_0_progressive.jpg"), "rb") as f:
        files = {"smoothed JPEG": jpeg_first_scans(f.read(), SMOOTHED_SCANS), "BMP": bmp_bytes(frame),
                 **{f"TIFF {k}": tiff_bytes(frame, c) for k, c in TIFF_CODES.items()}}
    for kind, data in files.items():
        out[kind] = os.path.join(directory, kind.replace(" ", "_"))
        with open(out[kind], "wb") as f:
            f.write(data)
    for kind, path in out.items():
        rgb = native_codec.decode(path)
        check(rgb.shape == frame.shape, f"{kind}: shape {rgb.shape}")
        if kind != "smoothed JPEG":
            check(np.array_equal(rgb, frame), f"{kind}: decode differs from the frame")
    return out


def twin_test(tr, d: str, label: str, pairs: list) -> tuple:
    """test() of trainer tr on two datasets of the same frames, `pairs`
    [(file of the first set, file of the second, (h, w))], their COCO
    files under d: both test loaders give the same batches, both dumps the
    same detections, 2 launches of each NMS kernel an image and set. ->
    (launches, detections, AP50 of each set, seconds)."""
    names = []
    for side in (0, 1):
        coco = {"images": [{"id": i + 1, "file_name": p[side], "height": p[2][0], "width": p[2][1]}
                           for i, p in enumerate(pairs)],
                "annotations": [{"id": i + 1, "image_id": i + 1, "category_id": 1, "bbox": [100.0, 200.0, 300.0, 150.0],
                                 "area": 45000.0, "iscrowd": 0} for i in range(len(pairs))],
                "categories": [{"id": 1, "name": "car"}]}
        path = os.path.join(d, f"{label}_{side}.json")
        with open(path, "w") as f:
            json.dump(coco, f)
        names.append(f"sim10k_{label}_{side}")
        register_dataset(names[-1], path, "/")
    batches = [list(build_test_loader(tr.cfg, n)) for n in names]
    check(len(batches[0]) == len(batches[1]) and all(
        np.array_equal(a["images"], b["images"]) and np.array_equal(a["scale"], b["scale"])
        for a, b in zip(*batches)), f"{label}: the two sets' batches differ")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = tr.test(names)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = dict(_kernels.LAUNCHES)
    check(all(c == 2 * 2 * len(pairs) for c in got.values()), f"{label} test(): launches {got}")
    dumps = []
    for n in names:
        with open(os.path.join(tr.output_dir, "inference", n, "coco_instances_results.json")) as f:
            dumps.append(sorted(json.load(f), key=lambda e: (e["image_id"], -e["score"], e["bbox"])))
    check(dumps[0] == dumps[1] and len(dumps[0]) > 0, f"{label} test(): detections differ "
          f"({len(dumps[0])} and {len(dumps[1])}, {match_dumps(*dumps)})")
    for n in names:
        DATASET_REGISTRY.pop(n, None)
    return got, len(dumps[0]), (res[names[0]]["AP50"], res[names[1]]["AP50"]), secs


def format_test(tr, formats: dict, root: str) -> tuple:
    """test() of trainer tr on the Sim10k frames 0, 1, 2 and 0 as the
    original JPEG files and rewritten (arithmetic-coded, BMP, TIFF LZW, TIFF
    PackBits), through twin_test. -> (launches, a line of numbers)."""
    frames = [native_codec.decode(os.path.join(JPEG_FIXTURES, f"sim10k_frame_{i}.jpg")) for i in range(3)]
    d = os.path.join(root, "formats")
    rewritten = [formats["arithmetic JPEG"], os.path.join(d, "f1.bmp"), os.path.join(d, "f2.tif"),
                 os.path.join(d, "f0.tif")]
    for path, data in zip(rewritten[1:], (bmp_bytes(frames[1]), tiff_bytes(frames[2], 5),
                                          tiff_bytes(frames[0], 32773))):
        with open(path, "wb") as f:
            f.write(data)
    originals = [os.path.join(JPEG_FIXTURES, f"sim10k_frame_{i}.jpg") for i in (0, 1, 2, 0)]
    hw = CAR_DOMAINS["sim10k"]["hw"]
    got, n, ap50, secs = twin_test(tr, d, "formats", [(o, r, hw) for o, r in zip(originals, rewritten)])
    line = (f"test() of the Sim10k source model (VGG16-BN, {tr.cfg.TPU.CANVAS[0]}x{tr.cfg.TPU.CANVAS[1]}) on "
            f"{len(originals)} Sim10k frames as arithmetic JPEG, BMP, TIFF LZW and TIFF PackBits beside the original "
            f"JPEG files: batches equal, {n} detections equal (AP50 {ap50[0]:.4f} and {ap50[1]:.4f}), {secs:.2f} s "
            f"for both sets, launches {got}")
    return got, line


def webp_test(tr, root: str) -> tuple:
    """test() of trainer tr on 4 Sim10k records as the committed WebP
    frames (lossy, lossy + ALPH, the lossless crop, lossy) beside the same
    records as PNG files of the port's decoded pixels (encode_png), through
    twin_test. -> (launches, a line of numbers)."""
    d = os.path.join(root, "webp")
    os.makedirs(d)
    kinds = ("lossy q80", "lossy + ALPH", "lossless 957x526 crop", "lossy q80")
    got, n, ap50, secs = twin_test(tr, d, "webp", png_twins(d, [os.path.join(WEBP_FIXTURES, WEBP_FRAMES[k])
                                                                for k in kinds]))
    line = (f"test() of the Sim10k source model on 4 Sim10k records as WebP (lossy q80, lossy + ALPH, lossless "
            f"957x526 crop, lossy q80) beside their PNG twins: batches equal, {n} detections equal (AP50 "
            f"{ap50[0]:.4f} and {ap50[1]:.4f}), {secs:.2f} s for both sets, launches {got}")
    return got, line


# the TIFF_FRAMES files this script writes from sim10k_frame_0.jpg's bytes
TIFF_WRITTEN = {"sim10k_frame_0_ycbcr22_packbits.tif": lambda jpeg: ycbcr_tiff_bytes(native_codec.decode_bytes(jpeg)),
                "sim10k_frame_0_ojpeg.tif": ojpeg_tiff_bytes}


def write_tiff_frames(directory: str) -> dict:
    """TIFF_FRAMES: the committed fixtures, and the TIFF_WRITTEN frames
    written here, each decode held to Pillow's recorded digest. ->
    {kind: path}."""
    import hashlib

    os.makedirs(directory)
    record = jpeg_fixtures(TIFF_FIXTURES)
    out = {}
    for kind, name in TIFF_FRAMES.items():
        out[kind] = os.path.join(TIFF_FIXTURES, name)
        if not record[name]["committed"]:
            with open(os.path.join(JPEG_FIXTURES, "sim10k_frame_0.jpg"), "rb") as f:
                data = TIFF_WRITTEN[name](f.read())
            out[kind] = os.path.join(directory, name)
            with open(out[kind], "wb") as f:
                f.write(data)
        rgb = native_codec.decode(out[kind])
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == record[name]["sha256"],
              f"{name}: decode differs from Pillow's recorded digest")
    return out


def tiff_test(tr, root: str) -> tuple:
    """test() of trainer tr on 8 Sim10k records as TIFF beside PNG twins of
    the port's decoded pixels (encode_png), through twin_test: frames 0, 1,
    2, 0 as JPEG-compressed TIFF (the committed 16-row-strip fixture, then
    each committed JPEG file as the one strip of a YCbCr JPEG TIFF) and as
    LZW RGB TIFF with Orientation 6 (read turned, 1914 rows by 1052).
    -> (launches, a line of numbers)."""
    d = os.path.join(root, "tiff")
    os.makedirs(d)
    frames = [os.path.join(JPEG_FIXTURES, f"sim10k_frame_{i}.jpg") for i in (0, 1, 2, 0)]
    files = [os.path.join(TIFF_FIXTURES, TIFF_FRAMES["JPEG YCbCr 4:2:0, 16-row strips"])]
    for i, src in enumerate(frames[1:], 1):
        with open(src, "rb") as f:
            files.append(os.path.join(d, f"jpeg_{i}.tif"))
            data = jpeg_tiff_bytes(f.read())
        with open(files[-1], "wb") as f:
            f.write(data)
    for i, src in enumerate(frames):
        files.append(os.path.join(d, f"orientation6_{i}.tif"))
        with open(files[-1], "wb") as f:
            f.write(tiff_bytes(native_codec.decode(src), 5, orientation=6))
    pairs = png_twins(d, files)
    check(pairs[4][2] == CAR_DOMAINS["sim10k"]["hw"][::-1], f"Orientation 6 read as {pairs[4][2]}")
    got, n, ap50, secs = twin_test(tr, d, "tiff", pairs)
    line = (f"test() of the Sim10k source model on 8 Sim10k records as TIFF (frames 0, 1, 2, 0 JPEG-compressed, "
            f"and LZW with Orientation 6, read as 1914x1052 portraits) beside their PNG twins: batches equal, {n} "
            f"detections equal (AP50 {ap50[0]:.4f} and {ap50[1]:.4f}), {secs:.2f} s for both sets, launches {got}")
    return got, line


def png_twins(d: str, files: list) -> list:
    """[(file, a PNG of the port's decoded pixels of it (encode_png), (h,
    w))] for twin_test, each twin decoded back to its file's pixels and
    image_size held to the decode's size."""
    pairs = []
    for i, path in enumerate(files):
        rgb = native_codec.decode(path)
        twin = os.path.join(d, f"twin_{i}_{os.path.basename(path)}.png")
        with open(twin, "wb") as f:
            f.write(native_codec.encode_png(rgb, level=1))
        check(np.array_equal(native_codec.decode(twin), rgb), f"{path}: PNG twin differs")
        check(native_codec.image_size(path) == rgb.shape[:2], f"{path}: image_size {native_codec.image_size(path)}")
        pairs.append((path, twin, rgb.shape[:2]))
    return pairs


def tiff_codec_test(tr, root: str) -> list:
    """test() of trainer tr, through twin_test, on Sim10k frames 0, 1, 2, 0
    as old-style JPEG TIFF (each committed JPEG file wrapped by
    ojpeg_tiff_bytes) and on 2 records as the committed LZMA and ZSTD crops,
    each set beside PNG twins of the port's decoded pixels. -> [(launches,
    a line of numbers)] a set."""
    d = os.path.join(root, "tiff_codecs")
    os.makedirs(d)
    files = []
    for i in (0, 1, 2, 0):
        files.append(os.path.join(d, f"ojpeg_{len(files)}_{i}.tif"))
        with open(os.path.join(JPEG_FIXTURES, f"sim10k_frame_{i}.jpg"), "rb") as f:
            data = ojpeg_tiff_bytes(f.read())
        with open(files[-1], "wb") as f:
            f.write(data)
    crops = [os.path.join(TIFF_FIXTURES, TIFF_FRAMES[k]) for k in TIFF_FRAMES if "crop" in k]
    out = []
    for label, what, paths in (("ojpeg", "frames 0, 1, 2, 0 as old-style JPEG TIFF", files),
                               ("lzma_zstd", "the 960x528 crop as LZMA and as ZSTD TIFF, predictor 2", crops)):
        got, n, ap50, secs = twin_test(tr, d, label, png_twins(d, paths))
        out.append((got, f"test() of the Sim10k source model on {len(paths)} Sim10k records, {what}, beside their "
                         f"PNG twins: batches equal, {n} detections equal (AP50 {ap50[0]:.4f} and {ap50[1]:.4f}), "
                         f"{secs:.2f} s for both sets, launches {got}"))
    return out


def write_raster_frames(directory: str) -> dict:
    """The Sim10k frame in each RASTER_WRITERS form under directory, each
    decoded back to the frame (the 16-bit PGM to its samples clipped at 255,
    as Pillow's mode I converts them). -> {kind: path}."""
    os.makedirs(directory)
    frame = native_codec.decode(os.path.join(JPEG_FIXTURES, "sim10k_frame_0.jpg"))
    out = {}
    for kind, write in RASTER_WRITERS.items():
        out[kind] = os.path.join(directory, kind.replace(" ", "_"))
        with open(out[kind], "wb") as f:
            f.write(write(frame))
        rgb = native_codec.decode(out[kind])
        want = np.repeat(np.minimum(pgm16_values(frame), 255).astype(np.uint8)[..., None], 3, 2) \
            if kind == "PGM 16-bit" else frame
        check(np.array_equal(rgb, want), f"{kind}: decode differs from the frame")
        check(native_codec.image_size(out[kind]) == frame.shape[:2], f"{kind}: image_size")
    return out


def raster_test(tr, root: str) -> tuple:
    """test() of trainer tr, through twin_test, on Sim10k frames 0, 1, 2, 0
    as raw PPM, QOI, PCX (8 bits x 3 planes) and RLE TGA beside PNG twins
    of their decoded pixels. -> (launches, a line of numbers)."""
    d = os.path.join(root, "raster")
    os.makedirs(d)
    files = []
    for i, (kind, write) in zip((0, 1, 2, 0), (("ppm", ppm_bytes), ("qoi", qoi_bytes), ("pcx", pcx_bytes),
                                               ("tga", tga_rle_bytes))):
        files.append(os.path.join(d, f"frame_{len(files)}_{i}.{kind}"))
        with open(files[-1], "wb") as f:
            f.write(write(native_codec.decode(os.path.join(JPEG_FIXTURES, f"sim10k_frame_{i}.jpg"))))
    got, n, ap50, secs = twin_test(tr, d, "raster", png_twins(d, files))
    line = (f"test() of the Sim10k source model on 4 Sim10k records as raw PPM, QOI, PCX and RLE TGA (frames 0, 1, "
            f"2, 0) beside their PNG twins: batches equal, {n} detections equal (AP50 {ap50[0]:.4f} and "
            f"{ap50[1]:.4f}), {secs:.2f} s for both sets, launches {got}")
    return got, line


def car_boxes(rng: np.random.RandomState, hw, k: int) -> list:
    """k seeded boxes (x1, y1, x2, y2) inside an hw frame, 24-320 px wide."""
    h, w = hw
    out = []
    for _ in range(k):
        bw, bh = rng.uniform(24, min(320, w / 3)), rng.uniform(16, min(200, h / 3))
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        out.append((round(x1, 1), round(y1, 1), round(x1 + bw, 1), round(y1 + bh, 1)))
    return out


def write_sim10k(root: str, n: int = CAR_FRAMES, seed: int = SEED) -> dict:
    """n Sim10k-style records under root/sim10k: JPEGImages/<id>.jpg copied
    in turn from the committed 1914x1052 fixture frames (three baseline, one
    progressive), Annotations/<id>.xml with
    seeded VOC boxes (cars, and a person and a motorbike that the car-only
    converter drops), converted by the port's sim10k_to_coco into
    annotations/sim10k_trainval.json. -> the converter's COCO dict."""
    import shutil

    frames = sorted(k for k in jpeg_fixtures() if k.startswith("sim10k_frame_"))
    base = os.path.join(root, "sim10k")
    img_dir, ann_dir = os.path.join(base, "JPEGImages"), os.path.join(base, "Annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    rng = np.random.RandomState(seed)
    h, w = CAR_DOMAINS["sim10k"]["hw"]
    for i in range(n):
        name = f"{3384645 + i}"
        shutil.copyfile(os.path.join(JPEG_FIXTURES, frames[i % len(frames)]), os.path.join(img_dir, name + ".jpg"))
        objs = [("car", b) for b in car_boxes(rng, (h, w), rng.randint(2, 9))]
        objs += [("person", car_boxes(rng, (h, w), 1)[0]), ("motorbike", car_boxes(rng, (h, w), 1)[0])]
        xml = "".join(f"<object><name>{c}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
                      f"<ymax>{b[3]}</ymax></bndbox></object>" for c, b in objs)
        with open(os.path.join(ann_dir, name + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width><height>{h}</height>"
                    f"<depth>3</depth></size>{xml}</annotation>")
    return sim10k_to_coco.main(["--voc-root", ann_dir, "--output", os.path.join(base, "annotations",
                                                                                "sim10k_trainval.json")])


def write_kitti(root: str, n: int = CAR_FRAMES, seed: int = SEED) -> dict:
    """n KITTI-style records under root/kitti/training: image_2/<id>.png
    (seeded synthetic frames at KITTI's 375x1242; KITTI_ADAM7's written
    Adam7-interlaced, KITTI_16BIT's at 16 bits a sample with the frame as
    the high byte and seeded noise as the low, so that each decodes to the
    8-bit frame) and label_2/<id>.txt with Car lines and a DontCare line,
    converted by the port's kitti_to_coco (image sizes from the PNG headers)
    into annotations/kitti_train.json. Each interlaced and 16-bit file is
    decoded back to its frame here. -> the converter's COCO dict."""
    base = os.path.join(root, "kitti")
    img_dir, lab_dir = os.path.join(base, "training", "image_2"), os.path.join(base, "training", "label_2")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    hw = CAR_DOMAINS["kitti"]["hw"]
    recs = make_synthetic_records(n, hw, 1, 6, seed=seed)
    noise = np.random.RandomState(seed)
    for i, r in enumerate(recs):
        rgb = np.clip(synthetic_image(r), 0, 255).astype(np.uint8)
        img = rgb
        if i in KITTI_16BIT:
            img = (rgb.astype(np.uint16) << 8) | noise.randint(0, 256, rgb.shape).astype(np.uint16)
        path = os.path.join(img_dir, f"{i:06d}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(img, adam7=i in KITTI_ADAM7))
        if i in KITTI_16BIT or i in KITTI_ADAM7:
            check(np.array_equal(native_codec.decode(path), rgb), f"kitti {path}: decode differs from its frame")
        lines = [f"Car 0.00 0 -1.57 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} 1.50 1.60 3.90 1.0 1.7 20.0 -1.5"
                 for x1, y1, x2, y2 in r["boxes"]]
        lines.append("DontCare -1 -1 -10 10.00 10.00 40.00 40.00 -1 -1 -1 -1000 -1000 -1000 -10")
        with open(os.path.join(lab_dir, f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return kitti_to_coco.main(["--label-dir", lab_dir, "--image-dir", img_dir,
                               "--output", os.path.join(base, "annotations", "kitti_train.json")])


def write_cityscapes_car(root: str, seed: int = SEED) -> None:
    """The target domain under root/cityscapes: CAR_TARGET_FRAMES synthetic
    1024x2048 PNG frames (the cli phase's) with the 8-class
    instancesonly_filtered_gtFine_train.json (the adaptation's
    TRAIN_TARGET, cityscapes_instancesonly_train) and, over the first
    CAR_TEST_FRAMES, the car-only caronly_filtered_gtFine_val.json
    (cityscapes_car_val: every box of those frames labelled a car, so that
    each frame has cars and AP is defined)."""
    frames = os.path.join(root, "cityscapes", "leftImg8bit")
    os.makedirs(frames)
    path, _, _ = write_eval_dataset(frames, CAR_TARGET_FRAMES, FRAME_HW, seed=seed)
    with open(path) as f:
        coco = json.load(f)
    images = [dict(im, file_name="leftImg8bit/" + im["file_name"]) for im in coco["images"]]
    car_id = CITYSCAPES_THING_CLASSES.index("car") + 1
    test_ids = {im["id"] for im in images[:CAR_TEST_FRAMES]}
    ann_dir = os.path.join(root, "cityscapes", "annotations")
    os.makedirs(ann_dir)
    with open(os.path.join(ann_dir, "instancesonly_filtered_gtFine_train.json"), "w") as f:
        json.dump({"images": images, "annotations": coco["annotations"], "categories": coco["categories"]}, f)
    with open(os.path.join(ann_dir, "caronly_filtered_gtFine_val.json"), "w") as f:
        json.dump({"images": images[:CAR_TEST_FRAMES],
                   "annotations": [dict(a, category_id=car_id) for a in coco["annotations"]
                                   if a["image_id"] in test_ids],
                   "categories": [{"id": car_id, "name": "car"}]}, f)


def car_weights(path: str) -> None:
    """A car-only source detector's .pth: seeded weights of the Sim10k
    source YAML's model (VGG16-BN, 1 class; KITTI's is the same)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, CAR_DOMAINS["sim10k"]["source"]), allow_new=True)
    torch.save({"model": init_weights(empty_model(detector_config_from_cfg(cfg)), SEED).state_dict()}, path)


def car_cfg(yaml: str, out: str, weights: str, *opts: str):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml), allow_new=True)
    cfg.merge_from_list([*CAR_OPTS, "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out, *opts])
    return cfg


def car_source_run(cfg, smi: str, label: str) -> tuple:
    """CAR_STEPS base-trainer steps of a car-only source YAML from its train
    loader (files decoded and resized on the host), each timed from the
    batch's fetch to the step's end; finite losses, CAR_BATCH launches of
    each kernel a step; one step under torch.profiler, peak memory.
    -> (the first step's NMS inputs, a line of numbers)."""
    tr = build_trainer(cfg)
    tr.resume_or_load()
    b = cfg.SOLVER.IMS_PER_BATCH
    it = iter(tr.build_train_loader())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, step_ms, metrics, launches, captured = [], [], [], [], []
    orig, record = capture_nms(captured)
    for i in range(CAR_STEPS):
        t0 = time.perf_counter()
        batch = next(it)
        staged = tr.stage(batch)
        start = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nms.nms_mask_matrix = record if i == 0 else orig
        try:
            m = tr.step_staged(staged)
        finally:
            nms.nms_mask_matrix = orig
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wall.append((t2 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        launches.append({k: c - start[k] for k, c in _kernels.LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(x[k]) for x in metrics for k in TRAIN_LOSSES), f"{label}: losses {metrics}")
    check(all(c == b for d in launches for c in d.values()), f"{label}: launches a step {launches}, expected {b}")
    staged = tr.stage(next(it))
    wall_p, dev_p, kern_p, _ = profile(lambda: tr.step_staged(staged), 1)
    it.close()
    med, med_step = float(np.median(wall[1:])), float(np.median(step_ms[1:]))
    line = (f"{label} source (batch {b}, {cfg.TPU.CANVAS[0]}x{cfg.TPU.CANVAS[1]}, {tr.det_cfg.dtype}) [{smi}]: "
            f"{med:.2f} ms a step from disk (fetch + stage + step, median of steps 1-{CAR_STEPS - 1}; the step alone "
            f"{med_step:.2f} ms; first {wall[0]:.1f} ms; {b * 1e3 / med:.2f} images/s), peak {peak:.2f} GiB; profiled "
            f"step: wall {wall_p:.2f} ms, device {dev_p:.2f} ms, busy {dev_p / wall_p:.1%}; total loss "
            f"{[round(x['total_loss'], 4) for x in metrics]}")
    del tr
    return captured, line, dict(step_ms=med_step, loop_ms=med, busy=dev_p / wall_p, peak_gib=peak)


def car_cli(module: str, argv: list, data_root: str, label: str) -> tuple:
    """One CLI run in a process of its own. -> (stdout, wall s, launches)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"simple_sfod_tpu_torch.tools.{module}", *argv],
                         cwd=ROOT, env=cli_env(data_root), capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"{label}: exit code {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout, wall, cli_launches(res.stdout)


def check_car_run(out: str, label: str, iters: int, keys) -> tuple:
    """metrics.json's last line at iters - 1 with finite losses, and
    eval_results.json with exactly `keys` (cityscapes_car_val, or its
    student and teacher entries), each with finite AP and AP50. -> (last
    metrics line, {key: AP50})."""
    lines = metrics_lines(out)
    check(lines and lines[-1]["iteration"] == iters - 1, f"{label}: metrics.json {lines[-1:]}")
    losses = {k: v for k, v in lines[-1].items() if k.startswith("loss") or k == "total_loss"}
    check(losses and all(np.isfinite(v) for v in losses.values()), f"{label}: losses {losses}")
    with open(os.path.join(out, "eval_results.json")) as f:
        ev = json.load(f)
    check(set(ev) == set(keys) and all(np.isfinite(r.get(k, np.nan)) for r in ev.values() for k in ("AP", "AP50")),
          f"{label}: eval_results.json {ev}")
    check(os.path.exists(os.path.join(out, "model_final.pth")), f"{label}: no model_final.pth")
    return lines[-1], {k: (round(r["AP"], 4), round(r["AP50"], 4)) for k, r in ev.items()}


def skipped_keys(stdout: str) -> set:
    """The names the checkpointer kept at their initialisation on a shape
    mismatch (its printed lines)."""
    out = set()
    for line in stdout.splitlines():
        if line.startswith("[checkpoint] shape mismatch") and " for " in line:
            out.add(line.split(" for ", 1)[1].split(";", 1)[0])
    return out


def car_phase(smi: str):
    """The car phase (module docstring). -> (the launches of each kernel on
    the path, a dict of numbers for the kernels line's notes)."""
    done = check_jpeg_fixtures()
    log(f"  {len(done)} committed image fixtures on this host bit-equal to Pillow's recorded digest "
        f"({', '.join(sorted(set(done.values())))})")
    jpeg_dec, jpeg_both = decode_resize_ms(os.path.join(JPEG_FIXTURES, "sim10k_frame_0.jpg"))
    prog_dec, prog_both = decode_resize_ms(os.path.join(JPEG_FIXTURES, "sim10k_frame_0_progressive.jpg"))
    total = {k: 0 for k in _kernels.LAUNCHES}
    numbers = {"jpeg_decode_ms": jpeg_dec, "jpeg_decode_resize_ms": jpeg_both,
               "progressive_decode_ms": prog_dec, "progressive_decode_resize_ms": prog_both}
    background = []

    def add(d):
        for k in total:
            total[k] += d[k]

    tmp = tempfile.TemporaryDirectory(prefix="sfod_car_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    try:
        t0 = time.perf_counter()
        sim = write_sim10k(data_root)
        kitti = write_kitti(data_root)
        write_cityscapes_car(data_root)
        kitti_png = os.path.join(data_root, "kitti", "training", "image_2", "{:06d}.png")
        png = kitti_png.format(0)
        city = os.path.join(data_root, "cityscapes", "leftImg8bit", "frame_0001.png")
        png_dec, png_both = decode_resize_ms(city)
        kitti_ms = {kind: decode_resize_ms(kitti_png.format(i))[0] for kind, i in
                    (("8-bit", 0), ("Adam7", KITTI_ADAM7[0]), ("16-bit", KITTI_16BIT[0]),
                     ("16-bit Adam7", KITTI_16BIT[-1]))}
        numbers.update(png_decode_ms=png_dec, png_decode_resize_ms=png_both, kitti_png_decode_ms=kitti_ms)
        check(native_codec.image_size(png) == CAR_DOMAINS["kitti"]["hw"], "kitti PNG header size")
        check(all(im["height"] == 375 and im["width"] == 1242 for im in kitti["images"]),
              "kitti_to_coco image sizes")
        check(sum(a["category_id"] == 1 for a in sim["annotations"]) == len(sim["annotations"]) > 0,
              "sim10k_to_coco kept other classes or no car")
        log(f"  wrote {CAR_FRAMES} Sim10k records (JPEG, a quarter progressive, {len(sim['annotations'])} cars after "
            f"sim10k_to_coco), {CAR_FRAMES} KITTI records (PNG, frames {KITTI_ADAM7} Adam7, {KITTI_16BIT} 16-bit, "
            f"each decoded back to its frame; {len(kitti['annotations'])} boxes after kitti_to_coco, sizes from the "
            f"headers) and {CAR_TARGET_FRAMES} Cityscapes frames ({CAR_TEST_FRAMES} as cityscapes_car_val) in "
            f"{time.perf_counter() - t0:.2f} s")
        formats = write_format_frames(os.path.join(root, "formats"))
        fmt_ms = {kind: decode_resize_ms(path) for kind, path in formats.items()}
        numbers["format_decode_ms"] = {k: v[0] for k, v in fmt_ms.items()}
        numbers["format_decode_resize_ms"] = {k: v[1] for k, v in fmt_ms.items()}
        log(f"  the 1914x1052 Sim10k frame in each new form, one thread [{smi}]: decode ms (decode + resize to 600 "
            "px ms): " + ", ".join(f"{k} {d:.2f} ({b:.2f})" for k, (d, b) in fmt_ms.items())
            + f"; BMP and TIFF each decoded back to the frame, the arithmetic file to sim10k_frame_0.jpg's pixels")
        webp_ms = {kind: decode_resize_ms(os.path.join(WEBP_FIXTURES, f)) for kind, f in WEBP_FRAMES.items()}
        numbers["webp_decode_ms"] = {k: v[0] for k, v in webp_ms.items()}
        numbers["webp_decode_resize_ms"] = {k: v[1] for k, v in webp_ms.items()}
        per_px = (webp_ms["lossless 957x526 crop"][0] / (957 * 526)) / (jpeg_dec / (1914 * 1052))
        log(f"  the Sim10k frame as WebP, one thread, median of 5 [{smi}]: decode ms (decode + resize to 600 px "
            "ms): " + ", ".join(f"{k} {d:.2f} ({b:.2f})" for k, (d, b) in webp_ms.items())
            + f"; beside the baseline JPEG's {jpeg_dec:.2f} ({jpeg_both:.2f}): lossy "
            f"{webp_ms['lossy q80'][0] / jpeg_dec:.2f}x, lossy + ALPH {webp_ms['lossy + ALPH'][0] / jpeg_dec:.2f}x, "
            f"lossless {per_px:.2f}x a pixel")
        tiff_frames = write_tiff_frames(os.path.join(root, "tiff_frames"))
        tiff_ms = {kind: decode_resize_ms(path) for kind, path in tiff_frames.items()}
        numbers["tiff_decode_ms"] = {k: v[0] for k, v in tiff_ms.items()}
        numbers["tiff_decode_resize_ms"] = {k: v[1] for k, v in tiff_ms.items()}
        numbers["tiff_crop_decode_mb_s"] = {k: TIFF_CROP_BYTES / 1e3 / d for k, (d, _) in tiff_ms.items() if "crop" in k}
        log(f"  the Sim10k frame as TIFF, one thread, median of 5 [{smi}]: decode ms (decode + resize to 600 px "
            "ms): " + ", ".join(f"{k} {d:.2f} ({b:.2f}, {d / jpeg_dec:.2f}x the baseline JPEG's decode"
                                + (f", {TIFF_CROP_BYTES / 1e3 / d:.1f} MB/s decoded" if "crop" in k else "") + ")"
                                for k, (d, b) in tiff_ms.items())
            + f"; the baseline JPEG {jpeg_dec:.2f} ({jpeg_both:.2f}); each decode equal to Pillow's recorded digest")
        raster = write_raster_frames(os.path.join(root, "raster_frames"))
        raster_ms = {kind: decode_resize_ms(path) for kind, path in raster.items()}
        frame_bytes = 1914 * 1052 * 3
        numbers["raster_decode_ms"] = {k: v[0] for k, v in raster_ms.items()}
        numbers["raster_decode_resize_ms"] = {k: v[1] for k, v in raster_ms.items()}
        numbers["raster_decode_mb_s"] = {k: frame_bytes / 1e3 / v[0] for k, v in raster_ms.items()}
        log(f"  the Sim10k frame as Netpbm, DIB, QOI, SGI, PCX and TGA (written here), one thread, median of 5 "
            f"[{smi}]: decode ms (decode + resize to 600 px ms): "
            + ", ".join(f"{k} {d:.2f} ({b:.2f}, {d / jpeg_dec:.2f}x the baseline JPEG's decode, "
                        f"{frame_bytes / 1e3 / d:.1f} MB/s decoded)" for k, (d, b) in raster_ms.items())
            + f"; the baseline JPEG {jpeg_dec:.2f} ({jpeg_both:.2f}); each decoded back to the frame (the 16-bit PGM "
            "to its samples clipped at 255)")
        log(f"  host decode on one thread [{smi}]: a 1914x1052 4:2:0 JPEG {jpeg_dec:.2f} ms, with the resize to "
            f"600 px {jpeg_both:.2f} ms; its progressive re-encoding {prog_dec:.2f} ms, with the resize "
            f"{prog_both:.2f} ms ({prog_dec / jpeg_dec:.2f}x the baseline's decode); a 1024x2048 PNG {png_dec:.2f} ms, "
            f"with the resize {png_both:.2f} ms; a 375x1242 KITTI PNG "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in kitti_ms.items()))
        w1 = os.path.join(root, "source_1class.pth")
        car_weights(w1)
        for name in ("sim10k_trainval", "kitti_train", "cityscapes_car_val", "cityscapes_instancesonly_train"):
            DATASET_REGISTRY.pop(name, None)
        os.environ["SFOD_DATASETS"] = data_root
        captured = {}
        for dom, spec in CAR_DOMAINS.items():
            # the source YAML in this process: step time from disk, a profiled step
            _kernels.reset_launches()
            cfg = car_cfg(spec["source"], os.path.join(root, dom + "_timed"), w1, "SOLVER.IMS_PER_BATCH",
                          str(CAR_BATCH))
            check(cfg.MODEL.ROI_HEADS.NUM_CLASSES == 1 and tuple(cfg.TPU.CANVAS) == spec["canvas"],
                  f"{dom}: {cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, canvas {cfg.TPU.CANVAS}")
            captured[dom], line, nums = car_source_run(cfg, smi, dom)
            numbers[dom] = nums
            add(dict(_kernels.LAUNCHES))
            log("  " + line)

        def chain(dom: str, spec: dict) -> tuple:
            """The source YAML through train_net (test() on cityscapes_car_val
            at the end), then source-free adaptation from its model_final (1
            class into the YAML's 8) through train_net_mt. -> each run's
            output directory and car_cli's (stdout, wall s, launches)."""
            src_out = os.path.join(root, dom + "_source")
            argv = ["--config-file", os.path.join(ROOT, spec["source"]), *CAR_OPTS, "MODEL.WEIGHTS", w1,
                    "OUTPUT_DIR", src_out, "SOLVER.IMS_PER_BATCH", str(CAR_BATCH), "SOLVER.MAX_ITER", str(CAR_ITERS),
                    "TEST.EVAL_PERIOD", str(CAR_ITERS)]
            src = car_cli("train_net", argv, data_root, f"{dom} train_net")
            ad_out = os.path.join(root, dom + "_adapt")
            argv = ["--config-file", os.path.join(ROOT, spec["adapt"]), *CAR_OPTS,
                    *[x for kv in ADAPT_CUTS.items() for x in kv],
                    "MODEL.WEIGHTS", os.path.join(src_out, "model_final.pth"), "OUTPUT_DIR", ad_out,
                    "SOLVER.MAX_ITER", str(CAR_ITERS), "TEST.EVAL_PERIOD", str(CAR_ITERS)]
            return src_out, src, ad_out, car_cli("train_net_mt", argv, data_root, f"{dom} train_net_mt")

        # both domains' CLIs at once, in processes of their own, beside the
        # NMS checks of this process (not timed)
        t0 = time.perf_counter()
        chains = {dom: Background(chain, dom, spec) for dom, spec in CAR_DOMAINS.items()}
        background.extend(chains.values())
        # the first timed step's RPN NMS inputs: kernels against the plain versions
        for dom, calls in captured.items():
            check(len(calls) == CAR_BATCH, f"{dom}: {len(calls)} NMS calls captured in a step")
            kept = [check_kernels_against_plain(b, s, v, thr, f"{dom} image {i}", cpu=i == 0)
                    for i, (b, s, v, thr) in enumerate(calls)]
            log(f"  {dom}: the step's {CAR_BATCH} RPN NMS inputs (N {[int(c[0].shape[0]) for c in calls]}), kernels "
                f"bit-equal to the plain versions, kept {kept}")
        for dom, spec in CAR_DOMAINS.items():
            src_out, (stdout, wall, got), ad_out, (ad_stdout, ad_wall, ad_got) = chains[dom].result()
            add(got)
            # CAR_BATCH a step (train-mode RPN), 2 an image in test() (RPN,
            # detection), 1 for the validation loss's one image (TEST.VAL_LOSS)
            want = CAR_BATCH * CAR_ITERS + 2 * CAR_TEST_FRAMES + 1
            check(all(c == want for c in got.values()), f"{dom} train_net: launches {got}, expected {want}")
            last, res = check_car_run(src_out, f"{dom} train_net", CAR_ITERS, ["cityscapes_car_val"])
            log(f"  train_net {spec['source']} ({CAR_ITERS} steps at batch {CAR_BATCH}, test() at {CAR_ITERS}) "
                f"[{smi}]: {wall:.2f} s, total loss {last['total_loss']:.4f}, (AP, AP50) {res}, launches {got}")
            add(ad_got)
            check(skipped_keys(ad_stdout) == CAR_SKIPPED, f"{dom} train_net_mt: skipped {skipped_keys(ad_stdout)}")
            # 3 an adaptation step, 2 an image and model (student, teacher) in
            # test(), 1 for the validation loss's one image
            want = 3 * CAR_ITERS + 2 * 2 * CAR_TEST_FRAMES + 1
            check(all(c == want for c in ad_got.values()), f"{dom} train_net_mt: launches {ad_got}, expected {want}")
            last, res = check_car_run(ad_out, f"{dom} train_net_mt", CAR_ITERS,
                                      ["cityscapes_car_val/student", "cityscapes_car_val/teacher"])
            log(f"  train_net_mt {spec['adapt']} from its model_final ({CAR_ITERS} steps, test() at {CAR_ITERS}) "
                f"[{smi}]: {ad_wall:.2f} s, skipped {sorted(skipped_keys(ad_stdout))} (1 class into 8), total loss "
                f"{last['total_loss']:.4f}, car-only remap (AP, AP50) {res}, launches {ad_got}")
        log(f"  both domains' CLIs at once, beside the NMS checks [{smi}]: {time.perf_counter() - t0:.2f} s")
        # test() images/s on the car-only set, in this process (the Sim10k source model)
        cfg = car_cfg(CAR_DOMAINS["sim10k"]["source"], os.path.join(root, "sim10k_test"),
                      os.path.join(root, "sim10k_source", "model_final.pth"))
        tr = build_trainer(cfg)
        tr.resume_or_load()
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.test()
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        got = dict(_kernels.LAUNCHES)
        add(got)
        check(all(c == 2 * CAR_TEST_FRAMES for c in got.values()), f"test(): launches {got}")
        numbers["test_images_s"] = CAR_TEST_FRAMES / test_s
        check(all(np.isfinite(v["AP50"]) for v in res.values()), f"test(): {res}")
        log(f"  test() of the Sim10k source model on cityscapes_car_val [{smi}]: {CAR_TEST_FRAMES} images in "
            f"{test_s:.2f} s ({CAR_TEST_FRAMES / test_s:.2f} images/s, decode and evaluation included)")
        got, line = format_test(tr, formats, root)
        add(got)
        log(f"  [{smi}] " + line)
        got, line = webp_test(tr, root)
        add(got)
        log(f"  [{smi}] " + line)
        got, line = tiff_test(tr, root)
        add(got)
        log(f"  [{smi}] " + line)
        for got, line in tiff_codec_test(tr, root):
            add(got)
            log(f"  [{smi}] " + line)
        got, line = raster_test(tr, root)
        add(got)
        log(f"  [{smi}] " + line)
        del tr
    finally:
        for b in background:
            b.join()
        os.environ.pop("SFOD_DATASETS", None)
        for name in ("sim10k_trainval", "kitti_train", "cityscapes_car_val", "cityscapes_instancesonly_train"):
            DATASET_REGISTRY.pop(name, None)
        tmp.cleanup()
    log(f"  launches on the car path: {total}")
    return total, numbers


# ---------------------------------------------------------------- export
EXPORT_BATCHES = (1, 2, 4, 8)  # the steady ms a call, artifact and eager
EXPORT_TIMEOUT_S = 420
SERVE_TIMEOUT_S = 300
SERVE_WAIT_MS = 50  # the served poly artifact's coalescing window: 3 concurrent requests share one call
EXPORT_POISONED = ("simple_sfod_tpu_torch.models", "simple_sfod_tpu_torch.config", "simple_sfod_tpu_torch.engine.trainers")
# the R101 server: tools.serve_model's main with the port's model code poisoned
SERVE_POISONED = (
    "import sys\n"
    f"for name in {EXPORT_POISONED!r}:\n"
    "    sys.modules[name] = None\n"
    "from simple_sfod_tpu_torch.tools import serve_model\n"
    "serve_model.main(sys.argv[1:])\n"
)


def export_jobs(root: str, weights: str, r101_weights: str) -> dict:
    """The export CLI's runs, by label: (argv, artifact path)."""
    main_yaml, r101_yaml = os.path.join(ROOT, CLI_YAML), os.path.join(ROOT, R101_ADABN_YAML)
    jobs = {
        "teacher poly": (main_yaml, ["--batch", "poly"]),
        "student float32 b1": (main_yaml, ["--model", "student"]),
        "student bf16 b1": (main_yaml, ["--model", "student", "--params-dtype", "bfloat16"]),
        "teacher weights-as-argument b1": (main_yaml, ["--no-bundle-params"]),
        # the AdaBN YAML's probe: batch-statistics BN (which also gives
        # random R101 weights sensible features)
        "r101 adabn train-mode-bn b1": (r101_yaml, ["--train-mode-bn"]),
    }
    out = {}
    for i, (label, (yaml, flags)) in enumerate(jobs.items()):
        path = os.path.join(root, f"artifact_{i}.sfodx")
        w = r101_weights if yaml == r101_yaml else weights
        argv = ["--config-file", yaml, "--out", path, *flags, "--selfcheck", "MODEL.WEIGHTS", w,
                "OUTPUT_DIR", os.path.join(root, f"out_{i}"), "SEED", "0"]
        out[label] = (argv, path)
    return out


def run_exports(jobs: dict) -> dict:
    """Every export CLI run at once, one process each (tracing is host work
    on one core); -> label: (wall s, export s, MiB, selfcheck box and score
    differences, detections)."""
    import re

    env = cli_env(ROOT)
    procs = {}
    t0 = time.perf_counter()
    for label, (argv, _) in jobs.items():
        procs[label] = subprocess.Popen([sys.executable, "-m", "simple_sfod_tpu_torch.tools.export_model", *argv],
                                        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    res = {}
    for label, p in procs.items():
        out, err = p.communicate(timeout=EXPORT_TIMEOUT_S)
        if p.returncode != 0:
            raise AssertionError(f"export {label}: exit code {p.returncode}\n{out[-2000:]}\n{err[-3000:]}")
        exp = re.search(r"\(([\d.]+) MiB\) in ([\d.]+) s", out)
        chk = re.search(r"selfcheck OK: .* at batch (\d+) \((\d+) detections; max difference boxes (\S+), scores (\S+)\)", out)
        check(exp is not None and chk is not None, f"export {label}: output {out[-1500:]}")
        res[label] = dict(wall_s=time.perf_counter() - t0, export_s=float(exp.group(2)), mib=float(exp.group(1)),
                          batch=int(chk.group(1)), detections=int(chk.group(2)),
                          box_diff=float(chk.group(3)), score_diff=float(chk.group(4).rstrip(")")))
    return res


def start_server(cmd: list, env: dict, log_path: str):
    """A server process and its base URL, from its first line; its stderr
    goes to log_path."""
    with open(log_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    line = proc.stdout.readline()
    if " on http://" not in line:
        proc.kill()
        proc.wait(timeout=30)
        with open(log_path) as f:
            raise AssertionError(f"server did not start: {line!r}\n{f.read()[-3000:]}")
    return proc, line.strip().rsplit(" on ", 1)[1].rstrip("/"), line.strip()


def stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def http_post(url: str, body: bytes):
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as resp:
        out = json.loads(resp.read())
    check("error" not in out, f"request: {out.get('error')}")
    return out, (time.perf_counter() - t0) * 1e3


def concurrent_posts(url: str, bodies: list) -> list:
    results, errors = [None] * len(bodies), []

    def worker(i):
        try:
            results[i] = http_post(url, bodies[i])
        except BaseException as e:  # reported after join
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT_S)
        check(not t.is_alive(), "a concurrent request did not finish")
    if errors:
        raise errors[0]
    return results


def check_served(res: dict, hw, label: str) -> None:
    check(res["height"] == hw[0] and res["width"] == hw[1], f"{label}: size {res['height']}x{res['width']}")
    for d in res["detections"]:
        x0, y0, x1, y1 = d["box"]
        check(np.isfinite(d["score"]) and 0 <= x0 <= x1 <= hw[1] and 0 <= y0 <= y1 <= hw[0] and 0 <= d["class"] < 8,
              f"{label}: detection {d}")


def npy_bytes(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def gated(service, payloads: list) -> list:
    """predict_array of each image from its own thread, all queued before
    the worker drains: one coalesced call."""
    results = [None] * len(payloads)
    service._batcher._gate.clear()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, service.predict_array(payloads[i])))
               for i in range(len(payloads))]
    try:
        for t in threads:
            t.start()
        for _ in range(1000):
            with service._batcher._cv:
                if len(service._batcher._queue) == len(payloads):
                    break
            time.sleep(0.01)
    finally:
        service._batcher._gate.set()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT_S)
        check(not t.is_alive(), "a gated request did not finish")
    return results


def det_diff(got: dict, want) -> tuple:
    """(valid and classes equal, max box difference, max score difference)."""
    same = torch.equal(got["valid"], want.valid) and torch.equal(got["classes"], want.classes)
    return same, (got["boxes"] - want.boxes).abs().max().item(), (got["scores"] - want.scores).abs().max().item()


def export_phase(smi: str, before_timing=lambda: None, keep_artifact: str = ""):
    """The export phase (module docstring); `before_timing()` is called
    before the first call timed in this process (the wq phase's workflow,
    which runs beside the exports, ends there); the poly artifact is copied
    to `keep_artifact` for the roofline phase. -> (the launches of each
    kernel in this process, a dict of numbers for the kernels line's
    notes)."""
    tmp = tempfile.TemporaryDirectory(prefix="sfod_export_")
    root = tmp.name
    total = {k: 0 for k in _kernels.LAUNCHES}
    r101_server = None

    def add(d):
        for k in total:
            total[k] += d[k]

    try:
        weights, r101_weights = os.path.join(root, "main.pth"), os.path.join(root, "r101.pth")
        write_cli_weights(weights)
        r101 = init_weights(empty_model(detector_config_from_cfg(r101_cfg(R101_ADABN_YAML))), SEED)
        with torch.no_grad():
            r101.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST  # detections from random weights
        torch.save({"model": r101.state_dict()}, r101_weights)
        del r101
        jobs = export_jobs(root, weights, r101_weights)
        t0 = time.perf_counter()
        res = run_exports(jobs)
        log(f"  {len(jobs)} export_model runs at once [{smi}]: {time.perf_counter() - t0:.1f} s wall")
        for label, r in res.items():
            log(f"    {label}: export {r['export_s']:.2f} s, {r['mib']:.1f} MiB; --selfcheck at batch {r['batch']}: "
                f"{r['detections']} detections, artifact vs eager max difference boxes {r['box_diff']:.3g} px, "
                f"scores {r['score_diff']:.3g}")
        f32, bf16 = res["student float32 b1"]["mib"], res["student bf16 b1"]["mib"]
        check(bf16 < 0.55 * f32 and res["teacher weights-as-argument b1"]["mib"] < 5, f"artifact sizes {res}")
        log(f"  student artifact float32 {f32:.1f} MiB, bfloat16 weights {bf16:.1f} MiB ({bf16 / f32:.1%})")
        poly_path = jobs["teacher poly"][1]
        if keep_artifact:
            shutil.copy(poly_path, keep_artifact)
        env = cli_env(ROOT)
        # the R101 artifact's server starts beside the poly one's and waits,
        # loaded and idle, for its requests below
        r101_server = Background(start_server, [sys.executable, "-c", SERVE_POISONED, "--artifact",
                                                jobs["r101 adabn train-mode-bn b1"][1], "--port", "0"], env,
                                 os.path.join(root, "serve_r101.log"))

        # the poly artifact behind `python -m simple_sfod_tpu_torch.tools.serve_model`
        proc, url, line = start_server([sys.executable, "-m", "simple_sfod_tpu_torch.tools.serve_model", "--artifact",
                                        poly_path, "--port", "0", "--max-wait-ms", str(SERVE_WAIT_MS)], env,
                                       os.path.join(root, "serve_poly.log"))
        try:
            r101_proc, r101_url, r101_line = r101_server.result()  # both servers loaded before any request
            info = json.loads(urllib.request.urlopen(f"{url}/", timeout=60).read())
            check(info["canvas"] == [608, 1216] and info["batch"] is None and info["platforms"] == ["cuda"]
                  and info["config"] == os.path.basename(CLI_YAML) and info["model"] == "teacher", f"info {info}")
            rng = np.random.RandomState(SEED + 11)
            imgs = [rng.randint(0, 256, IMAGE_HW + (3,)).astype(np.uint8) for _ in range(7)]
            # a first pass meets each call batch (1, 2, 4) once: cuDNN's and
            # cuBLAS's first call of a shape is not a request's latency
            warm = [http_post(url, npy_bytes(imgs[0]))[1]]
            warm += [ms for _, ms in concurrent_posts(url, [npy_bytes(imgs[i]) for i in (1, 2)])]
            warm += [ms for _, ms in concurrent_posts(url, [npy_bytes(imgs[i]) for i in (3, 4, 5)])]
            served = [http_post(url, npy_bytes(imgs[i])) for i in (0, 1)]
            served += concurrent_posts(url, [npy_bytes(imgs[i]) for i in (2, 3)])
            served += concurrent_posts(url, [npy_bytes(imgs[i]) for i in (4, 5, 6)])
            big = rng.randint(0, 256, FRAME_HW + (3,)).astype(np.uint8)
            big_res, big_ms = http_post(url, png_bytes(big))
        finally:
            stop_server(proc)
        for i, (r, _) in enumerate(served):
            check_served(r, IMAGE_HW, f"served request {i}")
        check_served(big_res, FRAME_HW, "served PNG")
        lat = [ms for _, ms in served] + [big_ms]
        log(f"  {line} [{smi}]: GET / ok; a first pass of 1, 2 and 3 requests {[round(ms, 1) for ms in warm]} ms; "
            f"then 7 requests of {IMAGE_HW[0]}x{IMAGE_HW[1]} (2 alone, 2 and 3 concurrent) "
            f"{[round(ms, 1) for _, ms in served]} ms and a {FRAME_HW[0]}x{FRAME_HW[1]} PNG {big_ms:.1f} ms "
            f"({len(big_res['detections'])} detections): p50 {np.median(lat):.1f} ms")

        # the same artifact in this process: load, launches, eager, timing
        before_timing()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program, meta = load_exported(poly_path)
        load_s = time.perf_counter() - t0
        module = program.module()
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(ROOT, CLI_YAML))
        cfg.merge_from_list(["MODEL.WEIGHTS", weights, "OUTPUT_DIR", os.path.join(root, "eager"), "SEED", "0"])
        tr = build_trainer(cfg, synthetic=True)
        tr.resume_or_load()
        eager = tr.teacher
        bench = synthetic_bench_batch(cfg, n=max(EXPORT_BATCHES))
        images = torch.from_numpy(bench["images"]).cuda()
        sizes = torch.from_numpy(bench["sizes"]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            module(images[:1], sizes[:1])["valid"].cpu()
        first_ms = (time.perf_counter() - t0) * 1e3
        log(f"  load_exported {load_s:.2f} s ({meta['config']}, batch {meta['batch']}), first call {first_ms:.1f} ms [{smi}]")

        ms = {}
        for b in EXPORT_BATCHES:
            _kernels.reset_launches()
            with torch.inference_mode():
                got = module(images[:b], sizes[:b])
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
            add(launches)
            check(all(c == 2 * b for c in launches.values()), f"artifact batch {b}: launches {launches}, expected {2 * b}")
            want = eager.infer(images[:b], sizes[:b])
            same, bd, sd = det_diff(got, want)
            check(same, f"artifact batch {b}: valid or classes differ from eager inference")
            # the export tool's --selfcheck bounds
            torch.testing.assert_close(got["boxes"], want.boxes, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got["scores"], want.scores, rtol=1e-5, atol=1e-5)
            with torch.inference_mode():
                t_art = time_ms(lambda: module(images[:b], sizes[:b]), 10)
            t_eager = time_ms(lambda: eager.infer(images[:b], sizes[:b]), 10)
            ms[b] = (t_art, t_eager)
            log(f"    batch {b}: artifact == eager in valid and classes, max difference boxes {bd:.3g} px, scores "
                f"{sd:.3g}; {int(want.valid.sum())} detections; steady {t_art:.2f} ms a call ({t_art / b:.2f} ms an "
                f"image), eager {t_eager:.2f} ms [{smi}]")
        with torch.inference_mode():
            wall, dev, kern, _ = profile(lambda: module(images[:1], sizes[:1])["valid"].cpu(), 5)
        nms_ms = sum(v for k, v in kern.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
        log(f"  profile artifact batch 1 [{smi}]: wall {wall:.2f} ms, device kernels {dev:.2f} ms, busy {dev / wall:.1%}, "
            f"NMS kernels {nms_ms:.3f} ms; top kernels {top(kern, 4)}")

        # one call's NMS inputs, captured where the program's op launches
        captured = []
        orig_launch = _kernels.launch_suppress_relation_bits

        def record(sb, sv, thr):
            captured.append((sb.clone(), sv.clone(), thr))
            return orig_launch(sb, sv, thr)

        _kernels.launch_suppress_relation_bits = record
        try:
            with torch.inference_mode():
                module(images[:1], sizes[:1])
        finally:
            _kernels.launch_suppress_relation_bits = orig_launch
        check(len(captured) == 2 and captured[0][0].shape[0] == 4096, f"captured {[c[0].shape for c in captured]}")
        for (sb, sv, thr), site in zip(captured, ("rpn", "detection")):
            rel = nms.suppress_relation_plain(sb, sv, thr)
            bits = orig_launch(sb, sv, thr)
            keep = nms.greedy_keep_from_bits(bits, sv)
            check(torch.equal(bits, nms.pack_bits(rel)) and torch.equal(keep, nms.greedy_keep_plain(rel, sv)),
                  f"{site} NMS inputs of the artifact: kernel != plain")
            log(f"  {site} NMS inputs of an artifact call N={sb.shape[0]} thr={thr}: kernel == plain, kept "
                f"{int(keep.sum())} of {int(sv.sum())} valid")

        # the served path in this process: 2 kernel launches an image of each call
        t0 = time.perf_counter()
        service = DetectionService(poly_path, max_wait_ms=SERVE_WAIT_MS)
        log(f"  a second load in this process (DetectionService over the artifact) {time.perf_counter() - t0:.2f} s")
        try:
            _kernels.reset_launches()
            local = [service.predict_array(imgs[i]) for i in (0, 1)]
            local += gated(service, [imgs[i] for i in (4, 5, 6)])
            launches = dict(_kernels.LAUNCHES)
        finally:
            service.close()
        add(launches)
        check(all(c == 2 * (1 + 1 + 4) for c in launches.values()), f"service launches {launches}, expected 12 (one call padded to 4)")
        check(local[0] == served[0][0] and local[1] == served[1][0], "the tool's server and this process's service differ")
        log(f"  DetectionService over the artifact in this process: requests 0 and 1 equal the tool's answers; 3 gated "
            f"requests in one call padded to 4; launches {launches} (2 an image of each call)")
        del module, program, tr, eager

        # the R101 artifact behind serve_model with the port's model code poisoned
        try:
            info = json.loads(urllib.request.urlopen(f"{r101_url}/", timeout=60).read())
            check(info["batch"] == 1 and info["config"] == os.path.basename(R101_ADABN_YAML), f"R101 info {info}")
            r101 = [http_post(r101_url, npy_bytes(imgs[i])) for i in (0, 1)]
            r101_big, r101_big_ms = http_post(r101_url, png_bytes(big))
        finally:
            stop_server(r101_proc)
        for i, (r, _) in enumerate(r101):
            check_served(r, IMAGE_HW, f"R101 request {i}")
        check_served(r101_big, FRAME_HW, "R101 PNG")
        log(f"  R101 C4 artifact served with {', '.join(EXPORT_POISONED)} poisoned [{smi}]: {r101_line}; requests "
            f"{[round(ms, 1) for _, ms in r101]} ms, PNG {r101_big_ms:.1f} ms, detections "
            f"{[len(r['detections']) for r, _ in r101]}")
        return total, dict(exports=res, load_s=load_s, first_ms=first_ms, ms=ms, p50_ms=float(np.median(lat)),
                           busy=dev / wall)
    finally:
        if r101_server is not None:
            r101_server.join()
            if r101_server._value is not None:
                stop_server(r101_server._value[0])
        tmp.cleanup()


# ---------------------------------------------------------------------------
# da: domain-adversarial training (DA-Faster, conditional DA, the
# source-available Adaptive Teacher, weighted classifiers in the source-free
# trainer) from the loader and through the CLIs
# ---------------------------------------------------------------------------
DA_YAML = "configs/faster_rcnn_VGG_cityscapes_da.yaml"
AT_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml"
DA_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0", "VIS_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "100000"]
DA_STEPS = 6  # da steps in this process (float32, 1 + 1), the first excluded from the median
CDA_STEPS = 4  # cda steps with DA_FASTER.ENTROPY_CONDITIONING
AT_STEPS = 8  # adaptive_teacher steps (bfloat16, 1 + 1) across the cut burn-in
AT_BURN_UP = 3  # SEMISUPNET.BURN_UP_STEP in this process (20000 in the YAML)
SFAT_DC_STEPS = 6  # source-free steps with both classifiers weighted
DA_CLI_ITERS = 4  # each train_net run on the DA YAML; the second resumes to 2 * DA_CLI_ITERS
AT_CLI_ITERS = 4  # the train_net_mt run on the AT YAML
AT_CLI_BURN_UP = 2
# the AT run's class-1 logit bias boost and LR: the student that the teacher
# copies after burn-in still gives pseudo-labels above 0.8 (at the YAML's
# BASE_LR 0.0025 three supervised steps on random weights moved the class
# logits by more than a bias of 6, and no detection stayed above 0.8)
AT_CLS_BIAS_BOOST = 6.0
AT_BASE_LR = "0.0001"
# the card-vs-CPU step of each path: (YAML, opts); the AT one is the boundary
# step (BURN_UP_STEP 0: the copy, then the joint losses) with the instance
# classifier built
DA_KINDS = {
    "da": (DA_YAML, []),
    "cda": (DA_YAML, ["TRAINER", "cda", "DA_FASTER.ENTROPY_CONDITIONING", "True"]),
    "adaptive_teacher": (AT_YAML, ["SEMISUPNET.BURN_UP_STEP", "0", "SEMISUPNET.INS_DC", "True"]),
    "sfat_weighted": (CLI_YAML, ["DOMAIN_CLASSIFIER.IMAGE", "True", "DOMAIN_CLASSIFIER.INSTANCE", "True"]),
}
# launches of each NMS kernel a step at batch 1 + 1, counted from the code:
# da/cda the supervised propose and one DC propose per domain; AT the
# teacher's RPN and detection NMS, the supervised propose of both source
# views, the pseudo propose (+2 with the instance classifier: one
# box_features propose per domain); the source-free main step's 3 + 2
DA_LAUNCHES = {"da": 3, "cda": 3, "adaptive_teacher": 5, "adaptive_teacher+ins": 7, "sfat_weighted": 5}
DA_DATASETS = ("cityscapes_instancesonly_train", "cityscapes_instancesonly_foggy_train_foggy_beta_0.02",
               "cityscapes_instancesonly_foggy_val_foggy_beta_0.02", "cityscapes_instancesonly_val")


def da_cfg(kind: str, out: str, *opts: str, canvas=None, dtype=None, kind_opts: bool = True):
    """The YAML of DA_KINDS[kind] with the phase's cuts, the kind's opts
    (unless `kind_opts` is False: the YAML as it is) and `opts`."""
    yaml, extra_opts = DA_KINDS[kind]
    kind_opts = extra_opts if kind_opts else []
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml), allow_new=True)
    extra = ([] if canvas is None else ["TPU.CANVAS", repr(tuple(canvas))]) + ([] if dtype is None else ["TPU.DTYPE", dtype])
    cfg.merge_from_list([*DA_OPTS, *kind_opts, "OUTPUT_DIR", out, *extra, *opts])
    return cfg


def da_weights(det_cfg) -> dict:
    """Seeded weights with the class-1 logit bias raised (pseudo-labels from
    random weights)."""
    model = init_weights(empty_model(det_cfg), SEED)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
    return model.state_dict()


def da_step_args(tr, kind: str, canvas, image_hw, seed: int = SEED):
    """A (source, target) pair of synthetic batches of one image at image_hw
    on `canvas` (the source-free step takes the target alone) and the
    trainer's draws for them."""
    recs = make_synthetic_records(2, tuple(image_hw), 8, 6, seed=seed)
    src, tgt = (synthetic_batch([r], tuple(canvas), tr.cfg.TPU.GT_CAPACITY) for r in recs)
    if kind == "sfat_weighted":
        return (tgt,), {}, tr.make_draws(1, tuple(canvas))
    return (src,), {"target": tgt}, tr.make_draws(1, tuple(canvas), tr.cfg.TPU.GT_CAPACITY, 1)


def da_state(tr) -> dict:
    """The student (or detector) and its classifiers in one state dict."""
    out = dict(tr.state.model.state_dict())
    heads = getattr(tr.state, "heads", None) or getattr(tr.state, "dc", {})
    for name, m in heads.items():
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    return out


def da_card_vs_cpu(kind: str, canvas=(128, 256), image_hw=(120, 250), device: str = "cuda"):
    """One float32 step of `kind` (TF32 off, which the trainer sets) on the
    card (`device`) and on the CPU from the same weights, batches and draws. -> the
    errors of `state_errors` over the detector (the student) and its
    classifiers, each loss's relative error and whether the counts agree;
    for the teacher-student kinds the teacher statistics' error too."""
    cfg = da_cfg(kind, tempfile.gettempdir(), canvas=canvas, dtype="float32")
    sd = da_weights(detector_config_from_cfg(cfg))
    cpu, card = build_trainer(cfg, device="cpu", state_dict=sd), build_trainer(cfg, device=device, state_dict=sd)
    if hasattr(cpu.state, "teacher"):
        for tr in (cpu, card):
            with torch.no_grad():
                tr.state.model.roi_heads.box_predictor.bbox_pred.bias += BBOX_OFFSET
    start = {k: v.clone() for k, v in da_state(cpu).items()}
    args, kw, draws = da_step_args(cpu, kind, canvas, image_hw)
    mc = {k: float(v) for k, v in cpu.run_step(*args, draws, **kw).items()}
    mg = {k: float(v) for k, v in card.run_step(*args, draws.to(device), **kw).items()}
    losses = [k for k in mc if k.startswith("loss") or k == "total_loss"]
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in losses},
           "counts_equal": all(mg[k] == mc[k] for k in mc if k.startswith("num_")), "losses_cpu": mc}
    out.update(state_errors(start, da_state(cpu), da_state(card)))
    if hasattr(cpu.state, "teacher"):
        tc, tg = cpu.state.teacher.state_dict(), card.state.teacher.state_dict()
        out["teacher_bn"] = max(
            (((tg[k].cpu() - tc[k]).abs().max() / tc[k].abs().max().clamp_min(1e-12)).item(), k)
            for k in tc if k.endswith(("running_mean", "running_var")))
    return out


def da_launches_per_step(kind: str, cfg) -> int:
    """The launches of each kernel that a step of `kind` at batch 1 + 1 makes."""
    if kind == "adaptive_teacher" and (cfg.SEMISUPNET.INS_DC or cfg.DOMAIN_CLASSIFIER.INSTANCE):
        return DA_LAUNCHES["adaptive_teacher+ins"]
    return DA_LAUNCHES[kind]


def da_run(tr, steps: int, label: str, smi: str, on_step=None):
    """`steps` steps of a built trainer on batches from its loaders (decoded
    from disk; staging outside the timed step), each timed alone, the first
    step's NMS inputs captured; then a step under set_sync_debug_mode("error")
    and a profiled step. `on_step(i, phase)` runs before ("before") and after
    ("after") step i. -> (metrics, wall ms, launches a step, captured NMS
    inputs, profile (wall, device, kernels), peak GiB)."""
    it = iter(tr.build_train_loader())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, wall, launches, captured = [], [], [], []
    orig, record = capture_nms(captured)
    for i in range(steps):
        staged = tr.stage(next(it))
        if on_step is not None:
            on_step(i, "before")
        start = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms.nms_mask_matrix = record if i == 0 else orig
        try:
            m = tr.step_staged(staged)
        finally:
            nms.nms_mask_matrix = orig
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: c - start[k] for k, c in _kernels.LAUNCHES.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if on_step is not None:
            on_step(i, "after")
    peak = torch.cuda.max_memory_allocated() / 2**30
    staged = tr.stage(next(it))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.step_staged(staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prof = profile(lambda: tr.step_staged(staged), 1)
    it.close()
    bad = [(i, k) for i, m in enumerate(metrics) for k, v in m.items() if k.startswith("loss") and not np.isfinite(v)]
    check(not bad and all(np.isfinite(m["total_loss"]) for m in metrics), f"{label}: non-finite losses {bad}")
    med = float(np.median(wall[1:]))
    log(f"  {label} ({tr.__class__.__name__}, batch 1 + 1, 608x1216, {str(tr.det_cfg.dtype).split('.')[-1]}) "
        f"[{smi}]: step {med:.2f} ms (median of steps 1-{steps - 1}; first {wall[0]:.1f} ms), peak {peak:.2f} GiB; "
        f"a step under set_sync_debug_mode('error'); profiled step: wall {prof[0]:.2f} ms, device {prof[1]:.2f} ms, "
        f"busy {prof[1] / prof[0]:.1%}")
    log(f"    total loss {[round(m['total_loss'], 4) for m in metrics]}; top kernels (ms): {top(prof[2])}")
    return metrics, wall, launches, captured, prof, peak


def da_phase(smi: str):
    """The da phase (module docstring). -> (the launches of each kernel on
    the path, a dict of numbers)."""
    total = {k: 0 for k in _kernels.LAUNCHES}

    def add(d):
        for k in total:
            total[k] += d[k]

    numbers = {}
    tmp = tempfile.TemporaryDirectory(prefix="sfod_da_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    try:
        t0 = time.perf_counter()
        write_cityscapes_car(data_root)  # its 8 frames' instancesonly train JSON: the labelled source
        write_cli_datasets(data_root)
        weights, at_weights = os.path.join(root, "source.pth"), os.path.join(root, "source_at.pth")
        write_cli_weights(weights)
        write_cli_weights(at_weights, AT_CLS_BIAS_BOOST)
        for name in DA_DATASETS:
            DATASET_REGISTRY.pop(name, None)
        os.environ["SFOD_DATASETS"] = data_root
        log(f"  wrote {CLI_TRAIN_FRAMES} foggy and {CAR_TARGET_FRAMES} clear 1024x2048 PNG frames with their COCO "
            f"JSONs and a seeded .pth in {time.perf_counter() - t0:.2f} s")

        # the CLIs (train_net on the DA YAML, then its --resume, beside train_net_mt on the AT YAML) while the
        # card-vs-CPU steps run; the timed runs below run alone
        da_out, at_out = os.path.join(root, "da_cli"), os.path.join(root, "at_cli")
        da_argv = ["--config-file", os.path.join(ROOT, DA_YAML), *DA_OPTS, "MODEL.WEIGHTS", weights,
                   "OUTPUT_DIR", da_out, "SOLVER.MAX_ITER", str(DA_CLI_ITERS), "SOLVER.CHECKPOINT_PERIOD",
                   str(DA_CLI_ITERS // 2), "TEST.EVAL_PERIOD", str(DA_CLI_ITERS)]
        at_argv = ["--config-file", os.path.join(ROOT, AT_YAML), *DA_OPTS, "MODEL.WEIGHTS", weights,
                   "OUTPUT_DIR", at_out, "SOLVER.MAX_ITER", str(AT_CLI_ITERS), "SEMISUPNET.BURN_UP_STEP",
                   str(AT_CLI_BURN_UP), "TEST.EVAL_PERIOD", str(AT_CLI_ITERS)]
        env = cli_env(data_root)
        resume_argv = [*da_argv[:2], "--resume", *da_argv[2:], "SOLVER.MAX_ITER", str(2 * DA_CLI_ITERS)]

        def start(tool, argv):
            return subprocess.Popen([sys.executable, "-m", f"simple_sfod_tpu_torch.tools.{tool}", *argv], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(p, label):
            out, errs = p.communicate(timeout=CLI_TIMEOUT_S)
            check(p.returncode == 0, f"{label}: exit code {p.returncode}\n{out[-3000:]}\n{errs[-3000:]}")
            return out

        # the AT run beside the DA run and then its --resume
        t0 = time.perf_counter()
        procs = {"at": start("train_net_mt", at_argv), "da": start("train_net", da_argv)}
        outs = {}
        try:
            # meanwhile one float32 step of each path on the card against the CPU's
            for kind in DA_KINDS:
                err = da_card_vs_cpu(kind)
                dc = {k: round(v, 6) for k, v in err["losses_cpu"].items()
                      if k.startswith("loss_DC") or k == "loss_consistency"}
                log(f"  card vs CPU, one float32 {kind} step at 128x256: " + format_errors(err, list(err["loss"])) +
                    f"; the CPU's DC losses {dc}")
                check(card_step_ok(err), f"{kind}: the card's step differs from the CPU's")
            outs["da"] = finish(procs["da"], "da CLI")
            # the DA checkpoint restores bit for bit in this process
            saved = torch.load(os.path.join(da_out, "model_final.pth"), map_location="cpu", weights_only=True)
            restored = cli_trainer(da_argv, resume=True)
            diff = state_diff(host_state(restored.checkpoint_state()), host_state(saved))
            check(diff == 0.0 and set(saved["trainer"]["heads"]) == {"da_img", "da_ins"},
                  f"DA restore differs by {diff}")
            del restored, saved
            da_lines = metrics_lines(da_out)  # before the resume appends to it
            with open(os.path.join(da_out, "eval_results.json")) as f:
                da_ev = json.load(f)
            procs["resume"] = start("train_net", resume_argv)
            outs["resume"] = finish(procs["resume"], "da --resume")
            outs["at"] = finish(procs["at"], "at CLI")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        cli_s = time.perf_counter() - t0

        # da, then cda with entropy conditioning, from the loaders
        captured = {}
        for kind, steps in (("da", DA_STEPS), ("cda", CDA_STEPS)):
            _kernels.reset_launches()
            cfg = da_cfg(kind, os.path.join(root, kind), "MODEL.WEIGHTS", weights)
            tr = build_trainer(cfg)
            tr.resume_or_load()
            check(tr.det_cfg.dtype == torch.float32 and tuple(cfg.TPU.CANVAS) == (608, 1216)
                  and tr.entropy_conditioning == (kind == "cda"), f"{kind}: configuration")
            heads0 = {f"{h}.{k}": v.clone() for h, m in tr.state.heads.items() for k, v in m.named_parameters()}
            metrics, wall, launches, captured[kind], prof, peak = da_run(tr, steps, kind, smi)
            add(dict(_kernels.LAUNCHES))
            want = DA_LAUNCHES[kind]
            check(all(c == want for d in launches for c in d.values()), f"{kind}: launches {launches}, expected {want}")
            check(all(m[k] > 0 for m in metrics for k in ("loss_DC_img", "loss_DC_ins", "loss_consistency")),
                  f"{kind}: DC losses {metrics}")
            heads = {f"{h}.{k}": v for h, m in tr.state.heads.items() for k, v in m.named_parameters()}
            moved = sum(not torch.equal(heads[k], v) for k, v in heads0.items())
            check(moved == len(heads0), f"{kind}: {moved} of {len(heads0)} DA head tensors moved")
            numbers[kind] = dict(step_ms=float(np.median(wall[1:])), busy=prof[1] / prof[0], peak_gib=peak,
                                 device_ms=prof[1])
            log(f"    DC losses of the last step: " + ", ".join(
                f"{k} {metrics[-1][k]:.4f}" for k in ("loss_DC_img", "loss_DC_ins", "loss_consistency")) +
                f"; all {len(heads0)} DA head tensors moved; launches {want} of each a step")
            del tr

        # the Adaptive Teacher across its cut burn-in
        _kernels.reset_launches()
        cfg = da_cfg("adaptive_teacher", os.path.join(root, "at"), "MODEL.WEIGHTS", at_weights,
                     "SEMISUPNET.BURN_UP_STEP", str(AT_BURN_UP), "SOLVER.BASE_LR", AT_BASE_LR, kind_opts=False)
        tr = build_trainer(cfg)
        tr.resume_or_load()
        check(tr.det_cfg.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in tr.state.teacher.parameters()),
              "adaptive_teacher: bfloat16 compute with a float32 EMA teacher")
        keep = np.float32(cfg.SEMISUPNET.EMA_KEEP_RATE)
        teacher0 = [p.clone() for p in tr.state.teacher.parameters()]
        snap, events = {}, []

        def on_step(i, phase):
            t_params = list(tr.state.teacher.parameters())
            s_params = list(tr.state.model.parameters())
            if phase == "before":
                snap["t"] = [p.clone() for p in t_params]
                snap["s"] = [p.clone() for p in s_params]
                snap["stats"] = [b.clone() for n, b in tr.state.teacher.named_buffers() if "running" in n]
                return
            stats = [b for n, b in tr.state.teacher.named_buffers() if "running" in n]
            stats_moved = any(not torch.equal(a, b) for a, b in zip(stats, snap["stats"]))
            if i < AT_BURN_UP:  # burn-in: parameters fixed, statistics moved by the pseudo forward
                check(all(torch.equal(a, b) for a, b in zip(t_params, teacher0)) and stats_moved,
                      f"AT step {i}: the teacher changed in burn-in")
                events.append("fixed")
            elif i == AT_BURN_UP:  # the copy of the student at the start of the step, no EMA at its end
                check(all(torch.equal(a, b) for a, b in zip(t_params, snap["s"])), f"AT step {i}: no boundary copy")
                events.append("copied")
            else:
                err = max(((t1 - (keep * t0 + (np.float32(1) - keep) * s1)).abs().max()
                           / s1.abs().max().clamp_min(1e-30)).item()
                          for t0, t1, s1 in zip(snap["t"], t_params, s_params))
                check(err <= 1e-6, f"AT step {i}: EMA rule off by {err:.3g}")
                events.append(f"ema {err:.2g}")

        metrics, wall, launches, captured["adaptive_teacher"], prof, peak = da_run(
            tr, AT_STEPS, "adaptive_teacher", smi, on_step)
        add(dict(_kernels.LAUNCHES))
        want = da_launches_per_step("adaptive_teacher", cfg)
        check(all(c == want for d in launches for c in d.values()), f"AT: launches {launches}, expected {want}")
        sup = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
        gated = []
        for i, m in enumerate(metrics):
            rest = m["total_loss"] - sum(m[k] for k in sup)
            check(all(np.isfinite(m[k]) for k in m), f"AT step {i}: {m}")
            if i < AT_BURN_UP:  # pseudo and DC losses computed, weighted 0
                check(abs(rest) <= 1e-5 * abs(m["total_loss"]) and m["loss_DC_img_s"] > 0, f"AT step {i}: {m}")
            else:
                check(rest > 1e-3 * abs(m["total_loss"]), f"AT step {i}: pseudo and DC losses not in the total {m}")
            gated.append(round(rest, 4))
        check(all(m["num_pseudo"] > 0 for m in metrics[AT_BURN_UP:]), "AT: no pseudo-labels after the boundary")
        numbers["adaptive_teacher"] = dict(step_ms=float(np.median(wall[1:])), busy=prof[1] / prof[0], peak_gib=peak,
                                           device_ms=prof[1])
        log(f"    teacher by step: {events}; total minus supervised by step {gated} (0 in burn-in); num_pseudo "
            f"{[int(m['num_pseudo']) for m in metrics]}; launches {want} of each a step")
        del tr

        # the source-free main YAML with both classifiers weighted
        _kernels.reset_launches()
        cfg = da_cfg("sfat_weighted", os.path.join(root, "sfat"), "MODEL.WEIGHTS", weights,
                     *[x for kv in ADAPT_CUTS.items() for x in kv])
        tr = build_trainer(cfg)
        tr.resume_or_load()
        dc0 = {f"{h}.{k}": v.clone() for h, m in tr.state.dc.items() for k, v in m.named_parameters()}
        metrics, wall, launches, captured["sfat_weighted"], prof, peak = da_run(tr, SFAT_DC_STEPS, "sfat_weighted", smi)
        add(dict(_kernels.LAUNCHES))
        want = DA_LAUNCHES["sfat_weighted"]
        check(all(c == want for d in launches for c in d.values()), f"SFAT: launches {launches}, expected {want}")
        dc_keys = ("loss_DC_img_s", "loss_DC_img_t", "loss_DC_ins_s", "loss_DC_ins_t")
        check(all(m[k] > 0 for m in metrics for k in dc_keys), f"SFAT DC losses {metrics}")
        dc = {f"{h}.{k}": v for h, m in tr.state.dc.items() for k, v in m.named_parameters()}
        moved = sum(not torch.equal(dc[k], v) for k, v in dc0.items())
        check(moved == len(dc0), f"SFAT: {moved} of {len(dc0)} classifier tensors moved")
        numbers["sfat_weighted"] = dict(step_ms=float(np.median(wall[1:])), busy=prof[1] / prof[0], peak_gib=peak,
                                        device_ms=prof[1])
        log(f"    DC losses of the last step: " + ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in dc_keys) +
            f"; all {len(dc0)} classifier tensors moved; launches {want} of each a step")
        del tr

        # every captured NMS input: kernels against their plain versions
        for label, calls in captured.items():
            kept = [check_kernels_against_plain(b, s, v, thr, f"{label} call {i}", cpu=i == 0)
                    for i, (b, s, v, thr) in enumerate(calls)]
            log(f"  {label}: the first step's {len(calls)} NMS inputs (N {[int(c[0].shape[0]) for c in calls]}), "
                f"kernels bit-equal to the plain versions, kept {kept}")

        # da: 3 a step, 2 an image of its TEST set in test(), 1 for the validation loss's image
        want_da = 3 * DA_CLI_ITERS + 2 * CLI_TEST_FRAMES + 1
        # AT: 5 a step, 2 an image and model (student, teacher) in test(), 1 for the validation loss
        want_at = 5 * AT_CLI_ITERS + 2 * 2 * CLI_TEST_FRAMES + 1
        for name, out, want, keys, n_ev, lines in (
                ("da", da_out, want_da, ("loss_DC_img", "loss_DC_ins", "loss_consistency"), 1, da_lines),
                ("at", at_out, want_at, ("loss_DC_img_s", "loss_DC_img_t", "loss_cls_pseudo"), 2, None)):
            got = cli_launches(outs[name])
            add(got)
            check(all(c == want for c in got.values()), f"{name} CLI: launches {got}, expected {want}")
            lines = lines or metrics_lines(out)
            check(lines and lines[-1]["iteration"] == DA_CLI_ITERS - 1
                  and all(np.isfinite(lines[-1][k]) for k in keys + ("total_loss",)), f"{name} CLI metrics {lines[-1:]}")
            if name == "at":
                with open(os.path.join(out, "eval_results.json")) as f:
                    ev = json.load(f)
            else:
                ev = da_ev
            check(len(ev) == n_ev and all(np.isfinite(v["AP50"]) for v in ev.values()), f"{name} CLI eval {ev}")
            log(f"  {name} CLI [{smi}]: total loss {lines[-1]['total_loss']:.4f}, AP50 "
                f"{ {k: round(v['AP50'], 4) for k, v in ev.items()} }, launches {got}")
        data = torch.load(os.path.join(at_out, "model_final.pth"), map_location="cpu", weights_only=True)
        check(any(k.startswith("modelTeacher.") for k in data["model"]) and any(
            k.startswith("modelStudent.") for k in data["model"]), "AT CLI: model_final.pth lacks a model")
        got = cli_launches(outs["resume"])
        add(got)
        check(all(c == want_da for c in got.values()), f"da --resume: launches {got}, expected {want_da}")
        lines = metrics_lines(da_out)
        check("resumed from" in outs["resume"] and lines[-1]["iteration"] == 2 * DA_CLI_ITERS - 1,
              f"da --resume: {lines[-1:]}")
        log(f"  train_net {DA_YAML} ({DA_CLI_ITERS} steps, checkpoints, test() at {DA_CLI_ITERS}), then --resume to "
            f"{2 * DA_CLI_ITERS}, beside train_net_mt {AT_YAML} ({AT_CLI_ITERS} steps across a burn-in of "
            f"{AT_CLI_BURN_UP}, test() of student and teacher), with the card-vs-CPU steps beside them: {cli_s:.2f} s; "
            f"the DA restore bit-equal to "
            f"model_final.pth; --resume: exit 0, metrics.json to {lines[-1]['iteration']}, launches {got}")
    finally:
        os.environ.pop("SFOD_DATASETS", None)
        for name in DA_DATASETS:
            DATASET_REGISTRY.pop(name, None)
        tmp.cleanup()
    log(f"  launches on the da path: {total}")
    return total, numbers


# ---------------------------------------------------------------------------
# the zoo phase: the bare VGG, the VGG-FPN detector and AdaIN style enhancement
# ---------------------------------------------------------------------------

# a seeded baseline JPEG of the repo (tests/test_torch_jpeg.py writes it from
# smooth_image(seed)): the style image of the enhance YAML's run
STYLE_JPEG = os.path.join(ROOT, "tests", "torch_jpeg", "f444_q90_45x63.jpg")
# pytorch-AdaIN's layouts: vgg_normalised.pth is VGG19 normalised to
# relu5_4 (the convs at these Sequential indices, 1x1 first), the decoder
# the mirror of its first 31 modules
ADAIN_VGG19 = {0: (3, 3, 1), 2: (64, 3, 3), 5: (64, 64, 3), 9: (128, 64, 3), 12: (128, 128, 3), 16: (256, 128, 3),
               19: (256, 256, 3), 22: (256, 256, 3), 25: (256, 256, 3), 29: (512, 256, 3), 32: (512, 512, 3),
               35: (512, 512, 3), 38: (512, 512, 3), 42: (512, 512, 3), 45: (512, 512, 3), 48: (512, 512, 3),
               51: (512, 512, 3)}
ADAIN_DECODER = {1: (256, 512), 5: (256, 256), 8: (256, 256), 11: (256, 256), 14: (128, 256), 18: (128, 128),
                 21: (64, 128), 25: (64, 64), 28: (3, 64)}


def write_adain_files(root: str, seed: int = SEED) -> tuple:
    """Seeded AdaIN weights as pytorch-AdaIN writes them: `vgg_normalised.pth`
    (all of VGG19's Sequential keys, '<idx>.weight'/'<idx>.bias') and
    `decoder_iter_160000.pth.tar`, each a torch.save of an ordered state
    dict. Kernels normal with std sqrt(2 / fan_in) where a ReLU follows
    (the activations keep their scale through the stack), sqrt(1 / fan_in)
    for the encoder's first 1x1 conv and sqrt(0.25 / fan_in) for the
    decoder's last, biases normal(0, 0.01), and the decoder's last bias 0.5:
    a view of mid-range pixels with structure, as trained weights give,
    where all-small weights would decode an almost black image (on which
    train-mode BatchNorm amplifies rounding). -> (encoder path, decoder
    path)."""
    from collections import OrderedDict

    g = torch.Generator().manual_seed(seed)

    def conv(out_c, in_c, k, gain):
        w = torch.empty(out_c, in_c, k, k).normal_(0.0, (gain / (in_c * k * k)) ** 0.5, generator=g)
        return w, torch.empty(out_c).normal_(0.0, 0.01, generator=g)

    paths = []
    last = max(ADAIN_DECODER)
    for name, layout in (("vgg_normalised.pth", {i: (*s, 1.0 if i == 0 else 2.0) for i, s in ADAIN_VGG19.items()}),
                         ("decoder_iter_160000.pth.tar",
                          {i: (*s, 3, 0.25 if i == last else 2.0) for i, s in ADAIN_DECODER.items()})):
        sd = OrderedDict()
        for idx, shape in layout.items():
            sd[f"{idx}.weight"], sd[f"{idx}.bias"] = conv(*shape)
        if name.startswith("decoder"):
            sd[f"{last}.bias"].fill_(0.5)
        paths.append(os.path.join(root, name))
        torch.save(sd, paths[-1])
    return tuple(paths)


ZOO_NOBN_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_source_nobn.yaml"
ZOO_NOBN_SFAT_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_nobn.yaml"
ZOO_FPN_YAML = "configs/vgg16_fpn_cityscapes_to_foggy_source.yaml"
ZOO_ENHANCE_YAML = "configs/faster_rcnn_VGG_cityscapes_foggy_enhance.yaml"
ZOO_STEPS = 6  # steps of each run (the first excluded from the median)
ZOO_CLI_ITERS = 4
# the bare VGG from random weights at the source YAMLs' BASE_LR 0.04 can
# diverge within a few steps: every zoo run takes the SFAT YAMLs' 0.0025
ZOO_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.0025", "VIS_PERIOD", "0",
            "SOLVER.CHECKPOINT_PERIOD", "100000"]


def zoo_cfg(yaml: str, out: str, *opts: str):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml), allow_new=True)
    cfg.merge_from_list([*ZOO_OPTS, "OUTPUT_DIR", out, *opts])
    return cfg


def zoo_weights(cfg, boost: float = CLS_BIAS_BOOST) -> dict:
    """Seeded weights of the config's detector with the class-1 logit bias
    raised (pseudo-labels from random weights)."""
    model = init_weights(empty_model(detector_config_from_cfg(cfg)), SEED)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias[1] += boost
    return model.state_dict()


def zoo_card_vs_cpu(cfg, sd: dict, sfat: bool, canvas=(128, 256), image_hw=(120, 250)):
    """One float32 step of the config's trainer on the card and on the CPU
    from the same weights, batch and draws. -> the errors of state_errors
    (and each loss's, the counts' equality), as da_card_vs_cpu."""
    cpu, card = build_trainer(cfg, device="cpu", state_dict=sd), build_trainer(cfg, device="cuda", state_dict=sd)
    if sfat:
        for tr in (cpu, card):
            with torch.no_grad():
                tr.state.model.roi_heads.box_predictor.bbox_pred.bias += BBOX_OFFSET
    start = {k: v.clone() for k, v in cpu.state.model.state_dict().items()}
    batch = synthetic_batch(make_synthetic_records(1, tuple(image_hw), 8, 6, seed=SEED), tuple(canvas),
                            cfg.TPU.GT_CAPACITY)
    draws = cpu.make_draws(1, tuple(canvas)) if sfat else cpu.make_draws(1, tuple(canvas), cfg.TPU.GT_CAPACITY)
    args = ({"images": batch["images"], "sizes": batch["sizes"]},) if sfat else (batch,)
    mc = {k: float(v) for k, v in cpu.run_step(*args, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(*args, draws.to("cuda") if sfat else draws).items()}
    losses = [k for k in mc if k.startswith("loss") or k == "total_loss"]
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in losses},
           "counts_equal": all(mg[k] == mc[k] for k in mc if k.startswith("num_")), "losses_cpu": mc}
    out.update(state_errors(start, cpu.state.model.state_dict(), card.state.model.state_dict()))
    if sfat:
        img = torch.from_numpy(batch["images"]).float()
        out["stylize"] = (card.style.stylize(img.cuda()).cpu() - cpu.style.stylize(img)).abs().max().item()
    return out


def zoo_run(tr, steps: int, label: str, smi: str, want_launches: int, sync_error: bool = False):
    """`steps` steps of a built trainer on batches from its loader (staging
    outside the timed step), the first step's NMS inputs captured; every
    step under set_sync_debug_mode("error") with `sync_error`, else one
    more step under it; a profiled step. -> (metrics, median ms, captured
    NMS inputs, a dict of numbers)."""
    it = iter(tr.build_train_loader())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, wall, launches, captured = [], [], [], []
    orig, record = capture_nms(captured)
    for i in range(steps + (0 if sync_error else 1)):
        staged = tr.stage(next(it))
        strict = sync_error or i == steps
        start = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms.nms_mask_matrix = record if i == 0 else orig
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            m = tr.step_staged(staged)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            nms.nms_mask_matrix = orig
        torch.cuda.synchronize()
        if i < steps:
            wall.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: c - start[k] for k, c in _kernels.LAUNCHES.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    staged = tr.stage(next(it))
    prof = profile(lambda: tr.step_staged(staged), 1, ops=True)
    it.close()
    bad = [(i, k) for i, m in enumerate(metrics) for k, v in m.items() if k.startswith("loss") and not np.isfinite(v)]
    check(not bad and all(np.isfinite(m["total_loss"]) for m in metrics), f"{label}: non-finite losses {bad}")
    check(all(c == want_launches for d in launches for c in d.values()),
          f"{label}: launches a step {launches}, expected {want_launches}")
    med = float(np.median(wall[1:]))
    log(f"  {label} ({tr.__class__.__name__}, batch {staged[0].shape[0]}, {staged[0].shape[1]}x{staged[0].shape[2]}, "
        f"{str(tr.det_cfg.dtype).split('.')[-1]}) [{smi}]: step {med:.2f} ms (median of steps 1-{steps - 1}; first "
        f"{wall[0]:.1f} ms), peak {peak:.2f} GiB; {'every step' if sync_error else 'a step'} under "
        f"set_sync_debug_mode('error'); profiled step: wall {prof[0]:.2f} ms, device {prof[1]:.2f} ms, busy "
        f"{prof[1] / prof[0]:.1%}; launches {want_launches} of each a step")
    log(f"    total loss {[round(m['total_loss'], 4) for m in metrics]}; top kernels (ms): {top(prof[2], 4)}; "
        f"top ops (self device ms): {top(prof[3], 4)}")
    return metrics, med, captured, dict(step_ms=med, busy=prof[1] / prof[0], peak_gib=peak, device_ms=prof[1],
                                        launches_per_step=want_launches)


def zoo_phase(smi: str):
    """The zoo phase (module docstring). -> (the launches of each kernel on
    the path, a dict of numbers)."""
    from simple_sfod_tpu_torch.engine import export

    total = {k: 0 for k in _kernels.LAUNCHES}

    def add(d):
        for k in total:
            total[k] += d[k]

    numbers, secs = {}, {}
    t_sec = [time.perf_counter()]

    def lap(name):  # the wall of each part of the phase
        now = time.perf_counter()
        secs[name] = round(now - t_sec[0], 2)
        t_sec[0] = now

    tmp = tempfile.TemporaryDirectory(prefix="sfod_zoo_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    cli = None
    try:
        t0 = time.perf_counter()
        write_cityscapes_car(data_root)  # cityscapes_instancesonly_train: the source YAMLs' TRAIN
        write_cli_datasets(data_root)  # the foggy TRAIN_TARGET and both TEST sets
        enc, dec = write_adain_files(root)
        style_opts = ["STYLE.STYLE_IMAGE", STYLE_JPEG, "STYLE.VGG_MODEL", enc, "STYLE.DECODER", dec]
        adapt_cuts = [x for kv in ADAPT_CUTS.items() if kv[0] != "SOLVER.BASE_LR" for x in kv]
        main_weights = os.path.join(root, "main.pth")
        write_cli_weights(main_weights)
        nobn_weights = os.path.join(root, "nobn.pth")
        torch.save({"model": zoo_weights(zoo_cfg(ZOO_NOBN_SFAT_YAML, root))}, nobn_weights)
        for name in DA_DATASETS:
            DATASET_REGISTRY.pop(name, None)
        os.environ["SFOD_DATASETS"] = data_root
        log(f"  wrote the PNG frames' datasets, seeded AdaIN files ({os.path.getsize(enc) / 2**20:.1f} + "
            f"{os.path.getsize(dec) / 2**20:.1f} MiB) and weights in {time.perf_counter() - t0:.2f} s")
        lap("data")

        captured = {}
        # the bare VGG: base steps, then SFAT steps at batch 4
        for key, yaml, want_launches, weights in (("nobn_source", ZOO_NOBN_YAML, 4, None),
                                                  ("nobn_sfat", ZOO_NOBN_SFAT_YAML, 12, nobn_weights)):
            _kernels.reset_launches()
            cfg = zoo_cfg(yaml, os.path.join(root, key), *(["MODEL.WEIGHTS", weights] if weights else []))
            tr = build_trainer(cfg)
            tr.resume_or_load()
            check(not tr.det_cfg.vgg_bn and not tr._batchnorms() and tr.det_cfg.dtype == torch.bfloat16,
                  f"{key}: configuration")
            metrics, _, captured[key], numbers[key] = zoo_run(tr, ZOO_STEPS, key, smi, want_launches)
            add(dict(_kernels.LAUNCHES))
            if weights:
                check(all(m["num_pseudo"] > 0 for m in metrics), f"{key}: no pseudo-labels")
            del tr
            lap(key)

        # FPN: base steps, test()
        _kernels.reset_launches()
        cfg = zoo_cfg(ZOO_FPN_YAML, os.path.join(root, "fpn"))
        tr = build_trainer(cfg)
        check(tr.det_cfg.fpn and not tr.det_cfg.vgg_bn and tr.det_cfg.rpn_pre_nms_topk_train == 2000,
              "fpn: configuration")
        _, _, captured["fpn_source"], numbers["fpn_source"] = zoo_run(tr, ZOO_STEPS, "fpn_source", smi, 4)
        add(dict(_kernels.LAUNCHES))
        check(all(int(c[2].shape[0]) <= 2000 for c in captured["fpn_source"]), "fpn: merged NMS inputs above 2000")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = tr.test()
        test_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        add(launches)
        n_test = 2 * CLI_TEST_FRAMES
        check(all(c == 2 * n_test for c in launches.values()) and len(res) == 2
              and all(np.isfinite(v["AP50"]) for v in res.values()), f"fpn test(): {res} launches {launches}")
        log(f"  fpn test() on {n_test} frames [{smi}]: {test_s:.2f} s ({n_test / test_s:.2f} images/s), launches "
            f"{launches} (2 an image), AP50 { {k: round(v['AP50'], 4) for k, v in res.items()} }")
        lap("fpn_source")

        # the CLI on the enhance YAML in a process of its own, beside the
        # untimed work: the FPN artifact, its requests, the card-vs-CPU steps
        cli_out = os.path.join(root, "enhance_cli")
        argv = ["--config-file", os.path.join(ROOT, ZOO_ENHANCE_YAML), *ZOO_OPTS, *style_opts, *adapt_cuts,
                "MODEL.WEIGHTS", main_weights, "OUTPUT_DIR", cli_out, "SOLVER.MAX_ITER", str(ZOO_CLI_ITERS),
                "TEST.EVAL_PERIOD", str(ZOO_CLI_ITERS)]
        t_cli = time.perf_counter()
        cli = Background(car_cli, "train_net_mt", argv, data_root, "enhance CLI")

        # the trained weights, with the class-1 logit bias raised so that its
        # few steps from random weights still give detections to serve
        fpn_sd = {k: v.clone() for k, v in tr.detector.model.state_dict().items()}
        fpn_sd["roi_heads.box_predictor.cls_score.bias"][1] += CLS_BIAS_BOOST
        eager = Detector(tr.det_cfg).load_state_dict(fpn_sd)
        path = os.path.join(root, "fpn.sfodx")
        t0 = time.perf_counter()
        program = export.export_inference(eager, fpn_sd, tuple(cfg.TPU.CANVAS))
        export.save_exported(program, path, {"config": os.path.basename(ZOO_FPN_YAML), "model": "student"})
        export_s = time.perf_counter() - t0
        del program
        # the reloaded artifact against eager inference on one canvas (the export tool's --selfcheck bounds)
        module = load_exported(path)[0].module()
        bench = synthetic_batch(make_synthetic_records(1, IMAGE_HW, 8, 6, seed=SEED), tuple(cfg.TPU.CANVAS), 8)
        images, sizes = torch.from_numpy(bench["images"]).cuda(), torch.from_numpy(bench["sizes"]).cuda()
        _kernels.reset_launches()
        with torch.inference_mode():
            got = module(images, sizes)
        add(dict(_kernels.LAUNCHES))
        want = eager.infer(images, sizes)
        same, bd, sd = det_diff(got, want)
        check(same and int(want.valid.sum()) > 0,
              f"fpn artifact: valid or classes differ from eager inference (valid {int(got['valid'].sum())} vs "
              f"{int(want.valid.sum())}, boxes {bd:.3g}, scores {sd:.3g})")
        torch.testing.assert_close(got["boxes"], want.boxes, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["scores"], want.scores, rtol=1e-5, atol=1e-5)
        del module, tr, eager
        service = DetectionService(path, max_wait_ms=SERVE_WAIT_MS)
        srv, url = serve_in_thread(service)
        try:
            rng = np.random.RandomState(SEED + 17)
            imgs = [rng.randint(0, 256, IMAGE_HW + (3,)).astype(np.uint8) for _ in range(2)]
            _kernels.reset_launches()
            served = [http_post(url, npy_bytes(im)) for im in imgs]
            launches = dict(_kernels.LAUNCHES)
        finally:
            srv.shutdown()
            srv.server_close()
            service.close()
        add(launches)
        for i, (r, _) in enumerate(served):
            check_served(r, IMAGE_HW, f"fpn artifact request {i}")
        check(all(c == 2 * len(imgs) for c in launches.values()), f"fpn artifact: launches {launches}")
        log(f"  fpn artifact (beside the CLI): export + save {export_s:.2f} s, {os.path.getsize(path) / 2**20:.1f} MiB; "
            f"reloaded == eager in valid and classes ({int(want.valid.sum())} detections), max difference boxes "
            f"{bd:.3g} px, scores {sd:.3g}; 2 requests through HTTP {[round(ms, 1) for _, ms in served]} ms [{smi}], "
            f"{[len(r['detections']) for r, _ in served]} detections, launches {launches}")
        numbers["fpn_source"].update(test_s=test_s, export_s=export_s, served_ms=[ms for _, ms in served])
        lap("fpn_artifact")

        for label, yaml, sfat, extra in (("FPN base", ZOO_FPN_YAML, False, []),
                                         ("style SFAT", ZOO_ENHANCE_YAML, True, style_opts)):
            cfg = zoo_cfg(yaml, tempfile.gettempdir(), "TPU.CANVAS", "(128, 256)", "TPU.DTYPE", "float32",
                          "SOLVER.IMS_PER_BATCH", "1", *extra)
            err = zoo_card_vs_cpu(cfg, zoo_weights(cfg), sfat)
            log(f"  card vs CPU, one float32 {label} step at 128x256: " + format_errors(err, list(err["loss"])) +
                (f"; stylised view max abs diff {err['stylize']:.3g} (0-255)" if sfat else ""))
            check(card_step_ok(err) and err.get("stylize", 0.0) <= 1e-2, f"{label}: the card's step differs")
        lap("card_vs_cpu")

        out, cli_s, got = cli.result()
        lap("cli_wait")
        add(got)
        lines = metrics_lines(cli_out)
        with open(os.path.join(cli_out, "eval_results.json")) as f:
            ev = json.load(f)
        # 3 a step; in test() 2 an image of each of the two TEST sets and each model; 1 for the validation loss
        want = 3 * ZOO_CLI_ITERS + 2 * 2 * 2 * CLI_TEST_FRAMES + 1
        check(all(c == want for c in got.values()), f"enhance CLI: launches {got}, expected {want}")
        check(lines and lines[-1]["iteration"] == ZOO_CLI_ITERS - 1 and np.isfinite(lines[-1]["total_loss"])
              and len(ev) == 4 and all(np.isfinite(v["AP50"]) for v in ev.values()), f"enhance CLI: {lines[-1:]} {ev}")
        check("[style]" not in out, "enhance CLI: a style file was not read")
        log(f"  train_net_mt {ZOO_ENHANCE_YAML} (seeded AdaIN .pth files, {os.path.basename(STYLE_JPEG)}; "
            f"{ZOO_CLI_ITERS} steps, test()) beside the artifact and the card-vs-CPU steps: "
            f"{time.perf_counter() - t_cli:.2f} s, its process {cli_s:.2f} s; total loss "
            f"{lines[-1]['total_loss']:.4f}; launches {got}")

        # the enhance YAML: SFAT steps with the style view, every step under sync-debug "error"
        _kernels.reset_launches()
        cfg = zoo_cfg(ZOO_ENHANCE_YAML, os.path.join(root, "enhance"), *style_opts, *adapt_cuts, "MODEL.WEIGHTS",
                      main_weights)
        tr = build_trainer(cfg)
        tr.resume_or_load()
        check(tr.style is not None and not tr.weak_strong and tuple(tr.style.style_image.shape) == (3, 45, 63),
              "enhance: the style module")
        metrics, _, captured["enhance"], numbers["enhance"] = zoo_run(tr, ZOO_STEPS, "enhance", smi, 3,
                                                                      sync_error=True)
        add(dict(_kernels.LAUNCHES))
        check(all(m["num_pseudo"] > 0 for m in metrics), "enhance: no pseudo-labels")
        img = torch.from_numpy(synthetic_image(make_synthetic_records(1, IMAGE_HW, 8, 6, seed=SEED)[0]))[None]
        img = torch.nn.functional.pad(img.float().cuda(), (0, 0, 0, 16, 0, 8))
        style_ms = time_ms(lambda: tr.style.stylize(img), 5)
        prof = profile(lambda: tr.style.stylize(img), 2)
        numbers["enhance"].update(stylize_ms=style_ms, stylize_device_ms=prof[1])
        log(f"  stylize alone, one 608x1216 image, float32 [{smi}]: {style_ms:.2f} ms (CUDA events), device "
            f"{prof[1]:.2f} ms; top kernels {top(prof[2], 3)}")
        del tr
        lap("enhance")

        for label, calls in captured.items():
            kept = [check_kernels_against_plain(b, s, v, thr, f"{label} call {i}", cpu=i == 0)
                    for i, (b, s, v, thr) in enumerate(calls)]
            log(f"  {label}: the first step's {len(calls)} NMS inputs (N {sorted({int(c[0].shape[0]) for c in calls})}), "
                f"kernels bit-equal to the plain versions, kept {kept}")
        lap("nms_checks")
        log(f"  the phase's parts (s): {secs}")
        numbers["parts_s"] = secs
    finally:
        if cli is not None:
            cli.join()
        os.environ.pop("SFOD_DATASETS", None)
        for name in DA_DATASETS:
            DATASET_REGISTRY.pop(name, None)
        tmp.cleanup()
    log(f"  launches on the zoo path: {total}")
    return total, numbers


# ---------------------------------------------------------------- settings
SET_SIM10K_YAML = "configs/faster_rcnn_VGG_sim10k_source.yaml"
SET_NOBN_YAML = ZOO_NOBN_YAML  # VGG.BN False (the Sim10k and KITTI _nobn YAMLs build VGG16-BN)
SET_STEPS = 6  # steps of each timed run (the first excluded from the median)
SET_CLI_ITERS = 4
SET_MC_SAMPLES = 10
SET_MC_IMAGES = 2
SET_RFPN_BATCH = 2
SET_BN_IMAGES = 4
SET_RES = ("res2", "res3", "res4", "res5")
# the source YAMLs' BASE_LR 0.04 diverges within 4 steps from the seeded
# ImageNet files (a NaN loss at step 3 of the bare VGG): the zoo runs' 0.0025
SET_CLI_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.0025", "VIS_PERIOD", "0",
                "SOLVER.CHECKPOINT_PERIOD", "100000",
                "SOLVER.IMS_PER_BATCH", str(CAR_BATCH), "SOLVER.MAX_ITER", str(SET_CLI_ITERS), "TEST.EVAL_PERIOD",
                str(SET_CLI_ITERS)]
TV_VGG16_BN_CONVS = (0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40)
TV_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def write_torchvision_vgg(path: str, bn: bool, seed: int = SEED) -> dict:
    """A seeded state dict with torchvision vgg16(_bn)'s names and full
    widths (an ImageNet file's layout: features.{i}.*, BatchNorms with their
    statistics, a classifier that the detector drops; the classifier cut
    small), saved to `path`. -> the dict."""
    g = torch.Generator().manual_seed(seed)
    widths = [w for stage in ((64, 64), (128, 128), (256,) * 3, (512,) * 3, (512,) * 3) for w in stage]
    sd, c_in = {}, 3
    for idx, c in zip(TV_VGG16_BN_CONVS if bn else TV_VGG16_CONVS, widths):
        sd[f"features.{idx}.weight"] = torch.randn((c, c_in, 3, 3), generator=g) / (9 * c_in) ** 0.5
        sd[f"features.{idx}.bias"] = torch.randn((c,), generator=g) * 0.05
        if bn:
            sd[f"features.{idx + 1}.weight"] = 0.5 + torch.rand((c,), generator=g)
            sd[f"features.{idx + 1}.bias"] = torch.randn((c,), generator=g) * 0.05
            sd[f"features.{idx + 1}.running_mean"] = torch.randn((c,), generator=g) * 0.1
            sd[f"features.{idx + 1}.running_var"] = 0.5 + 1.5 * torch.rand((c,), generator=g)
            sd[f"features.{idx + 1}.num_batches_tracked"] = torch.tensor(1000)
        c_in = c
    sd["classifier.0.weight"] = torch.randn((16, 8), generator=g)
    sd["classifier.0.bias"] = torch.zeros(16)
    torch.save(sd, path)
    return sd


def imagenet_loaded(cfg, tv: dict) -> tuple:
    """The config's trainer with the torchvision file as MODEL.WEIGHTS: ->
    (the loader's printed line, backbone tensors that differ from the
    file's import, backbone tensors compared)."""
    from simple_sfod_tpu_torch.checkpoint import torch_import

    tr = build_trainer(cfg)
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        tr.resume_or_load()
    finally:
        sys.stdout = stdout
    want = torch_import.import_torchvision_vgg(tv, tr.det_cfg.vgg_bn, tr.det_cfg.fpn)
    got = tr.state.model.state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    bad = [k for k in keys if not torch.equal(got[k].cpu(), want[k])]
    del tr
    return buf.getvalue().strip(), bad, len(keys)


def rfpn_config(cfg):
    """ResNet-50 (NORM BN) under the FPN of the config's detector, as the
    JAX package builds it from a DetectorConfig (no YAML names it)."""
    import dataclasses

    return dataclasses.replace(detector_config_from_cfg(cfg), backbone="resnet50", resnet_norm="BN",
                               fpn_in_features=SET_RES)


def rfpn_card_vs_cpu(cfg, det_cfg, canvas=(128, 256), image_hw=(120, 250)):
    """One float32 base step of the R50-FPN detector on the card and on the
    CPU from the same seeded weights, batch and draws (state_errors)."""
    sd = init_weights(empty_model(det_cfg), SEED).state_dict()
    cpu, card = (BaseTrainer(cfg, device=d, state_dict=sd, det_cfg=det_cfg) for d in ("cpu", "cuda"))
    start = {k: v.clone() for k, v in cpu.state.model.state_dict().items()}
    batch = synthetic_batch(make_synthetic_records(2, tuple(image_hw), 8, 6, seed=SEED), tuple(canvas),
                            cfg.TPU.GT_CAPACITY)
    draws = cpu.make_draws(2, tuple(canvas), cfg.TPU.GT_CAPACITY)
    mc = {k: float(v) for k, v in cpu.run_step(batch, draws).items()}
    mg = {k: float(v) for k, v in card.run_step(batch, draws).items()}
    out = {"loss": {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in TRAIN_LOSSES},
           "counts_equal": all(mg[k] == mc[k] for k in ("num_fg", "num_sampled")), "losses_cpu": mc}
    out.update(state_errors(start, cpu.state.model.state_dict(), card.state.model.state_dict()))
    return out


def mc_card_vs_cpu(cfg, canvas=(128, 256), image_hw=(120, 250)) -> tuple:
    """MC dropout of a float32 detector at 128x256 on the card and on the
    CPU, from the same seeded weights (class-1 logit raised), images and
    keep masks. -> (valid equal, largest mean and std differences on valid
    rows, valid rows)."""
    from simple_sfod_tpu_torch.models.faster_rcnn import box_dropout_masks
    from simple_sfod_tpu_torch.models.uncertainty import mc_dropout_box_outputs

    det_cfg = detector_config_from_cfg(cfg)
    sd = zoo_weights(cfg)
    batch = synthetic_batch(make_synthetic_records(2, tuple(image_hw), 8, 6, seed=SEED), tuple(canvas), 8)
    rows = 2 * proposal_counts(det_cfg, anchor_counts(det_cfg, tuple(canvas)), False)[1]
    out = {}
    for dev in ("cpu", "cuda"):
        det = Detector(det_cfg, dev).load_state_dict(sd)
        keep = box_dropout_masks(det_cfg, SET_MC_SAMPLES * rows, torch.Generator().manual_seed(SEED), "cpu")
        out[dev] = [t.cpu() for t in mc_dropout_box_outputs(det, batch["images"], batch["sizes"], SET_MC_SAMPLES,
                                                             keep=tuple(k.to(dev) for k in keep))]
    (mc, sc, _, vc), (mg, sg, _, vg) = out["cpu"], out["cuda"]
    return (torch.equal(vc, vg), (mg - mc)[vc].abs().max().item(), (sg - sc)[vc].abs().max().item(),
            int(vc.sum()))


def set_tool_then_train(vgg_path: str, out: str, data_root: str) -> tuple:
    """The port's import_weights tool (torchvision vgg16.pth into the bare
    VGG YAML's detector), then train_net from its output, each in a process
    of its own. -> (the tool's stdout, train_net's (stdout, wall s, launches))."""
    init = os.path.join(out, "vgg16_init.pth")
    res = subprocess.run([sys.executable, "-m", "simple_sfod_tpu_torch.tools.import_weights", "--torch", vgg_path,
                          "--kind", "torchvision_vgg", "--config-file", os.path.join(ROOT, SET_NOBN_YAML),
                          "--output", init], cwd=ROOT, env=cli_env(data_root), capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    check(res.returncode == 0, f"import_weights: exit code {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    argv = ["--config-file", os.path.join(ROOT, SET_NOBN_YAML), *SET_CLI_OPTS, "MODEL.WEIGHTS", init,
            "OUTPUT_DIR", os.path.join(out, "train")]
    return res.stdout, init, car_cli("train_net", argv, data_root, "train_net on the import_weights output")


def settings_phase(smi: str):
    """The settings phase (module docstring). -> (the launches of each
    kernel on the path, a dict of numbers)."""
    from simple_sfod_tpu_torch.checkpoint import torch_import
    from simple_sfod_tpu_torch.models.uncertainty import mc_dropout_box_outputs

    total = {k: 0 for k in _kernels.LAUNCHES}

    def add(d):
        for k in total:
            total[k] += d[k]

    numbers, secs = {}, {}
    t_sec = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = round(now - t_sec[0], 2)
        t_sec[0] = now

    tmp = tempfile.TemporaryDirectory(prefix="sfod_settings_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    names = ("sim10k_trainval", "cityscapes_car_val", "cityscapes_instancesonly_train") + DA_DATASETS
    background = []
    try:
        write_sim10k(data_root)
        write_cityscapes_car(data_root)
        write_cli_datasets(data_root)
        main_weights = os.path.join(root, "main.pth")
        write_cli_weights(main_weights)
        tv_bn = write_torchvision_vgg(os.path.join(root, "vgg16_bn.pth"), True)
        tv = write_torchvision_vgg(os.path.join(root, "vgg16.pth"), False, seed=SEED + 1)
        for name in names:
            DATASET_REGISTRY.pop(name, None)
        os.environ["SFOD_DATASETS"] = data_root
        lap("data")

        # dropout: the main SFAT YAML with ROI_BOX_HEAD.DROPOUT 0.5, batch 1
        captured = {}
        _kernels.reset_launches()
        adapt_cuts = [x for kv in ADAPT_CUTS.items() if kv[0] != "SOLVER.BASE_LR" for x in kv]
        cfg = zoo_cfg(CLI_YAML, os.path.join(root, "dropout"), *adapt_cuts, "MODEL.WEIGHTS", main_weights,
                      "MODEL.ROI_BOX_HEAD.DROPOUT", "0.5", "SOLVER.IMS_PER_BATCH", "1")
        tr = build_trainer(cfg)
        tr.resume_or_load()
        check(tr.detector.model.roi_heads.box_head.dropout == 0.5 and tr.det_cfg.dtype == torch.bfloat16,
              "dropout: configuration")
        metrics, _, captured["dropout_sfat"], numbers["dropout_sfat"] = zoo_run(tr, SET_STEPS, "dropout_sfat", smi, 3)
        add(dict(_kernels.LAUNCHES))
        check(all(m["num_pseudo"] > 0 for m in metrics), "dropout: no pseudo-labels")
        lap("dropout_sfat")

        # MC dropout: K passes of the trained student's box head on 2 images
        det = tr.detector
        bench = synthetic_batch(make_synthetic_records(SET_MC_IMAGES, IMAGE_HW, 8, 6, seed=SEED + 3),
                                tuple(cfg.TPU.CANVAS), 8)
        images, sizes = torch.from_numpy(bench["images"]).cuda(), torch.from_numpy(bench["sizes"]).cuda()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        captured["mc_dropout"] = []
        orig, record = capture_nms(captured["mc_dropout"])
        _kernels.reset_launches()
        nms.nms_mask_matrix = record
        try:
            mean, std, boxes, valid = mc_dropout_box_outputs(det, images, sizes, SET_MC_SAMPLES, generator=g)
        finally:
            nms.nms_mask_matrix = orig
        launches = dict(_kernels.LAUNCHES)
        r = det.cfg.rpn_post_nms_topk_test
        sums = mean.sum(-1)[valid]
        check(all(c == SET_MC_IMAGES for c in launches.values()) and tuple(mean.shape) == (SET_MC_IMAGES, r, 9)
              and tuple(std.shape) == tuple(mean.shape) and bool(torch.isfinite(mean).all())
              and bool(torch.isfinite(std).all()) and int(valid.sum()) > 0 and float(std[valid].max()) > 0
              and float((sums - 1).abs().max()) < 1e-4,
              f"mc dropout: launches {launches}, shapes {tuple(mean.shape)}, valid {int(valid.sum())}")
        mc_ms = time_ms(lambda: mc_dropout_box_outputs(det, images, sizes, SET_MC_SAMPLES, generator=g), 5)
        prof = profile(lambda: mc_dropout_box_outputs(det, images, sizes, SET_MC_SAMPLES, generator=g), 2)
        add(dict(_kernels.LAUNCHES))  # the checked call's, the timed calls' and the profiled ones
        numbers["mc_dropout"] = dict(ms=mc_ms, device_ms=prof[1], busy=prof[1] / prof[0], samples=SET_MC_SAMPLES,
                                     images=SET_MC_IMAGES, rois=r)
        log(f"  mc_dropout_box_outputs (K {SET_MC_SAMPLES}, {SET_MC_IMAGES} images, {r} proposals each, "
            f"{cfg.TPU.CANVAS[0]}x{cfg.TPU.CANVAS[1]}, bfloat16) [{smi}]: {mc_ms:.2f} ms a call (CUDA events), "
            f"profiled: wall {prof[0]:.2f} ms, device {prof[1]:.2f} ms, busy {prof[1] / prof[0]:.1%}; "
            f"{int(valid.sum())} valid rows, softmax std up to {float(std[valid].max()):.3g}; launches {launches} "
            f"(1 an image); top kernels (ms): {top(prof[2], 4)}")
        del tr, det
        lap("mc_dropout")

        # ResNet-50 under FPN: base steps at batch 2, AdaBN's update, inference
        _kernels.reset_launches()
        cfg = zoo_cfg(ZOO_FPN_YAML, os.path.join(root, "rfpn"), "SOLVER.IMS_PER_BATCH", str(SET_RFPN_BATCH))
        det_cfg = rfpn_config(cfg)
        tr = BaseTrainer(cfg, det_cfg=det_cfg)
        check(tr.det_cfg.fpn and tr.det_cfg.backbone == "resnet50" and tr.det_cfg.dtype == torch.bfloat16
              and len(tr._batchnorms()) > 50, "rfpn: configuration")
        n_anchors = sum(anchor_counts(det_cfg, tuple(cfg.TPU.CANVAS)))
        _, _, captured["rfpn"], numbers["rfpn"] = zoo_run(tr, SET_STEPS, "rfpn", smi, SET_RFPN_BATCH)
        add(dict(_kernels.LAUNCHES))
        bench = synthetic_batch(make_synthetic_records(SET_BN_IMAGES, IMAGE_HW, 8, 6, seed=SEED + 5),
                                tuple(cfg.TPU.CANVAS), 8)
        images, sizes = torch.from_numpy(bench["images"]).cuda(), torch.from_numpy(bench["sizes"]).cuda()
        bns = tr._batchnorms()
        before = [b.running_var.clone() for b in bns]
        tr.detector.bn_update(images)
        check(all(not torch.equal(b.running_var, v) and bool(torch.isfinite(b.running_var).all())
                  for b, v in zip(bns, before)), "rfpn: bn_update left a statistic or made it non-finite")
        bn_ms = time_ms(lambda: tr.detector.bn_update(images), 3, warmup=1)
        # the class-1 logit raised, so that the few steps from random weights give detections
        with torch.no_grad():
            tr.detector.model.roi_heads.box_predictor.cls_score.bias[1] += CLS_BIAS_BOOST
        captured["rfpn_infer"] = []
        orig, record = capture_nms(captured["rfpn_infer"])
        _kernels.reset_launches()
        nms.nms_mask_matrix = record
        try:
            dets = tr.detector.infer(images, sizes)
        finally:
            nms.nms_mask_matrix = orig
        launches = dict(_kernels.LAUNCHES)
        check(all(c == 2 * SET_BN_IMAGES for c in launches.values()) and bool(torch.isfinite(dets.boxes).all())
              and int(dets.valid.sum()) > 0, f"rfpn infer: launches {launches}, {int(dets.valid.sum())} detections")
        infer_ms = time_ms(lambda: tr.detector.infer(images, sizes), 5)
        add(dict(_kernels.LAUNCHES))
        numbers["rfpn"].update(bn_update_ms=bn_ms, infer_ms=infer_ms, anchors=n_anchors)
        log(f"  rfpn: {n_anchors} anchors an image over p2..p6; bn_update on {SET_BN_IMAGES} images {bn_ms:.2f} ms "
            f"(CUDA events; {len(bns)} BatchNorms moved); infer (class-1 logit raised by {CLS_BIAS_BOOST}) on {SET_BN_IMAGES} images [{smi}]: {infer_ms:.2f} ms a call "
            f"(CUDA events), {int(dets.valid.sum())} detections, launches {launches} (2 an image)")
        del tr
        lap("rfpn")

        # ImageNet initialisation: the CLIs in processes of their own, beside
        # the untimed work (the loads in this process, the card-vs-CPU
        # steps, the NMS checks)
        t_cli = time.perf_counter()
        argv = ["--config-file", os.path.join(ROOT, SET_SIM10K_YAML), *SET_CLI_OPTS, "MODEL.WEIGHTS",
                os.path.join(root, "vgg16_bn.pth"), "OUTPUT_DIR", os.path.join(root, "sim10k_imagenet")]
        sim_cli = Background(car_cli, "train_net", argv, data_root, "train_net from vgg16_bn.pth")
        tool_cli = Background(set_tool_then_train, os.path.join(root, "vgg16.pth"), os.path.join(root, "nobn_tool"),
                              data_root)
        background += [sim_cli, tool_cli]

        for label, yaml, sd in (("sim10k + vgg16_bn.pth", SET_SIM10K_YAML, tv_bn), ("bare VGG + vgg16.pth",
                                                                                   SET_NOBN_YAML, tv)):
            cfg = zoo_cfg(yaml, os.path.join(root, "load"), "MODEL.WEIGHTS",
                          os.path.join(root, "vgg16_bn.pth" if sd is tv_bn else "vgg16.pth"))
            line, bad, n = imagenet_loaded(cfg, sd)
            check(line.endswith("(0 of the backbone's)") and not bad, f"{label}: {line}; differ {bad[:3]}")
            log(f"  MODEL.WEIGHTS {label} in this process: {n} backbone tensors equal the file's import; {line}")
        lap("imagenet_in_process")

        cfg = zoo_cfg(ZOO_FPN_YAML, tempfile.gettempdir(), "TPU.CANVAS", "(128, 256)", "TPU.DTYPE", "float32")
        err = rfpn_card_vs_cpu(cfg, rfpn_config(cfg))
        log("  card vs CPU, one float32 R50-FPN base step at 128x256, batch 2: " + format_errors(err, TRAIN_LOSSES))
        check(card_step_ok(err), "rfpn: the card's step differs")
        cfg = zoo_cfg(CLI_YAML, tempfile.gettempdir(), "TPU.CANVAS", "(128, 256)", "TPU.DTYPE", "float32",
                      "MODEL.ROI_BOX_HEAD.DROPOUT", "0.5")
        same, mean_err, std_err, rows = mc_card_vs_cpu(cfg)
        log(f"  card vs CPU, mc_dropout_box_outputs (K {SET_MC_SAMPLES}) float32 at 128x256 on the same masks: valid "
            f"equal {same} ({rows} rows), mean max abs diff {mean_err:.3g}, std {std_err:.3g} (tol 1e-4)")
        check(same and rows > 0 and mean_err <= 1e-4 and std_err <= 1e-4, "mc dropout: the card differs from the CPU")
        lap("card_vs_cpu")

        for label, calls in captured.items():
            kept = [check_kernels_against_plain(b, s, v, thr, f"{label} call {i}", cpu=i == 0)
                    for i, (b, s, v, thr) in enumerate(calls)]
            log(f"  {label}: {len(calls)} NMS inputs (N {sorted({int(c[0].shape[0]) for c in calls})}), kernels "
                f"bit-equal to the plain versions, kept {kept}")
        lap("nms_checks")

        stdout, wall, got = sim_cli.result()
        add(got)
        want = CAR_BATCH * SET_CLI_ITERS + 2 * CAR_TEST_FRAMES + 1
        check(all(c == want for c in got.values()), f"train_net from vgg16_bn.pth: launches {got}, expected {want}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("[checkpoint] loaded")]
        check(line and line[0].endswith("(0 of the backbone's)"), f"train_net from vgg16_bn.pth: {line}")
        last, res = check_car_run(os.path.join(root, "sim10k_imagenet"), "train_net from vgg16_bn.pth",
                                  SET_CLI_ITERS, ["cityscapes_car_val"])
        log(f"  train_net {SET_SIM10K_YAML} MODEL.WEIGHTS vgg16_bn.pth (torchvision names; {SET_CLI_ITERS} steps at "
            f"batch {CAR_BATCH}, test()) [{smi}]: {wall:.2f} s; {line[0].split('; ', 1)[1]}; total loss "
            f"{last['total_loss']:.4f}, (AP, AP50) {res}, launches {got}")
        tool_out, init, (stdout, wall, got) = tool_cli.result()
        add(got)
        want = CAR_BATCH * SET_CLI_ITERS + 2 * 2 * CLI_TEST_FRAMES + 1
        check(all(c == want for c in got.values()), f"train_net on the tool's output: launches {got}, expected {want}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("[checkpoint] loaded")]
        check(line and line[0].endswith("0 tensors kept their initialisation (0 of the backbone's)"),
              f"train_net on the tool's output: {line}")
        written = torch.load(init, map_location="cpu", weights_only=True)["model"]
        want_sd = torch_import.import_torchvision_vgg(tv, False)
        check(all(torch.equal(written[k], v) for k, v in want_sd.items()), "import_weights: backbone differs")
        lines = metrics_lines(os.path.join(root, "nobn_tool", "train"))
        check(lines and np.isfinite(lines[-1]["total_loss"]), f"train_net on the tool's output: {lines[-1:]}")
        log(f"  import_weights --kind torchvision_vgg on {SET_NOBN_YAML} ({tool_out.strip()}), its 13 convs equal "
            f"the file's; then train_net from it ({SET_CLI_ITERS} steps at batch {CAR_BATCH}, test()) [{smi}]: "
            f"{wall:.2f} s; {line[0].split('; ', 1)[1]}; total loss {lines[-1]['total_loss']:.4f}, launches {got}")
        log(f"  both CLIs beside the untimed work: {time.perf_counter() - t_cli:.2f} s")
        lap("cli_wait")
        log(f"  the phase's parts (s): {secs}")
        numbers["parts_s"] = secs
    finally:
        for b in background:
            b.join()
        os.environ.pop("SFOD_DATASETS", None)
        for name in names:
            DATASET_REGISTRY.pop(name, None)
        tmp.cleanup()
    log(f"  launches on the settings path: {total}")
    return total, numbers


# ---------------------------------------------------------------- dist
DIST_STEPS = 6  # SFAT steps of the two-rank CLI run and of its one-process twin
DIST_TP_STEPS = 4  # base steps of the tensor-parallel CLI run and of its twin
DIST_BATCH = 2  # the global batch of every dist run
DIST_NCCL_STEPS = 2  # SFAT steps on the collective path at world 1 (NCCL) and without a group
DIST_TEST_FRAMES = 8  # the frames of each TEST set
DIST_TIMEOUT_S = 300
DIST_PROBE_TIMEOUT_S = 90
SOURCE_YAML = "configs/faster_rcnn_VGG_cityscapes_source_new.yaml"
DIST_OPTS = ["SEED", "0", "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.0025", "ADAPTIVE_THRESHOLD.WARM_UP", "4",
             "VIS_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "100000"]
# Held by card_step_ok's bound: one step in float32 at 128x256, where every
# top-k of the step keeps all its candidates (card_vs_cpu_adapt_step), from
# weights whose regression kernels are 0, so proposals and pseudo boxes are
# decoded from the biases alone (write_cli_weights). At 608x1216 the
# teacher's 100 detections are cut from more than 100 whose scores tie to
# rounding (random weights on flat synthetic frames), and so is the
# student's proposal set: two summation orders of one float32 step keep a
# box apart, and a sampled ROI moves loss_box_reg by ~0.4% (measured: NCCL
# world 1 against no group, PERF.md). The box head's tensor parallelism
# moves no proposal in its first step, so that step is held at 608x1216.
DIST_HELD = ["TPU.DTYPE", "float32", "TPU.CANVAS", "(128, 256)", "INPUT.MIN_SIZE_TRAIN", "(120,)",
             "INPUT.MIN_SIZE_TEST", "120"]
DIST_HELD_CANVAS = (128, 256)
# A bfloat16 step at 608x1216 rounds its activations and gradients to 8 bits
# of mantissa, so any change of summation order flips many of them and the
# ties above, and a BatchNorm bias's gradient, a sum of ~370k such values,
# parts by more than card_step_ok's bound allows. A bfloat16 step at full
# width is held to its control instead, the one-process step with only
# BatchNorm's summation order changed (bn_reordered): each error within
# CONTROL_FACTOR times the control's, or within card_step_ok's bound.
CONTROL_FACTOR = 4.0
# NCCL's answer to two ranks on one GPU: the probe's processes join a world
# of 2 over NCCL on device 0 and take one all-reduce
# (c) of the height bands (TPU.SPATIAL_SHARD): each backbone in float32 at
# 608x1216, one image, forward and backward with train-mode BatchNorm, in
# bands over two ranks against the whole image in one process
# (parallel/dryrun.py:compare_bands). Held per kind, maps and BatchNorm
# statistics by the largest difference over the tensor's largest entry,
# gradients (input and every parameter, summed over the bands) by the L2
# norm of the difference over the tensor's: the worst of each kind within
# CONTROL_FACTOR times the worst of its control (the whole pass in the
# other memory format: other kernels, another summation order), or within
# BANDS_FLOOR. In float32 a rounding difference flips a ReLU or a max
# pool's choice, which moves a gradient entry whole, so no largest-entry
# bound holds for gradients in either; the CPU tests hold the bands in
# float64 to 1e-5 of each tensor's largest entry.
_FPN = {"fpn": True, "fpn_in_features": ("vgg1", "vgg2", "vgg3", "vgg4"),
        "rpn_in_features": ("p2", "p3", "p4", "p5", "p6"), "roi_in_features": ("p2", "p3", "p4", "p5")}
BANDS_CASES = {name: {"det": det, "shape": (1, 3, 608, 1216), "dtype": "float32"} for name, det in (
    ("vgg16_bn", {"backbone": "vgg16"}),  # bands of 320 and 288 rows
    ("r101_c4_bn", {"backbone": "resnet101", "in_feature": "res4"}),  # 304 and 304
    ("vgg16_bn_fpn", _FPN),  # 320 and 288
)}
BANDS_FLOOR = {"map": 1e-4, "stat": 1e-4, "grad": 1e-3}
NCCL_PROBE = (
    "import sys, torch\n"
    "from simple_sfod_tpu_torch.parallel import mesh\n"
    "torch.cuda.set_device(0)\n"
    "mesh.initialize_distributed(sys.argv[1], 2, int(sys.argv[2]), 'nccl')\n"
    "t = torch.ones(1, device='cuda')\n"
    "torch.distributed.all_reduce(t)\n"
    "print('nccl two ranks on one device: all_reduce', t.item(), flush=True)\n"
)


@contextlib.contextmanager
def bn_reordered():
    """Within: BatchNorm2d's train-mode batch_norm runs on a copy of its
    input in the other memory format (NCHW for channels-last, and back),
    through the native kernels of that format, which sum the statistics and
    gradients in another order. The function is the same; its rounding is
    not."""
    from torch.nn import functional as F
    from simple_sfod_tpu_torch.models.backbones import vgg

    class Reordered:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps):
            if not training or x.dim() != 4:
                return F.batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps)
            cl = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
            other, back = (torch.contiguous_format, torch.channels_last) if cl else \
                (torch.channels_last, torch.contiguous_format)
            y = F.batch_norm(x.contiguous(memory_format=other), running_mean, running_var, weight, bias, training,
                             momentum, eps)
            return y.contiguous(memory_format=back)

    vgg.F = Reordered()
    try:
        yield
    finally:
        vgg.F = F


def control_ok(err, ctrl) -> bool:
    """A step's errors against those of its control (CONTROL_FACTOR)."""
    f = CONTROL_FACTOR
    return (max(err["loss"].values()) <= max(LOSS_TOL, f * max(ctrl["loss"].values()))
            and (err["counts_equal"] or not ctrl["counts_equal"])
            and err["param_bound"][0] <= max(1.0, f * ctrl["param_bound"][0])
            and err["bn"][0] <= max(BN_TOL, f * ctrl["bn"][0])
            and err["bn_fed_bias"][0] <= max(BN_FED_BIAS_TOL, f * ctrl["bn_fed_bias"][0]))


def watch_first_step(path: str) -> None:
    """In this process, every trainer that train_net builds saves its state
    as step1.pth after its first step, and rank 0 writes that step's
    metrics (summed over the ranks, as metrics.json's) to `path`."""
    import simple_sfod_tpu_torch.engine.trainers as trainers
    from simple_sfod_tpu_torch.parallel import mesh

    build = trainers.build_trainer

    def build_and_watch(*args, **kw):
        tr = build(*args, **kw)
        step = tr.step_staged

        def step_staged(*a, **k):
            metrics = step(*a, **k)
            if tr.state.step == 1:
                values = {n: float(v) for n, v in mesh.sum_metrics(metrics, tr.layout).items()}
                tr.save("step1")
                if mesh.is_main():
                    with open(path, "w") as f:
                        json.dump(values, f)
            return metrics

        tr.step_staged = step_staged
        return tr

    trainers.build_trainer = build_and_watch


def dist_rank(spec_path: str) -> None:
    """One process of the dist phase's CLI runs, started by
    `python -c "import chip_smoke; chip_smoke.dist_rank(spec)"`: train_net's
    main on the spec's argv (its --num-machines / --machine-rank /
    --dist-url / --dist-backend as given), recording the NMS inputs of the
    first step (3 calls: teacher RPN, teacher detection, student RPN; 1 for
    a base step) to the spec's capture path; with the spec's `step1` the
    first step's state and metrics (watch_first_step), with `reorder_bn`
    under bn_reordered (the control)."""
    with open(spec_path) as f:
        spec = json.load(f)
    captured = []
    orig, record = capture_nms(captured)

    def first_step(boxes, scores, valid, thr):
        return (record if len(captured) < spec["capture"] else orig)(boxes, scores, valid, thr)

    if spec.get("step1"):
        watch_first_step(spec["step1"])
    nms.nms_mask_matrix = first_step
    try:
        with bn_reordered() if spec.get("reorder_bn") else contextlib.nullcontext():
            train_net.main(train_net.default_argument_parser().parse_args(spec["argv"]))
    finally:
        nms.nms_mask_matrix = orig
    print(f"[peak] {torch.cuda.max_memory_allocated()} bytes allocated at most", flush=True)
    torch.save([(b.cpu(), s.cpu(), v.cpu(), thr) for b, s, v, thr in captured], spec["capture_path"])


def bands_worst(errs: dict) -> dict:
    """compare_bands' errors -> the worst of each kind, (error, tensor):
    maps and statistics by the largest difference, gradients by the norm."""
    out = {}
    for k, e in errs.items():
        kind = k.split(".")[0]
        out[kind] = max(out.get(kind, (0.0, "")), (e["norm"] if kind == "grad" else e["max"], k))
    return out


def bands_ok(res: dict) -> bool:
    """A compare_bands case within its control (BANDS_CASES' comment)."""
    worst, ctrl = bands_worst(res["errs"]), bands_worst(res["control"])
    return all(v <= max(BANDS_FLOOR[k], CONTROL_FACTOR * ctrl[k][0]) for k, (v, _) in worst.items())


def dist_bands_rank(spec_path: str) -> None:
    """One of the two processes of the dist phase's banded backbones, started
    by `python -c "import chip_smoke; chip_smoke.dist_bands_rank(spec)"`:
    rank `spec["rank"]` of a gloo world of 2 on the one GPU runs
    compare_bands on BANDS_CASES (float32: TF32 off) and writes its results
    and peak memory to `spec["out"]`."""
    from simple_sfod_tpu_torch.parallel import mesh
    from simple_sfod_tpu_torch.parallel.dryrun import compare_bands

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.initialize_distributed(spec["url"], 2, spec["rank"], "gloo")
    try:
        res = compare_bands(BANDS_CASES, device="cuda")
    finally:
        torch.distributed.destroy_process_group()
    with open(spec["out"], "w") as f:
        json.dump({"res": res, "peak": torch.cuda.max_memory_allocated()}, f)


class BandsRun:
    """The two dist_bands_rank processes, their output in files."""

    def __init__(self, root: str, data_root: str):
        from simple_sfod_tpu_torch.parallel.launch import free_port

        url = f"tcp://127.0.0.1:{free_port()}"
        self.procs, self.outs, self.logs, self.files = [], [], [], []
        self.t0 = time.perf_counter()
        for r in (0, 1):
            spec, out = os.path.join(root, f"bands_rank{r}.json"), os.path.join(root, f"bands_rank{r}.out.json")
            with open(spec, "w") as f:
                json.dump({"url": url, "rank": r, "out": out}, f)
            self.logs.append(os.path.join(root, f"bands_rank{r}.log"))
            self.files.append(open(self.logs[-1], "w"))
            self.outs.append(out)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.dist_bands_rank({spec!r})"], cwd=ROOT,
                env=cli_env(data_root), stdout=self.files[-1], stderr=subprocess.STDOUT))

    def result(self, timeout: float = DIST_TIMEOUT_S) -> list:
        """Wait. -> each rank's {"res", "peak"}, and the wall."""
        try:
            for p in self.procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"banded backbones: no end within {timeout} s")
        finally:
            for f in self.files:
                f.close()
        for p, log_path in zip(self.procs, self.logs):
            with open(log_path) as f:
                check(p.returncode == 0, f"banded backbones: exit code {p.returncode}\n{f.read()[-4000:]}")
        out = []
        for path in self.outs:
            with open(path) as f:
                out.append(json.load(f))
        return out, time.perf_counter() - self.t0

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class DistRun:
    """A dist_rank process, its output in a file (no pipe to fill)."""

    def __init__(self, root: str, label: str, argv: list, data_root: str, capture: int, step1: bool = False,
                 reorder_bn: bool = False):
        self.label = label
        self.log = os.path.join(root, f"{label}.log")
        self.capture_path = os.path.join(root, f"{label}.nms.pt")
        out = argv[argv.index("OUTPUT_DIR") + 1]
        spec = os.path.join(root, f"{label}.json")
        with open(spec, "w") as f:
            json.dump({"argv": argv, "capture": capture, "capture_path": self.capture_path,
                       "step1": os.path.join(out, "step1_metrics.json") if step1 else None,
                       "reorder_bn": reorder_bn}, f)
        self._f = open(self.log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.dist_rank({spec!r})"],
                                     cwd=ROOT, env=cli_env(data_root), stdout=self._f, stderr=subprocess.STDOUT)

    def result(self, timeout: float = DIST_TIMEOUT_S) -> dict:
        """Wait. -> {stdout, wall, launches, hash, step_ms, captured}."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{self.label}: no end within {timeout} s")
        finally:
            self._f.close()
        wall = time.perf_counter() - self.t0
        with open(self.log) as f:
            out = f.read()
        check(self.proc.returncode == 0, f"{self.label}: exit code {self.proc.returncode}\n{out[-4000:]}")
        lines = out.splitlines()
        state = [ln.split("sha256 ")[1] for ln in lines if ln.startswith("[state] ")]
        step = [float(ln.split(": ")[1].split(" ms")[0]) for ln in lines if ln.startswith("[trainer] rank ")]
        launches = json.loads([ln for ln in lines if ln.startswith("[launches] ")][-1][len("[launches] "):])
        peak = [int(ln.split()[1]) for ln in lines if ln.startswith("[peak] ")]
        return dict(stdout=out, wall=wall, launches=launches, hash=state[0] if state else None,
                    step_ms=step[0] if step else None, peak_gib=round(peak[-1] / 2 ** 30, 3) if peak else None,
                    captured=torch.load(self.capture_path, weights_only=False))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def dist_ranks(root, label, argv, data_root, capture, step1=False):
    """The two ranks of a run: train_net with --num-machines 2, one process
    a rank on the one GPU (NCCL refuses two ranks on one device, so gloo)."""
    from simple_sfod_tpu_torch.parallel.launch import free_port

    url = f"tcp://127.0.0.1:{free_port()}"
    return [DistRun(root, f"{label}_rank{r}", ["--num-machines", "2", "--machine-rank", str(r), "--dist-url", url,
                                               "--dist-backend", "gloo", *argv], data_root, capture, step1)
            for r in (0, 1)]


def model_file_state(path: str) -> dict:
    """A checkpoint's model state, on the card (where it is compared)."""
    return torch.load(path, map_location="cuda", weights_only=True)["model"]


def loss_errors(a: dict, b: dict) -> dict:
    keys = [k for k in b if k.startswith("loss") or k == "total_loss"]
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys}


def step_pair_errors(start, a_state, b_state, a_metrics, b_metrics, losses):
    """card_step_ok's errors of one step's state and metrics (a) against
    another's (b), from the same start."""
    err = state_errors(start, b_state, a_state)
    err["loss"] = {k: abs(a_metrics[k] - b_metrics[k]) / max(abs(b_metrics[k]), 1e-12) for k in losses}
    err["counts_equal"] = all(a_metrics[k] == b_metrics[k] for k in a_metrics if k.startswith("num_"))
    return err


def nccl_world1(smi: str, numbers: dict, captured: dict, dtype: str) -> dict:
    """DIST_NCCL_STEPS SFAT steps (the benchmark configuration at 608x1216,
    batch DIST_BATCH) through the collective code path of a world of 1 over
    NCCL (BatchNorm over the group, the counts and the gradient
    all-reduced) against the same steps without a group, on the same
    weights, batch and draws, each step timed. float32: at DIST_HELD_CANVAS
    from weights whose regression kernels are 0 (DIST_HELD says why), step
    1 held to card_step_ok's bound. bfloat16, at 608x1216: beside them the
    control, the steps without a group under bn_reordered, and step 1 held
    to it (control_ok); a step of each path profiled, with the host's time
    in synchronising calls, launches and collectives. Later steps are
    reported. -> launches."""
    from simple_sfod_tpu_torch.parallel import mesh
    from simple_sfod_tpu_torch.parallel.launch import free_port

    held = dtype == "float32"
    cfg = adapt_cfg(SFAT_BENCH_CONFIG, dtype=dtype, canvas=DIST_HELD_CANVAS if held else (608, 1216))
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH_TARGET", str(DIST_BATCH)])
    hw = (120, 250) if held else IMAGE_HW
    batch = synthetic_batch(make_synthetic_records(DIST_BATCH, hw, 8, 6, seed=SEED + 7), tuple(cfg.TPU.CANVAS), 8)
    start_sd = adapt_start(cfg)
    total = {k: 0 for k in _kernels.LAUNCHES}
    out = {}
    for label in ("no_group", "nccl_world1") if held else ("no_group", "control", "nccl_world1"):
        if label == "nccl_world1":
            check(mesh.initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, "nccl"), "nccl: no group")
        orig = nms.nms_mask_matrix
        try:
            with bn_reordered() if label == "control" else contextlib.nullcontext():
                tr = adapt_trainer(cfg, start=start_sd)
                check((tr.layout is not None) == (label == "nccl_world1"), f"{label}: layout {tr.layout}")
                if held:  # boxes from the biases (write_cli_weights' boxes_from_biases)
                    with torch.no_grad():
                        for m in (tr.state.model, tr.state.teacher):
                            m.proposal_generator.rpn_head.anchor_deltas.weight.zero_()
                            m.roi_heads.box_predictor.bbox_pred.weight.zero_()
                start = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}
                calls = captured.setdefault(f"{label} {dtype}", []) if label == "nccl_world1" else []
                orig, record = capture_nms(calls)
                ms, metrics, states = [], [], []
                _kernels.reset_launches()
                for i in range(DIST_NCCL_STEPS):
                    nms.nms_mask_matrix = record if i == 0 else orig
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics.append({k: float(v) for k, v in tr.run_step(batch).items()})
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    states.append({k: v.detach().clone() for k, v in tr.state.model.state_dict().items()})
                nms.nms_mask_matrix = orig
                launches = dict(_kernels.LAUNCHES)
                check(all(c == 3 * DIST_BATCH * DIST_NCCL_STEPS for c in launches.values()),
                      f"{label}: launches {launches}")
                for k in total:
                    total[k] += launches[k]
                prof = None
                if not held and label != "control":  # one more step, profiled (not compared)
                    _kernels.reset_launches()
                    prof = profile(lambda: tr.run_step(batch), 1, host=True)
                    for k in total:
                        total[k] += _kernels.LAUNCHES[k]
            out[label] = dict(start=start, states=states, metrics=metrics, ms=ms, prof=prof)
            del tr
        finally:
            nms.nms_mask_matrix = orig
            if label == "nccl_world1" and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    ref = out["no_group"]
    errs = {label: [step_pair_errors(ref["start"], out[label]["states"][i], ref["states"][i],
                                     out[label]["metrics"][i], ref["metrics"][i], ADAPT_LOSSES)
                    for i in range(DIST_NCCL_STEPS)] for label in out if label != "no_group"}
    size = f"SFAT at {cfg.TPU.CANVAS[0]}x{cfg.TPU.CANVAS[1]} {dtype}, batch {DIST_BATCH}"
    for label, e in errs.items():
        what = ("the control (no group, BatchNorm reordered)" if label == "control" else
                "NCCL world 1 (the collective path: BatchNorm, counts and gradient over a group of 1)")
        log(f"  {what} against no group, {size}{'; regression kernels 0' if held else ''}; step 1: "
            + format_errors(e[0], ADAPT_LOSSES) + f"; step {DIST_NCCL_STEPS} (reported): losses up to "
            f"{max(e[-1]['loss'].values()):.3g}, worst diff / bound {e[-1]['param_bound'][0]:.3g}, BN stats "
            f"{e[-1]['bn'][0]:.3g}; num_pseudo {[m['num_pseudo'] for m in out[label]['metrics']]}")
        numbers[f"{label}_{dtype}"] = dict(
            step_ms=out[label]["ms"], step1_loss_err=max(e[0]["loss"].values()),
            step1_param_bound=e[0]["param_bound"][0], step1_bn=e[0]["bn"][0], step1_bn_fed_bias=e[0]["bn_fed_bias"][0],
            last_loss_err=max(e[-1]["loss"].values()), last_param_bound=e[-1]["param_bound"][0], last_bn=e[-1]["bn"][0])
    if held:
        check(card_step_ok(errs["nccl_world1"][0]),
              "nccl world 1: the collective path's float32 step differs from the step without a group")
    else:
        check(control_ok(errs["nccl_world1"][0], errs["control"][0]),
              f"nccl world 1: the collective path's bfloat16 step parts from the step without a group by more than "
              f"{CONTROL_FACTOR} times its control")
        for label in ("no_group", "nccl_world1"):
            wall, dev, kern, _, host = out[label]["prof"]
            numbers[f"{label}_{dtype}"] = dict(numbers.get(f"{label}_{dtype}", {}), step_ms=out[label]["ms"],
                                               profiled_wall_ms=wall, device_ms=dev, busy=dev / wall, **host)
            log(f"  {label} {dtype} [{smi}]: step ms {[round(x, 2) for x in out[label]['ms']]} (CUDA-synchronised "
                f"host clock), a profiled step: wall {wall:.2f} ms, device {dev:.2f} ms, busy {dev / wall:.1%}; the "
                f"host in synchronising calls {host['sync_ms']:.2f} ms, in {host['launches']:.0f} launches "
                f"{host['launch_ms']:.2f} ms, in collectives {host['collective_ms']:.2f} ms; top kernels (ms) "
                f"{top(kern, 4)}")
    return total


def nccl_two_ranks_probe(root: str, data_root: str) -> str:
    """Two processes joining NCCL on the one GPU: NCCL's own words (the
    probe is expected to fail)."""
    from simple_sfod_tpu_torch.parallel.launch import free_port

    url = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, url, str(r)], cwd=ROOT, env=cli_env(data_root),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=DIST_PROBE_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + f"\n(no end within {DIST_PROBE_TIMEOUT_S} s)")
    codes = [p.returncode for p in procs]
    lines = [ln.strip() for o in outs for ln in o.splitlines() if "uplicate GPU" in ln or "ncclInvalidUsage" in ln
             or "nccl two ranks" in ln or "no end within" in ln]
    return f"exit codes {codes}; " + (" | ".join(dict.fromkeys(lines)) if lines else outs[0].strip()[-600:])


def run_step1(d: str) -> tuple:
    """(state, metrics) of a run's first step: watch_first_step's file and
    metrics, or those of a one-step run (model_final.pth and metrics.json's
    line)."""
    if os.path.exists(os.path.join(d, "step1.pth")):
        with open(os.path.join(d, "step1_metrics.json")) as f:
            return model_file_state(os.path.join(d, "step1.pth")), json.load(f)
    m = metrics_lines(d)
    check(m and m[-1]["iteration"] == 0, f"{d}: metrics.json {m[-1:]}")
    return model_file_state(os.path.join(d, "model_final.pth")), m[-1]


def dist_step_errors(weights: str, one_dir: str, two_dir: str, prefixes=("",)) -> dict:
    """card_step_ok's errors of step 1 of a run (rank 0's file and metrics)
    against step 1 of its one-process twin, from `weights`."""
    start = model_file_state(weights)
    start = {f"{p}{k}": v for p in prefixes for k, v in start.items()}
    (s1, m1), (s2, m2) = run_step1(one_dir), run_step1(two_dir)
    err = state_errors(start, s1, s2)
    err["loss"] = loss_errors(m2, m1)
    err["counts_equal"] = all(m2[k] == m1[k] for k in m1 if k.startswith("num_"))
    return err


def dist_phase(smi: str):
    """The dist phase (module docstring). -> (the launches of each kernel on
    the path, a dict of numbers)."""
    total = {k: 0 for k in _kernels.LAUNCHES}

    def add(d):
        for k in total:
            total[k] += d[k]

    numbers, secs, captured = {}, {}, {}
    t_sec = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        secs[name] = round(now - t_sec[0], 2)
        t_sec[0] = now

    tmp = tempfile.TemporaryDirectory(prefix="sfod_dist_")
    root = tmp.name
    data_root = os.path.join(root, "datasets")
    names = ("cityscapes_instancesonly_train",) + DA_DATASETS
    dirs = {k: os.path.join(root, k) for k in ("sfat_two_1", "sfat_one_1", "sfat_two", "sfat_one", "sfat_control",
                                              "tp_two", "tp_one", "sp_two", "sfat_sp")}
    runs = []
    bands = None
    banded = ["TPU.MESH_DATA", "1", "TPU.MESH_MODEL", "2", "TPU.SPATIAL_SHARD", "True"]

    def sfat(out, steps, *opts):  # the main YAML; test() after a run of more than one step
        return ["--config-file", os.path.join(ROOT, CLI_YAML), *DIST_OPTS, "SOLVER.IMS_PER_BATCH_TARGET",
                str(DIST_BATCH), "SOLVER.MAX_ITER", str(steps), "TEST.EVAL_PERIOD", str(steps if steps > 1 else 0),
                "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out, *opts]

    def tp(out, *opts):  # the source YAML in float32, DIST_TP_STEPS steps and test()
        return ["--config-file", os.path.join(ROOT, SOURCE_YAML), *DIST_OPTS, "TPU.DTYPE", "float32",
                "SOLVER.IMS_PER_BATCH", str(DIST_BATCH), "SOLVER.MAX_ITER", str(DIST_TP_STEPS), "TEST.EVAL_PERIOD",
                str(DIST_TP_STEPS), "MODEL.WEIGHTS", held_weights, "OUTPUT_DIR", out, *opts]

    def results(started):
        runs.extend(started)
        return [r.result() for r in started]

    def launches_as_counted(label, res, n):
        summed = {k: sum(r["launches"][k] for r in res) for k in total}
        check(all(c == n for c in summed.values()), f"{label}: launches {[r['launches'] for r in res]}, expected "
                                                     f"{n} in all")
        add(summed)

    def same_on_ranks(label, res):
        check(res[0]["hash"] is not None and res[0]["hash"] == res[1]["hash"],
              f"{label}: the ranks' states differ ({res[0]['hash']}, {res[1]['hash']})")

    try:
        write_cityscapes_car(data_root)  # cityscapes_instancesonly_train: the source YAML's TRAIN
        write_cli_datasets(data_root, test_frames=DIST_TEST_FRAMES)
        weights = os.path.join(root, "main.pth")
        write_cli_weights(weights)
        held_weights = os.path.join(root, "held.pth")
        write_cli_weights(held_weights, boxes_from_biases=True)
        for name in names:
            DATASET_REGISTRY.pop(name, None)
        lap("data")

        # A. the collective path of a world of 1 over NCCL, alone on the card
        add(nccl_world1(smi, numbers, captured, "float32"))
        add(nccl_world1(smi, numbers, captured, "bfloat16"))
        lap("nccl_world1")
        # the 14 processes below share the card with this one, whose
        # allocator still caches what every earlier phase freed: hand it back
        torch.cuda.empty_cache()
        free, whole = torch.cuda.mem_get_info()
        numbers["free_gib_before_cli_runs"] = round(free / 2 ** 30, 2)
        log(f"  device memory free before the CLI runs: {free / 2 ** 30:.2f} of {whole / 2 ** 30:.2f} GiB")

        # B. beside each other: the main YAML at full width (608x1216,
        # bfloat16) on two ranks for DIST_STEPS steps and test(), the first
        # step's state kept, its one-process twin and the twin's control
        # (one step under bn_reordered); held, one step of the main YAML at
        # DIST_HELD on two ranks and one process; the source YAML in float32
        # on data 1 x model 2 and one process; both again on data 1 x
        # model 2 in height bands; NCCL's probe
        sfat_ranks = dist_ranks(root, "sfat", sfat(dirs["sfat_two"], DIST_STEPS), data_root, 3, step1=True)
        runs.extend(sfat_ranks)
        sp_ranks = {"sp": dist_ranks(root, "sp", tp(dirs["sp_two"], *banded), data_root, 1, step1=True),
                    "sfat_sp": dist_ranks(root, "sfat_sp", sfat(dirs["sfat_sp"], DIST_STEPS, *banded), data_root, 3,
                                          step1=True)}
        runs.extend(r for v in sp_ranks.values() for r in v)
        held = [*DIST_HELD, "MODEL.WEIGHTS", held_weights]
        held_runs = {"sfat_two": dist_ranks(root, "sfat_1", sfat(dirs["sfat_two_1"], 1, *held), data_root, 3),
                     "sfat_one": [DistRun(root, "sfat_one_1", sfat(dirs["sfat_one_1"], 1, *held), data_root, 3)]}
        runs.extend(r for v in held_runs.values() for r in v)  # stopped by the finally if a later run fails
        started = [DistRun(root, "sfat_one", sfat(dirs["sfat_one"], DIST_STEPS), data_root, 3, step1=True),
                   DistRun(root, "sfat_control", sfat(dirs["sfat_control"], 1), data_root, 3, reorder_bn=True),
                   *dist_ranks(root, "tp", tp(dirs["tp_two"], "TPU.MESH_DATA", "1", "TPU.MESH_MODEL", "2"),
                               data_root, 1, step1=True),
                   DistRun(root, "tp_one", tp(dirs["tp_one"]), data_root, 1, step1=True)]
        probe = nccl_two_ranks_probe(root, data_root)
        numbers["nccl_two_ranks_one_gpu"] = probe
        log(f"  NCCL, two ranks on the one GPU: {probe}")
        c = results(sfat_ranks)
        a = {k: results(v) for k, v in held_runs.items()}
        twin, control, *tp_res = results(started)
        tp_two, tp_one = tp_res[:2], tp_res[2]
        sp = {k: results(v) for k, v in sp_ranks.items()}
        lap("cli_runs")
        # (c) the banded backbones, alone with this process's checks
        bands = BandsRun(root, data_root)
        same_on_ranks("sfat", c)
        same_on_ranks("sfat step 1", a["sfat_two"])
        same_on_ranks("tp", tp_two)
        same_on_ranks("sp (bands)", sp["sp"])
        same_on_ranks("sfat_sp (bands)", sp["sfat_sp"])
        for label, n in (("sfat_two", 3 * DIST_BATCH), ("sfat_one", 3 * DIST_BATCH)):  # 3 launches an image
            launches_as_counted(f"{label} step 1", a[label], n)
        launches_as_counted("sfat control", [control], 3 * DIST_BATCH)
        ts = ("modelTeacher.", "modelStudent.")
        held_err = dist_step_errors(held_weights, dirs["sfat_one_1"], dirs["sfat_two_1"], ts)
        log(f"  held: step 1 of {CLI_YAML} at {DIST_HELD} (batch {DIST_BATCH}; regression kernels 0) on two ranks "
            f"(gloo, one GPU; states bit-equal, sha256 {a['sfat_two'][0]['hash'][:16]}...) against one process: "
            + format_errors(held_err, ADAPT_LOSSES))
        check(card_step_ok(held_err), "sfat step 1: two ranks differ from one process")
        full_err = dist_step_errors(weights, dirs["sfat_one"], dirs["sfat_two"], ts)
        ctrl_err = dist_step_errors(weights, dirs["sfat_one"], dirs["sfat_control"], ts)
        for label, e in (("two ranks", full_err), ("the control (one process, BatchNorm reordered)", ctrl_err)):
            log(f"  full width: step 1 of {CLI_YAML} (608x1216, bfloat16, batch {DIST_BATCH}), {label} against one "
                f"process: " + format_errors(e, ADAPT_LOSSES))
        check(control_ok(full_err, ctrl_err), f"sfat step 1 at full width: two ranks part from one process by more "
                                              f"than {CONTROL_FACTOR} times the control")
        tp_err = dist_step_errors(held_weights, dirs["tp_one"], dirs["tp_two"])
        log(f"  held: step 1 of {SOURCE_YAML} at 608x1216 in float32 (batch {DIST_BATCH}; regression kernels 0) on "
            f"data 1 x model 2 (the box head split; states bit-equal) against one process: "
            + format_errors(tp_err, TRAIN_LOSSES))
        check(card_step_ok(tp_err), "tp step 1: two ranks differ from one process")
        # (a) the source YAML in height bands (float32, 608x1216) against the same one-process twin
        sp_err = dist_step_errors(held_weights, dirs["tp_one"], dirs["sp_two"])
        log(f"  held (a): step 1 of {SOURCE_YAML} at 608x1216 in float32 (batch {DIST_BATCH}; regression kernels 0) "
            f"on data 1 x model 2 in height bands (320 and 288 rows; the box head split; states bit-equal) against "
            f"one process: " + format_errors(sp_err, TRAIN_LOSSES))
        check(card_step_ok(sp_err), "sp step 1: the banded ranks differ from one process")
        # (b) the main YAML in height bands (bfloat16, 608x1216) against its twin, within 4x the control
        sfat_sp_err = dist_step_errors(weights, dirs["sfat_one"], dirs["sfat_sp"], ts)
        log(f"  held (b): step 1 of {CLI_YAML} (608x1216, bfloat16, batch {DIST_BATCH}) on data 1 x model 2 in "
            f"height bands against one process: " + format_errors(sfat_sp_err, ADAPT_LOSSES))
        check(control_ok(sfat_sp_err, ctrl_err), f"sfat_sp step 1: the banded ranks part from one process by more "
                                                 f"than {CONTROL_FACTOR} times the control")
        numbers["step1"] = {k: dict(loss_err=max(e["loss"].values()), param_bound=e["param_bound"][0], bn=e["bn"][0],
                                    bn_fed_bias=e["bn_fed_bias"][0], counts_equal=e["counts_equal"])
                            for k, e in (("sfat_held", held_err), ("sfat_full", full_err), ("sfat_control", ctrl_err),
                                         ("tp", tp_err), ("sp", sp_err), ("sfat_sp", sfat_sp_err))}

        # launches as counted: 3 an image of an SFAT step, 2 an image and
        # model in test() (dealt over the ranks), 1 a validation image on
        # each process; a base step 1 an image (each tensor-parallel rank
        # steps the whole batch), its test() one model
        test2 = 2 * 2 * 2 * DIST_TEST_FRAMES
        launches_as_counted("sfat ranks", c, 3 * DIST_STEPS * DIST_BATCH + test2 + 2)
        launches_as_counted("sfat twin", [twin], 3 * DIST_STEPS * DIST_BATCH + test2 + 1)
        launches_as_counted("tp ranks", tp_two, 2 * DIST_TP_STEPS * DIST_BATCH + test2 // 2 + 2)
        launches_as_counted("tp twin", [tp_one], DIST_TP_STEPS * DIST_BATCH + test2 // 2 + 1)
        # in bands both ranks run every test batch (one data index)
        launches_as_counted("sp ranks", sp["sp"], 2 * DIST_TP_STEPS * DIST_BATCH + test2 + 2)
        launches_as_counted("sfat_sp ranks", sp["sfat_sp"], 2 * 3 * DIST_STEPS * DIST_BATCH + 2 * test2 + 2)
        ev, last = {}, {}
        for k in ("sfat_two", "sfat_one", "tp_two", "tp_one", "sp_two", "sfat_sp"):
            m = metrics_lines(dirs[k])
            steps = DIST_STEPS if k.startswith("sfat") else DIST_TP_STEPS
            check(m and m[-1]["iteration"] == steps - 1
                  and all(np.isfinite(v) for n, v in m[-1].items() if n.startswith("loss")), f"{k}: {m[-1:]}")
            last[k] = m[-1]
            with open(os.path.join(dirs[k], "eval_results.json")) as f:
                ev[k] = json.load(f)
            check(all(r.get("AP50") is not None and np.isfinite(r["AP50"]) for r in ev[k].values()), f"{k}: {ev[k]}")
        ap = {k: (round(ev["sfat_two"][k]["AP50"], 4), round(ev["sfat_one"][k]["AP50"], 4)) for k in ev["sfat_one"]}
        sfat_loss = loss_errors(last["sfat_two"], last["sfat_one"])
        sfat_final = state_errors({f"{p}{k}": v for p in ("modelTeacher.", "modelStudent.")
                                   for k, v in model_file_state(weights).items()},
                                  *(model_file_state(os.path.join(dirs[k], "model_final.pth"))
                                    for k in ("sfat_one", "sfat_two")))
        tp_loss = loss_errors(last["tp_two"], last["tp_one"])
        tr = BaseTrainer(zoo_cfg(SOURCE_YAML, os.path.join(root, "tp_load")))
        tr.load_checkpoint(torch.load(os.path.join(dirs["tp_two"], "model_final.pth"), map_location="cpu",
                                      weights_only=True))  # strict: every key, the box head whole
        check(tuple(tr.detector.model.roi_heads.box_head.fc1.weight.shape) == (1024, 25088)
              and tr.state.step == DIST_TP_STEPS, "tp: the file does not load whole into one process")
        del tr
        tr = BaseTrainer(zoo_cfg(SOURCE_YAML, os.path.join(root, "sp_load")))
        tr.load_checkpoint(torch.load(os.path.join(dirs["sp_two"], "model_final.pth"), map_location="cpu",
                                      weights_only=True))  # strict: the backbone whole on every rank
        check(tr.state.step == DIST_TP_STEPS, "sp: the file does not load into one process")
        del tr
        dumps, sp_dumps = {}, {}
        for name in ("cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02"):
            for out, k2 in ((dumps, "tp_two"), (sp_dumps, "sp_two")):
                pair = []
                for k in (k2, "tp_one"):
                    with open(os.path.join(dirs[k], "inference", name, "coco_instances_results.json")) as f:
                        pair.append(json.load(f))
                check(pair[0] and pair[1], f"{k2}: no detections of {name}")
                out[name] = (*match_dumps(*pair), len(pair[1]))
        log(f"  reported, full width: {CLI_YAML} (bfloat16) on two ranks for {DIST_STEPS} steps and test() on "
            f"{DIST_TEST_FRAMES} frames of each TEST set against one process: step {DIST_STEPS}'s losses within "
            f"{max(sfat_loss.values()):.3g}, final states: worst diff / bound {sfat_final['param_bound'][0]:.3g}, BN "
            f"stats {sfat_final['bn'][0]:.3g}; AP50 (two ranks, one process) {ap}; {SOURCE_YAML} (float32) on data 1 x "
            f"model 2 for {DIST_TP_STEPS} steps: losses within {max(tp_loss.values()):.3g}, its model_final.pth loaded "
            f"strictly into one process (fc1 1024 x 25088 whole), detection dumps (unpaired, box px, score, "
            f"detections) {dumps}")
        numbers["sfat_two_ranks"] = dict(step_ms=[r["step_ms"] for r in c], wall_s=[r["wall"] for r in c],
                                         launches=[r["launches"] for r in c], twin_wall_s=twin["wall"], ap50=ap,
                                         last_loss_err=max(sfat_loss.values()),
                                         final_param_bound=sfat_final["param_bound"][0], final_bn=sfat_final["bn"][0])
        numbers["tp"] = dict(step_ms=[r["step_ms"] for r in tp_two], last_loss_err=max(tp_loss.values()),
                             dumps=dumps, peak_gib=[r["peak_gib"] for r in tp_two])
        sp_loss = loss_errors(last["sp_two"], last["tp_one"])
        sfat_sp_loss = loss_errors(last["sfat_sp"], last["sfat_one"])
        ap_sp = {k: (round(ev["sfat_sp"][k]["AP50"], 4), round(ev["sfat_one"][k]["AP50"], 4)) for k in ev["sfat_one"]}
        numbers["bands"] = dict(
            sp=dict(step_ms=[r["step_ms"] for r in sp["sp"]], peak_gib=[r["peak_gib"] for r in sp["sp"]],
                    last_loss_err=max(sp_loss.values()), dumps=sp_dumps),
            sfat_sp=dict(step_ms=[r["step_ms"] for r in sp["sfat_sp"]], peak_gib=[r["peak_gib"] for r in sp["sfat_sp"]],
                         last_loss_err=max(sfat_sp_loss.values()), ap50=ap_sp))
        log(f"  reported, height bands: {SOURCE_YAML} (float32) for {DIST_TP_STEPS} steps: losses within "
            f"{max(sp_loss.values()):.3g} of one process, its model_final.pth loaded strictly into one process, "
            f"detection dumps (unpaired, box px, score, detections) {sp_dumps}; {CLI_YAML} (bfloat16) for "
            f"{DIST_STEPS} steps: losses within {max(sfat_sp_loss.values()):.3g}, AP50 (bands, one process) {ap_sp}")
        log(f"  each rank's peak memory [{smi}]: the source YAML in bands (a) {numbers['bands']['sp']['peak_gib']} GiB "
            f"beside the tensor-parallel run's {numbers['tp']['peak_gib']} GiB; the main YAML in bands (b) "
            f"{numbers['bands']['sfat_sp']['peak_gib']} GiB beside the two data ranks' "
            f"{[r['peak_gib'] for r in c]} GiB; step ms (host clock, beside the other runs): (a) "
            f"{numbers['bands']['sp']['step_ms']}, tensor-parallel {numbers['tp']['step_ms']}, (b) "
            f"{numbers['bands']['sfat_sp']['step_ms']}")
        log(f"  beside each other and the other runs [{smi}]: the sfat ranks, 608x1216 bfloat16, "
            f"{[r['step_ms'] for r in c]} ms a step (median after the first, host clock: gloo stages each step's "
            f"gradient through host memory, so the step waits for it), walls {[round(r['wall'], 2) for r in c]} s; "
            f"the tensor-parallel ranks (float32) {[r['step_ms'] for r in tp_two]} ms a step; two ranks on one card "
            f"measure correctness, not scaling")
        lap("checks")

        calls = [(f"sfat_two step 1 rank {i}", r["captured"]) for i, r in enumerate(a["sfat_two"])]
        calls += [("sfat control", control["captured"])]
        calls += [(f"tp rank {i}", r["captured"]) for i, r in enumerate(tp_two)]
        calls += [(f"sfat full width rank {i}", r["captured"]) for i, r in enumerate(c)]
        calls += [(f"{k} (bands) rank {i}", r["captured"]) for k, v in sp.items() for i, r in enumerate(v)]
        for label, cs in calls + list(captured.items()):
            check(len(cs) >= 1, f"{label}: no NMS input captured")
            kept = [check_kernels_against_plain(bx.cuda(), sc.cuda(), v.cuda(), thr, f"{label} call {i}", cpu=i == 0)
                    for i, (bx, sc, v, thr) in enumerate(cs)]
            log(f"  {label}: {len(cs)} NMS inputs (N {sorted({int(x[0].shape[0]) for x in cs})}), kernels "
                f"bit-equal to the plain versions, kept {kept}")
        lap("nms_checks")
        band_res, band_wall = bands.result()
        for name, r0 in band_res[0]["res"].items():
            for rank, r in enumerate(band_res):
                res = r["res"][name]
                worst, ctrl = bands_worst(res["errs"]), bands_worst(res["control"])
                log(f"  held (c): {name} in float32 at 608x1216 in bands {res['plan']} (rank {rank}, {res['ms']:.1f} "
                    f"ms the banded pass) against one process: worst " + ", ".join(
                        f"{k} {v:.3g} ({n})" for k, (v, n) in worst.items()) + "; control (other memory format) "
                    + ", ".join(f"{k} {v:.3g}" for k, (v, _) in ctrl.items()))
                check(bands_ok(res), f"banded {name}: beyond {CONTROL_FACTOR}x its control or the floor {BANDS_FLOOR}")
        numbers["bands"]["backbones"] = {
            name: dict(worst={k: v for k, (v, _) in bands_worst(r0["errs"]).items()},
                       control={k: v for k, (v, _) in bands_worst(r0["control"]).items()},
                       ms=[r["res"][name]["ms"] for r in band_res])
            for name, r0 in band_res[0]["res"].items()}
        numbers["bands"]["backbones_peak_gib"] = [round(r["peak"] / 2 ** 30, 3) for r in band_res]
        log(f"  the banded backbones' two processes: {band_wall:.2f} s, peak "
            f"{numbers['bands']['backbones_peak_gib']} GiB")
        lap("bands")
        log(f"  the phase's parts (s): {secs}")
        numbers["parts_s"] = secs
    finally:
        if bands is not None:
            bands.stop()
        for r in runs:
            r.stop()
        for name in names:
            DATASET_REGISTRY.pop(name, None)
        tmp.cleanup()
    log(f"  launches on the dist path: {total}")
    return total, numbers


# ---------------------------------------------------------------- tools
TOOLS_FRAMES = 2  # synthetic 600x1200 frames of the raw path
TOOLS_RAW_TOPK = 512  # Detector.infer_raw's default
TOOLS_TIMED, TOOLS_WARMUP = 10, 3  # StepTimer's infer_raw calls at batch 1
TOOLS_TIMEOUT_S = 300


def plain_nms(boxes, scores, valid, thr):
    """A stand-in for nms.nms_mask_matrix through the plain versions on the
    tensors' device, one image at a time."""
    if valid.dim() == 1:
        return plain_keep(boxes, scores, valid, thr)
    return torch.stack([plain_keep(b, s, v, thr) for b, s, v in zip(boxes, scores, valid)])


def infer_raw_vs_plain(det, images, sizes, topk: int = TOOLS_RAW_TOPK):
    """det.infer_raw through the NMS ops, then through their plain versions
    on the card. -> (kernel detections, plain detections, the ops' launches
    in the first call)."""
    before = dict(_kernels.LAUNCHES)
    got = det.infer_raw(images, sizes, topk=topk)
    torch.cuda.synchronize()
    launches = {k: c - before[k] for k, c in _kernels.LAUNCHES.items()}
    orig = nms.nms_mask_matrix
    nms.nms_mask_matrix = plain_nms
    try:
        want = det.infer_raw(images, sizes, topk=topk)
    finally:
        nms.nms_mask_matrix = orig
    return got, want, launches


def same_detections(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("boxes", "scores", "classes", "valid"))


def tools_frames(n: int = TOOLS_FRAMES, seed: int = SEED + 5):
    """n seeded 600x1200 uint8 frames on the 608x1216 canvas, and their sizes."""
    rng = np.random.RandomState(seed)
    canvas = np.zeros((n, 608, 1216, 3), np.uint8)
    canvas[:, :IMAGE_HW[0], :IMAGE_HW[1]] = rng.randint(0, 256, (n, *IMAGE_HW, 3))
    return canvas, np.asarray([IMAGE_HW] * n, np.int32)


def tool_run(args: list, label: str) -> str:
    """A host tool of the port in a process of its own. -> its stdout."""
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=cli_env(ROOT), capture_output=True, text=True,
                         timeout=TOOLS_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{label}: exit code {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


METRICS_CALL = ("import json, sys\n"
                "from simple_sfod_tpu_torch.tools import metrics_tool\n"
                "res = metrics_tool.main(sys.argv[1:])\n"
                "print('[ap50] ' + json.dumps(res['coco']['AP50']))\n")


def http_get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read().decode()


def tools_phase(smi: str, keep: dict):
    """The tools phase (module docstring). `keep`: the eval phase's COCO GT
    and teacher detections and the AP50 test() reported on them, and the
    cli phase's teacher-student model_final.pth, in keep["dir"]. -> (the
    NMS launches of the path, its numbers)."""
    from simple_sfod_tpu_torch.evaluation.gui import serve_in_thread as serve_gui
    from simple_sfod_tpu_torch.utils.profiling import StepTimer, device_trace

    root = keep["dir"]
    numbers = {}
    background = []
    try:
        # the host tools in processes of their own, beside the untimed checks
        html = os.path.join(root, "report.html")
        metrics = Background(tool_run, ["-c", METRICS_CALL, "--gt", keep["gt"], "--gt-format", "coco",
                                        "--det", keep["dets"], "--det-format", "coco", "--metrics", "coco,voc,f1",
                                        "--html", html], "metrics_tool")
        exported = os.path.join(root, "exported_d2.pth")
        export = Background(tool_run, ["-m", "simple_sfod_tpu_torch.tools.export_weights", "--ckpt",
                                       keep["model_final"], "--output", exported, "--which", "auto",
                                       "--config-file", os.path.join(ROOT, CLI_YAML)], "export_weights")
        background += [metrics, export]

        cfg = get_main_cfg()
        cfg.freeze()
        det_cfg = detector_config_from_cfg(cfg)
        check(det_cfg.dtype == torch.bfloat16 and tuple(cfg.TPU.CANVAS) == (608, 1216), "main config")
        det = Detector(det_cfg).load_state_dict(init_weights(empty_model(det_cfg), SEED).state_dict())
        canvas, sizes = tools_frames()
        images_t, sizes_t = torch.from_numpy(canvas).cuda(), torch.from_numpy(sizes).cuda()
        torch.cuda.synchronize()
        _kernels.reset_launches()

        # 1. the raw path: one launch of each op an image, kernel == plain
        got, want, launches = infer_raw_vs_plain(det, images_t, sizes_t)
        check(all(c == TOOLS_FRAMES for c in launches.values()),
              f"infer_raw: launches {launches}, expected {TOOLS_FRAMES} of each (the RPN's NMS, one an image)")
        check(same_detections(got, want), "infer_raw: the NMS kernels' detections differ from the plain versions'")
        check(got.boxes.shape == (TOOLS_FRAMES, TOOLS_RAW_TOPK, 4) and bool(got.valid.all())
              and bool(torch.isfinite(got.scores).all()), f"infer_raw: {got.boxes.shape}, valid {int(got.valid.sum())}")
        check(bool((got.scores[:, :-1] >= got.scores[:, 1:]).all()), "infer_raw: scores not in descending order")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced = det.infer_raw(images_t, sizes_t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(same_detections(synced, got), "infer_raw under set_sync_debug_mode differs")
        log(f"  infer_raw ({TOOLS_FRAMES} x {IMAGE_HW[0]}x{IMAGE_HW[1]}, bfloat16, topk {TOOLS_RAW_TOPK}): launches "
            f"{launches}, bit-equal to the plain NMS on the card, scores {float(got.scores.min()):.4f}.."
            f"{float(got.scores.max()):.4f}; no host sync (set_sync_debug_mode('error'))")

        # 2. a looser NMS never keeps fewer
        strict = det.infer(images_t, sizes_t, score_thresh=0.0, topk=300)
        loose = det.infer(images_t, sizes_t, score_thresh=0.0, topk=300, nms_thresh=1.0)
        n_strict, n_loose = strict.valid.sum(1).tolist(), loose.valid.sum(1).tolist()
        check(all(0 < a <= b <= 300 for a, b in zip(n_strict, n_loose)), f"valid counts {n_strict} vs {n_loose}")
        check(bool(torch.isfinite(loose.boxes).all()), "infer(nms_thresh=1.0): non-finite boxes")
        log(f"  infer(score_thresh=0.0, topk=300): valid {n_strict} at the config's NMS {det_cfg.nms_thresh_test}, "
            f"{n_loose} at nms_thresh 1.0")

        # the metrics tool: COCO AP50 as test() reported it
        stdout = metrics.result()
        tool_ap50 = json.loads(stdout.strip().splitlines()[-1][len("[ap50] "):])
        check("== coco ==" in stdout and "== voc ==" in stdout and "== f1 ==" in stdout, f"metrics_tool: {stdout[-500:]}")
        check(abs(tool_ap50 - keep["test_ap50"]) <= 1e-6,
              f"metrics_tool AP50 {tool_ap50} vs test()'s {keep['test_ap50']}")
        with open(html) as f:
            check(f.read().startswith("<!doctype html"), "metrics_tool --html")
        log(f"  metrics_tool on the eval phase's teacher detections: COCO AP50 {tool_ap50!r}, test() "
            f"{keep['test_ap50']!r} (difference {abs(tool_ap50 - keep['test_ap50']):.3g}); the detections file's own "
            f"evaluation {keep['dump_ap50']!r}; report.html written")

        # the GUI: form, statistics and run pages
        srv, base = serve_gui()
        try:
            state = {"gt": keep["gt"], "gt_format": "coco", "det": keep["dets"], "det_format": "coco",
                     "out": os.path.join(root, "gui")}
            q = urllib.parse.urlencode(state)
            pages = {}
            for label, path in (("form", "/"), ("stats", f"/stats?which=gt&{q}"), ("det stats", f"/stats?which=det&{q}"),
                                ("run", f"/run?{q}&metrics=coco&metrics=voc&metrics=f1")):
                status, pages[label] = http_get(base + path)
                check(status == 200 and "class='err'" not in pages[label], f"GUI {label}: {status} {pages[label][:300]}")
        finally:
            srv.shutdown()
            srv.server_close()
        with open(os.path.join(root, "gui", "results.json")) as f:
            gui_ap50 = json.load(f)["coco"]["AP50"]
        tile = f'<div class="v">{gui_ap50:.2f}</div><div class="l">AP50</div>'
        check(abs(gui_ap50 - keep["test_ap50"]) <= 1e-6 and tile in pages["run"],
              f"GUI run: AP50 {gui_ap50} vs test()'s {keep['test_ap50']}")
        log(f"  metrics GUI: 200 on the form, GT and detection statistics and the run page; the run page's AP50 tile "
            f"{gui_ap50:.2f}, its results.json {gui_ap50!r}")

        # the weights out to the reference stack
        stdout = export.result()
        data = torch.load(exported, map_location="cpu", weights_only=True)
        check(set(data) == {"model", "iteration"}, f"exported file holds {sorted(data)}")
        saved = torch.load(keep["model_final"], map_location="cpu", weights_only=True)
        student = {k[len("modelStudent."):]: v for k, v in data["model"].items() if k.startswith("modelStudent.")}
        check(len(student) + sum(k.startswith("modelTeacher.") for k in data["model"]) == len(data["model"]) and student,
              "exported keys")
        cli_cfg = get_cfg()
        cli_cfg.merge_from_file(os.path.join(ROOT, CLI_YAML))
        Detector(detector_config_from_cfg(cli_cfg)).load_state_dict(student)  # strict, on the card
        differ = [k for k, v in student.items() if not k.endswith("num_batches_tracked")
                  and not (v.dtype == torch.float32 and torch.equal(v, saved["model"]["modelStudent." + k]))]
        check(not differ, f"exported student tensors differ from the checkpoint's: {differ[:3]}")
        check(data["iteration"] == saved["iteration"], f"iteration {data['iteration']} vs {saved['iteration']}")
        log(f"  export_weights --which auto: {stdout.strip().splitlines()[-1]}; keys model, iteration "
            f"({data['iteration']}); {len(student)} student tensors loaded strictly on the card, bit-equal to the "
            "checkpoint's")

        # device_trace around one raw call, then the raw path's time at batch 1
        trace_dir = os.path.join(root, "trace")
        with device_trace(trace_dir):
            det.infer_raw(images_t, sizes_t)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            trace = f.read()
        named = {op: trace.count(op) for op in ("sfod::suppress_relation_bits", "sfod::greedy_keep_from_bits")}
        check(all(named.values()), f"device_trace: {named}")
        timer = StepTimer(warmup=TOOLS_WARMUP)
        for _ in range(TOOLS_WARMUP + TOOLS_TIMED):
            timer.start()
            timer.stop(det.infer_raw(images_t[:1], sizes_t[:1]))
        summary = timer.summary()
        check(summary["steps"] == TOOLS_TIMED, f"StepTimer {summary}")
        numbers["infer_raw_batch1_median_ms"] = summary["median_s"] * 1e3
        log(f"  device_trace: {trace_dir}/trace.json ({len(trace) / 2**20:.2f} MiB) names {named}")
        log(f"  infer_raw at batch 1 [{smi}]: median {summary['median_s'] * 1e3:.2f} ms, mean "
            f"{summary['mean_s'] * 1e3:.2f} ms of {summary['steps']} (StepTimer, {TOOLS_WARMUP} warm-up)")
        total = dict(_kernels.LAUNCHES)
        # raw: 2 frames x 3 calls (kernel, sync-checked, traced); infer x 2:
        # RPN and detection NMS on 2 frames; StepTimer: 1 an image
        want_each = 3 * TOOLS_FRAMES + 2 * 2 * TOOLS_FRAMES + TOOLS_WARMUP + TOOLS_TIMED
        check(all(c == want_each for c in total.values()), f"tools launches {total}, expected {want_each} of each")
        numbers.update(tool_ap50=tool_ap50, test_ap50=keep["test_ap50"], valid_strict=n_strict, valid_loose=n_loose)
        log(f"  launches on the tools path: {total}")
    finally:
        for b in background:
            b.join()
    return total, numbers


# ---------------------------------------------------------------- roofline
ROOFLINE_BATCHES = ("1", "4")  # the eval stages' batches
# the timing's depth, below the tool's defaults (5 windows of 10 steps) to
# keep the script near half its limit: a median of 3 windows of 5 steps
ROOFLINE_WINDOWS, ROOFLINE_STEPS_PER_DISPATCH = 3, 5
PROFILE_STEPS, PROFILE_TOP = 3, 12
NMS_KERNELS = ("suppress_relation_bits", "greedy_keep_from_bits")


def roofline_phase(smi: str, artifact: str, root: str):
    """The steps' and forward paths' floors on the card and their share of
    them, and the op profile of the adaptation step, through the two tools'
    main(argv) in this process (no torch import a run): tools/roofline.py
    --headline and the FPN default with --measure, --eval --stages at batch 1
    and 4 with --measure, --serving on the export phase's poly artifact at
    batch 1 with --measure; tools/profile_step.py --steps 3. Held: every
    line's pct_of_roofline in (0, 100] (a count that is no lower bound
    fails here), its bound_by and the card's name and power limit; the
    stages' operations rising features < raw < full (flops features < raw:
    the class-wise NMS adds no contraction); the counted NMS launches of the
    headline step equal to the kernels' launch counters, 3 of each an image;
    both NMS kernels among the profile's device kernels. -> (the launches of
    each kernel in the phase, the lines' numbers for the kernels line)."""
    from simple_sfod_tpu_torch.tools import profile_step, roofline

    before = dict(_kernels.LAUNCHES)
    out = ["--output-dir", os.path.join(root, "out"), "--windows", str(ROOFLINE_WINDOWS)]
    steps = ["--measure", "--steps-per-dispatch", str(ROOFLINE_STEPS_PER_DISPATCH)]
    lines = roofline.main(["--headline", *steps, *out])
    lines += roofline.main([*steps, *out])
    lines += roofline.main(["--eval", "--stages", "--batches", *ROOFLINE_BATCHES, "--measure", *out])
    lines += roofline.main(["--serving", "--artifact", artifact, "--batches", "1", "--measure", *out])
    for ln in lines:
        label = f"roofline {ln['workload']} {ln.get('stage', '')} batch {ln['batch']}"
        check(0 < ln["pct_of_roofline"] <= 100, f"{label}: pct_of_roofline {ln['pct_of_roofline']}")
        check(ln["bound_by"] in ("operations", "bytes") and ln["gpu_name"] and ln["power_limit"], f"{label}: {ln}")
        measured = ln.get("measured_ms_per_step", ln.get("measured_ms_per_batch"))
        log(f"  {label} [{smi}]: {ln['flops'] / 1e9:.2f} GFLOP, bytes_min {ln['bytes_min'] / 1e6:.1f} MB, "
            f"bytes_eager {ln['bytes_eager'] / 1e6:.1f} MB, floor {ln['floor_ms']:.3f} ms ({ln['bound_by']}), "
            f"measured {measured:.3f} ms, {ln['pct_of_roofline']:.2f}% of the floor")
    for b in ROOFLINE_BATCHES:
        st = {ln["stage"]: ln for ln in lines if ln["workload"] == "eval_forward" and ln["batch"] == int(b)}
        ops = [st[k]["flops"] + st[k]["elementwise_ops"] + st[k]["nms_ops"] for k in ("features", "raw", "full")]
        check(ops[0] < ops[1] < ops[2] and st["features"]["flops"] < st["raw"]["flops"] <= st["full"]["flops"],
              f"eval stages at batch {b}: operations {ops}")
    head = lines[0]
    want = {k: 3 * head["batch"] for k in NMS_KERNELS}
    check(head["nms_launches"] == head["kernel_launches"] == want,
          f"headline step: counted {head['nms_launches']}, launched {head['kernel_launches']}, want {want}")
    trace_dir = os.path.join(root, "trace")
    profile_step.main(["--steps", str(PROFILE_STEPS), "--out", trace_dir, "--top", str(PROFILE_TOP)])
    full = profile_step.summarize_trace(os.path.join(trace_dir, "trace.json"), top=10 ** 6)
    names = [name for name, _, _ in full["device"]["top"]]
    check(all(any(k in n for n in names) for k in NMS_KERNELS), f"profile kernels {names[:20]}")
    check(0 < full["device"]["busy_share"] <= 1, f"profile busy share {full['device']['busy_share']}")
    log(f"  profile_step --steps {PROFILE_STEPS} [{smi}]: window {full['window_ms']:.2f} ms, device busy "
        f"{full['device']['busy_ms']:.2f} ms ({full['device']['busy_share']:.1%}), {len(names)} kernel names")
    keys = ("workload", "stage", "batch", "dtype", "flops", "elementwise_ops", "bytes_min", "bytes_eager", "nms_ops",
            "nms_bytes", "floor_ms", "bound_by", "measured_ms_per_step", "measured_ms_per_batch", "pct_of_roofline")
    numbers = {"lines": [{k: ln[k] for k in keys if k in ln} for ln in lines],
               "profile": {"window_ms": full["window_ms"], "busy_share": full["device"]["busy_share"]}}
    return {k: _kernels.LAUNCHES[k] - before[k] for k in before}, numbers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    with Phase("build"):
        # nvcc for the kernels and g++ for the two host libraries, together
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            futures = {"nms": pool.submit(_kernels.build, "nms")}
            futures.update({name: pool.submit(host_libs.build, name) for name in ("imgcodec", "cocoeval")})
            built = {name: f.result() for name, f in futures.items()}
        _kernels.load_all()
        log(f"build: {built['nms']} in {time.perf_counter() - t0:.2f} s with the host libraries (nvcc "
            f"{_kernels.BUILD_SECONDS.get('nms', 0.0):.2f} s; g++ imgcodec {host_libs.BUILD_SECONDS.get('imgcodec', 0.0):.2f} s, "
            f"cocoeval {host_libs.BUILD_SECONDS.get('cocoeval', 0.0):.2f} s)")
        # registers, static shared memory and spills, from nvcc -Xptxas -v
        ptxas = {}
        for mangled, use in _kernels.resource_usage("nms").items():
            # greedy_keep_from_bits has two routes: its kernel and the row walk
            name = next(k for k in _kernels.LAUNCHES if k in mangled)
            ptxas.setdefault(name, []).append(use)
            log(f"  {name} ({mangled}): {use}")
        check(set(ptxas) == set(_kernels.LAUNCHES), f"ptxas reported {sorted(ptxas)}")

    with Phase("kernels vs plain"):
        rng = np.random.RandomState(SEED)
        cases = [
            ("N=4096 thr=0.7", 4096, 3900, 0.7, 0),
            ("N=1024 thr=0.5 class-offset", 1024, 1000, 0.5, 8),
            ("N=1000 thr=0.5", 1000, 1000, 0.5, 0),
            ("N=1 thr=0.5", 1, 1, 0.5, 0),
            ("N=257 thr=0.7 0 valid", 257, 0, 0.7, 0),
            ("N=8192 thr=0.7", 8192, 8000, 0.7, 0),
            ("N=4097 thr=0.7", 4097, 4000, 0.7, 0),
            # above the keep kernel's shared-memory route: its row walk
            ("N=12288 thr=0.7", 12288, 12000, 0.7, 0),
        ]
        large_n = {}
        for label, n, n_valid, thr, ncls in cases:
            b, s, v = case_boxes(rng, n, n_valid, classes=ncls)
            kept = check_kernels_against_plain(b, s, v, thr, label, cpu=n <= 4097)
            log(f"  {label}: bit-equal, kept {kept}")
            if n > _kernels.GREEDY_MAX_N:
                large_n[label] = (b, s, v, thr)
        for label, b, s, v, thr, want in edge_cases():
            t = lambda a: torch.from_numpy(a).cuda()
            # the plain fixpoint needs n/2 rounds for the chain: too slow on the CPU
            kept = check_kernels_against_plain(t(b), t(s), t(v), thr, label, want, cpu="chain" not in label)
            log(f"  {label}: bit-equal and as expected, kept {kept}")
            if len(b) > _kernels.GREEDY_MAX_N:
                large_n[label] = (t(b), t(s), t(v), thr)

    with Phase("serve"):
        cfg = get_main_cfg()
        cfg.freeze()
        det_cfg = detector_config_from_cfg(cfg)
        check(det_cfg.dtype == torch.bfloat16 and tuple(cfg.TPU.CANVAS) == (608, 1216), "main config")
        state = init_weights(empty_model(det_cfg), SEED).state_dict()
        service = DetectionService(cfg, state, batch=2, max_wait_ms=10.0, config_name="main")
        srv, url = serve_in_thread(service)
        captured = []
        orig_nms, record = capture_nms(captured)
        try:
            rng = np.random.RandomState(SEED + 1)
            bodies, imgs = [], []
            for _ in range(N_REQUESTS):
                img = rng.randint(0, 256, IMAGE_HW + (3,)).astype(np.uint8)
                imgs.append(img)
                buf = io.BytesIO()
                np.save(buf, img)
                bodies.append(buf.getvalue())

            def post(body):
                req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as resp:
                    out = json.loads(resp.read())
                return out, (time.perf_counter() - t0) * 1e3

            info = json.loads(urllib.request.urlopen(f"{url}/", timeout=60).read())
            check(info["canvas"] == [608, 1216] and info["platforms"] == ["cuda"], f"service info {info}")

            results = [None] * N_REQUESTS
            latency = [0.0] * N_REQUESTS
            _kernels.reset_launches()
            # requests 0 and 1 one at a time (request 1's NMS inputs captured),
            # then 2 and 3 together
            for i in (0, 1):
                before = dict(_kernels.LAUNCHES)
                if i == 1:
                    nms.nms_mask_matrix = record
                results[i], latency[i] = post(bodies[i])
                nms.nms_mask_matrix = orig_nms
                for k, c in _kernels.LAUNCHES.items():
                    if c - before[k] < 2:
                        raise AssertionError(f"request {i}: {k} launched {c - before[k]} times, expected 2 (RPN + detection NMS)")
            errors = []

            def worker(i):
                try:
                    results[i], latency[i] = post(bodies[i])
                except BaseException as e:  # reported below, after join
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,)) for i in (2, 3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                if t.is_alive():
                    raise AssertionError("a concurrent request did not finish")
            if errors:
                raise errors[0]
            # a Cityscapes frame sent as a PNG file: native decode and resize
            big = rng.randint(0, 256, FRAME_HW + (3,)).astype(np.uint8)
            before = dict(_kernels.LAUNCHES)
            big_res, big_ms = post(png_bytes(big))
            check("error" not in big_res, f"{FRAME_HW} request: {big_res.get('error')}")
            for k, c in _kernels.LAUNCHES.items():
                check(c - before[k] == 2, f"{FRAME_HW} request: {k} launched {c - before[k]} times, expected 2")
            big_prep = service._prepare(big[:, :, ::-1].copy())
            check(big_prep[1] == (600, 1200), f"{FRAME_HW} frame resized to {big_prep[1]}, expected (600, 1200)")
            launches = dict(_kernels.LAUNCHES)
        finally:
            nms.nms_mask_matrix = orig_nms
            srv.shutdown()
            srv.server_close()
            service.close()

        for k, c in launches.items():
            if c < 2 * (N_REQUESTS + 1):
                raise AssertionError(f"{k} launched {c} times for {N_REQUESTS + 1} images, expected >= {2 * (N_REQUESTS + 1)}")
        check(big_res["width"] == FRAME_HW[1] and big_res["height"] == FRAME_HW[0], f"{FRAME_HW} request: size {big_res}")
        for d in big_res["detections"]:
            x0, y0, x1, y1 = d["box"]
            check(np.isfinite(d["score"]) and 0 <= x0 <= x1 <= FRAME_HW[1] and 0 <= y0 <= y1 <= FRAME_HW[0],
                  f"{FRAME_HW} request: detection {d}")
        log(f"  request {N_REQUESTS} ({FRAME_HW[0]}x{FRAME_HW[1]} PNG, resized to {big_prep[1]}): {big_ms:.1f} ms, "
            f"{len(big_res['detections'])} detections")
        for i, res in enumerate(results):
            if "error" in res:
                raise AssertionError(f"request {i}: {res['error']}")
            check(res["width"] == IMAGE_HW[1] and res["height"] == IMAGE_HW[0], f"request {i}: size {res}")
            dets = res["detections"]
            check(len(dets) <= det_cfg.detections_per_image, f"request {i}: {len(dets)} detections")
            for d in dets:
                x0, y0, x1, y1 = d["box"]
                if not all(np.isfinite([x0, y0, x1, y1, d["score"]])):
                    raise AssertionError(f"request {i}: non-finite detection {d}")
                if not (0 <= x0 <= x1 <= IMAGE_HW[1] and 0 <= y0 <= y1 <= IMAGE_HW[0]):
                    raise AssertionError(f"request {i}: box outside the image {d['box']}")
                check(0 <= d["class"] < det_cfg.num_classes, f"request {i}: class {d['class']}")
            log(f"  request {i}: {latency[i]:.1f} ms, {len(dets)} detections")
        log(f"  launches on the main path: {launches}")

        if len(captured) != 2:
            raise AssertionError(f"captured {len(captured)} NMS calls for one image, expected 2")
        for (b, s, v, thr), site in zip(captured, ("rpn", "roi")):
            keep_k = orig_nms(b, s, v, thr)
            keep_p = plain_keep(b, s, v, thr)
            if not torch.equal(keep_k, keep_p):
                raise AssertionError(f"{site} NMS: kernel and plain keep masks differ on the served inputs")
            log(f"  {site} NMS N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")

    with Phase("profile"):
        # the served detector without HTTP and the coalescing window: latency
        # by batch, then one image under torch.profiler
        det = service.detector
        prepared = [service._prepare(img) for img in imgs[:2]]
        canv = np.stack([p[0] for p in prepared])
        sizes = np.asarray([p[1] for p in prepared], np.int32)
        latency_ms = {}
        for b in (1, 2):
            for _ in range(3):
                det.infer(canv[:b], sizes[:b]).valid.cpu()
            runs = []
            for _ in range(10):
                t0 = time.perf_counter()
                det.infer(canv[:b], sizes[:b]).valid.cpu()
                runs.append((time.perf_counter() - t0) * 1e3)
            latency_ms[b] = float(np.median(runs))
            log(f"  infer batch {b}: median {latency_ms[b]:.2f} ms of 10 ({latency_ms[b] / b:.2f} ms/image)")
        torch.cuda.reset_peak_memory_stats()
        wall, dev, kern, ops = profile(lambda: det.infer(canv[:1], sizes[:1]).valid.cpu(), 5, ops=True)
        log(f"  profile batch 1: wall {wall:.2f} ms, device kernels {dev:.2f} ms, busy {dev / wall:.1%}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  top kernels (ms/image): {top(kern)}")
        log(f"  top ops by device self time (ms/image): {top(ops)}")
        del service, det

    with Phase("check vs CPU path"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        small = get_main_cfg()
        small.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", "(128, 256)"])
        small_cfg = detector_config_from_cfg(small)
        sd = init_weights(empty_model(small_cfg), SEED).state_dict()
        rng = np.random.RandomState(SEED + 2)
        img = rng.randint(0, 256, (1, 128, 256, 3)).astype(np.uint8)
        sizes = np.asarray([[120, 250]], np.int32)
        outs = {}
        for dev in ("cuda", "cpu"):
            d = Detector(small_cfg, device=dev).load_state_dict(sd)
            with torch.inference_mode():
                feat = d.model.features(torch.from_numpy(img).to(dev)).float().cpu()
            outs[dev] = (feat, d.infer(img, sizes))
        fg, fc = outs["cuda"][0], outs["cpu"][0]
        ferr = ((fg - fc).abs().max() / fc.abs().max().clamp_min(1e-12)).item()
        if not torch.isfinite(fg).all() or ferr > 1e-4:
            raise AssertionError(f"vgg4 feature: card vs CPU relative error {ferr:.3g} > 1e-4")
        g, c = outs["cuda"][1], outs["cpu"][1]
        gv, cv = g.valid.cpu(), c.valid
        if not torch.equal(gv, cv) or not torch.equal(g.classes.cpu()[gv], c.classes[cv]):
            raise AssertionError("detections: card and CPU valid/classes differ")
        berr = (g.boxes.cpu()[gv] - c.boxes[cv]).abs().max().item() if cv.any() else 0.0
        serr = (g.scores.cpu()[gv] - c.scores[cv]).abs().max().item() if cv.any() else 0.0
        if berr > 1e-2 or serr > 1e-4:
            raise AssertionError(f"detections: card vs CPU box err {berr:.3g} px, score err {serr:.3g}")
        log(f"  vgg4 rel err {ferr:.3g}; {int(cv.sum())} detections, box err {berr:.3g} px, score err {serr:.3g}")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    with Phase("timing"):
        rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for (b, s, v, thr), site in zip(captured, ("rpn", "roi")):
            r1, r2 = kernel_rows(b, s, v, thr, site)
            rows["suppress_relation_bits"].append(r1)
            rows["greedy_keep_from_bits"].append(r2)
        # N above the keep kernel's shared-memory route (its row walk)
        large_rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for label, (b, s, v, thr) in large_n.items():
            # the plain fixpoint takes N/2 rounds on the chain: one timed call
            r1, r2 = kernel_rows(b, s, v, thr, label, plain_reps=(2, 1))
            large_rows["suppress_relation_bits"].append(r1)
            large_rows["greedy_keep_from_bits"].append(r2)
        del large_n

    with Phase("train"):
        cfg = train_cfg("float32")
        log(f"  solver: BASE_LR {cfg.SOLVER.BASE_LR}, WARMUP_ITERS {cfg.SOLVER.WARMUP_ITERS}, MOMENTUM "
            f"{cfg.SOLVER.MOMENTUM}, WEIGHT_DECAY {cfg.SOLVER.WEIGHT_DECAY} (norm {cfg.SOLVER.WEIGHT_DECAY_NORM}), "
            f"STEPS {cfg.SOLVER.STEPS}, FACTOR_LIST {cfg.SOLVER.FACTOR_LIST}; canvas {cfg.TPU.CANVAS}, batch 1, image {IMAGE_HW}")
        train_captured = []
        step_ms = {}
        _kernels.reset_launches()
        for dtype in ("float32", "bfloat16"):
            trainer, batch, metrics, wall, per_step = train_run(dtype, train_captured)
            for i, m in enumerate(metrics):
                if not all(np.isfinite(m[k]) for k in TRAIN_LOSSES):
                    raise AssertionError(f"{dtype} step {i}: non-finite loss {m}")
            for i, d in enumerate(per_step):
                if any(c != 1 for c in d.values()):
                    raise AssertionError(f"{dtype} step {i}: kernel launches {d}, expected 1 of each per image")
            first, tenth = metrics[0]["total_loss"], metrics[10]["total_loss"]
            if not tenth < first:
                raise AssertionError(f"{dtype}: total loss did not fall over 10 steps ({first:.4f} -> {tenth:.4f})")
            step_ms[dtype] = float(np.median(wall[-TIMED:]))
            log(f"  {dtype} [{smi}]: step {step_ms[dtype]:.2f} ms (median of the last {TIMED} of {TRAIN_STEPS}; first "
                f"{wall[0]:.1f} ms), total loss {first:.4f} -> {tenth:.4f} after 10 steps, "
                f"gt {int(batch['gt_valid'].sum())} boxes; step 10: " +
                ", ".join(f"{k} {metrics[10][k]:.4f}" for k in TRAIN_LOSSES[:4]) +
                f", num_fg {metrics[10]['num_fg']:.0f}, num_sampled {metrics[10]['num_sampled']:.0f}")
        # one bfloat16 step (the SFAT main path's dtype) under the profiler
        torch.cuda.reset_peak_memory_stats()
        wall_p, dev_p, kern_p, ops_p = profile(lambda: trainer.run_step(batch), 3, ops=True)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_launches = dict(_kernels.LAUNCHES)
        nms_ms = sum(v for k, v in kern_p.items() if "suppress_relation_bits_kernel" in k or "greedy_keep_from_bits_kernel" in k)
        log(f"  profile bfloat16 step [{smi}]: wall {wall_p:.2f} ms, device kernels {dev_p:.2f} ms, busy {dev_p / wall_p:.1%}, "
            f"NMS kernels {nms_ms:.3f} ms ({nms_ms / dev_p:.1%} of device time), peak memory {peak_gib:.2f} GiB")
        log(f"  top kernels (ms/step): {top(kern_p)}")
        log(f"  top ops by device self time (ms/step): {top(ops_p, 10)}")
        log(f"  launches on the train path: {train_launches} over {2 * TRAIN_STEPS + 4} steps")

        if len(train_captured) != 2:
            raise AssertionError(f"captured {len(train_captured)} train-mode NMS calls, expected 2")
        for (b, s, v, thr), dtype in zip(train_captured, ("float32", "bfloat16")):
            keep_k = nms.nms_mask_matrix(b, s, v, thr)
            if not torch.equal(keep_k, plain_keep(b, s, v, thr)):
                raise AssertionError(f"train-mode RPN NMS ({dtype}): kernel and plain keep masks differ")
            log(f"  train-mode RPN NMS ({dtype}) N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")
        train_rows = kernel_rows(*train_captured[1], "train rpn (bfloat16)")
        del trainer

        err = card_vs_cpu_step()
        log("  card vs CPU, one float32 step at 256x512 (TF32 off): loss rel err " + format_errors(err, TRAIN_LOSSES) +
            "; CPU losses " + ", ".join(f"{k} {err['losses_cpu'][k]:.4f}" for k in TRAIN_LOSSES))
        if not card_step_ok(err):
            raise AssertionError(f"card step differs from the CPU step: {err}")

    with Phase("adapt"):
        # the main path: the main variant on the adaptation benchmark's
        # configuration (bfloat16, strong view, adaptive threshold, fixed
        # bfloat16 teacher), then on the main configuration, then _single
        adapt_captured = []
        adapt_step_ms = {}
        _kernels.reset_launches()
        for i, (label, base, trainer, steps) in enumerate((
            ("main variant, SFAT_BENCH_CONFIG", SFAT_BENCH_CONFIG, "source_free_adaptive_teacher", ADAPT_STEPS),
            ("main variant, MAIN_CONFIG", MAIN_CONFIG, "source_free_adaptive_teacher", ADAPT_STEPS),
            ("_single, SFAT_BENCH_CONFIG", SFAT_BENCH_CONFIG, "source_free_adaptive_teacher_single", SINGLE_STEPS),
        )):
            cfg = adapt_cfg(base, trainer)
            tr, batch, metrics, wall, per_step, teacher0, ema_err = adapt_run(cfg, steps, adapt_captured if i == 0 else [])
            check_adapt_run(label, tr, metrics, per_step, teacher0)
            if tr.ema_enabled:
                check(ema_err is not None and ema_err <= 1e-6, f"{label}: EMA rule off by {ema_err}")
            med = float(np.median(wall[-TIMED:])) if steps > TIMED else float(np.median(wall[1:]))
            log(f"  {label} [{smi}]: {type(tr).__name__}, teacher {next(tr.state.teacher.parameters()).dtype}, "
                f"step {med:.2f} ms (median of the last {min(TIMED, steps - 1)} of {steps}; first {wall[0]:.1f} ms); "
                f"num_pseudo per step {[int(m['num_pseudo']) for m in metrics]}; step {steps - 1}: " +
                ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in ADAPT_LOSSES) +
                (f"; EMA rule error {ema_err:.3g}" if ema_err is not None else "; teacher parameters unchanged, statistics moved"))
            adapt_step_ms[label] = med
            if i == 0:
                main_tr, main_batch = tr, batch
            del tr
        adapt_launches = dict(_kernels.LAUNCHES)
        total_steps = 2 * ADAPT_STEPS + SINGLE_STEPS
        log(f"  launches on the adaptation path: {adapt_launches} over {total_steps} steps at batch 1")
        check(all(c == 3 * total_steps for c in adapt_launches.values()), f"adaptation launches {adapt_launches}")

        # the three NMS inputs of the first step: kernel == plain
        check(len(adapt_captured) == 3, f"captured {len(adapt_captured)} NMS calls in one adaptation step, expected 3")
        adapt_sites = ("teacher rpn (test mode)", "teacher detection", "student rpn (train mode)")
        for (b, s_, v, thr), site in zip(adapt_captured, adapt_sites):
            keep_k = nms.nms_mask_matrix(b, s_, v, thr)
            check(torch.equal(keep_k, plain_keep(b, s_, v, thr)), f"{site} NMS: kernel and plain keep masks differ")
            log(f"  {site} NMS N={b.shape[0]} thr={thr}: kernel == plain, kept {int(keep_k.sum())} of {int(v.sum())} valid")

        # the strong view on the card against the CPU's, on the trainer's
        # draws and on draws that apply every op
        images, sizes = main_tr.stage(main_batch)
        draws = main_tr.make_draws(1, tuple(images.shape[1:3]))
        every_op = draws.strong._replace(do=torch.ones_like(draws.strong.do))
        for what, d in (("drawn", draws.strong), ("every op", every_op)):
            err, n_over, n_px = strong_view_card_vs_cpu(images[0].float(), sizes[0], d)
            log(f"  strong view card vs CPU ({what}: ops {d.do[0].int().tolist()}): max diff {err:.4g}, "
                f"{n_over} of {n_px} values more than 1 uint8 step apart")
            check(err <= 2.0 and n_over <= 1e-4 * n_px, f"strong view ({what}): card vs CPU {err}, {n_over} over 1 step")

        # the bfloat16 step reads nothing back to the host
        images, sizes = main_tr.stage(main_batch)
        draws = main_tr.make_draws(1, tuple(images.shape[1:3]))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = main_tr.step_on_device(images, sizes, draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(all(np.isfinite(float(m[k])) for k in ADAPT_LOSSES), "sync-checked step: non-finite loss")
        log("  step_on_device (bfloat16, batch on the device) ran under set_sync_debug_mode('error')")

        # one bfloat16 step under the profiler
        torch.cuda.reset_peak_memory_stats()
        wall_a, dev_a, kern_a, ops_a = profile(lambda: main_tr.run_step(main_batch), 3, ops=True)
        peak_a = torch.cuda.max_memory_allocated() / 2**30
        nms_a = sum(v for k, v in kern_a.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
        log(f"  profile bfloat16 adaptation step [{smi}]: wall {wall_a:.2f} ms, device kernels {dev_a:.2f} ms, "
            f"busy {dev_a / wall_a:.1%}, NMS kernels {nms_a:.3f} ms ({nms_a / dev_a:.1%} of device time), "
            f"peak memory {peak_a:.2f} GiB")
        log(f"  top kernels (ms/step): {top(kern_a)}")
        log(f"  top ops by device self time (ms/step): {top(ops_a, 12)}")
        del main_tr

        # the kernels on the step's three NMS inputs
        adapt_rows = {"suppress_relation_bits": [], "greedy_keep_from_bits": []}
        for (b, s_, v, thr), site in zip(adapt_captured, adapt_sites):
            r1, r2 = kernel_rows(b, s_, v, thr, site)
            adapt_rows["suppress_relation_bits"].append(r1)
            adapt_rows["greedy_keep_from_bits"].append(r2)

        for canvas, image_hw, held in (((128, 256), (120, 250), True), ((256, 512), (250, 500), False)):
            err = card_vs_cpu_adapt_step(canvas, image_hw)
            log(f"  card vs CPU, one float32 adaptation step at {canvas[0]}x{canvas[1]} (TF32 off"
                f"{'' if held else '; reported, not held: see card_vs_cpu_adapt_step'}): loss rel err " +
                format_errors(err, ADAPT_LOSSES) + f"; teacher BN stats rel err {err['teacher_bn'][0]:.3g} "
                f"({err['teacher_bn'][1]}); CPU " + ", ".join(f"{k} {err['losses_cpu'][k]:.4f}" for k in ADAPT_LOSSES) +
                f", num_pseudo {err['losses_cpu']['num_pseudo']:.0f}")
            if held:
                check(card_step_ok(err), f"adaptation step on the card differs from the CPU's: {err}")

    # what the tools phase reads from the eval and cli phases
    tools_dir = tempfile.TemporaryDirectory(prefix="sfod_tools_")
    keep = {"dir": tools_dir.name}

    with Phase("eval"):
        # the host libraries, built in the build phase from the checkout's sources
        for name in ("imgcodec", "cocoeval"):
            log(f"  host library {name}: {os.path.basename(built[name])}, g++ {host_libs.BUILD_SECONDS.get(name, 0.0):.2f} s")
        log("  JPEG and PNG decode: the port's own decoders (data/csrc/jpeg_decode.cpp, the PNG unfilter); no "
            "system image library")
        eval_dir = tempfile.TemporaryDirectory(prefix="sfod_eval_")
        root = eval_dir.name
        try:
            t0 = time.perf_counter()
            path, recs, first = write_eval_dataset(root, EVAL_IMAGES, FRAME_HW)
            log(f"  wrote {EVAL_IMAGES} {FRAME_HW[0]}x{FRAME_HW[1]} PNG frames and their COCO JSON in "
                f"{time.perf_counter() - t0:.2f} s")
            got = native_codec.decode(os.path.join(root, "frame_0001.png"))
            check(got.shape == first.shape and np.array_equal(got, first), "first PNG decode differs from the array written")
            cfg = adapt_cfg(MAIN_CONFIG)
            cfg.OUTPUT_DIR = os.path.join(root, "output")
            for name in (*cfg.DATASETS.TEST, *cfg.DATASETS.TRAIN_TARGET):
                register_dataset(name, path, root, CITYSCAPES_THING_CLASSES)
            tr = adapt_trainer(cfg)
            loader = tr.build_train_loader()
            # host decode + resize, one thread, every record
            t0 = time.perf_counter()
            preps = [loader._prep_image(r) for r in loader.records]
            decode_ms = (time.perf_counter() - t0) * 1e3 / len(preps)
            check(all(p[0].shape == (600, 1200, 3) for p in preps), f"resized to {preps[0][0].shape}")
            log(f"  host decode + resize (PNG {FRAME_HW[0]}x{FRAME_HW[1]} -> 600x1200) [{smi}]: {decode_ms:.2f} ms an image "
                "(one thread)")
            del preps
            it = iter(loader)
            steps = []
            for _ in range(EVAL_STEPS):
                batch = next(it)
                check(tuple(batch["sizes"][0]) == (600, 1200), f"train batch size {batch['sizes']}")
                steps.append({k: float(v) for k, v in tr.run_step(batch).items()})
            it.close()
            check(all(np.isfinite(m[k]) for m in steps for k in ADAPT_LOSSES), f"adaptation losses {steps}")
            log(f"  {EVAL_STEPS} adaptation steps from trainer.build_train_loader(): total loss "
                f"{[round(m['total_loss'], 4) for m in steps]}, num_pseudo {[int(m['num_pseudo']) for m in steps]}")

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            results = tr.test()
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            eval_launches = dict(_kernels.LAUNCHES)
            peak_eval = torch.cuda.max_memory_allocated() / 2**30
            n_eval = 2 * len(cfg.DATASETS.TEST) * EVAL_IMAGES
            check(all(c == 2 * n_eval for c in eval_launches.values()),
                  f"test(): launches {eval_launches}, expected {2 * n_eval} of each (2 per image and model)")
            with open(os.path.join(cfg.OUTPUT_DIR, "eval_results.json")) as f:
                written = json.load(f)
            check(len(written) == 4 and all(
                isinstance(v.get(k), (int, float)) and np.isfinite(v[k]) for v in written.values() for k in ("AP", "AP50", "F1")
            ), f"eval_results.json: {written}")
            log(f"  trainer.test() [{smi}]: {test_s:.2f} s for {n_eval} images ({n_eval / test_s:.2f} images/s, the host "
                f"decode included), launches {eval_launches}, peak memory {peak_eval:.2f} GiB")
            for key, v in written.items():
                log(f"    {key}: AP {v['AP']:.4f} AP50 {v['AP50']:.4f} F1 {v['F1']:.4f} DECE {v['DECE']}")
            # the teacher's detections on the first TEST set as a COCO results
            # file beside its GT, and test()'s AP50 on them: the tools phase's
            # metrics tool and GUI read these
            name = cfg.DATASETS.TEST[0]
            id_map = get_dataset(name).get("id_map") or {}
            keep["dets"] = os.path.join(keep["dir"], "coco_instances_results.json")
            keep["gt"] = shutil.copy(path, os.path.join(keep["dir"], "annotations.json"))
            keep["test_ap50"] = results[f"{name}/teacher"]["AP50"]
            keep["dump_ap50"] = tr._evaluate(tr.teacher, name, dump_json=keep["dets"],
                                             category_ids={v: k for k, v in id_map.items()})["AP50"]
            log(f"  {name}: the teacher's detections written as a COCO results file (its evaluation's AP50 "
                f"{keep['dump_ap50']!r}, test()'s {keep['test_ap50']!r})")

            # the whole eval loop (loader, dispatch, read-back, evaluators) by
            # pipeline depth, on the teacher (the fixed bfloat16 one)
            name = cfg.DATASETS.TEST[0]
            rate = {}
            for depth in (1, 4, 1, 4):
                coco = COCOEvaluator(CITYSCAPES_THING_CLASSES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inference_on_dataset(tr.teacher, build_test_loader(cfg, name), CITYSCAPES_THING_CLASSES,
                                     [coco, F1Evaluator()], pipeline_depth=depth)
                rate.setdefault(depth, []).append(EVAL_IMAGES / (time.perf_counter() - t0))
            log(f"  eval loop [{smi}]: depth 1 {rate[1]} images/s, depth 4 {rate[4]} images/s ({EVAL_IMAGES} images, "
                f"batch {cfg.TEST.IMS_PER_BATCH}, {cfg.DATALOADER.NUM_WORKERS} decode threads)")
            native, plain = coco_map_native(coco._dets, coco._gts, 8), coco_map(coco._dets, coco._gts, 8)
            diff = max(abs(native[k] - plain[k]) for k in ("AP", "AP50", "AP75", "AR100") if np.isfinite(plain[k]))
            check(diff <= 1e-9 and all(np.isfinite(native[k]) == np.isfinite(plain[k]) for k in native if k.startswith("A")),
                  f"native COCO vs coco_map: {diff}")
            n_dets = sum(len(d["scores"]) for d in coco._dets.values())
            log(f"  native COCO evaluator vs plain coco_map on {n_dets} detections: max difference {diff:.3g} (tol 1e-9)")

            wall_e, dev_e, kern_e, ops_e = profile(
                lambda: inference_on_dataset(tr.teacher, build_test_loader(cfg, name), CITYSCAPES_THING_CLASSES,
                                             pipeline_depth=4), 1)
            nms_e = sum(v for k, v in kern_e.items() if "suppress_relation_bits" in k or "greedy_keep_from_bits" in k)
            log(f"  profile eval loop, depth 4 [{smi}]: wall {wall_e:.2f} ms, device kernels {dev_e:.2f} ms, busy "
                f"{dev_e / wall_e:.1%}, NMS kernels {nms_e:.3f} ms ({nms_e / EVAL_IMAGES:.3f} ms an image)")
            log(f"  top kernels (ms/pass): {top(kern_e)}")

            # a dispatch reads nothing back to the host
            staging = Staging(tr.teacher.device, 1)
            batch = next(iter(build_test_loader(cfg, name)))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                images, sizes = staging.stage(0, batch)
                dets = tr.teacher.infer(images, sizes)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(bool(torch.isfinite(dets.scores).all()), "sync-checked dispatch: non-finite scores")
            log("  staging + Detector.infer ran under set_sync_debug_mode('error')")

            res_card, res_cpu, (unpaired, box_err, score_err), n_small = card_vs_cpu_eval(root)
            metric_err = max(abs(res_card[k] - res_cpu[k]) for k in ("AP", "AP50", "F1"))
            log(f"  card vs CPU, float32 eval loop on {EVAL_SMALL['images']} images at {EVAL_SMALL['canvas']}: "
                f"{n_small} detections, {unpaired} unpaired, box err {box_err:.3g} px, score err {score_err:.3g}, "
                f"AP/AP50/F1 err {metric_err:.3g}")
            check(n_small > 0 and unpaired == 0 and box_err <= 1e-2 and score_err <= 1e-4 and metric_err <= 1e-6,
                  "card eval loop differs from the CPU's")
            del tr
        finally:
            eval_dir.cleanup()

    with Phase("cli"):
        cli_launches_total = cli_phase(smi, adapt_step_ms, keep)

    with Phase("tools"):
        try:
            tools_launches, tools_numbers = tools_phase(smi, keep)
        finally:
            tools_dir.cleanup()

    with Phase("r101"):
        r101_launches, r101_rows = r101_phase(smi)

    with Phase("wq"):
        wq_launches, workflow = wq_phase(smi)

    def end_workflow():  # the wq phase's workflow, ended in the export phase
        for k, v in workflow.finish(smi).items():
            wq_launches[k] += v
        log(f"  launches on the wq path: {wq_launches}")

    roofline_dir = tempfile.TemporaryDirectory(prefix="sfod_roofline_")
    try:
        artifact = os.path.join(roofline_dir.name, "teacher_poly.sfodx")
        try:
            with Phase("export"):
                export_launches, _ = export_phase(smi, before_timing=end_workflow, keep_artifact=artifact)
        finally:
            workflow.close()

        with Phase("roofline"):
            roofline_launches, roofline_numbers = roofline_phase(smi, artifact, roofline_dir.name)
    finally:
        roofline_dir.cleanup()

    with Phase("car"):
        car_launches, _ = car_phase(smi)

    with Phase("da"):
        da_launches, da_numbers = da_phase(smi)

    with Phase("zoo"):
        zoo_launches, zoo_numbers = zoo_phase(smi)

    with Phase("settings"):
        settings_launches, settings_numbers = settings_phase(smi)

    with Phase("dist"):
        dist_launches, dist_numbers = dist_phase(smi)

    replaces = {
        "suppress_relation_bits": "simple_sfod_tpu/ops/pallas_kernels.py:26",
        "greedy_keep_from_bits": "simple_sfod_tpu/ops/pallas_kernels.py:123",
    }
    kernels = []
    for name in rows:
        # the main path, one adaptation step (batch 1): the kernel once per
        # NMS call site (teacher RPN, teacher detection, student RPN); the
        # numbers are the sum over the three sites, on the first step's
        # inputs. launches count every path: serve, train, adapt and eval
        # (trainer.test(), 2 per image and evaluated model), cli (the
        # CLI's subprocesses and the phase's loops, AdaBN included), r101
        # (its AdaBN CLI and test(), SFAT and base steps) and wq (the AdaBN
        # dump's test(), the WQ steps, the WQ CLI and the workflow's
        # CLIs), car (the Sim10k and KITTI source steps, their CLIs'
        # steps and test(), the adaptation CLIs) and export (the poly
        # artifact's calls and its DetectionService in this process, 2 an
        # image of each call; the export tools' and servers' processes
        # count their own) and da (the da, cda, adaptive_teacher and
        # weighted source-free steps and their CLIs) and zoo (the bare-VGG,
        # FPN and style runs, FPN test() and its artifact's requests, the
        # enhance CLI) and settings (the dropout SFAT steps, MC dropout, the
        # R50-FPN steps and inference, the ImageNet-init CLIs) and tools (the
        # raw path, inference with overrides, device_trace and StepTimer's
        # calls) and roofline (the tools' counted and timed steps and
        # forward calls, and the profiled steps). r101_per_step: the
        # ResNet-101 adaptation step's three calls.
        # per_call: one served image's two calls; train_per_step: one
        # supervised step's RPN call; large_n: N above the keep kernel's
        # shared-memory route (the row walk)
        per = adapt_rows[name]
        bound_by = max(per, key=lambda r: r["bound_ms"])["bound_by"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "simple_sfod_tpu_torch/ops/csrc/nms.cu",
            "replaces": replaces[name],
            "launches": launches[name] + train_launches[name] + adapt_launches[name] + eval_launches[name] +
                        cli_launches_total[name] + tools_launches[name] + r101_launches[name] + wq_launches[name] +
                        car_launches[name] + export_launches[name] + da_launches[name] + zoo_launches[name] +
                        settings_launches[name] + dist_launches[name] + roofline_launches[name],
            "max_abs_err": float(max(r["err"] for r in per + rows[name] + large_rows[name])),
            "ms": sum(r["ms"] for r in per),
            "call_ms": sum(r["call_ms"] for r in per),
            "plain_ms": sum(r["plain_ms"] for r in per),
            "bound_ms": sum(r["bound_ms"] for r in per),
            "bound_by": bound_by,
            "library_ms": None,
            "ptxas": ptxas[name],
            "launches_by_path": {"serve": launches[name], "train": train_launches[name], "adapt": adapt_launches[name],
                                 "eval": eval_launches[name], "cli": cli_launches_total[name],
                                 "tools": tools_launches[name],
                                 "r101": r101_launches[name], "wq": wq_launches[name], "car": car_launches[name],
                                 "export": export_launches[name], "da": da_launches[name], "zoo": zoo_launches[name],
                                 "settings": settings_launches[name], "dist": dist_launches[name],
                                 "roofline": roofline_launches[name]},
            "da_steps": da_numbers,
            "zoo_runs": zoo_numbers,
            "settings_runs": settings_numbers,
            "dist_runs": dist_numbers,
            "tools_runs": tools_numbers,
            "roofline_runs": roofline_numbers,
            "adapt_per_step": per,
            "r101_per_step": r101_rows[name],
            "per_call": rows[name],
            "train_per_step": train_rows[0 if name == "suppress_relation_bits" else 1],
            "large_n": large_rows[name],
        })
    log(f"total wall {time.perf_counter() - t_start:.2f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
