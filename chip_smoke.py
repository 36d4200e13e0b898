#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``super_gradients_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``. It
imports nothing of JAX or of the JAX package, and exits non-zero (printing no
result) without CUDA or without the port's sources next to it. Phases:

1. build kernel K1 (exact-NMS keep mask, ``csrc/nms_exact.cu``) from the sources;
2. K1 against its plain PyTorch version on the card: keep masks bit-equal on random
   fixtures at the predict path's shape (B=8, K=1024), the suppression chain,
   threshold-adjacent IoUs and the sweep's tiling (K around multiples of 64, chains
   across tile edges, valid prefixes, scattered valid boxes, identical and disjoint
   boxes). K1 timed at B=8 and B=32, K=1024, for valid prefixes of 64, 300 and 1024
   and for 80% random valid boxes: the whole call with CUDA events, each of its two
   CUDA kernels with ``torch.profiler``, beside its bound; the plain version at
   K=1024;
3. the slice at full width: YOLO-NAS-M, 80 classes, random weights from seed 0
   (``cls_pred`` biases at 0), a few ``predict()`` requests on mixed-size uint8
   images and ``predict_batch_tensor`` on [8, 640, 640, 3], fused bf16 and fp32
   unfused; K1's launch counter must rise and every image must detect something;
4. the fp32 unfused forward and predict on the GPU (TF32 off) against the same
   model on the CPU (plain path);
5. fused bf16 ``predict_batch_tensor`` throughput at b8 and b32;
6. K1 at the predict path's own candidates: the ``batched_nms`` input of fused bf16
   ``predict_batch_tensor`` at b8 and b32 is captured, K1 is held bit-equal to the
   plain version on it and timed as in phase 2, and ``batched_nms`` is timed whole;
7. the training slice at full width: YOLO-NAS-M, 80 classes, 640x640, seed 0,
   ``Trainer.train`` in the COCO YOLO-NAS regime (AdamW 2e-4, weight decay 1e-5 off
   biases and BN, cosine to 0.1 after a linear batch warmup from 1e-6, threshold
   EMA 0.9997, PPYoloELoss with TAL, bf16) for 2 epochs of 4 pinned batches of 16
   with up to 120 boxes. Every loss finite, every parameter changed, the EMA
   weights handed back, and ``predict()`` afterwards runs K1 and differs from before;
8. one fp32 SGD step (TF32 off) of YOLO-NAS-M at ``FP64_STEP_HW``, b2, on the GPU and on the CPU,
   both held to an fp64 CPU step: the assigners' labels are compared (the count of
   anchors that differ is printed), then every run takes the fp64 run's assignment,
   and the GPU's loss components and gradients must be no further from fp64 than
   twice the CPU fp32 run's;
9. the bf16 train step timed at b16 and b32 on a batch already on the card: ms a
   step and img/s by CUDA events, split into forward, loss (assigner and losses),
   backward and optimizer + EMA; the device's idle share (``torch.profiler`` self
   CUDA time against wall time); peak memory;
10. validation with ``DetectionMetrics`` at full width (YOLO-NAS-M, 640, fp32, TF32
   off): ``Trainer.evaluate`` on a batch whose targets are the model's own
   detections must give mAP@0.50:0.95 >= 0.999; with the targets moved by a seeded
   offset, the mAP on the card must agree with ``Trainer.evaluate`` of the same batch
   and weights on the CPU (plain NMS). Then one validation batch as training runs
   it (bf16, channels_last) timed at b16 and b32: forward, ``batched_nms`` and K1
   alone by CUDA events, host matching and ``compute`` by the host clock, and the
   device's idle share over the batch;
11. recipe-driven training from a COCO-format dataset at full width: an RF100-layout
   dataset of 64 train and 32 valid PNGs written by PIL (seeded smooth fields with
   1-30 filled rectangles over 80 categories, a few valid boxes iscrowd) in a temporary
   directory, then ``train_from_recipe.main`` of ``roboflow_yolo_nas_m`` (YOLO-NAS-M,
   640, the mosaic/affine/mixup/HSV/flip chain, uint8 batches standardized on the card),
   cut to 2 epochs of b16 with 8 loader workers, bf16, each epoch tiling the train set
   to 2 batches a worker: K1 4 launches inside it, every loss and metric finite,
   ``recipe.json`` the resolved recipe; ``Trainer.resume_experiment`` takes no step and
   restores a bit-equal state; ``evaluate_checkpoint(ckpt_best)`` equals
   ``Trainer.evaluate`` of ``models.get(checkpoint_path=ckpt_best.pth)`` on the val
   loader, and the live weights in place of the EMA's (a planted fault) do not; a uint8
   batch standardized on the card is bit-equal to the host's; two loaders of one seed
   and 4 workers give byte-equal first batches. Timed: epoch 2's loop whole and in its
   steady state (after the first wave of one batch a worker): ms a step, the share
   spent waiting in ``next(loader)``, the device's idle share; bytes a batch, the loader
   alone at 0, 4 and 8 workers, one sample's chain by stage, and the loader alone with
   cv2's own pool in each worker (the kept choice) against cv2 run sequentially there.
   The transforms take the JAX package's cv2 calls: the phase fails if cv2 does not
   import, and every no-cv2 stand-in raises while it runs (loader workers included);
12. the data and predict surface at full width (YOLO-NAS-M, 640, exact NMS; the
   stand-ins raise here too): ``predict()`` on a folder of PNG and JPEG files, on a PIL
   image and on an MP4 (8 frames of 640x480, written by cv2), each held to the same call
   on the CPU (fp32, TF32 off, phase 4's matched-fraction rule); every result drawn and
   saved, the drawn video read back at its size, frame count and rate; ``predict()`` of
   phase 3's 4-image request timed again, with its host letterbox alone; one validated
   ``Trainer.train`` epoch from plain ``torch.utils.data.DataLoader``s over phase 11's
   dataset, the train order from a ``ClassBalancedSampler``, with
   ``DetectionVisualizationCallback`` (K1 3 launches: 2 validation batches and the
   drawing; 4 PNGs through the logger); ``AutoTrainBatchSizeSelectionCallback`` over
   the ladder 8-64 with an 80 GB budget, each candidate's peak memory printed;
13. YOLO-NAS-POSE-S at 640 (published widths and depths, 17 joints, seed 0, ``cls_pred``
   biases 0): (a) fp32 ``predict()`` on the card against the CPU (TF32 off, exact NMS,
   conf 0.01, up to 300 poses) on phase 3's 4-image request and a PIL image, boxes
   matched one to one at IoU 0.99 (>= 99%) and the matched joints within
   ``POSE_PX_TOL`` px, one result drawn, saved and read back at its size; (b) fused bf16
   ``predict_batch_tensor`` at b8 and b32: img/s (host clock), forward and
   ``batched_pose_nms`` ms (CUDA events), idle share (profiler); (c) K1 on the captured
   pose candidates (K = 1024, all valid) at b8 and b32, bit-equal to the plain version
   and timed as in phase 6; (d) one fp32 SGD pose step on the card and on the CPU held to
   an fp64 CPU step (phase 8's rule), then the bf16 step at b16 and b32 by part, its
   idle share, its peak memory and the assigner's peak beside its ``[B, 30, 8400, 17]``
   OKS distances; (e) ``train_from_recipe`` of ``coco2017_yolo_nas_pose_s`` on a COCO
   person-keypoints dataset of PNGs written from seed 13 (phase 11's sizes, 1-6 persons
   each, visibility 0/1/2, ~10% iscrowd), 2 epochs of b16 with the train set tiled to 2
   batches a worker, bf16, one validation pass an epoch through
   ``PoseEstimationMetrics`` (K1 4 launches), the epoch-2 steady state and
   ``evaluate_checkpoint`` held to a direct ``Trainer.evaluate`` with a planted fault
   beyond the gate. K1's launches in (a) and (e) join the kernels line;
14. classification at full width, launching no kernel (K1 must count 0 here): (a) ResNet-50,
   1000 classes, seed 0, its head scaled to a logit std of 2 (random-init logits reach
   ~2,000, where every softmax is one-hot): fp32 ``predict()`` (TF32 off) on phase 3's
   request and a PIL image on the card and on the CPU, top-1 equal, top-5 probabilities
   within ``CLS_CONF_TOL``, logits within twice the CPU's distance to fp64; (b) that
   request's ``predict()`` latency and its host preprocessing alone, and the fp32 forward
   at b32 and b128 (ms, img/s, idle share); (c) the ``imagenet_resnet50`` regime through
   ``Trainer.train`` on the registered ``imagenet_train`` / ``imagenet_val`` loaders over an
   ImageFolder of PNGs it writes (2 epochs of 3 steps of b64: every loss finite, every
   parameter changed, the weights handed back), then the bf16 step at b128 and b256 by
   part with its idle share and peak memory; (d) ``train_from_recipe`` of ``cifar10_resnet``
   on the JAX package's class-separable CIFAR test data with its overrides, fp32 with TF32
   off and cuDNN deterministic, from model seeds 0-5 (the best Accuracy of the six >= 0.90),
   ``evaluate_checkpoint`` of the seed-0 run within 1e-6 of a direct ``Trainer.evaluate``
   with a planted fault beyond it, and ``resume_experiment`` taking no step;
15. segmentation at Seg50's 512x1024, 19 classes, launching no kernel (K1 must count 0 here):
   for PP-LiteSeg-T and STDC1-Seg, seed 0, (a) fp32 ``predict()`` (TF32 off) of four seeded
   1024x2048 images and a PIL image on the card and on the CPU, class maps agreeing on >= 99.9%
   of the pixels, logits within twice the CPU's distance to fp64; (b) that request's
   ``predict()`` latency and its host preprocessing alone, the fp32 forward at b8 and b16
   (ms, img/s, idle share); (c) the bf16 train step by part at b8 (PP-LiteSeg-T +
   ``DiceCEEdgeLoss``) and b16 (STDC1-Seg + ``STDCLoss``) with idle share and peak memory, and
   OHEM's sort alone; (d) ``train_from_recipe`` of ``cityscapes_pplite_seg50`` and
   ``cityscapes_stdc_base`` (bf16, 2 epochs, 8 workers) on a Cityscapes-layout tree of 16 + 8
   1024x2048 PNGs written by ``tools/cityscapes_synthetic.py``: every loss finite, every
   parameter changed, ``evaluate_checkpoint`` within 1e-6 of a direct ``Trainer.evaluate`` with
   a planted fault beyond it, ``resume_experiment`` taking no step, the bytes of a batch;
16. PP-YOLOE-S and YOLOX-S at 640 (published widths and depths, 80 classes, seed 0, the
   prediction kernels redrawn as ``spread_zoo_head`` says): (a) fp32 ``predict()`` (TF32 off,
   exact NMS) on phase 3's request and a PIL image on the card against the CPU (phase 4's
   matched-fraction rule), and PP-YOLOE's fused forward against its unfused one on the card;
   (b) fused bf16 ``predict_batch_tensor`` at b8 and b32: img/s, forward and ``batched_nms``
   ms, idle share; (c) K1 bit-equal to its plain version on each model's captured candidates
   (PP-YOLOE's from its logits, YOLOX's from its probability scores) and timed; (d)
   ``SlidingWindowInferenceDetectionWrapper`` (tile 640, step 512) over YOLO-NAS-M and
   PP-YOLOE-S on a seeded 1080x1920 image, GPU against CPU, one K1 launch an image over its
   8 tiles' 67,200 anchors, timed, then ``SlidingWindowValidationCallback``'s JAX-equal
   ``TypeError``; (e) one fp32 SGD YOLOX-S step at b2 on 320x320 images on the card and on the CPU
   held to an fp64 CPU step (phase 8's rule, the SimOTA assignment compared, then shared), and the bf16
   step at b16 by part for YOLOX-S (SimOTA), PP-YOLOE-S with ATSS and with TAL, with idle share
   and peak memory; (f) ``train_from_recipe`` of ``roboflow_yolox`` and ``roboflow_ppyoloe``
   on phase 11's dataset (2 epochs of b16, bf16, both stage switches cut to epoch 1: L1 on,
   mosaic and mixup closed, ATSS to TAL), K1 once a validation batch, ``evaluate_checkpoint``
   within 1e-6 of a direct ``Trainer.evaluate`` with a planted fault beyond it,
   ``resume_experiment`` taking no step, and a few batches of ``coco2017_train_ppyoloe`` with
   ``multiscale`` over a COCO-layout copy of the images at the sizes of its schedule;
17. MobileNet and SSD at full width, seed 0: (a) SSD-lite-MobileNetV2 (80 classes, 320, BN
   statistics on 16 noise images) fp32 ``predict()`` (TF32 off, exact NMS) on phase 3's
   request and a PIL image on the card against the CPU, phase 4's matched-fraction rule at
   the default conf 0.25 (both NMS caps bind) and at 0.95 (neither does), with what each
   unmatched detection met printed; (b) K1 bit-equal to its plain version on SSD's captured
   candidates (the raw 81-column confs, as the JAX predict program suppresses them) at b8 and
   b32, timed; (c) fused bf16 ``predict_batch_tensor`` at b8 and b32: img/s, forward and
   ``batched_nms`` ms, idle share; (d) one fp32 SGD SSD step at b2 on the card and on the CPU
   held to an fp64 CPU step (phase 8's rule: the matching and the mined negatives compared,
   then the fp64 ones shared), and the bf16 step at b32 by part with ``SSDLoss`` apart, idle
   share and peak memory; (e) MobileNetV3-large (1000 classes, 224, the head scaled to a logit
   std of 2) fp32 ``predict()`` against the CPU (top-1 equal, top-5 within ``CLS_CONF_TOL``, the
   card's logits within twice the CPU's distance to fp64) and its fp32 forward at b32 and b128; (f) ``train_from_recipe`` of
   ``coco2017_ssd_lite_mobilenet_v2`` on a COCO-layout copy of phase 11's PNGs (2 epochs of b16),
   K1 once a validation batch, the dataset's class names on the trained model,
   ``evaluate_checkpoint`` within 1e-6 of a direct ``Trainer.evaluate`` with a planted fault
   beyond it; (g) ``models.get("ssd_lite_mobilenet_v2", pretrained_weights="coco")`` from a
   temporary ``$SG_PRETRAINED_DIR`` holding a port-written ``.pth``: predictions equal to the
   same file through ``checkpoint_path=``, the COCO class names and processing.

18. data parallelism (``torch.distributed``; the launcher starts the ranks as
   ``chip_smoke.py --ddp-rank ...``, each killed with its session past ``DDP_TIMEOUT``):
   (a) ``python3 -m torch.distributed.run --standalone --nproc_per_node=1`` of the module
   ``super_gradients_tpu_torch.train_from_recipe`` (run as ``-m`` runs it) with
   ``roboflow_yolo_nas_m num_devices=1`` on phase 11's dataset, 1 epoch of b16 at 320, bf16: the rank
   joins a one-rank NCCL group, its losses are finite, K1 launches once a validation batch on
   it, and ``evaluate_checkpoint`` equals a direct ``Trainer.evaluate`` (phase 11's gate);
   on that rank, ``GlobalBatchNorm2d`` forced onto its global path holds to ``nn.BatchNorm2d``
   on a bf16 channels_last activation within ``DDP_BN_BF16_TOL`` (both timed, with the
   profiler's host time by op), and the bf16 b16 step is timed by part as the trainer builds
   it there (DDP, cuDNN's BN), without DDP's wrapper and with the global BN forced on,
   interleaved on one model (two passes of ``DDP_TIMED_STEPS`` steps each), beside phase 9's step;
   (b) two ranks sharing the card over gloo (``setup_device(backend="gloo")``) take one fp32
   SGD step of YOLO-NAS-M at 320 (TF32 off) on a global batch of 4 (phase 8's dataset
   extended), 2 a rank: the loss, the gradients and the updated weights no further from an
   fp64 CPU step than twice the one-process GPU step (the fp64 assignment shared, as in
   phase 8), and ``GlobalBatchNorm2d`` over the two ranks within ``DDP_BN_TOL`` of
   ``nn.BatchNorm2d`` on the whole batch; (c) the same two ranks, after (b), run
   ``train_from_recipe`` (1 epoch of global b16 at 320, bf16) validated with ``DetectionMetrics``
   gathered over the ranks: equal on both ranks and within 1e-6 of one process's validation
   of ``ckpt_best.pth`` under the same policy, K1 twice on each rank, nothing written by rank
   1; (d) with two or more GPUs, the bf16 step at global b32 over NCCL timed by part on each
   rank (with one GPU it says so and runs nothing). The ranks' K1 launches join the kernels
   line;
19. the Cityscapes segmentation zoo at 1024x2048, 19 classes, seed 0, launching no kernel (K1
   must count 0 here): (a) fp32 ``predict()`` (TF32 off) of two seeded 1024x2048 images by
   DDRNet-23, RegSeg48 and SegFormer-B0 at their 1024x2048 input on the card and on the CPU,
   class maps agreeing on >= ``SEG_AGREEMENT`` of the pixels, the card's logits of one image
   within twice the CPU's distance to an fp64 CPU run, and the fp32 forward at b2 timed; (b)
   the bf16 train step of DDRNet-23 with its aux head and ``OhemCELoss`` (the recipe's
   criterion) at b8 on 1024x1024 crops by part, its idle share and peak memory; (c)
   ``train_from_recipe`` of ``cityscapes_ddrnet`` and ``cityscapes_regseg48`` (their loaders,
   b8, bf16, one epoch of two steps, validated) on phase 15(d)'s Cityscapes-layout tree of 16 + 8
   1024x2048 PNGs: losses and metrics finite, every parameter changed;
20. the rest of the segmentation zoo at 512x512 (the COCO segmentation recipe's size), 21
   classes, seed 0, launching no kernel (K1 must count 0 here): (a) fp32 ``predict()`` (TF32
   off) of two seeded 512x512 images by ShelfNet34-LW, ShelfNet50 (the HW path: transposed
   convs, SE and FCN aux heads) and LadderNet-50 on the card and on the CPU, class maps agreeing
   on >= ``SEG_AGREEMENT`` of the pixels, |GPU - fp64| / |CPU - fp64| of one image's logits
   at most ``SHELF_CUDNN_RATIO`` through cuDNN (whose fp32 convolutions land further from fp64
   than the CPU's) and at most 2 (phase 19's rule) with cuDNN off, and the fp32 forward at b2
   timed; (b) ``coco_segmentation_shelfnet_lw``'s bf16 step (SGD
   5e-3, momentum 0.9, weight decay 1e-4 off bias and BN, no EMA) of ShelfNet34-LW with
   ``ShelfNetOHEMLoss`` over its three heads at b32 on 512x512 by part, its idle share and
   peak memory; (c) ``train_from_recipe`` of ``coco_segmentation_shelfnet_lw`` on a seeded
   COCO-layout tree (polygons, a compressed RLE, an uncompressed-RLE crowd, overlapping
   instances) and of ``supervisely_unet`` on a seeded csv tree (``tools/segmentation_synthetic.py``),
   each at its own image size and batch (b32 at 512x512, b32 at 480x320), bf16, 2 loader workers,
   one epoch of two steps, and ``evaluate_checkpoint`` within 1e-6 of a direct ``Trainer.evaluate``;
21. the rest of the classification zoo at ImageNet's 224, 1000 classes, seed 0, launching no kernel
   (K1 must count 0 here): (a) EfficientNet-B0, RegNetY800, RepVGG-A0 (and its deploy form after
   ``fuse_repvgg``), ViT-Base/16, DenseNet-121 and BEiT-Base, the BN statistics set on the request (a
   random-init BN net calibrated on noise is chaotic) and each head scaled to a logit std of 2 as in
   phase 14: fp32 ``predict()`` (TF32 off) of four seeded images on the card and on the CPU, top-1
   equal and top-5 probabilities within ``CLS_CONF_TOL``, the logits' distances to fp64 printed, and
   the fp32 forward at b32 timed; (b) ``imagenet_efficientnet``'s bf16 step (EfficientNet-B0, RMSProp
   with momentum 0.9 and weight decay 1e-4 off bias and BN, EMA, label smoothing 0.1) at b128 and
   ``imagenet_vit_base``'s (ViT-Base, SGD, ``clip_grad_norm`` 1.0) at b64, by part, with idle share
   and peak memory; (c) RMSProp and Lion over EfficientNet-B0's parameters, 5 steps of seeded
   gradients at a changing LR in fp64 on the card and on the CPU, within ``CLS_ZOO_OPT_TOL``, and the
   fp32 step timed; (d) ``train_from_recipe`` of ``imagenet_efficientnet`` and ``imagenet_vit_base``
   on phase 14(c)'s ImageFolder tree (10 classes), bf16, one epoch of two steps of b100, validated:
   losses and metrics finite, every parameter changed, ``evaluate_checkpoint`` within 1e-6 of a direct
   ``Trainer.evaluate`` with a planted fault beyond it;
22. export and knowledge distillation at full width: (a) YOLO-NAS-M (80 classes, 640, seed 0,
   ``cls_pred`` biases 0) exported fused bf16 with exact NMS (``conversion/export.py``, K1 as the
   op ``sg_torch::nms_exact_keep``) at b1 and b8, saved, loaded and run on phase 3's letterboxed
   request and on noise: ``num_detections`` equal to the live ``predict_batch_tensor``, >= 99% of
   the detections matched at IoU 0.99, K1 launched inside the loaded program and bit-equal to its
   plain version on the candidates captured there; the export seconds, the artifact's MB, the
   exported and live b8 batch ms and the op's dispatch against K1's direct launch; YOLO-NAS-POSE-S
   (640) and PP-LiteSeg-T (512x1024) exported in fp32 and held on the card to the CPU by phase
   13(a)'s and 15(a)'s gates; (b) ``imagenet_resnet50_kd``'s bf16 step (ResNet-50 from BEiT-Base/16,
   1000 classes, 224) at its b192 by part (teacher and student forward apart), with idle share and
   peak memory; ``train_from_kd_recipe`` of that recipe on phase 14(c)'s ImageFolder tree, one epoch
   of two steps, the teacher from a port-written ``.pth`` in a temporary ``$SG_PRETRAINED_DIR``: the
   teacher bit-unchanged, the student moved, ``evaluate_checkpoint`` within 1e-6 of a direct
   ``Trainer.evaluate`` with a planted fault beyond it; one fp32 KD step of ``resnet18_cifar`` from
   ``resnet18_cifar`` at 32 px within twice the CPU's distance to fp64; ``cityscapes_kd_base``'s bf16
   step (DDRNet-23-slim from DDRNet-39, ``SegKDLoss``) at its b16 and 512x1024 on a batch of phase
   15(d)'s tree, by part. K1's launches of (a) join the kernels line; (b) launches none.

Phase 7 also validates: 2 batches of 16 after each epoch with ``DetectionMetrics``
(K1 once a batch: 4 launches inside ``Trainer.train``), writes ``ckpt_latest``,
``ckpt_best``, ``ckpt_epoch_1``, ``average_model`` and ``recipe.json`` into a
temporary directory, resumes from them with a second ``Trainer`` (bit-equal state,
no step taken) and predicts with ``models.get(checkpoint_path=ckpt_best.pth)``.

The line before the last is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "super_gradients_tpu_torch/csrc/nms_exact.cu"
KERNEL_REPLACES = "super_gradients_tpu/ops/pallas/nms_kernel.py:93"
K1_CUDA_KERNELS = ("nms_mask_kernel", "nms_sweep_kernel")
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate (at a 700 W limit)
H100_FP32_FLOP_PER_S = 67e12
H100_BYTES_PER_S = 3.35e12
IOU_FLOPS = 13  # 2 min, 2 max, 2 sub, 2 clamps, mul, add, sub, +eps, div, with areas computed once
# |GPU - CPU| mAP@0.50:0.95 of phase 10's jittered batch: 1.34e-5 on an H100 80GB HBM3
# (a match flipped by the two devices' fp32 forwards), held here with a 37x margin
VALID_MAP_TOL = 5e-4
# the images of the fp32 steps held to an fp64 CPU step (YOLO-NAS-M in phases 8 and 18b, YOLOX-S in
# 16e): 320 keeps the script inside its time limit (YOLO-NAS-M's fp64 CPU step takes 24 s at 640).
# Pose's (13d) stays at 640: at 320 its fp32 GPU loss_dfl landed 7.5x the CPU's distance from fp64,
# past the 2x gate.
FP64_STEP_HW = 320


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=2, queue_ahead=False):
    """Mean device milliseconds of fn() over iters calls (CUDA events).

    With ``queue_ahead`` the device first sleeps while the host enqueues every call, so
    the events time the device alone and not how fast the host issues the launches.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_sorted_boxes(torch, gen, b, k, num_classes=80, size=640.0):
    """Score-sorted, class-offset candidate boxes as the predict path builds them."""
    xy = torch.rand((b, k, 2), generator=gen) * size
    wh = torch.rand((b, k, 2), generator=gen) * 120 + 4
    boxes = torch.cat([xy, xy + wh], dim=-1)
    cls = torch.randint(0, num_classes, (b, k), generator=gen).float()
    boxes = boxes + (cls * 8192.0)[..., None]
    valid = torch.rand((b, k), generator=gen) > 0.2
    return boxes.cuda().contiguous(), valid.cuda().contiguous()


def k1_bound(valid, k):
    """Least time (ms) the card could take for K1 on these inputs, and what bounds it.

    Operations: the IoUs of the pairs among each image's valid boxes. Bytes: boxes and
    valid read once, keep written once.
    """
    n = valid.sum(dim=1).double()
    flops = IOU_FLOPS * float((n * (n - 1) / 2).sum())
    nbytes = valid.shape[0] * k * (16 + 1 + 1)
    ops_ms, bytes_ms = 1e3 * flops / H100_FP32_FLOP_PER_S, 1e3 * nbytes / H100_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _self_device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def profiled(torch, fn, iters, with_cpu=True, attempts=3):
    """``torch.profiler`` ``key_averages()`` of ``iters`` calls of ``fn``, and the wall
    ms per call. A session that records no device time at all is repeated, up to
    ``attempts`` (one session of this script's first H100 runs recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if with_cpu else [ProfilerActivity.CUDA]
    for attempt in range(attempts):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        events = prof.key_averages()
        if sum(_self_device_us(e) for e in events) > 0:
            return events, wall_ms
        print(f"profiler session {attempt + 1} of {attempts} recorded no device time; profiling again")
    check(False, f"the profiler recorded no device time in {attempts} sessions")


def k1_kernel_ms(torch, fn, iters=50):
    """Mean device ms per call of each of K1's CUDA kernels (torch.profiler key_averages)."""
    fn()
    torch.cuda.synchronize()
    events, _ = profiled(torch, fn, iters)
    per_kernel = dict.fromkeys(K1_CUDA_KERNELS, 0.0)
    for evt in events:
        for name in K1_CUDA_KERNELS:
            if name in evt.key:
                total_us = evt.device_time_total if hasattr(evt, "device_time_total") else evt.cuda_time_total
                per_kernel[name] += total_us / 1e3 / iters
    check(all(ms > 0 for ms in per_kernel.values()), f"the profiler saw no device time for a K1 kernel: {per_kernel}")
    return per_kernel


def time_k1(torch, nms_exact, label, boxes, valid, t, phase=2):
    """K1's device time on these inputs: whole call, per CUDA kernel, and its bound."""
    call = lambda: nms_exact.exact_nms_keep(boxes, valid, t)  # noqa: E731
    per_kernel = k1_kernel_ms(torch, call)
    ms = cuda_ms(call, iters=50, queue_ahead=True)
    bound_ms, bound_by = k1_bound(valid, boxes.shape[1])
    passes = ", ".join(f"{name} {kms:.4f} ms" for name, kms in per_kernel.items())
    print(f"[{phase}] K1 {label}: {ms:.4f} ms a call (CUDA events; {passes} by the profiler); "
          f"bound {1e3 * bound_ms:.3f} us by {bound_by}, reached {100 * bound_ms / ms:.2f}%")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, **per_kernel}


def check_k1_equal(torch, nms_exact, name, boxes, valid, t):
    got = nms_exact.exact_nms_keep(boxes, valid, t)
    torch.cuda.synchronize()
    ref = nms_exact.exact_nms_keep_plain(boxes, valid, t)
    err = (got.float() - ref.float()).abs().max().item() if got.numel() else 0.0
    check(err == 0.0, f"K1 keep mask differs from the plain version on {name}")
    return err


def tiling_fixtures(torch, gen):
    """Cases aimed at the sweep's 64-box tiles and the valid extent (name, boxes, valid, t)."""
    out = [(f"random_b2_k{k}", *random_sorted_boxes(torch, gen, 2, k, num_classes=4), 0.5)
           for k in (1, 63, 64, 65, 128, 129, 1000)]
    # chains of boxes 3 px apart across the tile edges 63/64/65 and 127/128/129: at t=0.3
    # neighbours overlap (IoU 0.54), boxes two apart do not (0.25)
    x = torch.arange(130, dtype=torch.float32) * 100
    for start, base in ((60, 20000.0), (124, 40000.0)):
        n = torch.arange(min(9, 130 - start), dtype=torch.float32)
        x[start:start + len(n)] = base + 3 * n
    chain = torch.stack([x, torch.zeros_like(x), x + 10, torch.full_like(x, 10)], -1)[None].cuda()
    out.append(("tile_chain", chain, torch.ones(1, 130, dtype=torch.bool).cuda(), 0.3))
    boxes, _ = random_sorted_boxes(torch, gen, 4, 1024, num_classes=4)
    prefixes = torch.arange(1024)[None, :] < torch.tensor([0, 1, 64, 300])[:, None]
    out.append(("prefixes_0_1_64_300_of_1024", boxes, prefixes.cuda(), 0.6))
    boxes, _ = random_sorted_boxes(torch, gen, 2, 300)
    scattered = torch.rand((2, 300), generator=gen) < 0.4
    scattered[:, 64:128] = False
    out.append(("non_prefix", boxes, scattered.cuda(), 0.5))
    same = torch.tensor([5.0, 5.0, 50.0, 40.0]).expand(1, 150, 4).contiguous().cuda()
    out.append(("identical", same, torch.ones(1, 150, dtype=torch.bool).cuda(), 0.5))
    i = torch.arange(150, dtype=torch.float32)
    xy = torch.stack([(i % 15) * 20, (i // 15) * 20], -1)
    apart = torch.cat([xy, xy + 10], -1)[None].cuda()
    out.append(("disjoint", apart, torch.ones(1, 150, dtype=torch.bool).cuda(), 0.5))
    return out, chain


def phase_kernel(torch, nms_exact, box_iou):
    """K1 vs plain: bit-equal masks; returns (max_abs_err, timings)."""
    gen = torch.Generator().manual_seed(0)
    fixtures = [("random_b8_k1024_t0.7", *random_sorted_boxes(torch, gen, 8, 1024), 0.7),
                ("random_b8_k1024_t0.5", *random_sorted_boxes(torch, gen, 8, 1024), 0.5),
                ("random_b3_k200_t0.6", *random_sorted_boxes(torch, gen, 3, 200), 0.6),
                ("random_b2_k4096_t0.7", *random_sorted_boxes(torch, gen, 2, 4096, num_classes=4), 0.7)]
    chain = torch.tensor([[[0, 0, 10, 10], [3, 0, 13, 10], [8, 0, 18, 10]]], dtype=torch.float32).cuda()
    ones3 = torch.ones(1, 3, dtype=torch.bool).cuda()
    fixtures.append(("chain", chain, ones3, 0.3))
    # threshold-adjacent: integer boxes with IoU exactly float32(0.3) (inter 3, union 10) ...
    pair = torch.tensor([[[0, 0, 3, 3], [2, 0, 3, 4]]], dtype=torch.float32).cuda()
    ones2 = torch.ones(1, 2, dtype=torch.bool).cuda()
    fixtures.append(("iou_equals_t", pair, ones2, 0.3))
    below = float(torch.nextafter(torch.tensor(0.3), torch.tensor(0.0)))
    fixtures.append(("iou_above_t", pair, ones2, below))
    # ... and float boxes whose threshold is the exact fp32 IoU of one of their pairs
    boxes, valid = random_sorted_boxes(torch, gen, 4, 512, num_classes=1)
    iou = box_iou(boxes, boxes)
    for i, t in enumerate(iou[:, 0, 1:64].flatten().unique()[-5:].tolist()):
        fixtures.append((f"float_iou_equals_t_{i}", boxes, valid, t))

    tiling, tile_chain = tiling_fixtures(torch, gen)
    fixtures += tiling
    max_err = max(check_k1_equal(torch, nms_exact, name, b, v, t) for name, b, v, t in fixtures)
    check(nms_exact.exact_nms_keep(chain, ones3, 0.3).tolist() == [[True, False, True]], "chain keep mask")
    check(nms_exact.exact_nms_keep(pair, ones2, 0.3).tolist() == [[True, True]], "IoU == t must not suppress")
    check(nms_exact.exact_nms_keep(pair, ones2, below).tolist() == [[True, False]], "IoU > t must suppress")
    kept = nms_exact.exact_nms_keep(tile_chain, torch.ones(1, 130, dtype=torch.bool).cuda(), 0.3)[0].cpu()
    check(kept[60:69].tolist() == [True, False] * 4 + [True] and kept[124:].tolist() == [True, False] * 3,
          "chains across tile edges keep every other box")
    print(f"[2] K1 bit-equal to the plain version on {len(fixtures)} fixtures")

    timings = {}
    for b in (8, 32):
        boxes, random_valid = random_sorted_boxes(torch, gen, b, 1024)
        for n in (64, 300, 1024):
            valid = (torch.arange(1024)[None, :] < n).expand(b, 1024).contiguous().cuda()
            timings[b, n] = time_k1(torch, nms_exact, f"B={b} K=1024 valid prefix {n}", boxes, valid, 0.7)
        timings[b, "random"] = time_k1(torch, nms_exact, f"B={b} K=1024 80% random valid", boxes, random_valid, 0.7)
        all_valid = torch.ones((b, 1024), dtype=torch.bool).cuda()
        plain_ms = cuda_ms(lambda: nms_exact.exact_nms_keep_plain(boxes, all_valid, 0.7), iters=3, warmup=1)
        timings[b, 1024]["plain_ms"] = plain_ms
        print(f"[2] K1 plain version B={b} K=1024 all valid: {plain_ms:.3f} ms")
    return max_err, timings


def zero_cls_bias(model):
    """Random-init class scores sit at the 0.01 prior; at bias 0 they spread around 0.5."""
    import torch

    with torch.no_grad():
        for name, module in model.net.named_modules():
            if name.endswith("cls_pred"):
                module.bias.zero_()
    return model


def request_images(np, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((480, 640), (640, 640), (720, 1280), (333, 517))]


def check_predictions(np, preds, n_images, what):
    check(len(preds) == n_images, f"{what}: {len(preds)} predictions for {n_images} images")
    for p in preds:
        check(len(p) > 0, f"{what}: an image has no detection")
        check(np.isfinite(p.bboxes_xyxy).all() and np.isfinite(p.confidence).all(), f"{what}: non-finite output")
        h, w = p.image.shape[:2]
        check((p.bboxes_xyxy[:, 0::2] <= w).all() and (p.bboxes_xyxy[:, 1::2] <= h).all(), f"{what}: box off the image")


def phase_slice(torch, np, models, nms_exact):
    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    batch = torch.rand((8, 640, 640, 3), generator=torch.Generator().manual_seed(1)).cuda()
    nms_exact.exact_nms_keep.launches = 0
    t0 = time.perf_counter()
    for seed in range(3):  # requests with mixed image sizes, deploy form (fused, bf16, channels_last)
        images = request_images(np, seed)[: 2 + seed]
        check_predictions(np, model.predict(images), len(images), "predict fused bf16")
    images = request_images(np, 3)
    check_predictions(np, model.predict(images, fuse_model=False, bf16=False), len(images), "predict fp32 unfused")
    for kw in (dict(), dict(fuse_model=False, bf16=False)):
        out = model.predict_batch_tensor(batch, **kw)
        torch.cuda.synchronize()
        check(tuple(out.boxes.shape) == (8, 300, 4) and out.labels.dtype == torch.int32, f"NMSOutput shapes {kw}")
        check(bool((out.num_detections > 0).all()), f"predict_batch_tensor {kw}: an image has no detection")
        check(bool(torch.isfinite(out.boxes).all() and torch.isfinite(out.scores).all()), f"non-finite {kw}")
    launches = nms_exact.exact_nms_keep.launches
    check(launches > 0, "the predict path never launched kernel K1")
    print(f"[3] yolo_nas_m predict slice ok in {time.perf_counter() - t0:.1f} s; K1 launches {launches}")
    return model, launches


def phase_gpu_vs_cpu(torch, np, models, model, matched_fraction):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu"))
        gpu_sd, cpu_sd = model.net.state_dict(), cpu_model.net.state_dict()
        check(all(torch.equal(gpu_sd[k].cpu(), cpu_sd[k]) for k in cpu_sd), "GPU and CPU models differ in weights")
        # At 640x640 the random-weight YOLO-NAS-M is ill-conditioned enough that the
        # CPU's own fp32 forward is ~4e-4 off its fp64 forward in the scores. So the
        # GPU's fp32 forward is held to the fp64 CPU forward: at most twice the CPU
        # fp32 error, field by field, with the bulk of the scores as tight as in
        # tests/parity_utils.py::assert_close.
        x = torch.rand((2, 3, 640, 640), generator=torch.Generator().manual_seed(2))
        net64 = copy.deepcopy(cpu_model.net).double()
        with torch.inference_mode():
            g, c, t = model.net(x.cuda()), cpu_model.net(x), net64(x.double())
        for field in ("pred_scores", "cls_logits", "pred_bboxes"):
            truth = getattr(t, field)
            gpu_err = (getattr(g, field).cpu().double() - truth).abs().max().item()
            cpu_err = (getattr(c, field).double() - truth).abs().max().item()
            print(f"[4] fp32 {field} vs fp64 CPU: GPU max err {gpu_err:.3g}, CPU max err {cpu_err:.3g}")
            check(gpu_err <= 2 * cpu_err, f"GPU fp32 {field} more than twice as far from fp64 as the CPU's")
        tight = (g.pred_scores.cpu() - c.pred_scores).abs() <= 2e-4 + 1e-3 * c.pred_scores.abs()
        print(f"[4] fp32 pred_scores GPU vs CPU within 2e-4 + 1e-3|s|: {tight.float().mean().item():.5f}")
        check(tight.float().mean().item() > 0.97, "fewer than 97% of the scores agree tightly between GPU and CPU")

        rng = np.random.RandomState(4)
        images = [rng.randint(0, 256, (640, 640, 3), dtype=np.uint8) for _ in range(2)]
        gp = model.predict(images, fuse_model=False, bf16=False)
        cp = cpu_model.predict(images, fuse_model=False, bf16=False)
        for a, b in zip(gp, cp):
            frac = matched_fraction(a, b, 0.99)
            print(f"[4] predict GPU vs CPU: {len(a)} vs {len(b)} detections, {frac:.4f} matched")
            check(frac >= 0.99, "fewer than 99% of the detections match between GPU and CPU")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def same_boxes(np, a, b):
    """[len(a), len(b)]: every coordinate within 1e-3 px plus 1e-5 of its magnitude (a few fp32
    ulps, scaled up from the model's input to the original image)."""
    a, b = a[:, None], b[None]
    return (np.abs(a - b) <= 1e-3 + 1e-5 * np.maximum(np.abs(a), np.abs(b))).all(-1)


def match_detections(torch, np, box_iou, a, b, iou_min):
    """Greedy one-to-one matches between two non-empty detection sets, in a's order: same
    label, IoU >= iou_min, or the same box up to fp32 rounding of original-image pixels
    (clipping can make a box zero-area, whose IoU is 0 even with itself). Returns the
    matched indices of a and of b."""
    iou = box_iou(torch.from_numpy(a.bboxes_xyxy), torch.from_numpy(b.bboxes_xyxy)).numpy()
    same = same_boxes(np, a.bboxes_xyxy, b.bboxes_xyxy)
    ok = ((iou >= iou_min) | same) & (a.labels[:, None] == b.labels[None])
    matched_a, matched_b = [], set()
    for i in range(len(a)):
        for j in np.flatnonzero(ok[i]):
            if j not in matched_b:
                matched_a.append(i)
                matched_b.add(j)
                break
    return matched_a, matched_b


def matched_fraction_fn(torch, np, box_iou):
    def matched_fraction(a, b, iou_min):
        """Share of one-to-one matches between two detection sets (match_detections)."""
        if len(a) == 0 or len(b) == 0:
            return float(len(a) == len(b))
        return len(match_detections(torch, np, box_iou, a, b, iou_min)[0]) / max(len(a), len(b))

    return matched_fraction


def unmatched_causes(torch, np, box_iou, a, b, iou_min):
    """Each detection of ``a`` that match_detections leaves without a partner in ``b``: its
    label, score, rank in a (of how many) and box, the lowest score b kept, its best IoU with
    a same-label detection of b, its largest IoU with a same-label detection that scores
    higher in b (the box that suppressed it there if that IoU passes the NMS threshold), and
    the same-label box of b nearest in its coordinates."""
    matched_a, _ = match_detections(torch, np, box_iou, a, b, iou_min)
    iou = box_iou(torch.from_numpy(a.bboxes_xyxy), torch.from_numpy(b.bboxes_xyxy)).numpy()
    rank = np.empty(len(a), int)
    rank[np.argsort(-a.confidence, kind="stable")] = np.arange(len(a))
    causes = []
    for i in sorted(set(range(len(a))) - set(matched_a)):
        same = b.labels == a.labels[i]
        higher = same & (b.confidence > a.confidence[i])
        causes.append({"label": int(a.labels[i]), "score": float(a.confidence[i]), "rank": f"{rank[i] + 1}/{len(a)}",
                       "other_lowest_score": float(b.confidence.min()),
                       "best_iou": float(iou[i][same].max()) if same.any() else 0.0,
                       "higher_scoring_iou": float(iou[i][higher].max()) if higher.any() else 0.0,
                       "box": a.bboxes_xyxy[i].tolist(),
                       "nearest_box": b.bboxes_xyxy[same][np.abs(b.bboxes_xyxy[same] - a.bboxes_xyxy[i]).max(-1)
                                                          .argmin()].tolist() if same.any() else None})
    return causes


def phase_timing(torch, model):
    for b in (8, 32):
        batch = torch.rand((b, 640, 640, 3), generator=torch.Generator().manual_seed(3)).cuda()
        for _ in range(3):
            model.predict_batch_tensor(batch)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model.predict_batch_tensor(batch)
        out.num_detections.cpu()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[5] yolo_nas_m fused bf16 predict_batch_tensor b{b}: {b * iters / dt:.1f} img/s ({1e3 * dt / iters:.2f} ms/batch)")


def capture_call(module, name, run):
    """Runs ``run()`` with ``module.name`` wrapped; returns the wrapped function's last (args, kwargs)."""
    original, seen = getattr(module, name), []

    def capturing(*args, **kwargs):
        seen.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, capturing)
    try:
        run()
    finally:
        setattr(module, name, original)
    check(len(seen) > 0, f"{module.__name__}.{name} was never called")
    return seen[-1]


def phase_candidates(torch, model, nms_exact):
    """K1 and batched_nms at the candidates the predict path gives them (fused bf16); returns max_abs_err."""
    from super_gradients_tpu_torch.models import sg_model
    from super_gradients_tpu_torch.ops import nms as nms_module

    max_err = 0.0
    for b in (8, 32):
        batch = torch.rand((b, 640, 640, 3), generator=torch.Generator().manual_seed(3)).cuda()
        nms_args, nms_kwargs = capture_call(sg_model, "batched_nms", lambda: model.predict_batch_tensor(batch))
        with torch.inference_mode():
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep",
                                                lambda: nms_module.batched_nms(*nms_args, **nms_kwargs))
            max_err = max(max_err, check_k1_equal(torch, nms_exact, f"predict candidates b{b}", boxes, valid, t))
            n_valid = valid.sum(dim=1)
            n_kept = nms_exact.exact_nms_keep(boxes, valid, t).sum(dim=1)
            print(f"[6] b{b} candidates: K={boxes.shape[1]}, valid per image {n_valid.tolist()}, "
                  f"kept per image {n_kept.tolist()}; K1 bit-equal to the plain version")
            time_k1(torch, nms_exact, f"b{b} predict candidates", boxes, valid, t, phase=6)
            nms_call = lambda: nms_module.batched_nms(*nms_args, **nms_kwargs)  # noqa: E731
            device_ms = cuda_ms(nms_call, iters=20, queue_ahead=True)
            paced_ms = cuda_ms(nms_call, iters=20)
        print(f"[6] b{b} batched_nms exact: {device_ms:.4f} ms device time, {paced_ms:.4f} ms "
              f"as the host issues it (CUDA events)")
    return max_err


# super_gradients_tpu/recipes/training_hyperparams/coco2017_yolo_nas_train_params.yaml, bf16,
# with the warmup (1000 steps) cut to half of phase 7's 8 steps
COCO_YOLO_NAS = dict(
    warmup_mode="LinearBatchLRWarmup", warmup_initial_lr=1e-6, lr_warmup_steps=4, initial_lr=2e-4,
    lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, zero_weight_decay_on_bias_and_bn=True,
    loss="PPYoloELoss", criterion_params={"use_static_assigner": False, "num_classes": 80},
    optimizer="AdamW", optimizer_params={"weight_decay": 1e-5},
    ema=True, ema_params={"decay": 0.9997, "decay_type": "threshold"}, mixed_precision=True,
    metric_to_watch="mAP@0.50:0.95", valid_metrics_list=[{"DetectionMetrics": {"num_cls": 80}}],
)
VALID_KEYS = ("mAP@0.50:0.95", "mAP@0.50", "Precision@0.50:0.95", "Recall@0.50:0.95", "F1@0.50:0.95",
              "Best_score_threshold", "Loss")
CKPT_FILES = ("ckpt_latest.pth", "ckpt_best.pth", "ckpt_epoch_1.pth", "average_model.pth", "recipe.json")


def phase_train(torch, np, models, nms_exact, ckpt_root):
    """Trainer.train of YOLO-NAS-M at 640 on the card with validation and checkpoints,
    resume from them, then predict() on the trained model and on the best checkpoint.
    Returns K1's launches inside Trainer.train."""
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    before = {k: v.clone() for k, v in model.net.named_parameters()}
    images = request_images(np, 5)[:2]
    predicted_before = model.predict(images)
    dataset = RandomDetectionDataset(num_samples=64, image_size=(640, 640), num_classes=80, max_boxes=120)
    loader = torch.utils.data.DataLoader(dataset, batch_size=16, num_workers=4, pin_memory=True)
    valid_loader = torch.utils.data.DataLoader(RandomDetectionDataset(32, (640, 640), 80, 120), batch_size=16,
                                               num_workers=2, pin_memory=True)
    params = dict(COCO_YOLO_NAS, max_epochs=2, save_ckpt_epoch_list=[1])
    trainer = Trainer("chip_smoke", ckpt_root_dir=ckpt_root)
    nms_exact.exact_nms_keep.launches = 0
    t0 = time.perf_counter()
    trainer.train(model, params, loader, valid_loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = nms_exact.exact_nms_keep.launches
    check(train_launches == 2 * len(valid_loader), f"K1 launched {train_launches} times in Trainer.train, "
                                                   f"expected one a validation batch ({2 * len(valid_loader)})")
    history = trainer.train_loss_history
    # each step's loss is >= 0, so an epoch mean is finite exactly when every step's loss is
    check(len(history) == 2 and all(np.isfinite(history)), f"train losses {history}")
    valid = trainer.valid_metrics_history
    check(len(valid) == 2 and all(set(VALID_KEYS) <= set(v) and all(np.isfinite(list(v.values()))) for v in valid),
          f"validation results {valid}")
    missing = [f for f in CKPT_FILES if not os.path.isfile(os.path.join(trainer.ckpt_dir, f))]
    check(not missing, f"checkpoint files missing: {missing}")
    state = trainer.train_state
    check(state.step == 8, f"{state.step} steps taken, expected 8")
    after = dict(model.net.named_parameters())
    unchanged = [k for k in before if torch.equal(before[k], after[k])]
    # a parameter whose gradient is ~0 can keep its value: AdamW moves it by about
    # lr * |g| / (|g| + eps), below fp32 resolution for |g| << eps (1e-8)
    flat = _flat_gradient_parameters(torch, models, dataset)
    check(set(unchanged) <= flat, f"parameters unchanged by training: {sorted(set(unchanged) - flat)[:5]}")
    averaged = state.ema.state_dict()
    check(all(torch.equal(v, averaged[k]) for k, v in model.net.state_dict().items()), "the EMA weights were not handed back")
    check(any(not torch.equal(v, averaged[k]) for k, v in state.net.state_dict().items()), "EMA equals the live weights")

    t1 = time.perf_counter()
    resumed = Trainer("chip_smoke", ckpt_root_dir=ckpt_root)
    resumed.train(zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=1, device="cuda")),
                  dict(params, resume=True), loader, valid_loader)
    resume_seconds = time.perf_counter() - t1
    check(resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == [], "resume took a step")
    check_state_equal(torch, state, resumed.train_state)
    nms_exact.exact_nms_keep.launches = 0
    predicted_after = model.predict(images)
    launches = nms_exact.exact_nms_keep.launches
    check(launches > 0, "predict() after training never launched kernel K1")
    check(any(len(a) != len(b) or not np.array_equal(a.confidence, b.confidence)
              for a, b in zip(predicted_after, predicted_before)), "predict() after training gives the old output")
    best_path = os.path.join(trainer.ckpt_dir, "ckpt_best.pth")
    best = torch.load(best_path, map_location="cpu", weights_only=True)
    loaded = models.get("yolo_nas_m", num_classes=80, seed=2, device="cuda", checkpoint_path=best_path)
    check(all(torch.equal(v.cpu(), best["ema_net"][k]) for k, v in loaded.net.state_dict().items()),
          "models.get(checkpoint_path=) did not load the saved EMA weights")
    check_predictions(np, loaded.predict(images), len(images), "predict from ckpt_best")
    sizes = {f: os.path.getsize(os.path.join(trainer.ckpt_dir, f)) / 2**20 for f in CKPT_FILES}
    print(f"[7] yolo_nas_m Trainer.train 2 epochs x 4 batches of 16 at 640, bf16, with validation (2 batches of 16) "
          f"and checkpoints: {seconds:.1f} s; K1 launches in it: {train_launches}; losses {history}; "
          f"{len(before) - len(unchanged)} of {len(before)} parameters changed; unchanged {unchanged}, each with "
          f"|gradient| < 1e-9 on the first batch ({len(flat)} such: {sorted(flat)}); EMA handed back; predict after it: "
          f"K1 launches {launches}, detections {[len(p) for p in predicted_before]} -> {[len(p) for p in predicted_after]}")
    print(f"[7] validation: {json.dumps(valid)}")
    print(f"[7] checkpoints (MiB): {json.dumps({k: round(v, 1) for k, v in sizes.items()})}; resume with no step left: "
          f"{resume_seconds:.1f} s, live, EMA, optimizer state and step bit-equal; ckpt_best loaded by models.get, "
          f"epoch {best['epoch']}")
    del trainer, resumed, state, loader, valid_loader, loaded, best
    torch.cuda.empty_cache()
    return train_launches


def check_state_equal(torch, a, b):
    """Two TrainStates bit-equal: live and EMA weights, optimizer state, step."""
    check(a.step == b.step, f"step {a.step} vs {b.step}")
    for what, x, y in (("live", a.net.state_dict(), b.net.state_dict()), ("EMA", a.ema.state_dict(), b.ema.state_dict())):
        check(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x), f"resumed {what} weights differ")
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    check(oa["state"].keys() == ob["state"].keys(), "resumed optimizer state has other parameters")
    for i, sa in oa["state"].items():
        check(all(torch.equal(v, ob["state"][i][k]) for k, v in sa.items()), f"resumed optimizer state {i} differs")


def _flat_gradient_parameters(torch, models, dataset):
    """Parameters whose every gradient element is below 1e-9 in the first bf16 step of
    phase 7 (with random weights, no anchor of the stride-32 level is positive, so its
    regression branch gets almost no gradient)."""
    import numpy as np

    from super_gradients_tpu_torch.training import Trainer

    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    step = Trainer("chip_smoke_probe").prepare(model, COCO_YOLO_NAS, steps_per_epoch=1)
    images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(16))))
    loss, _ = step.loss(step.forward(images.cuda().contiguous(memory_format=torch.channels_last)), targets.cuda())
    step.backward(loss)
    flat = {k for k, p in step.state.net.named_parameters() if p.grad is None or float(p.grad.abs().max()) < 1e-9}
    del step, model
    torch.cuda.empty_cache()
    return flat


class _FixedAssigner:
    """Stands in for a loss's assigner: returns one precomputed assignment."""

    def __init__(self, result):
        self.result = result

    def __call__(self, *args, **kwargs):
        return self.result


def _one_step(torch, model, images, targets, assign=None, base=COCO_YOLO_NAS):
    """Forward, loss and backward of one fp32 SGD train step in the regime ``base``;
    returns its assignment, its loss components and its gradients (fp64, on the CPU)."""
    from super_gradients_tpu_torch.training import Trainer

    params = dict(base, optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-5},
                  ema=False, mixed_precision=False, lr_warmup_steps=0, initial_lr=1e-3)
    step = Trainer("chip_smoke_fp32").prepare(model, params, steps_per_epoch=1)
    out = step.forward(images)
    own = step.criterion.assign(out, targets)
    if assign is not None:
        fixed = _FixedAssigner(type(assign)(*(t.to(images.device, t.dtype if not t.is_floating_point()
                                                   else images.dtype) for t in assign)))
        if hasattr(step.criterion, "assigner"):
            step.criterion.assigner = fixed
        else:  # YoloXDetectionLoss: SimOTA is its own method
            step.criterion._assign = fixed
    loss, comps = step.loss(out, targets)
    step.backward(loss)
    grads = {k: p.grad.detach().double().cpu() for k, p in step.state.net.named_parameters() if p.grad is not None}
    step.update()
    comps = {k: float(v.detach()) for k, v in dict(comps, loss=loss).items()}
    return own, comps, grads


def phase_train_gpu_vs_cpu(torch, np, models):
    """One fp32 step on the GPU and the CPU, held to an fp64 CPU step (phase 4's rule)."""
    import types

    from super_gradients_tpu_torch.training import RandomDetectionDataset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu")
        dataset = RandomDetectionDataset(num_samples=2, image_size=(FP64_STEP_HW, FP64_STEP_HW), num_classes=80,
                                         max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(2))))
        runs = {}
        for name, device, dtype in (("fp64 CPU", "cpu", torch.float64), ("fp32 CPU", "cpu", torch.float32),
                                    ("fp32 GPU", "cuda", torch.float32)):
            net = copy.deepcopy(cpu_model.net).to(device, dtype)
            model = types.SimpleNamespace(net=net, device=torch.device(device))
            x, t = images.to(device, dtype), targets.to(device, dtype)
            if device == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            ref_assign = runs["fp64 CPU"][0] if runs else None
            runs[name] = _one_step(torch, model, x, t, assign=ref_assign)
            del net, model
        labels64 = runs["fp64 CPU"][0].labels
        for name in ("fp32 CPU", "fp32 GPU"):
            diff = int((runs[name][0].labels.cpu() != labels64).sum())
            print(f"[8] {name}: {diff} of {labels64.numel()} anchors assigned another label than fp64 CPU "
                  f"({int((labels64 != 80).sum())} foreground)")
        gpu_cpu = int((runs["fp32 GPU"][0].labels.cpu() != runs["fp32 CPU"][0].labels).sum())
        print(f"[8] fp32 GPU vs fp32 CPU: {gpu_cpu} anchors with another label; all runs below take the fp64 assignment")
        ref_comps, ref_grads = runs["fp64 CPU"][1], runs["fp64 CPU"][2]
        for key in ("loss_cls", "loss_iou", "loss_dfl", "loss"):
            errs = {name: abs(runs[name][1][key] - ref_comps[key]) for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[8] {key} {ref_comps[key]:.6f} (fp64 CPU): GPU err {errs['fp32 GPU']:.3g}, CPU err {errs['fp32 CPU']:.3g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-6 * abs(ref_comps[key]),
                  f"GPU fp32 {key} more than twice as far from fp64 as the CPU's")
        for group in ("backbone", "neck", "heads", ""):
            keys = [k for k in ref_grads if k.startswith(group)]
            norm = float(sum((ref_grads[k] ** 2).sum() for k in keys) ** 0.5)
            errs = {name: float(sum(((runs[name][2][k] - ref_grads[k]) ** 2).sum() for k in keys) ** 0.5)
                    for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[8] gradients {group or 'all'} (norm {norm:.4g}): GPU L2 err {errs['fp32 GPU']:.4g}, "
                  f"CPU L2 err {errs['fp32 CPU']:.4g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-7 * norm,
                  f"GPU fp32 gradients ({group or 'all'}) more than twice as far from fp64 as the CPU's")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def step_runner(step, images, targets):
    """One train step by its four parts; ``run(events)`` records a CUDA event before,
    between and after them."""

    def run(events=None):
        marks = [lambda: None] * 5 if events is None else [e.record for e in events]
        marks[0]()
        out = step.forward(images)
        marks[1]()
        loss, _ = step.loss(out, targets)
        marks[2]()
        step.backward(loss)
        marks[3]()
        step.update()
        marks[4]()
        return loss

    return run


def time_by_part(torch, run, warmup=3, iters=10):
    """Mean ms of ``run``'s parts over ``iters`` steps after ``warmup`` (CUDA events):
    {forward, loss, backward, update, step}."""
    for _ in range(warmup):
        run()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
    for ev in events:
        run(ev)
    torch.cuda.synchronize()
    parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
    step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
    return dict(zip(("forward", "loss", "backward", "update"), parts), step=step_ms)


def phase_train_timing(torch, np, models):
    """bf16 train step of YOLO-NAS-M at 640, b16 and b32, on a batch already on the card.
    Returns {batch: ms by part}."""
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    model = models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda")
    timings = {}
    for b in (16, 32):
        step = Trainer("chip_smoke_timing").prepare(model, dict(COCO_YOLO_NAS, lr_warmup_steps=1000), steps_per_epoch=100)
        dataset = RandomDetectionDataset(num_samples=b, image_size=(640, 640), num_classes=80, max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
        images = images.cuda().contiguous(memory_format=torch.channels_last)
        targets = targets.cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = step_runner(step, images, targets)
        ms = timings[b] = time_by_part(torch, run)
        step_ms = ms["step"]
        # device activity only: tracing every CPU op would slow the host, which bounds this step
        events, wall_ms = profiled(torch, run, 5, with_cpu=False)
        kernels = sorted(events, key=lambda e: -_self_device_us(e))
        busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / 5
        top = ", ".join(f"{e.key[:60]} x{e.count // 5} {_self_device_us(e) / 5e3:.2f} ms" for e in kernels[:8])
        loss = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), f"b{b} train loss not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[9] yolo_nas_m bf16 train step b{b}: {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.1f} img/s (CUDA events); "
              f"forward {ms['forward']:.2f}, loss {ms['loss']:.2f}, backward {ms['backward']:.2f}, optimizer+EMA "
              f"{ms['update']:.2f} ms; profiled (device activity only): wall {wall_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
              f"peak memory {peak:.2f} GiB")
        print(f"[9] b{b} device time by kernel, per step: {len(kernels)} kinds, "
              f"{sum(e.count for e in kernels) // 5} launches; top: {top}")
        del step, images, targets, loss, events, kernels, run
        torch.cuda.empty_cache()
    return timings


def own_detection_targets(np, nms, max_boxes=300):
    """[B, max_boxes, 5] targets (cls, x1, y1, x2, y2) holding each image's detections."""
    b = len(nms.num_detections)
    targets = np.full((b, max_boxes, 5), -1.0, np.float32)
    for i in range(b):
        n = int(nms.num_detections[i])
        targets[i, :n, 0] = nms.labels[i, :n]
        targets[i, :n, 1:5] = nms.boxes[i, :n]
    return targets


def phase_validation(torch, np, models, nms_exact, ckpt_root):
    """Trainer.evaluate at full width against a known answer and against the CPU;
    returns the GPU-vs-CPU mAP difference."""
    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.metrics import DetectionMetrics, to_host

    metrics = [{"DetectionMetrics": {"num_cls": 80}}]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
        images = torch.rand((4, 3, 640, 640), generator=torch.Generator().manual_seed(7))
        with torch.inference_mode():  # the input as Trainer.evaluate puts it on the card
            x = images.cuda().contiguous(memory_format=torch.channels_last)
            nms = to_host(DetectionMetrics(num_cls=80).preprocess_device(model.net(x), None))
        own = own_detection_targets(np, nms)
        trainer = Trainer("chip_smoke_valid", ckpt_root_dir=ckpt_root)
        nms_exact.exact_nms_keep.launches = 0
        exact = trainer.evaluate(model, [(images, torch.from_numpy(own))], metrics_list=metrics)
        check(nms_exact.exact_nms_keep.launches == 1, "Trainer.evaluate on the card did not launch K1 once")
        check(exact["mAP@0.50:0.95"] >= 0.999, f"mAP on the model's own detections: {exact}")

        rng = np.random.RandomState(8)
        jittered = own.copy()
        wh = np.concatenate([own[..., 3:5] - own[..., 1:3]] * 2, -1)
        jittered[..., 1:5] += rng.randn(*wh.shape).astype(np.float32) * 0.08 * wh
        batch = [(images, torch.from_numpy(jittered))]
        gpu = trainer.evaluate(model, batch, metrics_list=metrics)
        cpu_model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu"))
        cpu = trainer.evaluate(cpu_model, batch, metrics_list=metrics)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    diffs = {k: abs(gpu[k] - cpu[k]) for k in gpu}
    print(f"[10] yolo_nas_m 640 fp32 Trainer.evaluate, 4 images, {[int(n) for n in nms.num_detections]} detections: "
          f"own detections as targets mAP@0.50:0.95 {exact['mAP@0.50:0.95']:.6f}; jittered targets GPU "
          f"{gpu['mAP@0.50:0.95']:.6f} CPU {cpu['mAP@0.50:0.95']:.6f}; |GPU - CPU| by key {json.dumps(diffs)}")
    check(0.2 <= gpu["mAP@0.50:0.95"] <= 0.9, f"jittered mAP {gpu['mAP@0.50:0.95']} outside [0.2, 0.9]")
    check(diffs["mAP@0.50:0.95"] <= VALID_MAP_TOL, f"GPU and CPU mAP differ by {diffs['mAP@0.50:0.95']}")
    del model, cpu_model
    torch.cuda.empty_cache()
    return diffs["mAP@0.50:0.95"]


def phase_validation_timing(torch, np, models, nms_exact):
    """One validation batch as Trainer.train runs it (bf16 autocast, channels_last, fp32
    outputs, DetectionMetrics), timed by part at b16 and b32. K1 is held bit-equal to its
    plain version on each batch's candidates (b16 is the shape phase 7 validates at);
    returns the largest difference."""
    from super_gradients_tpu_torch.ops import nms as nms_module
    from super_gradients_tpu_torch.training import RandomDetectionDataset
    from super_gradients_tpu_torch.training.metrics import DetectionMetrics, to_host
    from super_gradients_tpu_torch.training.mixed_precision import autocast, to_f32

    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    net = copy.deepcopy(model.net).to(memory_format=torch.channels_last).eval()
    metric = DetectionMetrics(num_cls=80)
    max_err = 0.0
    for b in (16, 32):
        dataset = RandomDetectionDataset(num_samples=b, image_size=(640, 640), num_classes=80, max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
        images = images.cuda().contiguous(memory_format=torch.channels_last)
        host_targets = targets.numpy()

        def run(events=None, host=None):
            marks = [lambda: None] * 3 if events is None else [e.record for e in events]
            with torch.inference_mode():
                marks[0]()
                with autocast(images.device, True):
                    out = to_f32(net(images))
                marks[1]()
                nms = metric.preprocess_device(out, None)
                marks[2]()
            nms = to_host(nms)  # waits for the device
            t0 = time.perf_counter()
            state = metric.update(metric.init(), nms, host_targets)
            t1 = time.perf_counter()
            result = metric.compute(state)
            if host is not None:
                host.append((t1 - t0, time.perf_counter() - t1))
            return result, nms

        for _ in range(2):
            run()
        iters = 5
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(iters)]
        host = []
        t0 = time.perf_counter()
        for ev in events:
            result, nms = run(ev, host)
        batch_ms = (time.perf_counter() - t0) * 1e3 / iters
        forward_ms = sum(ev[0].elapsed_time(ev[1]) for ev in events) / iters
        nms_ms = sum(ev[1].elapsed_time(ev[2]) for ev in events) / iters
        match_ms, compute_ms = (1e3 * sum(h[i] for h in host) / iters for i in (0, 1))
        with torch.inference_mode():
            with autocast(images.device, True):
                out = to_f32(net(images))
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep", lambda: metric.preprocess_device(out, None))
        max_err = max(max_err, check_k1_equal(torch, nms_exact, f"validation candidates b{b}", boxes, valid, t))
        k1_ms =cuda_ms(lambda: nms_exact.exact_nms_keep(boxes, valid, t), iters=20, queue_ahead=True)
        prof_events, wall_ms = profiled(torch, run, 3, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 3
        check(np.isfinite(list(result.values())).all(), f"b{b} validation metrics not finite: {result}")
        print(f"[10] yolo_nas_m bf16 validation batch b{b}: {batch_ms:.2f} ms (host clock), of which forward "
              f"{forward_ms:.2f} ms and batched_nms {nms_ms:.3f} ms (CUDA events; K1 alone {k1_ms:.4f} ms, "
              f"{int(valid.sum())} valid of {valid.numel()} candidates, keep mask bit-equal to the plain version), host matching {match_ms:.2f} ms and compute "
              f"{compute_ms:.2f} ms (host clock); {int(nms.num_detections.sum())} detections; profiled: wall "
              f"{wall_ms:.2f} ms a batch, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        del images, targets, out, boxes, valid
    del model, net
    torch.cuda.empty_cache()
    return max_err


RF100_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500))  # (h, w): 640x480, 480x640, 640x427, 500x375
RECIPE_WAVES = 2  # train batches a loader worker makes an epoch in phase 11 (the set tiled by min_samples)
# evaluate_checkpoint against Trainer.evaluate of models.get(checkpoint_path=ckpt_best.pth), both
# fp32 on the same val set: |difference| of each metric, and of Loss relative to it
RECIPE_EVAL_TOL = 1e-6


def metric_differences(a, b):
    """|a - b| of each metric of ``b``, of Loss relative to b's."""
    return {k: abs(a[k] - b[k]) / (abs(b[k]) if k == "Loss" else 1.0) for k in b}


def check_evaluate_checkpoint(torch, cfg, experiment, ckpt_dir, ckpt_root, tag, fault="ema"):
    """evaluate_checkpoint(ckpt_best) of a recipe run held to a direct Trainer.evaluate of
    models.get(checkpoint_path=ckpt_best.pth) on the recipe's val loader (fp32, within
    RECIPE_EVAL_TOL), and a planted fault beyond it: the live weights where the EMA's belong
    (``fault="ema"``), a fresh model's BN statistics (``fault="bn"``, for runs whose EMA
    equals the live weights) or a fresh model's weights (``fault="fresh"``, for a model without
    BN or EMA). Returns (the evaluated metrics, the checkpoint's epoch)."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training import Trainer

    best_path = os.path.join(ckpt_dir, "ckpt_best.pth")
    best = torch.load(best_path, map_location="cpu", weights_only=True)
    t0 = time.perf_counter()
    evaluated = Trainer.evaluate_checkpoint(experiment, ckpt_root_dir=ckpt_root, ckpt_name="ckpt_best")
    seconds = time.perf_counter() - t0
    build = dict(num_classes=cfg["num_classes"], arch_params=cfg.get("arch_params"))
    model = models.get(cfg["architecture"], checkpoint_path=best_path, **build)
    val_loader = Trainer._loader_from_cfg(cfg, "val")
    hyper = cfg["training_hyperparams"]
    direct = Trainer(f"{experiment}_direct", ckpt_root_dir=ckpt_root).evaluate(model, val_loader, hyper)
    diffs = metric_differences(evaluated, direct)
    if fault == "ema":
        what = "live weights for the EMA's"
        model.net.load_state_dict(best["net"])
    elif fault == "fresh":
        what = "a fresh model's weights"
        model.net.load_state_dict(models.get(cfg["architecture"], seed=1, **build).net.state_dict())
    else:
        what = "a fresh model's BN statistics"
        fresh = models.get(cfg["architecture"], seed=1, **build)
        with torch.no_grad():
            for name, buf in fresh.net.named_buffers():
                model.net.get_buffer(name).copy_(buf)
        del fresh
    faulty = metric_differences(Trainer(f"{experiment}_fault", ckpt_root_dir=ckpt_root).evaluate(
        model, val_loader, hyper), direct)
    close_loader(val_loader)
    epoch = best.get("epoch")
    print(f"[{tag}] {experiment} evaluate_checkpoint(ckpt_best, epoch {epoch}, fp32) {seconds:.1f} s: "
          f"{json.dumps(evaluated)}; |difference| to Trainer.evaluate of models.get(checkpoint_path=ckpt_best.pth) "
          f"(Loss relative): {json.dumps(diffs)}, limit {RECIPE_EVAL_TOL}; planted fault ({what}): {json.dumps(faulty)}")
    check(max(diffs.values()) <= RECIPE_EVAL_TOL, f"{experiment} evaluate_checkpoint differs from Trainer.evaluate: {diffs}")
    check(max(faulty.values()) > RECIPE_EVAL_TOL, f"the planted fault passes the {experiment} evaluate_checkpoint gate: "
                                                   f"{faulty}")
    del model, best
    torch.cuda.empty_cache()
    return evaluated, epoch


def smooth_field(np, rng, h, w):
    """A seeded smooth RGB field: a 5x7 grid of random colours, bilinearly upsampled."""
    grid = rng.randint(0, 256, (5, 7, 3)).astype(np.float32)

    def weights(n, cells):  # [n, cells]: linear interpolation between the grid points
        pos = np.linspace(0, cells - 1, n)
        return np.maximum(0, 1 - np.abs(pos[:, None] - np.arange(cells)[None])).astype(np.float32)

    return np.einsum("hi,ijc,wj->hwc", weights(h, 5), grid, weights(w, 7), optimize=True).astype(np.uint8)


def make_rf100_dataset(np, root, name="synthetic", seed=11):
    """An RF100-layout COCO dataset of PNGs written by PIL (its adaptive line filters, as
    real files have them): 64 train and 32 valid images, 1-30 boxes each over 80
    categories, filled rectangles on smooth fields; about 5% of the valid boxes are
    iscrowd. Returns (boxes, crowd boxes)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    n_boxes = n_crowd = 0
    for split, count in (("train", 64), ("valid", 32)):
        folder = os.path.join(root, name, split)
        os.makedirs(folder)
        images, annotations = [], []
        for i in range(count):
            h, w = RF100_SIZES[i % len(RF100_SIZES)]
            image = smooth_field(np, rng, h, w)
            for _ in range(rng.randint(1, 31)):
                bw, bh = rng.uniform(16, w / 3), rng.uniform(16, h / 3)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                image[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(0, 256, 3)
                crowd = int(split == "valid" and rng.rand() < 0.05)
                annotations.append({"id": len(annotations), "image_id": i, "category_id": int(rng.randint(80)),
                                    "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": crowd})
                n_boxes, n_crowd = n_boxes + 1, n_crowd + crowd
            Image.fromarray(image).save(os.path.join(folder, f"{i:04d}.png"), compress_level=1)
            images.append({"id": i, "file_name": f"{i:04d}.png", "height": h, "width": w})
        with open(os.path.join(folder, "_annotations.coco.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": c, "name": f"class_{c}"} for c in range(80)]}, f)
    return n_boxes, n_crowd


class TimedLoader:
    """Wraps a loader: records how long each ``next()`` waits and the bytes of the first
    batch, and profiles the device over the steps of one epoch (``profile_epoch``) from
    its request number ``profile_from`` to its end."""

    def __init__(self, loader, profile_epoch, profile_from=0):
        self.loader = loader
        self.profile_epoch = profile_epoch
        self.profile_from = profile_from
        self.epochs = []  # per epoch: (request times, waits)
        self.batch_bytes = None
        self.busy_ms = self.window_ms = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        requests, waits = [], []  # requests: when each next() began, then the end of the last step
        self.epochs.append((requests, waits))
        profiling = len(self.epochs) - 1 == self.profile_epoch
        prof = profile(activities=[ProfilerActivity.CUDA]) if profiling else None
        it = iter(self.loader)
        while True:
            if prof is not None and len(requests) == self.profile_from:
                prof.__enter__()
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                requests.append(t0)
                break
            requests.append(t0)
            waits.append(time.perf_counter() - t0)
            if self.batch_bytes is None:
                self.batch_bytes = sum(t.numel() * t.element_size() for t in batch)
            yield batch
        if prof is not None:
            torch.cuda.synchronize()
            self.window_ms = (time.perf_counter() - requests[self.profile_from]) * 1e3
            prof.__exit__(None, None, None)
            self.busy_ms = sum(_self_device_us(e) for e in prof.key_averages()) / 1e3


def one_wave(dataloaders, dataset, workers):
    """Each of ``workers`` loader workers makes one batch of 16 (the main process one
    batch with none), all at once from a fresh loader: images a second, first batch."""
    loader = dataloaders.DataLoader(dataset, batch_size=16, shuffle=True, num_workers=workers,
                                    min_samples=16 * max(workers, 1))
    t0 = time.perf_counter()
    batches = list(loader)
    seconds = time.perf_counter() - t0
    close_loader(loader)
    return 16 * len(batches) / seconds, batches[0]


def chain_breakdown(torch, cv2, dataset, samples=4):
    """Milliseconds a sample of each stage of the dataset's chain, on one thread (torch's
    and cv2's) as in a loader worker: decoding the images, then each transform."""
    threads, cv2_threads = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    stages = {"decode": 0.0}
    try:
        for i in range(samples):
            t0 = time.perf_counter()
            sample = dataset._get_sample(i)
            extra = [dataset._get_sample(dataset.np_rng.randint(len(dataset)))
                     for _ in range(dataset.transforms.additional_samples_count)]
            stages["decode"] += time.perf_counter() - t0
            for t in dataset.transforms.transforms[:-1]:
                t0 = time.perf_counter()
                n = t.additional_samples_count
                sample = t(sample, dataset.rng, extra[:n] if n else ())
                name = type(t).__name__.replace("Detection", "")
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
        cv2.setNumThreads(cv2_threads)
    return {k: round(1e3 * v / samples, 1) for k, v in stages.items()}


def close_loader(loader):
    """Stop a DataLoader's persistent worker processes."""
    iterator = getattr(loader, "_iterator", None)
    if iterator is not None and hasattr(iterator, "_shutdown_workers"):
        iterator._shutdown_workers()
    loader._iterator = None


class NoStandIns:
    """While active, every no-cv2 stand-in of the image code (``resize_bilinear``, the
    torch ``warp_affine``, the numpy HSV conversions, ``add_weighted_half``) raises: the
    stand-ins must not run quietly where cv2 imports. Loader workers forked inside
    inherit the traps."""

    def __enter__(self):
        from super_gradients_tpu_torch.inference import processing
        from super_gradients_tpu_torch.training.transforms import detection

        def trap(*args, **kwargs):
            raise RuntimeError("chip_smoke: a no-cv2 stand-in of the image code ran although cv2 imports")

        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (processing, "resize_bilinear"), (detection, "warp_affine"), (detection, "rgb_to_hsv_u8"),
            (detection, "hsv_to_rgb_u8"), (detection, "add_weighted_half"))]
        for m, name, _ in self.saved:
            setattr(m, name, trap)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        return False


def cv2_threads_rates(dataloaders, cv2, train_set, workers):
    """The loader alone at ``workers`` workers, one wave each: cv2's own pool in
    each worker (the kept choice) and cv2 run sequentially in each worker
    (``cv2.setNumThreads(0)`` after the worker init; ``setNumThreads(1)`` would resize the
    pool, which crashes a forked worker whose parent has used it)."""
    kept = dataloaders._seed_worker

    def sequential(worker_id):
        kept(worker_id)
        cv2.setNumThreads(0)

    variants = {f"cv2's pool ({cv2.getNumThreads()} threads) in each worker (kept)": kept,
                "cv2 sequential in each worker": sequential}
    rates = {name: [] for name in variants}
    try:
        for name in variants:
            dataloaders._seed_worker = variants[name]
            rates[name].append(one_wave(dataloaders, train_set, workers)[0])
    finally:
        dataloaders._seed_worker = kept
    return rates


def phase_recipe(torch, np, nms_exact, ckpt_root, data_root):
    """Recipe-driven YOLO-NAS-M training from an RF100-layout COCO dataset of PNGs, on the
    transforms' cv2 path. Returns K1's launches inside train_from_recipe."""
    from super_gradients_tpu_torch.inference import processing

    cv2 = processing.cv2_module()
    check(cv2 is not None, "cv2 does not import on this machine: the transforms would take their no-cv2 stand-ins")
    print(f"[11] cv2 {cv2.__version__} ({cv2.getNumThreads()} threads in the main process): the transforms and the "
          f"letterbox take the JAX package's cv2 calls; every no-cv2 stand-in raises during this phase")
    with NoStandIns():
        return _phase_recipe(torch, np, nms_exact, ckpt_root, data_root, cv2)


def _phase_recipe(torch, np, nms_exact, ckpt_root, data_root, cv2):
    from super_gradients_tpu_torch import train_from_recipe
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer, dataloaders
    from super_gradients_tpu_torch.training.trainer import _to_device
    from super_gradients_tpu_torch.training.transforms.detection import DetectionSample, DetectionStandardize

    t_phase = time.perf_counter()
    cpus = os.cpu_count()
    workers = min(8, cpus)
    n_boxes, n_crowd = make_rf100_dataset(np, data_root)
    cuts = [f"dataset_params.train_dataset_params.data_dir={data_root}",
            f"dataset_params.val_dataset_params.data_dir={data_root}", "dataset_name=synthetic", "num_classes=80",
            "epochs=2", "batch_size=16", "val_batch_size=16", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}",
            "training_hyperparams.mixed_precision=True"]
    cfg = config.load_recipe("roboflow_yolo_nas_m", overrides=cuts)
    tiled = RECIPE_WAVES * 16 * workers
    print(f"[11] recipe roboflow_yolo_nas_m through train_from_recipe.main (PyYAML present: YAML path); dataset: "
          f"64 train + 32 valid PNGs, {n_boxes} boxes ({n_crowd} iscrowd); cuts: {cuts}, and the train loader "
          f"rebuilt over the recipe's dataset with min_samples={tiled} ({RECIPE_WAVES} batches a worker an epoch)")

    timed = {}
    original_get = dataloaders.get

    def timed_get(name=None, **kw):
        loader = original_get(name, **kw)
        if name == cfg["train_dataloader"]:
            loader = dataloaders.DataLoader(loader.dataset, batch_size=loader.batch_size, shuffle=True, drop_last=True,
                                            num_workers=loader.num_workers, min_samples=tiled)
            loader = timed.setdefault("train", TimedLoader(loader, profile_epoch=1, profile_from=workers))
        return loader

    dataloaders.get = timed_get
    nms_exact.exact_nms_keep.launches = 0
    t0 = time.perf_counter()
    try:
        _, trainer = train_from_recipe.main(["--config-name=roboflow_yolo_nas_m", *cuts])
    finally:
        dataloaders.get = original_get
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    launches = nms_exact.exact_nms_keep.launches
    n_valid_batches = -(-32 // 16)
    check(launches == 2 * n_valid_batches, f"K1 launched {launches} times in train_from_recipe, expected "
                                           f"one a validation batch ({2 * n_valid_batches})")
    history, valid = trainer.train_loss_history, trainer.valid_metrics_history
    check(len(history) == 2 and all(np.isfinite(history)), f"recipe train losses {history}")
    metric_keys = {"mAP@0.50", "Precision@0.50", "Recall@0.50", "F1@0.50", "Best_score_threshold", "Loss"}
    check(len(valid) == 2 and all(metric_keys <= set(v) and np.isfinite(list(v.values())).all() for v in valid),
          f"recipe validation results {valid}")
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        check(json.load(f) == cfg, "recipe.json is not the resolved recipe")
    steps = tiled // 16
    check(trainer.train_state.step == 2 * steps, f"{trainer.train_state.step} steps taken, expected {2 * steps}")

    loader = timed["train"]
    requests, waits = loader.epochs[1]

    def loop(start):  # ms a step and loader-wait share over epoch 2's steps from `start` on
        seconds = requests[-1] - requests[start]
        return seconds * 1e3 / (len(waits) - start), sum(waits[start:]) / seconds

    whole_ms, whole_share = loop(0)
    steady_ms, steady_share = loop(workers)
    first_waits = [round(e[1][0] * 1e3, 1) for e in loader.epochs]
    print(f"[11] train_from_recipe: 2 epochs x {steps} steps of 16 at 640 (bf16) with validation and checkpoints in "
          f"{train_seconds:.1f} s; K1 launches in it: {launches}; losses {history}")
    print(f"[11] validation: {json.dumps(valid)}")
    print(f"[11] epoch 2 train loop ({workers} workers, {steps} steps): whole {whole_ms:.2f} ms a step "
          f"({16e3 / whole_ms:.1f} img/s), loader-wait share {whole_share:.3f}; steady state (steps {workers + 1}-{steps}, "
          f"after the first wave) {steady_ms:.2f} ms a step ({16e3 / steady_ms:.1f} img/s), loader-wait share "
          f"{steady_share:.3f}, device busy {loader.busy_ms:.2f} of {loader.window_ms:.2f} ms, idle share "
          f"{1 - loader.busy_ms / loader.window_ms:.3f}; waits in next(loader) {[round(w * 1e3, 1) for w in waits]} ms; "
          f"first batch of each epoch waited {first_waits} ms; {loader.batch_bytes} bytes a batch to the card "
          f"(uint8 images + float32 targets; float32 images would be {16 * 3 * 640 * 640 * 4} bytes)")

    t1 = time.perf_counter()
    _, resumed = Trainer.resume_experiment("roboflow_yolo_nas_m", ckpt_root_dir=ckpt_root)
    resume_seconds = time.perf_counter() - t1
    check(resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == [], "resume_experiment took a step")
    check_state_equal(torch, trainer.train_state, resumed.train_state)
    print(f"[11] resume_experiment: no step, state bit-equal, {resume_seconds:.1f} s")
    evaluated, epoch = check_evaluate_checkpoint(torch, cfg, "roboflow_yolo_nas_m", trainer.ckpt_dir, ckpt_root, "11")
    print(f"[11] evaluate_checkpoint to the epoch's bf16 validation: "
          f"{json.dumps(metric_differences(evaluated, valid[epoch]))}")
    del trainer, resumed

    val = dataloaders.get(cfg["val_dataloader"], dataset_params=cfg["dataset_params"]["val_dataset_params"],
                          dataloader_params={"batch_size": 16})
    images, targets = next(iter(val))
    on_card, _ = _to_device(images.pin_memory(), targets, torch.device("cuda"), val.max_value)
    standardize = DetectionStandardize(val.max_value)
    host = np.stack([standardize(DetectionSample(im.permute(1, 2, 0).numpy(), None, None), None).image for im in images])
    check(images.dtype == torch.uint8 and torch.equal(on_card.cpu(), torch.from_numpy(host).permute(0, 3, 1, 2)),
          "uint8 batch standardized on the card differs from the host's DetectionStandardize")

    train_set = dataloaders.get(cfg["train_dataloader"], dataset_params=cfg["dataset_params"]["train_dataset_params"],
                                dataloader_params={"batch_size": 16}).dataset
    breakdown = chain_breakdown(torch, cv2, train_set)
    rates, firsts = {}, []
    for n in (0, 4, 4, workers):
        rate, first = one_wave(dataloaders, train_set, n)
        rates.setdefault(n, []).append(rate)
        if n == 4:
            firsts.append(first)
    check(all(torch.equal(a, b) for a, b in zip(*firsts)), "two loaders with one seed and 4 workers differ in batch 1")
    threads = cv2_threads_rates(dataloaders, cv2, train_set, workers)
    print(f"[11] uint8 val batch standardized on the card: bit-equal to the host DetectionStandardize; two train "
          f"loaders (seed 0, 4 workers): first batches byte-equal. Loader alone (mosaic train chain, b16; one batch a "
          f"worker, all at once, from a fresh loader), cpu_count {cpus}: "
          + ", ".join(f"{n} workers {' / '.join(f'{r:.1f}' for r in rs)} img/s" for n, rs in rates.items())
          + f"; a sample's chain on one thread, ms by stage: {json.dumps(breakdown)}")
    print(f"[11] cv2 threads in the {workers} loader workers, loader alone, one wave each (img/s): "
          + "; ".join(f"{name} {' / '.join(f'{r:.1f}' for r in rs)}" for name, rs in threads.items()))
    print(f"[11] phase seconds: {time.perf_counter() - t_phase:.1f}")
    torch.cuda.empty_cache()
    return launches


SURFACE_VIDEO = (8, 480, 640)  # frames, height, width of phase 12's MP4
SURFACE_BUDGET_GB = 80.0  # the batch-size probe's budget: the card's memory
SURFACE_LADDER = (8, 64)  # smallest and largest batch the probe tries


def write_surface_inputs(np, folder):
    """Phase 12's inputs: two PNGs and a JPEG written by PIL, and an MP4 written by cv2,
    of smooth fields with filled rectangles. Returns the video's path."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(12)

    def picture(h, w):
        image = smooth_field(np, rng, h, w)
        for _ in range(12):
            y, x = rng.randint(0, h - 40), rng.randint(0, w - 40)
            image[y:y + rng.randint(20, h // 3), x:x + rng.randint(20, w // 3)] = rng.randint(0, 256, 3)
        return image

    images = os.path.join(folder, "images")
    os.makedirs(images)
    for name, (h, w) in (("a.png", (480, 640)), ("b.png", (640, 427)), ("c.jpg", (720, 1280))):
        Image.fromarray(picture(h, w)).save(os.path.join(images, name), **({"quality": 92} if name.endswith(".jpg") else {}))
    frames, h, w = SURFACE_VIDEO
    path = os.path.join(folder, "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (w, h))
    base = picture(h, w)
    for i in range(frames):
        writer.write(cv2.cvtColor(np.roll(base, 8 * i, axis=1), cv2.COLOR_RGB2BGR))
    writer.release()
    return images, path


def phase_surface(torch, np, nms_exact, matched_fraction, data_root, work):
    """The data and predict surface at full width (YOLO-NAS-M, 640, exact NMS): predict on a
    folder, a PIL image and a video against the CPU, drawing and saving, the 4-image
    request's latency, a plain-loader epoch with a class-balanced sampler and the
    visualization callback, and the batch-size probe; every no-cv2 stand-in raises.
    Returns K1's launches in the phase."""
    with NoStandIns():
        return _phase_surface(torch, np, nms_exact, matched_fraction, data_root, work)


def _phase_surface(torch, np, nms_exact, matched_fraction, data_root, work):
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.inference import video
    from super_gradients_tpu_torch.inference.prediction_results import VideoPredictions
    from super_gradients_tpu_torch.training import Trainer, callbacks, pre_launch_callbacks, samplers
    from super_gradients_tpu_torch.training.datasets_roboflow import RoboflowDetectionDataset
    from super_gradients_tpu_torch.training.dataloaders import _yolo_nas_train_transforms, _yolo_nas_val_transforms
    from super_gradients_tpu_torch.training.losses import get_loss

    t_phase = time.perf_counter()
    images_dir, video_path = write_surface_inputs(np, work)
    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    cpu_model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu"))
    pil_image = Image.open(os.path.join(images_dir, "b.png"))
    nms_exact.exact_nms_keep.launches = 0

    # predict on files, a PIL image and a video, fp32 (TF32 off) against the CPU, as phase 4
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = {}
        for what, source in (("folder", images_dir), ("PIL image", pil_image), ("video", video_path)):
            gpu = model.predict(source, fuse_model=False, bf16=False)
            cpu = cpu_model.predict(source, fuse_model=False, bf16=False)
            check_predictions(np, gpu, len(cpu), f"phase 12 predict on a {what}")
            fractions = [matched_fraction(a, b, 0.99) for a, b in zip(gpu, cpu)]
            check(min(fractions) >= 0.99, f"predict on a {what}: GPU vs CPU matched fractions {fractions}")
            results[what] = (gpu, fractions)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    check(isinstance(results["video"][0], VideoPredictions) and len(results["video"][0]) == SURFACE_VIDEO[0],
          "predict on the video did not give one prediction a frame")
    print(f"[12] yolo_nas_m 640 fp32 predict GPU vs CPU (TF32 off), matched fractions at IoU 0.99: "
          + "; ".join(f"{what} ({len(r)} images, {sum(len(p) for p in r)} detections) min {min(f):.4f}"
                      for what, (r, f) in results.items()))

    # draw and save every result; the files read back at their sizes and frame count
    out = os.path.join(work, "out")
    for what, (preds, _) in results.items():
        if what == "video":
            continue
        for p in preds:
            drawn = p.draw()
            check(drawn.shape == p.image.shape and not np.array_equal(drawn, p.image), f"{what}: draw() drew nothing")
        preds.save(os.path.join(out, what.replace(" ", "_")))
        for i, p in enumerate(preds):
            with Image.open(os.path.join(out, what.replace(" ", "_"), f"pred_{i}.jpg")) as saved:
                check(saved.size == (p.image.shape[1], p.image.shape[0]), f"{what}: a saved image has another size")
    video_out = os.path.join(out, "clip_drawn.mp4")
    results["video"][0].save(video_out)
    frames, fps = video.load_video(video_out)
    check(len(frames) == SURFACE_VIDEO[0] and frames[0].shape == SURFACE_VIDEO[1:] + (3,) and fps == 8,
          f"the drawn video reads back as {len(frames)} frames of {frames[0].shape if frames else None} at {fps} fps")
    print(f"[12] draw() and save(): {len(os.listdir(os.path.join(out, 'folder')))} + 1 JPEGs at their sizes; the drawn "
          f"video reads back as {len(frames)} frames of {frames[0].shape[1]}x{frames[0].shape[0]} at {fps} fps")

    # predict() latency of the 4-image request (fused bf16), and its host letterbox alone
    request = request_images(np, 0)
    for _ in range(3):
        model.predict(request)
    latency, letterbox = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(request)
        latency.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        model._prep_host_batches(request, 8)
        letterbox.append((time.perf_counter() - t0) * 1e3)
    print(f"[12] predict() of 4 mixed-size images (fused bf16, exact NMS), host clock, 10 requests: median "
          f"{np.median(latency):.2f} ms (min {min(latency):.2f}, max {max(latency):.2f}); the host letterbox alone "
          f"(cv2.resize, pad, /255) median {np.median(letterbox):.2f} ms")

    # one validated epoch from plain torch loaders, a class-balanced train order, the visualization callback
    train_set = RoboflowDetectionDataset(data_dir=data_root, dataset_name="synthetic", split="train",
                                         transforms=_yolo_nas_train_transforms((640, 640)))
    valid_set = RoboflowDetectionDataset(data_dir=data_root, dataset_name="synthetic", split="valid",
                                         transforms=_yolo_nas_val_transforms((640, 640)))
    sampler = samplers.ClassBalancedSampler(dataset=train_set, num_samples=64, seed=0)
    train_loader = torch.utils.data.DataLoader(train_set, batch_size=16, sampler=sampler, num_workers=8,
                                               drop_last=True, pin_memory=True)
    valid_loader = torch.utils.data.DataLoader(valid_set, batch_size=16, num_workers=4, pin_memory=True)
    trainer = Trainer("surface", ckpt_root_dir=os.path.join(work, "ckpt"))
    params = dict(COCO_YOLO_NAS, max_epochs=1, save_model=False, sg_logger_params={"tensorboard": False},
                  phase_callbacks=[callbacks.DetectionVisualizationCallback(max_images=4)])
    launches_before = nms_exact.exact_nms_keep.launches
    t0 = time.perf_counter()
    trainer.train(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"), params, train_loader, valid_loader)
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    epoch_launches = nms_exact.exact_nms_keep.launches - launches_before
    drawn = sorted(os.listdir(os.path.join(trainer.ckpt_dir, "images")))
    check(len(trainer.train_loss_history) == 1 and np.isfinite(trainer.train_loss_history[0]), "plain-loader epoch loss")
    check(trainer.train_state.step == 4, f"{trainer.train_state.step} steps from 64 class-balanced samples of 16")
    check(len(trainer.valid_metrics_history) == 1 and np.isfinite(list(trainer.valid_metrics_history[0].values())).all(),
          f"plain-loader validation {trainer.valid_metrics_history}")
    check(epoch_launches == 3, f"K1 launched {epoch_launches} times in the epoch, expected 2 validation batches + 1 drawing")
    check(len(drawn) == 4, f"the visualization callback wrote {drawn}")
    side = valid_set[0][0].shape[-1]  # the validation batches' square size, 640
    with Image.open(os.path.join(trainer.ckpt_dir, "images", drawn[0])) as im:
        check(im.size == (side, side), f"a drawn validation image is {im.size}, not {side}x{side}")
    draws = np.bincount(list(sampler), minlength=len(train_set))
    print(f"[12] plain torch DataLoader (8 workers) over the phase-11 RF100 train set with a ClassBalancedSampler "
          f"(64 draws, the most-drawn image {draws.max()} times), 1 epoch of 4 steps of 16 at 640 (bf16) validated on "
          f"32 images through a plain loader, in {train_seconds:.1f} s: loss {trainer.train_loss_history[0]:.4f}, "
          f"validation {json.dumps(trainer.valid_metrics_history[0])}; K1 {epoch_launches} launches; "
          f"DetectionVisualizationCallback wrote {drawn}")
    del trainer, train_loader, valid_loader

    # the pre-launch batch-size probe on YOLO-NAS-M at 640 over a bounded ladder
    criterion = get_loss("PPYoloELoss", {"num_classes": 80})
    box = torch.tensor([[1.0, 100.0, 120.0, 300.0, 360.0], [7.0, 320.0, 40.0, 600.0, 200.0]], device=model.device)

    def loss_fn(out, t):  # detection targets for the probe's batch of zero images
        return criterion(out, box.expand(t.shape[0], 2, 5).contiguous())

    probe = pre_launch_callbacks.estimate_train_step_memory_gb
    readings = {}

    def recorded(m, bs, hw, fn):
        readings[bs] = probe(m, bs, hw, fn)
        return readings[bs]

    recipe = {"dataset_params": {"train_dataloader_params": {"batch_size": 16}},
              "training_hyperparams": {"initial_lr": 2e-4}}
    pre_launch_callbacks.estimate_train_step_memory_gb = recorded
    t0 = time.perf_counter()
    try:
        cfg = pre_launch_callbacks.AutoTrainBatchSizeSelectionCallback(
            min_batch_size=SURFACE_LADDER[0], max_batch_size=SURFACE_LADDER[1], hbm_budget_gb=SURFACE_BUDGET_GB)(
            recipe, model=model, loss_fn=loss_fn, image_hw=(640, 640))
    finally:
        pre_launch_callbacks.estimate_train_step_memory_gb = probe
    chosen = cfg["dataset_params"]["train_dataloader_params"]["batch_size"]
    fitting = [bs for bs, gb in readings.items() if gb is not None and gb <= SURFACE_BUDGET_GB]
    check(fitting and chosen == max(fitting), f"probe readings {readings}, chosen batch {chosen}")
    check(abs(cfg["training_hyperparams"]["initial_lr"] - 2e-4 * chosen / 16) < 1e-12, "the LR was not scaled linearly")
    check(all(readings[a] < readings[b] for a, b in zip(fitting, fitting[1:])), f"peak memory not rising: {readings}")
    print(f"[12] AutoTrainBatchSizeSelectionCallback, yolo_nas_m 640 fp32 forward + backward, ladder "
          f"{SURFACE_LADDER[0]}-{SURFACE_LADDER[1]}, budget {SURFACE_BUDGET_GB} GB: peak GB by batch "
          + json.dumps({bs: None if gb is None else round(gb, 3) for bs, gb in readings.items()})
          + f"; chosen batch {chosen}, initial_lr 2e-4 -> {cfg['training_hyperparams']['initial_lr']:.3g}; "
          f"{time.perf_counter() - t0:.1f} s")
    launches = nms_exact.exact_nms_keep.launches
    print(f"[12] phase seconds: {time.perf_counter() - t_phase:.1f}; K1 launches in the phase: {launches}")
    del model, cpu_model
    torch.cuda.empty_cache()
    return launches


# super_gradients_tpu/recipes/coco2017_yolo_nas_pose_s.yaml's training_hyperparams, bf16
COCO_YOLO_NAS_POSE = dict(
    warmup_mode="LinearBatchLRWarmup", warmup_initial_lr=1e-6, lr_warmup_steps=128, initial_lr=2e-3,
    lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.05, zero_weight_decay_on_bias_and_bn=True,
    loss="YoloNASPoseLoss", criterion_params={"num_joints": 17},
    optimizer="AdamW", optimizer_params={"weight_decay": 1e-6},
    ema=True, ema_params={"decay": 0.997, "decay_type": "threshold"}, mixed_precision=True,
    metric_to_watch="AP", valid_metrics_list=[{"PoseEstimationMetrics": {"num_joints": 17}}],
)
# |GPU - CPU| of a matched pose's joints (x, y) in original-image pixels, fp32 predict at 640
POSE_PX_TOL = 0.5
POSE_MAX_PREDICTIONS = 300  # phase 13(a) keeps every pose NMS leaves, so the matched fraction counts them all
POSE_RECIPE_WAVES = 2  # train batches a loader worker makes an epoch in phase 13(e) (the set tiled by min_samples)


def pose_matched(np, box_iou_fn, a, b, iou_min=0.99):
    """One-to-one matches between two pose results by box IoU >= iou_min; returns the
    matched fraction and the largest |difference| of a matched pair's joints (x, y)."""
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b)), 0.0
    iou = box_iou_fn(a.bboxes_xyxy, b.bboxes_xyxy)
    used, worst = set(), 0.0
    for i in range(len(a)):
        for j in np.flatnonzero(iou[i] >= iou_min):
            if j not in used:
                used.add(j)
                worst = max(worst, float(np.abs(a.poses[i, :, :2] - b.poses[j, :, :2]).max()))
                break
    return len(used) / max(len(a), len(b)), worst


def write_pose_coco(np, root, seed=13):
    """A COCO person-keypoints dataset of PNGs written by PIL: 64 train and 32 val images of
    phase 11's sizes on smooth fields, 1-6 persons each (a filled box), 17 joints inside the
    box with visibility 0 (position 0, 0), 1 or 2; about 10% of the persons iscrowd.
    Returns (persons, crowd persons)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    n_persons = n_crowd = 0
    for split, count in (("train", 64), ("val", 32)):
        folder = os.path.join(root, "images", split)
        os.makedirs(folder)
        images, annotations = [], []
        for i in range(count):
            h, w = RF100_SIZES[i % len(RF100_SIZES)]
            image = smooth_field(np, rng, h, w)
            for _ in range(rng.randint(1, 7)):
                bw, bh = rng.uniform(32, w / 2), rng.uniform(48, h / 1.5)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                image[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(0, 256, 3)
                vis = rng.randint(0, 3, 17)
                kps = np.stack([rng.uniform(x, x + bw, 17), rng.uniform(y, y + bh, 17), vis], -1)
                kps[vis == 0, :2] = 0
                crowd = int(rng.rand() < 0.1)
                annotations.append({"id": len(annotations), "image_id": i, "category_id": 1, "bbox": [x, y, bw, bh],
                                    "area": bw * bh, "iscrowd": crowd, "keypoints": kps.reshape(-1).tolist(),
                                    "num_keypoints": int((vis > 0).sum())})
                n_persons, n_crowd = n_persons + 1, n_crowd + crowd
            Image.fromarray(image).save(os.path.join(folder, f"{i:04d}.png"), compress_level=1)
            images.append({"id": i, "file_name": f"{i:04d}.png", "height": h, "width": w})
        with open(os.path.join(root, f"person_keypoints_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": [{"id": 1, "name": "person"}]}, f)
    return n_persons, n_crowd


def phase_pose(torch, np, nms_exact, box_iou, root):
    """YOLO-NAS-POSE-S at 640 (published widths, 17 joints, seed 0, cls_pred biases 0):
    (a) fp32 predict GPU vs CPU, (b) fused bf16 predict_batch_tensor timing, (c) K1 on the
    captured pose candidates, (d) the fp32 train step GPU vs CPU vs fp64 and the bf16 step
    by part, (e) train_from_recipe of coco2017_yolo_nas_pose_s. Returns (K1 launches on the
    main path, the largest K1-vs-plain difference)."""
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models import sg_model
    from super_gradients_tpu_torch.ops import nms as nms_module
    from super_gradients_tpu_torch.training import Trainer, dataloaders

    t_phase = time.perf_counter()

    def iou_np(a, b):
        return box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    # (a) fp32 predict on the card against the CPU, TF32 off, exact NMS at conf 0.01
    model = zero_cls_bias(models.get("yolo_nas_pose_s", seed=0, device="cuda"))
    cpu_model = zero_cls_bias(models.get("yolo_nas_pose_s", seed=0, device="cpu"))
    gpu_sd, cpu_sd = model.net.state_dict(), cpu_model.net.state_dict()
    check(all(torch.equal(gpu_sd[k].cpu(), cpu_sd[k]) for k in cpu_sd), "pose: GPU and CPU models differ in weights")
    images = request_images(np, 3)
    pil_image = Image.fromarray(request_images(np, 5)[1])
    kw = dict(conf=0.01, bf16=False, fuse_model=False, nms_mode="exact", max_predictions=POSE_MAX_PREDICTIONS)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nms_exact.exact_nms_keep.launches = 0
    try:
        gpu = list(model.predict(images, **kw)) + list(model.predict(pil_image, **kw))
        predict_launches = nms_exact.exact_nms_keep.launches
        cpu = list(cpu_model.predict(images, **kw)) + list(cpu_model.predict(pil_image, **kw))
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    check(predict_launches == 2, f"pose predict launched K1 {predict_launches} times, expected one a batch (2)")
    fractions, worst = [], 0.0
    for g, c in zip(gpu, cpu):
        check(len(g) > 0 and np.isfinite(g.poses).all() and g.poses.shape[1:] == (17, 3), "pose: empty or bad result")
        frac, px = pose_matched(np, iou_np, g, c)
        fractions.append(frac)
        worst = max(worst, px)
    print(f"[13a] yolo_nas_pose_s 640 fp32 predict GPU vs CPU (TF32 off, exact NMS, conf 0.01, up to "
          f"{POSE_MAX_PREDICTIONS} poses), 4-image request + a PIL image: poses {[len(g) for g in gpu]} vs "
          f"{[len(c) for c in cpu]}; matched fractions at box IoU 0.99 {[round(f, 4) for f in fractions]}; matched "
          f"joints |GPU - CPU| max {worst:.4f} px (limit {POSE_PX_TOL}); K1 launches {predict_launches}")
    check(min(fractions) >= 0.99, f"pose predict GPU vs CPU matched fractions {fractions}")
    check(worst <= POSE_PX_TOL, f"matched poses differ by {worst} px between GPU and CPU")
    drawn_path = os.path.join(root, "pose_drawn.png")
    gpu[0].save(drawn_path)
    with Image.open(drawn_path) as saved:
        check(saved.size == (images[0].shape[1], images[0].shape[0]), "the drawn pose result reads back at another size")
    check(not np.array_equal(gpu[0].draw(), gpu[0].image), "the pose drawing drew nothing")
    del cpu
    print(f"[13a] seconds {time.perf_counter() - t_phase:.1f}")

    # (b) fused bf16 predict_batch_tensor, and (c) K1 on its captured candidates
    max_err = 0.0
    for b in (8, 32):
        batch = torch.rand((b, 640, 640, 3), generator=torch.Generator().manual_seed(3)).cuda()
        call = lambda: model.predict_batch_tensor(batch)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            out = call()
        out.num_detections.cpu()
        dt = time.perf_counter() - t0
        net = model._deploy_net(True, True)
        x = batch.to(torch.bfloat16).permute(0, 3, 1, 2)
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: net(x), iters=10)
            o = net(x)
            nms_call = lambda: nms_module.batched_pose_nms(  # noqa: E731
                o.pred_bboxes, o.pred_scores, o.pred_pose_coords, o.pred_pose_scores, score_threshold=0.5,
                iou_threshold=0.7, nms_top_k=1024, max_predictions=30, mode="exact")
            nms_ms = cuda_ms(nms_call, iters=20)
        events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[13b] yolo_nas_pose_s fused bf16 predict_batch_tensor b{b}: {b * iters / dt:.1f} img/s "
              f"({1e3 * dt / iters:.2f} ms/batch, host clock); forward {forward_ms:.2f} ms, batched_pose_nms "
              f"{nms_ms:.4f} ms (CUDA events); profiled: wall {wall_ms:.2f} ms a batch, device busy {busy_ms:.2f} ms, "
              f"idle share {1 - busy_ms / wall_ms:.3f}")
        nms_args, nms_kwargs = capture_call(sg_model, "batched_pose_nms",
                                            lambda: model.predict_batch_tensor(batch, conf=0.01))
        with torch.inference_mode():
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep",
                                                lambda: nms_module.batched_pose_nms(*nms_args, **nms_kwargs))
            check(tuple(boxes.shape) == (b, 1024, 4) and bool(valid.all()), "pose candidates: K = 1024, all valid")
            max_err = max(max_err, check_k1_equal(torch, nms_exact, f"pose candidates b{b}", boxes, valid, t))
            n_kept = nms_exact.exact_nms_keep(boxes, valid, t).sum(dim=1)
            print(f"[13c] b{b} pose candidates: K={boxes.shape[1]}, all valid, kept per image {n_kept.tolist()}; "
                  f"K1 bit-equal to the plain version")
            time_k1(torch, nms_exact, f"b{b} pose candidates", boxes, valid, t, phase="13c")
        del batch, out, o, boxes, valid, nms_args, nms_kwargs
    print(f"[13b-c] seconds {time.perf_counter() - t_phase:.1f}")

    phase_pose_train_steps(torch, np, model, cpu_model)
    del model, cpu_model
    torch.cuda.empty_cache()
    print(f"[13d] seconds {time.perf_counter() - t_phase:.1f}")

    # (e) the pose recipe
    data_root, ckpt_root = os.path.join(root, "coco_pose"), os.path.join(root, "ckpt")
    launches = phase_pose_recipe(torch, np, nms_exact, dataloaders, Trainer, models, data_root, ckpt_root)
    print(f"[13] K1 launches in phase 13's main paths: {predict_launches} (predict) + {launches} (recipe run); "
          f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return predict_launches + launches, max_err


def phase_pose_train_steps(torch, np, model, cpu_model):
    """(d) One fp32 SGD pose step at 640 on the GPU and the CPU, held to an fp64 CPU step
    (phase 8's rule), then the bf16 step at b16 and b32 by part with its peak memory
    (``model`` on the card and ``cpu_model`` on the CPU carry the same weights)."""
    import types

    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.dataloaders import RandomPoseDataset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dataset = RandomPoseDataset(num_samples=2, image_size=(640, 640), num_joints=17, max_poses=30)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(2))))
        runs = {}
        for name, device, dtype in (("fp64 CPU", "cpu", torch.float64), ("fp32 CPU", "cpu", torch.float32),
                                    ("fp32 GPU", "cuda", torch.float32)):
            net = copy.deepcopy(cpu_model.net).to(device, dtype)
            m = types.SimpleNamespace(net=net, device=torch.device(device))
            x, t = images.to(device, dtype), targets.to(device, dtype)
            if device == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            runs[name] = _one_step(torch, m, x, t, assign=runs["fp64 CPU"][0] if runs else None,
                                   base=COCO_YOLO_NAS_POSE)
            del net, m
        labels64 = runs["fp64 CPU"][0].labels
        for name in ("fp32 CPU", "fp32 GPU"):
            diff = int((runs[name][0].labels.cpu() != labels64).sum())
            print(f"[13d] pose {name}: {diff} of {labels64.numel()} anchors assigned another label than fp64 CPU "
                  f"({int((labels64 != 1).sum())} positive)")
        ref_comps, ref_grads = runs["fp64 CPU"][1], runs["fp64 CPU"][2]
        for key in ("loss_cls", "loss_iou", "loss_dfl", "loss_pose_cls", "loss_pose_reg", "loss"):
            errs = {name: abs(runs[name][1][key] - ref_comps[key]) for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[13d] {key} {ref_comps[key]:.6f} (fp64 CPU): GPU err {errs['fp32 GPU']:.3g}, "
                  f"CPU err {errs['fp32 CPU']:.3g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-6 * abs(ref_comps[key]),
                  f"pose GPU fp32 {key} more than twice as far from fp64 as the CPU's")
        for group in ("backbone", "neck", "heads", ""):
            keys = [k for k in ref_grads if k.startswith(group)]
            norm = float(sum((ref_grads[k] ** 2).sum() for k in keys) ** 0.5)
            errs = {name: float(sum(((runs[name][2][k] - ref_grads[k]) ** 2).sum() for k in keys) ** 0.5)
                    for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[13d] pose gradients {group or 'all'} (norm {norm:.4g}): GPU L2 err {errs['fp32 GPU']:.4g}, "
                  f"CPU L2 err {errs['fp32 CPU']:.4g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-7 * norm,
                  f"pose GPU fp32 gradients ({group or 'all'}) more than twice as far from fp64 as the CPU's")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    del runs

    for b in (16, 32):
        step = Trainer("chip_smoke_pose_timing").prepare(model, COCO_YOLO_NAS_POSE, steps_per_epoch=100)
        dataset = RandomPoseDataset(num_samples=b, image_size=(640, 640), num_joints=17, max_poses=30)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
        images = images.cuda().contiguous(memory_format=torch.channels_last)
        targets = targets.cuda()

        def run(events=None):
            marks = [lambda: None] * 5 if events is None else [e.record for e in events]
            marks[0]()
            out = step.forward(images)
            marks[1]()
            loss, _ = step.loss(out, targets)
            marks[2]()
            step.backward(loss)
            marks[3]()
            step.update()
            marks[4]()
            return loss

        for _ in range(3):
            run()
        iters = 10
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
        for ev in events:
            run(ev)
        torch.cuda.synchronize()
        parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
        step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
        prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the assigner's [B, max_poses, 8400, 17] OKS distances, alone in the loss
        out = step.forward(images)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            step.criterion.assign(out, targets)
        torch.cuda.synchronize()
        assign_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        oks_gib = b * targets.shape[1] * out.pred_pose_coords.shape[1] * 17 * 4 / 2**30
        check(bool(torch.isfinite(loss)), f"pose b{b} train loss not finite")
        print(f"[13d] yolo_nas_pose_s bf16 train step b{b}: {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.1f} img/s "
              f"(CUDA events); forward {parts[0]:.2f}, loss {parts[1]:.2f}, backward {parts[2]:.2f}, optimizer+EMA "
              f"{parts[3]:.2f} ms; profiled (device activity only): wall {wall_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak memory {peak:.2f} GiB; the assigner "
              f"alone peaks {assign_peak:.2f} GiB above its inputs, of which the OKS distances "
              f"[{b}, {targets.shape[1]}, {out.pred_pose_coords.shape[1]}, 17] fp32 are {oks_gib:.2f} GiB")
        del step, images, targets, loss, out, prof_events
        torch.cuda.empty_cache()


def phase_pose_recipe(torch, np, nms_exact, dataloaders, Trainer, models, data_root, ckpt_root):
    """(e) train_from_recipe of coco2017_yolo_nas_pose_s on a COCO person-keypoints dataset
    written here; returns K1's launches inside it."""
    from super_gradients_tpu_torch import train_from_recipe
    from super_gradients_tpu_torch.common import config

    cpus = os.cpu_count()
    workers = min(8, cpus)
    n_persons, n_crowd = write_pose_coco(np, data_root)
    cuts = ["epochs=2", "batch_size=16", "val_batch_size=16", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}",
            "training_hyperparams.mixed_precision=True"]
    for split in ("train", "val"):
        cuts += [f"dataset_params.{split}_dataset_params.data_dir={data_root}",
                 f"dataset_params.{split}_dataset_params.json_file=person_keypoints_{split}.json",
                 f"dataset_params.{split}_dataset_params.subdir=images/{split}"]
    cfg = config.load_recipe("coco2017_yolo_nas_pose_s", overrides=cuts)
    tiled = POSE_RECIPE_WAVES * 16 * workers
    print(f"[13e] recipe coco2017_yolo_nas_pose_s through train_from_recipe.main; dataset: 64 train + 32 val PNGs, "
          f"{n_persons} persons ({n_crowd} iscrowd); cuts: {cuts}, and the train loader rebuilt over the recipe's "
          f"dataset with min_samples={tiled} ({POSE_RECIPE_WAVES} batches a worker an epoch)")
    timed = {}
    original_get = dataloaders.get

    def timed_get(name=None, **kw):
        loader = original_get(name, **kw)
        if name == cfg["train_dataloader"]:
            loader = dataloaders.DataLoader(loader.dataset, batch_size=loader.batch_size, shuffle=True, drop_last=True,
                                            num_workers=loader.num_workers, min_samples=tiled)
            loader = timed.setdefault("train", TimedLoader(loader, profile_epoch=1, profile_from=workers))
        return loader

    dataloaders.get = timed_get
    nms_exact.exact_nms_keep.launches = 0
    t0 = time.perf_counter()
    try:
        _, trainer = train_from_recipe.main(["--config-name=coco2017_yolo_nas_pose_s", *cuts])
    finally:
        dataloaders.get = original_get
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    launches = nms_exact.exact_nms_keep.launches
    n_valid_batches = -(-32 // 16)
    check(launches == 2 * n_valid_batches, f"K1 launched {launches} times in the pose recipe run, expected one a "
                                           f"validation batch ({2 * n_valid_batches})")
    history, valid = trainer.train_loss_history, trainer.valid_metrics_history
    check(len(history) == 2 and all(np.isfinite(history)), f"pose recipe train losses {history}")
    check(len(valid) == 2 and all(set(v) == {"AP", "AR", "Loss"} and np.isfinite(list(v.values())).all()
                                  for v in valid), f"pose recipe validation results {valid}")
    steps = tiled // 16
    check(trainer.train_state.step == 2 * steps, f"{trainer.train_state.step} steps taken, expected {2 * steps}")
    loader = timed["train"]
    requests, waits = loader.epochs[1]
    seconds = requests[-1] - requests[workers]
    steady_ms, steady_share = seconds * 1e3 / (len(waits) - workers), sum(waits[workers:]) / seconds
    print(f"[13e] train_from_recipe: 2 epochs x {steps} steps of 16 at 640 (bf16) with validation and checkpoints in "
          f"{train_seconds:.1f} s; K1 launches in it: {launches}; losses {history}; validation {json.dumps(valid)}")
    print(f"[13e] epoch 2 steady state (steps {workers + 1}-{steps}, {workers} workers): {steady_ms:.2f} ms a step "
          f"({16e3 / steady_ms:.1f} img/s), loader-wait share {steady_share:.3f}, device busy {loader.busy_ms:.2f} of "
          f"{loader.window_ms:.2f} ms, idle share {1 - loader.busy_ms / loader.window_ms:.3f}; {loader.batch_bytes} "
          f"bytes a batch to the card (float32 images + float32 targets)")

    check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], trainer.ckpt_dir, ckpt_root, "13e")
    close_loader(loader.loader)
    del trainer
    torch.cuda.empty_cache()
    return launches


CLS_CONF_TOL = 1e-4  # |GPU - CPU| of a top-5 probability in phase 14(a)
CLS_ACCURACY_FLOOR = 0.90  # the floor of the JAX package's test_cifar10_recipe_cli_accuracy_floor
IMAGENET_SIZES = ((300, 400), (256, 256), (480, 360), (375, 500), (240, 320))  # phase 14(c)'s PNGs


def write_image_folder(np, root, n_classes, per_class, seed):
    """An ImageNet-layout folder of PNGs (``root/class_k/i.png``) in several sizes, each a
    smooth field tinted by its class."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
        for i in range(per_class):
            h, w = IMAGENET_SIZES[(c + i) % len(IMAGENET_SIZES)]
            img = smooth_field(np, rng, h, w)
            img[..., c % 3] = np.clip(img[..., c % 3].astype(np.int32) + 20 * c, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, f"class_{c}", f"{i}.png"), compress_level=1)


def phase_classification(torch, np, nms_exact, root):
    """ResNet classification at full width: (a) fp32 predict GPU vs CPU, (b) predict latency
    and the forward's throughput, (c) the imagenet_resnet50 regime through Trainer.train and
    the bf16 step by part, (d) train_from_recipe of cifar10_resnet. Launches no kernel."""
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models.sg_model import ClassificationModel

    t_phase = time.perf_counter()
    launches_before = nms_exact.exact_nms_keep.launches

    # (a) fp32 predict on the card against the CPU, TF32 off
    model = models.get("resnet50", num_classes=1000, seed=0, device="cuda")
    cpu_model = models.get("resnet50", num_classes=1000, seed=0, device="cpu")
    check(isinstance(model, ClassificationModel), "resnet50 is not a ClassificationModel")
    images = request_images(np, 3)
    pil_image = Image.fromarray(request_images(np, 5)[1])
    # the random-init logits reach ~2,000 on these images, so every softmax would be
    # one-hot: the head is scaled (the same factor on both devices) to a logit std of 2
    _, batches, _ = cpu_model._prep_host_batches(images, 4)
    with torch.inference_mode():
        std = float(cpu_model.net(torch.from_numpy(batches[0]).permute(0, 3, 1, 2)).std())
    with torch.no_grad():
        for m in (model, cpu_model):
            m.net.linear.weight.mul_(2.0 / std)
            m.net.linear.bias.mul_(2.0 / std)
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = list(model.predict(images)) + list(model.predict(pil_image))
        _, batches, _ = model._prep_host_batches(images + [np.asarray(pil_image)], 5)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            g_logits = model._deploy_net(False, False)(x.cuda()).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    cpu = list(cpu_model.predict(images)) + list(cpu_model.predict(pil_image))
    with torch.inference_mode():
        c_logits = cpu_model.net(x).double()
        r_logits = copy.deepcopy(cpu_model.net).double()(x.double())
    top1 = [(g.prediction, c.prediction) for g, c in zip(gpu, cpu)]
    conf_err = max(float(np.abs(g.confidence - c.confidence).max()) for g, c in zip(gpu, cpu))
    e_gpu, e_cpu = float((g_logits - r_logits).abs().max()), float((c_logits - r_logits).abs().max())
    print(f"[14a] resnet50 1000 classes 224 fp32 predict GPU vs CPU (TF32 off; head scaled by {2.0 / std:.3e}), "
          f"4-image request + a PIL image: top-1 "
          f"{top1}; top-5 probabilities |GPU - CPU| max {conf_err:.3e} (limit {CLS_CONF_TOL}); top-1 probabilities "
          f"{[round(float(g.confidence[0]), 4) for g in gpu]}; logits |GPU - fp64| max {e_gpu:.3e}, |CPU - fp64| max "
          f"{e_cpu:.3e} (|logit| max {float(r_logits.abs().max()):.2f})")
    check(len(gpu) == 5 and all(g.labels.shape == (5,) and np.isfinite(g.confidence).all() for g in gpu),
          "classification predict: a result is not 5 finite labels")
    check(all(a == b for a, b in top1), f"GPU and CPU top-1 differ: {top1}")
    check(conf_err <= CLS_CONF_TOL, f"top-5 probabilities differ by {conf_err} between GPU and CPU")
    check(e_gpu <= 2 * e_cpu + 1e-6 * float(r_logits.abs().max()), f"GPU logits {e_gpu} vs CPU {e_cpu} from fp64")
    del cpu_model, cpu, c_logits, r_logits

    # (b) predict latency (host clock) and the fp32 forward's throughput
    tf32 = f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32}"
    model.predict(images)
    request_ms, prep_ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        model.predict(images)
        request_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        model._prep_host_batches(images, 32, pad_last=True)
        prep_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"[14b] resnet50 predict() of the 4-image request (batch padded to 32): median {np.median(request_ms):.2f} ms "
          f"(host clock, 10 runs; {tf32}); host preprocessing alone median {np.median(prep_ms):.2f} ms")
    net = model._deploy_net(False, False)
    for b in (32, 128):
        batch = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(b)).cuda()
        batch = batch.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            call = lambda: net(batch)  # noqa: E731
            ms = cuda_ms(call, iters=10)
            events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[14b] resnet50 fp32 forward b{b} at 224 ({tf32}, channels_last): {ms:.2f} ms a batch (CUDA events), "
              f"{b * 1e3 / ms:.1f} img/s; profiled: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        del batch, events
    del model, net
    torch.cuda.empty_cache()
    print(f"[14a-b] seconds {time.perf_counter() - t_phase:.1f}")

    phase_classification_train(torch, np, os.path.join(root, "imagenet"))
    print(f"[14c] seconds {time.perf_counter() - t_phase:.1f}")
    phase_classification_recipe(torch, np, os.path.join(root, "cifar"))
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 14 launched K1 {launched} times; classification has no NMS")
    print(f"[14] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 14: {launched}")


def phase_classification_train(torch, np, root):
    """(c) The imagenet_resnet50 regime (SGD 0.1, momentum 0.9, weight decay 1e-4 off bias
    and BN, 5 warmup epochs then cosine, label smoothing 0.1, bf16, no EMA) through
    Trainer.train on the registered imagenet_train / imagenet_val loaders over an
    ImageFolder of PNGs written here, 2 epochs (of 400) of 3 steps of b64; then the bf16
    step at b128 and b256 by part."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer, dataloaders
    from super_gradients_tpu_torch.training.callbacks import Callback

    t0 = time.perf_counter()
    write_image_folder(np, os.path.join(root, "train"), n_classes=10, per_class=20, seed=21)
    write_image_folder(np, os.path.join(root, "val"), n_classes=10, per_class=4, seed=22)
    write_seconds = time.perf_counter() - t0
    workers = min(8, os.cpu_count())
    tp = dict(config.load_recipe("imagenet_resnet50")["training_hyperparams"], max_epochs=2, save_model=False,
              sg_logger_params={"tensorboard": False})
    check(tp["initial_lr"] == 0.1 and tp["optimizer_params"] == {"momentum": 0.9, "weight_decay": 1e-4}
          and tp["zero_weight_decay_on_bias_and_bn"] and tp["lr_mode"] == "CosineLRScheduler"
          and tp["loss"] == "LabelSmoothingCrossEntropyLoss" and tp["criterion_params"] == {"smooth_eps": 0.1}
          and tp["mixed_precision"] and not tp["ema"], f"the imagenet_resnet50 regime changed: {tp}")
    train_loader = dataloaders.get("imagenet_train", dataset_params={"data_dir": os.path.join(root, "train"),
                                                                     "batch_size": 64},
                                   dataloader_params={"num_workers": workers})
    valid_loader = dataloaders.get("imagenet_val", dataset_params={"data_dir": os.path.join(root, "val"),
                                                                   "batch_size": 64},
                                   dataloader_params={"num_workers": workers})
    model = models.get("resnet50", num_classes=10, seed=0, device="cuda")
    before = {k: v.detach().clone() for k, v in model.net.named_parameters()}

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, ctx):
            self.losses.append(float(ctx.step_metrics["loss"]))

    recorder = StepLosses()
    trainer = Trainer("chip_smoke_imagenet", ckpt_root_dir=os.path.join(root, "ckpt"))
    t0 = time.perf_counter()
    trainer.train(model, tp, train_loader, valid_loader, additional_callbacks=[recorder])
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    close_loader(train_loader)
    close_loader(valid_loader)
    after = dict(model.net.named_parameters())
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    live = trainer.train_state.net.state_dict()
    handed_back = all(torch.equal(v, live[k]) for k, v in model.net.state_dict().items())
    print(f"[14c] resnet50 (10 classes) Trainer.train, imagenet_resnet50 regime (bf16), imagenet_train / imagenet_val "
          f"over {10 * 20} + {10 * 4} PNGs of {len(IMAGENET_SIZES)} sizes (written in {write_seconds:.1f} s), "
          f"{workers} workers: 2 epochs x {len(train_loader)} steps of 64 in {train_seconds:.1f} s; step losses "
          f"{[round(v, 4) for v in recorder.losses]}; validation {json.dumps(trainer.valid_metrics_history)}; "
          f"parameters unchanged {len(unchanged)} of {len(before)}; weights handed back {handed_back}")
    check(len(recorder.losses) == 2 * len(train_loader) and all(np.isfinite(recorder.losses)),
          f"imagenet regime step losses {recorder.losses}")
    check(not unchanged, f"parameters the training left unchanged: {unchanged[:5]}")
    check(handed_back, "the trained weights were not handed back to the model")
    check(len(trainer.valid_metrics_history) == 2 and all(set(v) == {"Accuracy", "Top5", "Loss"}
                                                          for v in trainer.valid_metrics_history),
          f"imagenet regime validation {trainer.valid_metrics_history}")
    del trainer, before, after, live

    for b in (128, 256):
        step = Trainer("chip_smoke_cls_timing").prepare(model, tp, steps_per_epoch=100)
        images = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(b)).cuda()
        images = images.contiguous(memory_format=torch.channels_last)
        targets = torch.randint(0, 10, (b,), generator=torch.Generator().manual_seed(b + 1)).cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run(events=None):
            marks = [lambda: None] * 5 if events is None else [e.record for e in events]
            marks[0]()
            out = step.forward(images)
            marks[1]()
            loss, _ = step.loss(out, targets)
            marks[2]()
            step.backward(loss)
            marks[3]()
            step.update()
            marks[4]()
            return loss

        for _ in range(3):
            run()
        iters = 10
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
        for ev in events:
            run(ev)
        torch.cuda.synchronize()
        parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
        step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
        prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
        loss = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), f"resnet50 b{b} bf16 train loss not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[14c] resnet50 bf16 train step b{b} at 224: {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.1f} img/s "
              f"(CUDA events); forward {parts[0]:.2f}, loss {parts[1]:.2f}, backward {parts[2]:.2f}, optimizer "
              f"{parts[3]:.2f} ms; profiled (device activity only): wall {wall_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak memory {peak:.2f} GiB")
        del step, images, targets, loss, prof_events
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()


def phase_classification_recipe(torch, np, root):
    """(d) train_from_recipe of cifar10_resnet on class-separable CIFAR pickles with the
    JAX package's test overrides, in fp32 with TF32 off and cuDNN's deterministic
    algorithms (reproducible from the seed), from model seed 0 and again from seeds 1-5.
    The cut is chaotic (one seed lands on another best Accuracy with another thread count
    or TF32 setting, in the JAX package too, whose own test misses the floor from several
    seeds: PERF.md section 6), so one run's best Accuracy is a draw: the floor of 0.90
    holds for the best of the six runs, and each run's best is printed. On the seed-0 run, evaluate_checkpoint(ckpt_best) is
    within 1e-6 of a direct Trainer.evaluate (a planted fault beyond it), and
    resume_experiment takes no step."""
    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer
    from tools.cifar10_floor_seeds import write_separable_cifar

    write_separable_cifar(root)
    ckpt_root = os.path.join(root, "ckpt")
    overrides = [f"ckpt_root_dir={ckpt_root}", "epochs=5", "lr=0.01", "batch_size=32", "val_batch_size=128",
                 f"dataset_params.train_dataset_params.root={root}", f"dataset_params.val_dataset_params.root={root}",
                 "training_hyperparams.lr_warmup_epochs=0", "training_hyperparams.average_best_models=False",
                 "training_hyperparams.sg_logger_params.tensorboard=False"]
    cfg = config.load_recipe("cifar10_resnet", overrides=overrides)
    settings = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        _, trainer = train_from_recipe.main(["--config-name", "cifar10_resnet", *overrides])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        best = float(trainer.best_metric)
        print(f"[14d] train_from_recipe cifar10_resnet (resnet18_cifar, 32x32, fp32, TF32 off, cuDNN deterministic) on "
              f"640 + 128 class-separable CIFAR images, overrides {overrides[1:6]}: {trainer.train_state.step} steps in "
              f"{seconds:.1f} s; losses {[round(v, 4) for v in trainer.train_loss_history]}; validation Accuracy "
              f"{[round(v['Accuracy'], 4) for v in trainer.valid_metrics_history]}; best {best:.4f} "
              f"(floor {CLS_ACCURACY_FLOOR})")
        spread = [max(v["Accuracy"] for v in trainer.valid_metrics_history)]
        original_get = models.get
        for seed in range(1, 6):
            models.get = lambda *a, seed=seed, **k: original_get(*a, **dict(k, seed=seed))
            try:
                _, other = train_from_recipe.main(["--config-name", "cifar10_resnet", *overrides,
                                                   f"ckpt_root_dir={ckpt_root}_seed{seed}",
                                                   "training_hyperparams.save_model=False"])
            finally:
                models.get = original_get
            spread.append(max(v["Accuracy"] for v in other.valid_metrics_history))
            del other
        print(f"[14d] the same run from model seeds 0-5: best Accuracy {[round(a, 4) for a in spread]}; "
              f"{sum(a >= CLS_ACCURACY_FLOOR for a in spread)} of 6 at the floor ({CLS_ACCURACY_FLOOR}) or above")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = settings
    check(max(spread) >= CLS_ACCURACY_FLOOR, f"cifar10_resnet best Accuracy of six runs {spread} < {CLS_ACCURACY_FLOOR}")
    check(all(np.isfinite(trainer.train_loss_history)), f"cifar10_resnet losses {trainer.train_loss_history}")

    experiment = cfg["experiment_name"]
    check_evaluate_checkpoint(torch, cfg, experiment, trainer.ckpt_dir, ckpt_root, "14d", fault="bn")
    step_before = trainer.train_state.step
    _, resumed = Trainer.resume_experiment(experiment, ckpt_root_dir=ckpt_root)
    print(f"[14d] resume_experiment: {len(resumed.train_loss_history)} epochs run, "
          f"{resumed.train_state.step} optimizer steps counted (the run had {step_before})")
    check(resumed.train_loss_history == [] and resumed.train_state.step == step_before,
          "resume_experiment of a finished cifar10_resnet run took a step")
    del trainer, resumed
    torch.cuda.empty_cache()


SEG_MODELS = (("pp_lite_t_seg50", "DiceCEEdgeLoss", 8), ("stdc1_seg50", "STDCLoss", 16))  # model, loss, step batch
SEG_AGREEMENT = 0.999  # least share of pixels whose class the card and the CPU agree on in phase 15(a)
SEG_RECIPES = ("cityscapes_pplite_seg50", "cityscapes_stdc_base")


def seg_request(np, seed):
    """Four 1024x2048 uint8 images (Cityscapes' size) from ``seed``."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (1024, 2048, 3), dtype=np.uint8) for _ in range(4)]


def phase_segmentation(torch, np, nms_exact, root):
    """Segmentation at Seg50's size, 19 classes: (a) fp32 predict GPU vs CPU for PP-LiteSeg-T
    and STDC1-Seg, (b) predict latency and the fp32 forward's throughput, (c) the bf16 train
    step by part, (d) train_from_recipe of the two Cityscapes recipes on a Cityscapes-layout
    tree written here. Launches no kernel (K1 must count 0)."""
    launches_before = nms_exact.exact_nms_keep.launches
    t_phase = time.perf_counter()
    for name, loss, batch in SEG_MODELS:
        phase_segmentation_predict(torch, np, name)
        print(f"[15a-b] {name} seconds {time.perf_counter() - t_phase:.1f}")
        phase_segmentation_step(torch, np, name, loss, batch)
        print(f"[15c] {name} seconds {time.perf_counter() - t_phase:.1f}")
    phase_segmentation_recipes(torch, np, root)
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 15 launched K1 {launched} times; segmentation has no NMS")
    print(f"[15] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 15: {launched}")


def phase_segmentation_predict(torch, np, name):
    """(a) fp32 predict (TF32 off) of four 1024x2048 images and a PIL image on the card and on
    the CPU: class maps agree on >= SEG_AGREEMENT of the pixels; the card's logits (first two
    images) within twice the CPU's distance to an fp64 CPU run. (b) predict() latency and
    its preprocessing alone, and the fp32 forward at b8 / b16."""
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models.sg_model import SegmentationModel

    model = models.get(name, seed=0, device="cuda")
    cpu_model = models.get(name, seed=0, device="cpu")
    check(isinstance(model, SegmentationModel) and model.num_classes == 19, f"{name} is not a 19-class segmenter")
    images = seg_request(np, 31)
    pil_image = Image.fromarray(seg_request(np, 32)[0])
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = list(model.predict(images)) + list(model.predict(pil_image))
        _, batches, _ = model._prep_host_batches(images[:2], 2)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            g_logits = model._deploy_net(False, False)(x.cuda()).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    cpu = list(cpu_model.predict(images)) + list(cpu_model.predict(pil_image))
    with torch.inference_mode():
        c_logits = cpu_model.net(x).double()
        r_logits = copy.deepcopy(cpu_model.net).double()(x.double())
    agree = [float((g.segmentation_map == c.segmentation_map).mean()) for g, c in zip(gpu, cpu)]
    e_gpu, e_cpu = float((g_logits - r_logits).abs().max()), float((c_logits - r_logits).abs().max())
    top2 = r_logits.topk(2, dim=1).values
    print(f"[15a] {name} 19 classes at 512x1024, fp32 predict GPU vs CPU (TF32 off), four 1024x2048 images + a PIL "
          f"image: maps {[g.segmentation_map.shape for g in gpu][0]} {gpu[0].segmentation_map.dtype}, pixels agreeing "
          f"{[round(a, 6) for a in agree]} (limit {SEG_AGREEMENT}); classes used {len(np.unique(gpu[0].segmentation_map))}; "
          f"logits |GPU - fp64| max {e_gpu:.3e}, |CPU - fp64| max {e_cpu:.3e} (|logit| max "
          f"{float(r_logits.abs().max()):.2f}, top-2 gap median {float((top2[:, 0] - top2[:, 1]).median()):.3f})")
    check(len(gpu) == 5 and all(g.segmentation_map.shape == (1024, 2048) for g in gpu), "segmentation maps' shape")
    check(min(agree) >= SEG_AGREEMENT, f"{name}: GPU and CPU maps agree on {agree} of the pixels")
    check(e_gpu <= 2 * e_cpu + 1e-6 * float(r_logits.abs().max()), f"{name}: GPU logits {e_gpu} vs CPU {e_cpu} from fp64")
    del cpu_model, cpu, c_logits, r_logits, g_logits

    tf32 = f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32}"
    model.predict(images)
    request_ms, prep_ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        model.predict(images)
        request_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        model._prep_host_batches(images, 4, pad_last=True)
        prep_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"[15b] {name} predict() of four 1024x2048 images (one batch of 4): median {np.median(request_ms):.2f} ms "
          f"(host clock, 10 runs; {tf32}); host preprocessing alone median {np.median(prep_ms):.2f} ms")
    net = model._deploy_net(False, False)
    for b in (8, 16):
        batch = torch.randn((b, 3, 512, 1024), generator=torch.Generator().manual_seed(b)).cuda()
        batch = batch.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            call = lambda: net(batch)  # noqa: E731
            ms = cuda_ms(call, iters=10)
            events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[15b] {name} fp32 forward b{b} at 512x1024 ({tf32}, channels_last): {ms:.2f} ms a batch (CUDA events), "
              f"{b * 1e3 / ms:.1f} img/s; profiled: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        del batch, events
    del model, net
    torch.cuda.empty_cache()


def phase_segmentation_step(torch, np, name, loss, b, hw=(512, 1024), arch_params=None,
                            criterion_params=None, tag="15c", num_classes=19, training_params=None):
    """(c) The bf16 train step at ``hw`` by part (the Cityscapes recipes' SGD, momentum 0.9,
    weight decay 5e-4 off bias and BN, exp EMA, or ``training_params``), with its idle share and
    peak memory; and the OHEM sort of one head's b x H x W pixel losses alone."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training import Trainer

    loss_name = loss
    h, w = hw
    model = models.get(name, num_classes=num_classes, seed=0, arch_params=arch_params, device="cuda")
    criterion_params = criterion_params or {"num_classes": 19, "ignore_index": 255}
    tp = training_params or dict(
        optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 5e-4}, zero_weight_decay_on_bias_and_bn=True,
        initial_lr=0.01, lr_mode="PolyLRScheduler", max_epochs=2, ema=True,
        ema_params={"decay": 0.9999, "beta": 15, "decay_type": "exp"})
    tp = dict(tp, loss=loss_name, criterion_params=criterion_params, mixed_precision=True)
    step = Trainer("chip_smoke_seg_timing").prepare(model, tp, steps_per_epoch=100)
    gen = torch.Generator().manual_seed(b)
    images = torch.rand((b, 3, h, w), generator=gen).cuda().contiguous(memory_format=torch.channels_last)
    targets = torch.randint(0, num_classes, (b, h, w), generator=gen, dtype=torch.int32)
    targets[torch.rand((b, h, w), generator=gen) < 0.1] = 255
    targets = targets.cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(events=None):
        marks = [lambda: None] * 5 if events is None else [e.record for e in events]
        marks[0]()
        out = step.forward(images)
        marks[1]()
        loss, _ = step.loss(out, targets)
        marks[2]()
        step.backward(loss)
        marks[3]()
        step.update()
        marks[4]()
        return loss

    for _ in range(3):
        run()
    iters = 10
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
    for ev in events:
        run(ev)
    torch.cuda.synchronize()
    parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
    step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
    prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
    busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
    loss = run()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"{name} b{b} bf16 train loss not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    pixel_losses = torch.rand(b * h * w, generator=gen).cuda()
    sort_ms = cuda_ms(lambda: torch.sort(pixel_losses, descending=True), iters=10)
    kernels = sorted(prof_events, key=lambda e: -_self_device_us(e))
    top = ", ".join(f"{e.key[:60]} x{e.count // 5} {_self_device_us(e) / 5e3:.2f} ms" for e in kernels[:6])
    print(f"[{tag}] {name}{' with ' + json.dumps(arch_params) if arch_params else ''} + {loss_name} bf16 train step "
          f"b{b} at {h}x{w}: {step_ms:.2f} ms/step, "
          f"{b * 1e3 / step_ms:.1f} img/s (CUDA events); forward {parts[0]:.2f}, loss {parts[1]:.2f}, backward "
          f"{parts[2]:.2f}, optimizer + EMA {parts[3]:.2f} ms; profiled (device activity only): wall {wall_ms:.2f} "
          f"ms/step, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak memory {peak:.2f} GiB; "
          f"OHEM's descending sort of {b * h * w} pixel losses alone {sort_ms:.3f} ms (one per OHEM head); device "
          f"time by kernel a step, top 6 of {len(kernels)} kinds: {top}")
    del step, images, targets, loss, prof_events, model, pixel_losses
    torch.cuda.empty_cache()


def phase_segmentation_recipes(torch, np, root):
    """(d) train_from_recipe of cityscapes_pplite_seg50 and cityscapes_stdc_base (their own
    batches, 8 and 16, 8 workers, bf16, 2 epochs) on a Cityscapes-layout tree of 16 train and
    8 val 1024x2048 PNGs over two cities written here; evaluate_checkpoint within 1e-6 of a
    direct Trainer.evaluate (a planted fault, a fresh model's BN statistics, beyond it);
    resume_experiment takes no step."""
    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer, dataloaders
    from tools.cityscapes_synthetic import write_cityscapes_tree

    data_root, ckpt_root = os.path.join(root, "cityscapes"), os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    write_cityscapes_tree(data_root, train=16, val=8, height=1024, width=2048, seed=0)
    print(f"[15d] Cityscapes-layout tree (16 train + 8 val 1024x2048 PNGs, 2 cities, every trainId and void) written "
          f"in {time.perf_counter() - t0:.1f} s")
    workers = min(8, os.cpu_count())
    for recipe in SEG_RECIPES:
        cuts = ["epochs=2", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}", "training_hyperparams.mixed_precision=True",
                f"dataset_params.train_dataset_params.root={data_root}",
                f"dataset_params.val_dataset_params.root={data_root}",
                "training_hyperparams.sg_logger_params.tensorboard=False"]
        cfg = config.load_recipe(recipe, overrides=cuts)
        timed = {}
        original_get = dataloaders.get

        def timed_get(name=None, **kw):
            loader = original_get(name, **kw)
            if name == cfg["train_dataloader"]:
                loader = timed.setdefault("train", TimedLoader(loader, profile_epoch=1))
            return loader

        initial = {k: v.detach().clone() for k, v in models.get(cfg["architecture"], num_classes=19).net.named_parameters()}
        dataloaders.get = timed_get
        t0 = time.perf_counter()
        try:
            _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        finally:
            dataloaders.get = original_get
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        live = dict(trainer.train_state.net.named_parameters())
        unchanged = [k for k, v in initial.items() if torch.equal(v, live[k])]
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        loader = timed["train"]
        print(f"[15d] train_from_recipe {recipe} ({cfg['architecture']}, {cfg['training_hyperparams']['loss']}, "
              f"b{loader.batch_size}, bf16, {workers} workers, cuts {cuts[:2]}): {trainer.train_state.step} steps in "
              f"{seconds:.1f} s; losses {history}; validation {json.dumps(valid)}; parameters unchanged "
              f"{len(unchanged)} of {len(initial)}; {loader.batch_bytes} bytes a batch to the card (float32 images + "
              f"int32 masks); epoch 2: loader waits {[round(w, 3) for w in loader.epochs[1][1]]} s, device busy "
              f"{loader.busy_ms:.2f} of {loader.window_ms:.2f} ms")
        check(len(history) == 2 and all(np.isfinite(history)), f"{recipe} train losses {history}")
        check(len(valid) == 2 and all(set(v) == {"PixelAccuracy", "IoU", "Loss"} and np.isfinite(list(v.values())).all()
                                      for v in valid), f"{recipe} validation results {valid}")
        check(not unchanged, f"{recipe}: parameters the training left unchanged: {unchanged[:5]}")

        # the planted fault: a fresh model's BN statistics (the live weights would not do: after
        # one step the EMA equals them, its first decay being 0)
        check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], trainer.ckpt_dir, ckpt_root, "15d", fault="bn")
        step_before = trainer.train_state.step
        _, resumed = Trainer.resume_experiment(cfg["experiment_name"], ckpt_root_dir=ckpt_root)
        check(resumed.train_loss_history == [] and resumed.train_state.step == step_before,
              f"resume_experiment of a finished {recipe} run took a step")
        close_loader(loader.loader)
        del trainer, resumed, initial, live
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 16: PP-YOLOE and YOLOX

ZOO_MODELS = ("ppyoloe_s", "yolox_s")
# The random init gives PP-YOLOE zero prediction kernels (every anchor scores 0.01, every box
# alike) and YOLOX a heavy-tailed head whose scores saturate at 1.0 in fp32, whose raw size
# regression reaches the exp clip, and whose best scores sit on the letterbox's grey padding,
# where every anchor sees the same input (boxes clipped to zero area, equal scores): exact
# ties and degenerate boxes, which leave a GPU / CPU comparison to rounding. So 16a redraws the
# prediction kernels from a seeded normal: PP-YOLOE's scaled to outputs of these standard
# deviations on noise, class biases at 0 ...
ZOO_HEAD_STD = {"pred_cls": 2.0, "pred_reg": 2.0}
# ... YOLOX's scaled on phase 3's letterboxed request: the class and objectness logits to this
# standard deviation about the prior, each channel's sign chosen so the letterbox grey (114)
# scores below its mean (background, as in a trained detector); the size regression to a
# largest |value| of 2 (sizes within exp(+-2) strides)
ZOO_YOLOX_SPREAD = {"cls_preds": 1.5, "obj_preds": 1.5, "reg_preds": 2.0}
# 16a's score threshold (the predict default)
ZOO_CONF = {"ppyoloe_s": 0.25, "yolox_s": 0.25}
# |fused - unfused| fp32 forward on the card (TF32 off), scores and boxes (px): the re-parameterized
# RepVGG sums its branches in another order; the detection sets at the 300 cap differ by a few
# boxes ranked near the cap, so 16a prints their matched fraction and gates the forward
ZOO_FUSE_TOL = (1e-3, 0.1)
# super_gradients_tpu/recipes/coco2017_yolox.yaml and coco2017_ppyoloe_s.yaml, bf16
COCO_YOLOX = dict(
    initial_lr=0.02, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.05, lr_warmup_epochs=0,
    zero_weight_decay_on_bias_and_bn=True, loss="YoloXDetectionLoss",
    criterion_params={"num_classes": 80, "strides": [8, 16, 32]}, optimizer="SGD",
    optimizer_params={"momentum": 0.9, "weight_decay": 5e-4, "nesterov": True}, ema=True, mixed_precision=True,
    metric_to_watch="mAP@0.50:0.95", valid_metrics_list=[{"DetectionMetrics": {"num_cls": 80, "nms_mode": "exact"}}],
)
COCO_PPYOLOE = dict(
    warmup_mode="LinearBatchLRWarmup", warmup_initial_lr=1e-6, lr_warmup_steps=1000, initial_lr=2e-3,
    lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, zero_weight_decay_on_bias_and_bn=False,
    loss="PPYoloELoss", criterion_params={"num_classes": 80, "use_static_assigner": True}, optimizer="AdamW",
    optimizer_params={"weight_decay": 1e-4}, ema=True, ema_params={"decay": 0.9997, "decay_type": "threshold"},
    mixed_precision=True, metric_to_watch="mAP@0.50:0.95",
    valid_metrics_list=[{"DetectionMetrics": {"num_cls": 80, "nms_mode": "exact"}}],
)


def spread_zoo_head(torch, np, model):
    """Redraw the prediction convs' kernels from a seeded normal and scale them on the card:
    PP-YOLOE's to ``ZOO_HEAD_STD`` on noise (class biases at 0), YOLOX's to ``ZOO_YOLOX_SPREAD``
    on phase 3's letterboxed 4-image request, the letterbox grey below each channel's mean."""
    from super_gradients_tpu_torch.models.detection.yolo_nas import CLS_PRIOR_BIAS

    gen = torch.Generator().manual_seed(0)
    spread = ZOO_HEAD_STD if model.name.startswith("ppyoloe") else ZOO_YOLOX_SPREAD
    convs = {k: m for k, m in model.net.named_modules()
             if isinstance(m, torch.nn.Conv2d) and len(k.split(".")) > 1 and k.split(".")[-2] in spread}
    check(len(convs) in (6, 9), f"{model.name}: {len(convs)} prediction convs")
    fields = {"pred_cls": "cls_logits", "pred_reg": "reg_distri", "cls_preds": "cls_logits",
              "obj_preds": "obj_logits", "reg_preds": "reg_raw"}
    with torch.no_grad():
        for k, m in convs.items():
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
            if k.split(".")[-2] == "pred_cls":
                m.bias.zero_()
        if spread is ZOO_HEAD_STD:
            out = model.net(torch.rand((2, 3, 640, 640), generator=torch.Generator().manual_seed(9)).to(model.device))
            for k, m in convs.items():
                kind = k.split(".")[-2]
                m.weight.mul_(spread[kind] / float(getattr(out, fields[kind]).float().std()))
            return model
        for m in convs.values():
            m.bias.zero_()
        _, batches, _ = model._prep_host_batches(request_images(np, 3), 8)
        out = model.net(torch.from_numpy(batches[0]).permute(0, 3, 1, 2).to(model.device))
        grey = model.net(torch.full((1, 3, 640, 640), 114 / 255.0, device=model.device))
        starts = np.cumsum((0,) + out.num_anchors_list)
        for kind in spread:
            value, background = getattr(out, fields[kind]), getattr(grey, fields[kind])
            level_convs = [m for k, m in convs.items() if k.split(".")[-2] == kind]
            if kind == "reg_preds":
                for m in level_convs:
                    m.weight.mul_(spread[kind] / float(value.abs().max()))
                continue
            # per level and channel: the mean over the request, and the side the grey lies on
            stats = []
            for m, a, n in zip(level_convs, starts, out.num_anchors_list):
                v = value[:, a:a + n].reshape(-1, m.out_channels)
                mean, g = v.mean(0), background[0, a + n // 2 + int(n ** 0.5) // 2].reshape(-1)
                stats.append((m, v, mean, torch.where(g > mean, -1.0, 1.0)))
            std = float(torch.cat([((v - mean) * sign).flatten() for _, v, mean, sign in stats]).std())
            for m, _, mean, sign in stats:
                scale = sign * spread[kind] / std
                m.weight.mul_(scale[:, None, None, None])
                m.bias.copy_(CLS_PRIOR_BIAS - scale * mean)
    return model


def zoo_pair(torch, np, models, name):
    """(card model, CPU model) of ``name`` at 640, 80 classes, seed 0, the same spread head."""
    model = spread_zoo_head(torch, np, models.get(name, num_classes=80, seed=0, device="cuda"))
    cpu_model = models.get(name, num_classes=80, seed=0, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    return model, cpu_model


def phase_zoo(torch, np, nms_exact, matched_fraction, root):
    """Phase 16: PP-YOLOE-S and YOLOX-S at 640 (published widths and depths, 80 classes, seed 0,
    the spread head). Returns (K1 launches on the main paths, the largest K1-vs-plain difference)."""
    t_phase = time.perf_counter()
    launches, max_err = 0, 0.0
    for name in ZOO_MODELS:
        n, err = phase_zoo_predict(torch, np, nms_exact, matched_fraction, name)
        launches, max_err = launches + n, max(max_err, err)
        print(f"[16a-c] {name} seconds {time.perf_counter() - t_phase:.1f}")
    n, err = phase_zoo_sliding_window(torch, np, nms_exact, matched_fraction)
    launches, max_err = launches + n, max(max_err, err)
    print(f"[16d] seconds {time.perf_counter() - t_phase:.1f}")
    phase_zoo_train(torch, np)
    print(f"[16e] seconds {time.perf_counter() - t_phase:.1f}")
    launches += phase_zoo_recipes(torch, np, nms_exact, root)
    print(f"[16] K1 launches in phase 16's main paths: {launches}; phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, max_err


def phase_zoo_predict(torch, np, nms_exact, matched_fraction, name):
    """(a) fp32 predict() on the card against the CPU (and PP-YOLOE fused against unfused),
    (b) fused bf16 predict_batch_tensor timing, (c) K1 on the captured candidates."""
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models import sg_model
    from super_gradients_tpu_torch.ops import nms as nms_module

    model, cpu_model = zoo_pair(torch, np, models, name)
    logits = name.startswith("ppyoloe")
    images = request_images(np, 3)
    pil_image = Image.fromarray(request_images(np, 5)[1])
    kw = dict(bf16=False, fuse_model=False, nms_mode="exact", conf=ZOO_CONF[name])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nms_exact.exact_nms_keep.launches = 0
    try:
        gpu = list(model.predict(images, **kw)) + list(model.predict(pil_image, **kw))
        launches = nms_exact.exact_nms_keep.launches
        cpu = list(cpu_model.predict(images, **kw)) + list(cpu_model.predict(pil_image, **kw))
        fused = list(model.predict(images, **dict(kw, fuse_model=True))) if logits else gpu
        with torch.inference_mode():  # the RepVGG re-parameterization on the card's forward
            x = torch.rand((2, 3, 640, 640), generator=torch.Generator().manual_seed(6)).cuda()
            unfused_out, fused_out = model.net(x), model.fuse().net(x)
        fuse_errs = [float((getattr(fused_out, f) - getattr(unfused_out, f)).abs().max())
                     for f in ("pred_scores", "pred_bboxes")]
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    check(launches == 2, f"{name} predict launched K1 {launches} times, expected one a batch (2)")
    check_predictions(np, gpu, 5, f"{name} fp32 predict")
    fractions = [matched_fraction(g, c, 0.99) for g, c in zip(gpu, cpu)]
    fused_fractions = [matched_fraction(f, g, 0.99) for f, g in zip(fused, gpu)]
    print(f"[16a] {name} 640 fp32 predict GPU vs CPU (TF32 off, exact NMS, conf {ZOO_CONF[name]}), 4-image request + a "
          f"PIL image: "
          f"detections {[len(g) for g in gpu]} vs {[len(c) for c in cpu]}; matched fractions at IoU 0.99 "
          f"{[round(f, 4) for f in fractions]}; fused vs unfused on the card: forward |difference| max "
          f"{fuse_errs[0]:.3g} (scores), {fuse_errs[1]:.3g} px (boxes), predictions matched "
          f"{[round(f, 4) for f in fused_fractions]}; K1 launches {launches}")
    check(min(fractions) >= 0.99, f"{name} predict GPU vs CPU matched fractions {fractions}")
    check(fuse_errs[0] <= ZOO_FUSE_TOL[0] and fuse_errs[1] <= ZOO_FUSE_TOL[1],
          f"{name} fused forward differs from the unfused one by {fuse_errs}")
    del cpu, cpu_model

    max_err = 0.0
    for b in (8, 32):
        batch = torch.rand((b, 640, 640, 3), generator=torch.Generator().manual_seed(3)).cuda()
        call = lambda: model.predict_batch_tensor(batch)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            out = call()
        out.num_detections.cpu()
        dt = time.perf_counter() - t0
        net = model._deploy_net(True, True)
        x = batch.to(torch.bfloat16).permute(0, 3, 1, 2)
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: net(x), iters=10)
            o = net(x)
            nms_call = lambda: nms_module.batched_nms(  # noqa: E731
                o.pred_bboxes, o.cls_logits if logits else o.pred_scores, score_threshold=0.25, iou_threshold=0.7,
                nms_top_k=1024, max_predictions=300, mode="exact", scores_are_logits=logits)
            nms_ms = cuda_ms(nms_call, iters=20)
        events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[16b] {name} fused bf16 predict_batch_tensor b{b}: {b * iters / dt:.1f} img/s ({1e3 * dt / iters:.2f} "
              f"ms/batch, host clock); forward {forward_ms:.2f} ms, batched_nms {nms_ms:.4f} ms (CUDA events); "
              f"profiled: wall {wall_ms:.2f} ms a batch, device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        nms_args, nms_kwargs = capture_call(sg_model, "batched_nms", call)
        check(nms_kwargs["scores_are_logits"] is logits, f"{name}: NMS on the wrong score map")
        with torch.inference_mode():
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep",
                                                lambda: nms_module.batched_nms(*nms_args, **nms_kwargs))
            max_err = max(max_err, check_k1_equal(torch, nms_exact, f"{name} candidates b{b}", boxes, valid, t))
            n_kept = nms_exact.exact_nms_keep(boxes, valid, t).sum(dim=1)
            print(f"[16c] {name} b{b} candidates ({'logits' if logits else 'probability scores'}): K={boxes.shape[1]}, "
                  f"valid per image {valid.sum(dim=1).tolist()}, kept per image {n_kept.tolist()}; K1 bit-equal to "
                  f"the plain version")
            time_k1(torch, nms_exact, f"{name} b{b} candidates", boxes, valid, t, phase="16c")
        del batch, out, o, boxes, valid, nms_args, nms_kwargs
    del model
    torch.cuda.empty_cache()
    return launches, max_err


def phase_zoo_sliding_window(torch, np, nms_exact, matched_fraction):
    """(d) SlidingWindowInferenceDetectionWrapper (tile 640, step 512) over YOLO-NAS-M and
    PP-YOLOE-S on a seeded 1080x1920 image, GPU against CPU (fp32, TF32 off), one K1 launch an
    image, timed; then the JAX-equal TypeError of SlidingWindowValidationCallback."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.inference.prediction_results import DetectionPrediction
    from super_gradients_tpu_torch.inference import sliding_window
    from super_gradients_tpu_torch.ops import nms as nms_module
    from super_gradients_tpu_torch.training import callbacks

    image = torch.rand((1080, 1920, 3), generator=torch.Generator().manual_seed(16))
    image_gpu = image.cuda()
    SlidingWindowInferenceDetectionWrapper = sliding_window.SlidingWindowInferenceDetectionWrapper
    compute_tile_origins = sliding_window.compute_tile_origins
    tiles = compute_tile_origins((1080, 1920), (640, 640), (512, 512))
    check(len(tiles) == 8, f"{len(tiles)} tiles of a 1080x1920 image")
    launches, max_err = 0, 0.0
    for name in ("yolo_nas_m", "ppyoloe_s"):
        if name == "yolo_nas_m":
            model = zero_cls_bias(models.get(name, num_classes=80, seed=0, device="cuda"))
            cpu_model = zero_cls_bias(models.get(name, num_classes=80, seed=0, device="cpu"))
        else:
            model, cpu_model = zoo_pair(torch, np, models, name)
        wrapper, cpu_wrapper = (SlidingWindowInferenceDetectionWrapper(m) for m in (model, cpu_model))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        nms_exact.exact_nms_keep.launches = 0
        try:
            got = wrapper.predict_image_tensor(image_gpu, bf16=False)
            n = nms_exact.exact_nms_keep.launches
            ref = cpu_wrapper.predict_image_tensor(image, bf16=False)
        finally:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        check(n == 1, f"sliding window over {name} launched K1 {n} times, expected 1")
        launches += n

        def as_set(out):
            k = int(out.num_detections[0])
            return DetectionPrediction(bboxes_xyxy=out.boxes[0, :k].cpu().numpy(),
                                       confidence=out.scores[0, :k].cpu().numpy(), labels=out.labels[0, :k].cpu().numpy())

        g, c = as_set(got), as_set(ref)
        frac = matched_fraction(g, c, 0.99)
        check(len(g.labels) > 0 and frac >= 0.99, f"sliding window {name} GPU vs CPU: {frac} matched")
        call = lambda: wrapper.predict_image_tensor(image_gpu)  # noqa: E731
        whole_ms = cuda_ms(call, iters=5)
        nms_args, nms_kwargs = capture_call(sliding_window, "batched_nms", call)
        with torch.inference_mode():
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep",
                                                lambda: nms_module.batched_nms(*nms_args, **nms_kwargs))
            max_err = max(max_err, check_k1_equal(torch, nms_exact, f"sliding window {name}", boxes, valid, t))
            nms_ms = cuda_ms(lambda: nms_module.batched_nms(*nms_args, **nms_kwargs), iters=10)
            k1 = time_k1(torch, nms_exact, f"sliding window {name} candidates", boxes, valid, t, phase="16d")
        print(f"[16d] {name} sliding window 1080x1920, {len(tiles)} tiles of 640 (step 512), {nms_args[0].shape[1]} "
              f"anchors into one batched_nms: fp32 GPU vs CPU {len(g.labels)} vs {len(c.labels)} detections, "
              f"{frac:.4f} matched at IoU 0.99; K1 launches {n}; bf16 predict_image_tensor {whole_ms:.2f} ms, its "
              f"batched_nms {nms_ms:.4f} ms, K1 {k1['ms']:.4f} ms (CUDA events), valid candidates "
              f"{int(valid.sum())} of {valid.shape[1]}")
        if name == "yolo_nas_m":
            batch = (torch.rand((2, 3, 640, 640), generator=torch.Generator().manual_seed(17)) * 255).to(torch.uint8)
            ctx = callbacks.PhaseContext(model=model, valid_loader=[(batch, torch.zeros(2, 1, 5))])
            try:
                callbacks.SlidingWindowValidationCallback().on_validation_loader_end(ctx)
            except TypeError as e:
                check(str(e) == "'SlidingWindowInferenceDetectionWrapper' object is not callable", f"TypeError {e}")
                print(f"[16d] SlidingWindowValidationCallback raises the JAX package's TypeError: {e}")
            else:
                check(False, "SlidingWindowValidationCallback ran without the JAX package's TypeError")
        del model, cpu_model, wrapper, cpu_wrapper, boxes, valid, nms_args, nms_kwargs
        torch.cuda.empty_cache()
    return launches, max_err


def phase_zoo_train(torch, np):
    """(e) One fp32 SGD YOLOX-S step at b2 on FP64_STEP_HW images on the card and on the CPU, held
    to an fp64 CPU step (phase 8's rule, the SimOTA assignment compared, then the fp64 one shared);
    the bf16 step at b16 by part for YOLOX-S, and PP-YOLOE-S with ATSS and with TAL."""
    import types

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = models.get("yolox_s", num_classes=80, seed=0, device="cpu")
        dataset = RandomDetectionDataset(num_samples=2, image_size=(FP64_STEP_HW, FP64_STEP_HW), num_classes=80,
                                         max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(2))))
        runs = {}
        for name, device, dtype in (("fp64 CPU", "cpu", torch.float64), ("fp32 CPU", "cpu", torch.float32),
                                    ("fp32 GPU", "cuda", torch.float32)):
            net = copy.deepcopy(cpu_model.net).to(device, dtype)
            m = types.SimpleNamespace(net=net, device=torch.device(device))
            x, t = images.to(device, dtype), targets.to(device, dtype)
            if device == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            runs[name] = _one_step(torch, m, x, t, assign=runs["fp64 CPU"][0] if runs else None, base=COCO_YOLOX)
            del net, m
        fg64, gt64 = runs["fp64 CPU"][0].fg_mask, runs["fp64 CPU"][0].matched_gt
        for name in ("fp32 CPU", "fp32 GPU"):
            own = runs[name][0]
            diff = int((own.fg_mask.cpu() != fg64).sum() + ((own.matched_gt.cpu() != gt64) & fg64).sum())
            print(f"[16e] yolox_s {name}: {diff} anchors with another SimOTA foreground or gt than fp64 CPU "
                  f"({int(fg64.sum())} foreground); all runs take the fp64 assignment")
        ref_comps, ref_grads = runs["fp64 CPU"][1], runs["fp64 CPU"][2]
        for key in ("iou", "obj", "cls", "num_fg", "loss"):
            errs = {name: abs(runs[name][1][key] - ref_comps[key]) for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[16e] yolox_s {key} {ref_comps[key]:.6f} (fp64 CPU): GPU err {errs['fp32 GPU']:.3g}, "
                  f"CPU err {errs['fp32 CPU']:.3g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-6 * abs(ref_comps[key]),
                  f"yolox GPU fp32 {key} more than twice as far from fp64 as the CPU's")
        for group in ("_backbone", "_head", ""):
            keys = [k for k in ref_grads if k.startswith(group)]
            norm = float(sum((ref_grads[k] ** 2).sum() for k in keys) ** 0.5)
            errs = {name: float(sum(((runs[name][2][k] - ref_grads[k]) ** 2).sum() for k in keys) ** 0.5)
                    for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[16e] yolox_s gradients {group or 'all'} (norm {norm:.4g}): GPU L2 err {errs['fp32 GPU']:.4g}, "
                  f"CPU L2 err {errs['fp32 CPU']:.4g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-7 * norm,
                  f"yolox GPU fp32 gradients ({group or 'all'}) more than twice as far from fp64 as the CPU's")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    del runs, cpu_model

    b = 16
    dataset = RandomDetectionDataset(num_samples=b, image_size=(640, 640), num_classes=80, max_boxes=120)
    images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
    images = images.cuda().contiguous(memory_format=torch.channels_last)
    targets = targets.cuda()
    for name, base, assigner in (("yolox_s", COCO_YOLOX, "SimOTA"), ("ppyoloe_s", COCO_PPYOLOE, "ATSS"),
                                 ("ppyoloe_s", dict(COCO_PPYOLOE, criterion_params={"num_classes": 80,
                                                                                    "use_static_assigner": False}),
                                  "TAL")):
        model = models.get(name, num_classes=80, seed=0, device="cuda")
        step = Trainer("chip_smoke_zoo_timing").prepare(model, base, steps_per_epoch=100)

        def run(events=None):
            marks = [lambda: None] * 5 if events is None else [e.record for e in events]
            marks[0]()
            out = step.forward(images)
            marks[1]()
            loss, _ = step.loss(out, targets)
            marks[2]()
            step.backward(loss)
            marks[3]()
            step.update()
            marks[4]()
            return loss

        for _ in range(3):
            run()
        iters = 10
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
        for ev in events:
            run(ev)
        torch.cuda.synchronize()
        parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
        step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
        with torch.no_grad():
            out = step.forward(images)
            assign_ms = cuda_ms(lambda: step.criterion.assign(out, targets), iters=10)
        prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(bool(torch.isfinite(loss)), f"{name} {assigner} b{b} train loss not finite")
        print(f"[16e] {name} ({assigner}) bf16 train step b{b}: {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.1f} img/s "
              f"(CUDA events); forward {parts[0]:.2f}, loss {parts[1]:.2f} (of which the {assigner} assignment "
              f"{assign_ms:.2f}, the losses {parts[1] - assign_ms:.2f}), backward {parts[2]:.2f}, optimizer+EMA "
              f"{parts[3]:.2f} ms; profiled (device activity only): wall {wall_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak memory {peak:.2f} GiB")
        del step, model, loss, out, prof_events
        torch.cuda.empty_cache()
    del images, targets


def write_coco_splits(rf100_root, coco_root):
    """A COCO2017-layout copy of phase 11's train and valid splits."""
    import shutil

    os.makedirs(os.path.join(coco_root, "annotations"))
    for split, coco_split in (("train", "train2017"), ("valid", "val2017")):
        src = os.path.join(rf100_root, "synthetic", split)
        shutil.copytree(src, os.path.join(coco_root, "images", coco_split))
        shutil.copy(os.path.join(src, "_annotations.coco.json"),
                    os.path.join(coco_root, "annotations", f"instances_{coco_split}.json"))


def phase_zoo_recipes(torch, np, nms_exact, root):
    """(f) train_from_recipe of roboflow_yolox and roboflow_ppyoloe on phase 11's dataset (2
    epochs of b16, bf16, 8 workers), both stage switches cut to epoch 1; evaluate_checkpoint
    held to a direct Trainer.evaluate, resume_experiment; then coco2017_train_ppyoloe with
    multiscale over a COCO-layout copy. Returns K1's launches in the two runs."""
    from super_gradients_tpu_torch import train_from_recipe
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer, callbacks, dataloaders
    from super_gradients_tpu_torch.training.losses import PPYoloELoss, YoloXDetectionLoss
    from super_gradients_tpu_torch.training.trainer import _to_device

    data_root, ckpt_root = os.path.join(root, "rf100"), os.path.join(root, "ckpt")
    n_boxes, n_crowd = make_rf100_dataset(np, data_root)
    workers = min(8, os.cpu_count())
    total = 0
    for recipe, switch in (("roboflow_yolox", "YoloXTrainingStageSwitchCallback: {next_stage_start_epoch: 1}"),
                           ("roboflow_ppyoloe", "PPYoloETrainingStageSwitchCallback: {static_assigner_end_epoch: 1}")):
        cuts = [f"dataset_params.train_dataset_params.data_dir={data_root}",
                f"dataset_params.val_dataset_params.data_dir={data_root}", "dataset_name=synthetic", "num_classes=80",
                "epochs=2", "batch_size=16", "val_batch_size=16", f"num_workers={workers}",
                f"ckpt_root_dir={ckpt_root}", "training_hyperparams.mixed_precision=True",
                f"training_hyperparams.phase_callbacks=[{{{switch}}}]"]
        if recipe == "roboflow_ppyoloe":
            cuts.append("training_hyperparams.criterion_params.use_static_assigner=True")
        cfg = config.load_recipe(recipe, overrides=cuts)
        closed, flags = [], []
        close = callbacks._close_multisample_transforms
        calls = {cls: cls.__call__ for cls in (YoloXDetectionLoss, PPYoloELoss)}
        callbacks._close_multisample_transforms = lambda loader: closed.append(close(loader)) or closed[-1]
        YoloXDetectionLoss.__call__ = lambda self, *a: flags.append(self.use_l1) or calls[YoloXDetectionLoss](self, *a)
        PPYoloELoss.__call__ = lambda self, *a: flags.append(self.use_static_assigner) or calls[PPYoloELoss](self, *a)
        nms_exact.exact_nms_keep.launches = 0
        t0 = time.perf_counter()
        try:
            _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        finally:
            callbacks._close_multisample_transforms = close
            for cls, call in calls.items():
                cls.__call__ = call
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = nms_exact.exact_nms_keep.launches
        total += launches
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        check(launches == 2 * 2, f"K1 launched {launches} times in {recipe}, expected one a validation batch (4)")
        check(len(history) == 2 and all(np.isfinite(history)), f"{recipe} train losses {history}")
        check(len(valid) == 2 and all(np.isfinite(list(v.values())).all() for v in valid), f"{recipe} validation {valid}")
        first, last = (True, False) if recipe == "roboflow_ppyoloe" else (False, True)
        check(flags[:4] == [first] * 4 and flags[-1] == last and flags == sorted(flags, reverse=first),
              f"{recipe}: the stage switch did not act at epoch 1 ({flags})")
        if recipe == "roboflow_yolox":
            check(closed == [2] and trainer.training_params["criterion_params"]["use_l1"] is True,
                  f"YOLOX stage switch closed {closed} transforms")
        print(f"[16f] recipe {recipe} ({cfg['architecture']}) through train_from_recipe.main on phase 11's dataset "
              f"(64 train + 32 valid PNGs, {n_boxes} boxes, {n_crowd} iscrowd): 2 epochs x "
              f"{trainer.train_state.step // 2} steps "
              f"of 16 at 640 (bf16), {workers} workers, {seconds:.1f} s; K1 launches {launches}; losses {history}; "
              f"validation {json.dumps(valid)}; the stage switch at epoch 1: "
              f"{'mosaic and mixup closed, use_l1 on' if recipe == 'roboflow_yolox' else 'ATSS -> TAL'} "
              f"(criterion flags by call {flags})")

        _, resumed = Trainer.resume_experiment(recipe, ckpt_root_dir=ckpt_root)
        check(resumed.train_loss_history == [] and resumed.train_state.step == trainer.train_state.step,
              f"{recipe}: resume_experiment took a step")
        print(f"[16f] {recipe} resume_experiment: no step")
        check_evaluate_checkpoint(torch, cfg, recipe, trainer.ckpt_dir, ckpt_root, "16f")
        del trainer, resumed

    coco_root = os.path.join(root, "coco")
    write_coco_splits(data_root, coco_root)
    loader = dataloaders.get("coco2017_train_ppyoloe", dataset_params={"data_dir": coco_root, "batch_size": 16,
                                                                     "multiscale": True})
    shapes = []
    for images, targets in loader:
        on_card, targets = _to_device(images, targets, torch.device("cuda"), loader.max_value)
        check(on_card.dtype == torch.float32 and 0.0 <= float(on_card.min()) and float(on_card.max()) <= 1.0 + 1e-6,
              f"multi-scale batch not in [0, 1]: {float(on_card.min())}, {float(on_card.max())}")
        shapes.append(tuple(on_card.shape))
    check([s[2] for s in shapes] == [512, 544, 576, 608], f"multi-scale sizes {shapes}")
    print(f"[16f] coco2017_train_ppyoloe (multiscale) over a COCO-layout copy of the train split: batches on the card "
          f"{shapes}")
    return total


# ------------------------------------------------------------------ phase 17: MobileNet and SSD

# super_gradients_tpu/recipes/coco2017_ssd_lite_mobilenet_v2.yaml's training_hyperparams, bf16
COCO_SSD = dict(
    initial_lr=0.02, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.01, lr_warmup_epochs=0,
    zero_weight_decay_on_bias_and_bn=True, loss="SSDLoss", criterion_params={"image_size": 320}, optimizer="SGD",
    optimizer_params={"momentum": 0.9, "weight_decay": 4e-5}, ema=True, mixed_precision=True,
    valid_metrics_list=[{"DetectionMetrics_050": {"num_cls": 80, "nms_mode": "exact"}}], metric_to_watch="mAP@0.50",
)
# the BN statistics of 17a's models are set on this many noise images (as tests/test_torch_ssd.py
# sets them): models.get's two-image calibration leaves the lite heads' BNs on the 3x3 and 2x2
# levels 18 and 8 values a channel, which amplifies fp32 rounding between the two devices
SSD_CALIBRATION_IMAGES = 16
# 17a's score thresholds, both gated: the predict default, at which the random-init SSD passes
# ~90% of its 3,234 x 81 (anchor, column) pairs, so the 1,024-candidate and 300-detection caps
# bind; and 0.95, at which ~90-170 candidates an image pass (CPU count on phase 3's request),
# so neither cap binds and every candidate and detection is compared
SSD_CONFS = (0.25, 0.95)


def ssd_pair(torch, models):
    """(card model, CPU model) of SSD-lite-MobileNetV2, 80 classes, 320, seed 0, the same weights
    and BN statistics set on ``SSD_CALIBRATION_IMAGES`` noise images."""
    from super_gradients_tpu_torch.models.model_factory import _calibrate_batch_norm

    cpu_model = models.get("ssd_lite_mobilenet_v2", num_classes=80, seed=0, device="cpu")
    _calibrate_batch_norm(cpu_model.net, torch.Generator().manual_seed(3), (SSD_CALIBRATION_IMAGES, 3, 320, 320))
    model = models.get("ssd_lite_mobilenet_v2", num_classes=80, seed=0, device="cuda")
    model.load_state_dict({k: v.cuda() for k, v in cpu_model.net.state_dict().items()})
    return model, cpu_model


def phase_mobilenet_ssd(torch, np, nms_exact, matched_fraction, root):
    """Phase 17: SSD-lite-MobileNetV2 (80 classes, 320) and MobileNetV3-large (1000 classes,
    224) at full width, seed 0. Returns (K1 launches on the main paths, the largest K1-vs-plain
    difference)."""
    t_phase = time.perf_counter()
    launches, max_err = phase_ssd_predict(torch, np, nms_exact, matched_fraction)
    print(f"[17a-c] seconds {time.perf_counter() - t_phase:.1f}")
    phase_ssd_train(torch, np)
    print(f"[17d] seconds {time.perf_counter() - t_phase:.1f}")
    phase_mobilenet_predict(torch, np, nms_exact)
    print(f"[17e] seconds {time.perf_counter() - t_phase:.1f}")
    launches += phase_ssd_recipe(torch, np, nms_exact, root)
    print(f"[17f] seconds {time.perf_counter() - t_phase:.1f}")
    launches += phase_ssd_pretrained(torch, np, nms_exact, root)
    print(f"[17] K1 launches in phase 17's main paths: {launches}; phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, max_err


def phase_ssd_predict(torch, np, nms_exact, matched_fraction):
    """(a) fp32 predict() GPU vs CPU, (b) K1 on SSD's captured candidates, (c) fused bf16
    predict_batch_tensor timing."""
    from PIL import Image

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models import sg_model
    from super_gradients_tpu_torch.ops import nms as nms_module
    from super_gradients_tpu_torch.ops.bbox import box_iou

    model, cpu_model = ssd_pair(torch, models)
    images = request_images(np, 3)
    pil_image = Image.fromarray(request_images(np, 5)[1])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nms_exact.exact_nms_keep.launches = 0
    gpu, cpu = {}, {}
    try:
        for conf in SSD_CONFS:
            kw = dict(bf16=False, fuse_model=False, nms_mode="exact", conf=conf)
            gpu[conf] = list(model.predict(images, **kw)) + list(model.predict(pil_image, **kw))
            cpu[conf] = list(cpu_model.predict(images, **kw)) + list(cpu_model.predict(pil_image, **kw))
        launches = nms_exact.exact_nms_keep.launches
        _, batches, _ = cpu_model._prep_host_batches(images, 4)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2)
        with torch.inference_mode():
            out, g_logits = cpu_model.net(x), model.net(x.cuda()).cls_logits.cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    check(launches == 4, f"SSD predict launched K1 {launches} times, expected one a batch (4)")
    for conf in SSD_CONFS:
        check_predictions(np, gpu[conf], 5, f"ssd_lite_mobilenet_v2 fp32 predict at conf {conf}")
    high = max(SSD_CONFS)
    check(max(len(g) for g in gpu[high] + cpu[high]) < model._default_max_predictions,
          f"17a's detections at conf {high} reached the cap")
    n_candidates = int((torch.sigmoid(out.cls_logits) > high).sum(dim=(1, 2)).max())
    check(n_candidates < model._default_nms_top_k, f"17a's candidates at conf {high} reached the cap ({n_candidates})")
    # the score of the last candidate that the 1,024 cap keeps, per image of the request
    cap_scores = [torch.sigmoid(lg.flatten(1)).topk(model._default_nms_top_k).values[:, -1].tolist()
                  for lg in (g_logits, out.cls_logits)]
    fractions = {}
    for conf in SSD_CONFS:
        g, c = gpu[conf], cpu[conf]
        fractions[conf] = [matched_fraction(a, b, 0.99) for a, b in zip(g, c)]
        zero_area = [int((np.diff(a.bboxes_xyxy[:, 0::2], axis=1) * np.diff(a.bboxes_xyxy[:, 1::2], axis=1) <= 0).sum())
                     for a in g]
        causes = [(i, "GPU", unmatched_causes(torch, np, box_iou, a, b, 0.99)) for i, (a, b) in enumerate(zip(g, c))]
        causes += [(i, "CPU", unmatched_causes(torch, np, box_iou, b, a, 0.99)) for i, (a, b) in enumerate(zip(g, c))]
        print(f"[17a] ssd_lite_mobilenet_v2 80 classes 320 fp32 predict GPU vs CPU (TF32 off, exact NMS, conf {conf}"
              f"{', the predict default' if conf == model._default_nms_conf else ''}; BN statistics on "
              f"{SSD_CALIBRATION_IMAGES} noise images), 4-image request + a PIL image: detections {[len(a) for a in g]} "
              f"vs {[len(b) for b in c]}; matched fractions at IoU 0.99 {[round(f, 4) for f in fractions[conf]]}; "
              f"zero-area boxes (clipped off the image, matched as the same box) on the card {zero_area}")
        for i, side, rows in causes:
            for row in rows:
                print(f"[17a]   conf {conf}, image {i}: a {side} detection without a partner: {json.dumps(row)}")
    print(f"[17a] at conf {high} at most {n_candidates} candidates an image of the request; the 1,024th "
          f"candidate's score per image of the request: GPU {cap_scores[0]}, CPU {cap_scores[1]}; labels up to "
          f"{max(int(a.labels.max()) for a in gpu[min(SSD_CONFS)])} (the raw confs' sigmoid, background column 0 "
          f"included, as in JAX); raw conf logits std {float(out.cls_logits.std()):.3f}, softmax class probabilities "
          f"max {float(out.pred_scores.max()):.4f}, sigmoid of the logits above 0.99: "
          f"{float((torch.sigmoid(out.cls_logits) > 0.99).float().mean()):.4f}; K1 launches {launches}")
    check(min(min(f) for f in fractions.values()) >= 0.99, f"SSD predict GPU vs CPU matched fractions {fractions}")
    del cpu, cpu_model, out, g_logits

    max_err = 0.0
    for b in (8, 32):
        batch = torch.rand((b, 320, 320, 3), generator=torch.Generator().manual_seed(3)).cuda()
        call = lambda: model.predict_batch_tensor(batch)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            res = call()
        res.num_detections.cpu()
        dt = time.perf_counter() - t0
        net = model._deploy_net(True, True)
        x = batch.to(torch.bfloat16).permute(0, 3, 1, 2)
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: net(x), iters=10)
            o = net(x)
            nms_call = lambda: nms_module.batched_nms(  # noqa: E731
                o.pred_bboxes, o.cls_logits, score_threshold=0.25, iou_threshold=0.7, nms_top_k=1024,
                max_predictions=300, mode="exact", scores_are_logits=True)
            nms_ms = cuda_ms(nms_call, iters=20)
        events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[17c] ssd_lite_mobilenet_v2 fused bf16 predict_batch_tensor b{b} at 320: {b * iters / dt:.1f} img/s "
              f"({1e3 * dt / iters:.2f} ms/batch, host clock); forward {forward_ms:.2f} ms, batched_nms {nms_ms:.4f} ms "
              f"(CUDA events); profiled: wall {wall_ms:.2f} ms a batch, device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        nms_args, nms_kwargs = capture_call(sg_model, "batched_nms", call)
        check(nms_kwargs["scores_are_logits"] is True and nms_args[1].shape[-1] == 81,
              "SSD predict must suppress on the 81 raw conf columns, as the JAX predict program does")
        with torch.inference_mode():
            (boxes, valid, t), _ = capture_call(nms_module, "exact_nms_keep",
                                                lambda: nms_module.batched_nms(*nms_args, **nms_kwargs))
            max_err = max(max_err, check_k1_equal(torch, nms_exact, f"SSD candidates b{b}", boxes, valid, t))
            n_kept = nms_exact.exact_nms_keep(boxes, valid, t).sum(dim=1)
            print(f"[17b] ssd_lite_mobilenet_v2 b{b} candidates (logits, 81 columns): K={boxes.shape[1]}, valid per "
                  f"image {valid.sum(dim=1).tolist()}, kept per image {n_kept.tolist()}; K1 bit-equal to the plain "
                  f"version")
            time_k1(torch, nms_exact, f"ssd_lite_mobilenet_v2 b{b} candidates", boxes, valid, t, phase="17b")
        del batch, res, o, boxes, valid, nms_args, nms_kwargs
    del model
    torch.cuda.empty_cache()
    return launches, max_err


def _ssd_one_step(torch, model, images, targets, fixed=None):
    """Forward, loss and backward of one fp32 SGD SSD step, with the matching and the mined
    negatives of ``fixed`` (another run's) where given; returns this run's own (matching, mined
    negatives), its loss components and its gradients (fp64, on the CPU)."""
    from super_gradients_tpu_torch.training import Trainer

    params = dict(COCO_SSD, ema=False, mixed_precision=False, initial_lr=1e-3)
    step = Trainer("chip_smoke_ssd_fp32").prepare(model, params, steps_per_epoch=1)
    criterion, seen = step.criterion, {}
    match, mine = criterion.match, criterion.hard_negatives

    def fixed_match(t):
        seen["match"] = match(t)
        return seen["match"] if fixed is None else tuple(x.to(t.device) for x in fixed[0])

    def fixed_mine(ce, pos):
        seen["neg"] = mine(ce, seen["match"][0])
        return seen["neg"] if fixed is None else fixed[1].to(ce.device, ce.dtype)

    criterion.match, criterion.hard_negatives = fixed_match, fixed_mine
    loss, comps = step.loss(step.forward(images), targets)
    step.backward(loss)
    grads = {k: p.grad.detach().double().cpu() for k, p in step.state.net.named_parameters() if p.grad is not None}
    comps = {k: float(v.detach()) for k, v in dict(comps, loss=loss).items()}
    return (tuple(x.cpu() for x in seen["match"]), seen["neg"].cpu()), comps, grads


def phase_ssd_train(torch, np):
    """(d) one fp32 SGD SSD-lite step at b2 on the card and on the CPU held to an fp64 CPU step
    (phase 8's rule: the matching and the mined negatives compared, then the fp64 ones shared),
    then the bf16 step at b32 by part with SSDLoss apart, idle share and peak memory."""
    import types

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = models.get("ssd_lite_mobilenet_v2", num_classes=80, seed=0, device="cpu")
        dataset = RandomDetectionDataset(num_samples=2, image_size=(320, 320), num_classes=80, max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(2))))
        runs = {}
        for name, device, dtype in (("fp64 CPU", "cpu", torch.float64), ("fp32 CPU", "cpu", torch.float32),
                                    ("fp32 GPU", "cuda", torch.float32)):
            net = copy.deepcopy(cpu_model.net).to(device, dtype)
            m = types.SimpleNamespace(net=net, device=torch.device(device))
            x, t = images.to(device, dtype), targets.to(device, dtype)
            if device == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            runs[name] = _ssd_one_step(torch, m, x, t, fixed=runs["fp64 CPU"][0] if runs else None)
            del net, m
        (match64, neg64), ref_comps, ref_grads = runs["fp64 CPU"]
        for name in ("fp32 CPU", "fp32 GPU"):
            (match, neg), _, _ = runs[name]
            pos_diff = int((match[0] != match64[0]).sum())
            neg_diff = int((neg != neg64).sum())
            print(f"[17d] ssd_lite_mobilenet_v2 {name}: {pos_diff} anchors matched otherwise and {neg_diff} other "
                  f"mined negatives than fp64 CPU ({int(match64[0].sum())} positives, {int(neg64.sum())} negatives); "
                  f"all runs take the fp64 matching and mining")
        for key in ("loc_loss", "conf_loss", "loss"):
            errs = {name: abs(runs[name][1][key] - ref_comps[key]) for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[17d] ssd_lite_mobilenet_v2 {key} {ref_comps[key]:.6f} (fp64 CPU): GPU err {errs['fp32 GPU']:.3g}, "
                  f"CPU err {errs['fp32 CPU']:.3g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-6 * abs(ref_comps[key]),
                  f"SSD GPU fp32 {key} more than twice as far from fp64 as the CPU's")
        for group in ("backbone", "neck", "heads", ""):
            keys = [k for k in ref_grads if k.startswith(group)]
            norm = float(sum((ref_grads[k] ** 2).sum() for k in keys) ** 0.5)
            errs = {name: float(sum(((runs[name][2][k] - ref_grads[k]) ** 2).sum() for k in keys) ** 0.5)
                    for name in ("fp32 GPU", "fp32 CPU")}
            print(f"[17d] ssd_lite_mobilenet_v2 gradients {group or 'all'} (norm {norm:.4g}): GPU L2 err "
                  f"{errs['fp32 GPU']:.4g}, CPU L2 err {errs['fp32 CPU']:.4g}")
            check(errs["fp32 GPU"] <= 2 * errs["fp32 CPU"] + 1e-7 * norm,
                  f"SSD GPU fp32 gradients ({group or 'all'}) more than twice as far from fp64 as the CPU's")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    del runs, cpu_model

    b = 32
    dataset = RandomDetectionDataset(num_samples=b, image_size=(320, 320), num_classes=80, max_boxes=120)
    images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
    images = images.cuda().contiguous(memory_format=torch.channels_last)
    targets = targets.cuda()
    model = models.get("ssd_lite_mobilenet_v2", num_classes=80, seed=0, device="cuda")
    step = Trainer("chip_smoke_ssd_timing").prepare(model, COCO_SSD, steps_per_epoch=100)

    def run(events=None):
        marks = [lambda: None] * 5 if events is None else [e.record for e in events]
        marks[0]()
        out = step.forward(images)
        marks[1]()
        loss, _ = step.loss(out, targets)
        marks[2]()
        step.backward(loss)
        marks[3]()
        step.update()
        marks[4]()
        return loss

    for _ in range(3):
        run()
    iters = 10
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(iters)]
    for ev in events:
        run(ev)
    torch.cuda.synchronize()
    parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / iters for i in range(4)]
    step_ms = sum(ev[0].elapsed_time(ev[4]) for ev in events) / iters
    with torch.no_grad():
        out = step.forward(images)
        match_ms = cuda_ms(lambda: step.criterion.match(targets), iters=10)
    prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
    busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(loss)), f"SSD b{b} train loss not finite")
    print(f"[17d] ssd_lite_mobilenet_v2 bf16 train step b{b} at 320: {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.1f} "
          f"img/s (CUDA events); forward {parts[0]:.2f}, SSDLoss {parts[1]:.2f} (of which the matching "
          f"{match_ms:.2f}), backward {parts[2]:.2f}, optimizer+EMA {parts[3]:.2f} ms; profiled (device activity only): "
          f"wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak "
          f"memory {peak:.2f} GiB")
    del step, model, loss, out, prof_events, images, targets
    torch.cuda.empty_cache()


def phase_mobilenet_predict(torch, np, nms_exact):
    """(e) MobileNetV3-large, 1000 classes, 224: fp32 predict() GPU vs CPU (TF32 off, the head
    scaled to a logit std of 2 as phase 14a does; top-1 equal, top-5 probabilities within
    CLS_CONF_TOL, the card's fp32 logits within twice the CPU's distance to an fp64 run), then
    the fp32 forward at b32 and b128."""
    from PIL import Image

    from super_gradients_tpu_torch import models

    launches_before = nms_exact.exact_nms_keep.launches
    model = models.get("mobilenet_v3_large", num_classes=1000, seed=0, device="cuda")
    cpu_model = models.get("mobilenet_v3_large", num_classes=1000, seed=0, device="cpu")
    images = request_images(np, 3)
    pil_image = Image.fromarray(request_images(np, 5)[1])
    _, batches, _ = cpu_model._prep_host_batches(images, 4)
    with torch.inference_mode():
        std = float(cpu_model.net(torch.from_numpy(batches[0]).permute(0, 3, 1, 2)).std())
    with torch.no_grad():
        for m in (model, cpu_model):
            m.net.classifier[3].weight.mul_(2.0 / std)
            m.net.classifier[3].bias.mul_(2.0 / std)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = list(model.predict(images)) + list(model.predict(pil_image))
        _, batches, _ = model._prep_host_batches(images + [np.asarray(pil_image)], 5)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            g_logits = model._deploy_net(False, False)(x.cuda()).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    cpu = list(cpu_model.predict(images)) + list(cpu_model.predict(pil_image))
    with torch.inference_mode():
        c_logits = cpu_model.net(x).double()
        r_logits = copy.deepcopy(cpu_model.net).double()(x.double())
    top1 = [(g.prediction, c.prediction) for g, c in zip(gpu, cpu)]
    conf_err = max(float(np.abs(g.confidence - c.confidence).max()) for g, c in zip(gpu, cpu))
    e_gpu, e_cpu = float((g_logits - r_logits).abs().max()), float((c_logits - r_logits).abs().max())
    print(f"[17e] mobilenet_v3_large 1000 classes 224 fp32 predict GPU vs CPU (TF32 off; head scaled by "
          f"{2.0 / std:.3e}), 4-image request + a PIL image: top-1 {top1} ({len(set(top1))} distinct: the random "
          f"init's logits vary little from image to image); top-5 probabilities |GPU - CPU| max {conf_err:.3e} (limit "
          f"{CLS_CONF_TOL}); logits |GPU - fp64| max {e_gpu:.3e}, |CPU - fp64| max {e_cpu:.3e} (limit: twice the CPU's)")
    check(all(a == b for a, b in top1), f"MobileNetV3 GPU and CPU top-1 differ: {top1}")
    check(conf_err <= CLS_CONF_TOL, f"MobileNetV3 top-5 probabilities differ by {conf_err} between GPU and CPU")
    check(e_gpu <= 2 * e_cpu, f"MobileNetV3 fp32 logits on the card {e_gpu} from fp64, more than twice the CPU's {e_cpu}")
    del cpu_model, cpu
    tf32 = f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32}"
    net = model._deploy_net(False, False)
    for b in (32, 128):
        batch = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(b)).cuda()
        batch = batch.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            call = lambda: net(batch)  # noqa: E731
            ms = cuda_ms(call, iters=10)
            events, wall_ms = profiled(torch, call, 5, with_cpu=False)
        busy_ms = sum(_self_device_us(e) for e in events) / 1e3 / 5
        print(f"[17e] mobilenet_v3_large fp32 forward b{b} at 224 ({tf32}, channels_last): {ms:.2f} ms a batch (CUDA "
              f"events), {b * 1e3 / ms:.1f} img/s; profiled: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
              f"idle share {1 - busy_ms / wall_ms:.3f}")
        del batch, events
    del model, net
    torch.cuda.empty_cache()
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"MobileNet predict launched K1 {launched} times; classification has no NMS")


def phase_ssd_recipe(torch, np, nms_exact, root):
    """(f) train_from_recipe of coco2017_ssd_lite_mobilenet_v2 on a COCO-layout copy of phase
    11's PNGs at 320 (2 epochs of b16), K1 once a validation batch, evaluate_checkpoint held to
    a direct Trainer.evaluate with a planted fault beyond it. Returns K1's launches."""
    from super_gradients_tpu_torch import train_from_recipe
    from super_gradients_tpu_torch.common import config

    data_root, coco_root, ckpt_root = (os.path.join(root, d) for d in ("rf100", "coco", "ckpt"))
    n_boxes, n_crowd = make_rf100_dataset(np, data_root)
    write_coco_splits(data_root, coco_root)
    workers = min(8, os.cpu_count())
    recipe = "coco2017_ssd_lite_mobilenet_v2"
    cuts = [f"dataset_params.train_dataset_params.data_dir={coco_root}",
            f"dataset_params.val_dataset_params.data_dir={coco_root}", "epochs=2", "batch_size=16",
            "val_batch_size=16", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}"]
    cfg = config.load_recipe(recipe, overrides=cuts)
    nms_exact.exact_nms_keep.launches = 0
    t0 = time.perf_counter()
    model, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nms_exact.exact_nms_keep.launches
    history, valid = trainer.train_loss_history, trainer.valid_metrics_history
    check(launches == 2 * 2, f"K1 launched {launches} times in {recipe}, expected one a validation batch (4)")
    check(len(history) == 2 and all(np.isfinite(history)), f"{recipe} train losses {history}")
    check(len(valid) == 2 and all(np.isfinite(list(v.values())).all() for v in valid), f"{recipe} validation {valid}")
    check(model.class_names is not None and model.class_names[0] == "class_0",
          f"{recipe}: the dataset's class names did not reach the model ({(model.class_names or [None])[:2]})")
    print(f"[17f] recipe {recipe} through train_from_recipe.main on a COCO-layout copy of phase 11's dataset (64 train "
          f"+ 32 valid PNGs, {n_boxes} boxes, {n_crowd} iscrowd): 2 epochs x {trainer.train_state.step // 2} steps of "
          f"16 at 320, {workers} workers, {seconds:.1f} s; K1 launches {launches}; losses {history}; validation "
          f"{json.dumps(valid)}; the model carries the dataset's class names")
    check_evaluate_checkpoint(torch, cfg, recipe, trainer.ckpt_dir, ckpt_root, "17f")
    print(f"[17f] K1 launches in the three evaluations: {nms_exact.exact_nms_keep.launches - launches}")
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def phase_ssd_pretrained(torch, np, nms_exact, root):
    """(g) models.get("ssd_lite_mobilenet_v2", pretrained_weights="coco") from a temporary
    $SG_PRETRAINED_DIR holding a .pth that the port wrote: the same predictions as the same file
    through checkpoint_path=, and the COCO processing. Returns K1's launches of its predict."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models import pretrained_models
    from super_gradients_tpu_torch.models.class_names import COCO_DETECTION_CLASSES_LIST

    mirror = os.path.join(root, "pretrained")
    os.makedirs(mirror)
    path = os.path.join(mirror, os.path.basename(pretrained_models.get_pretrained_url("ssd_lite_mobilenet_v2", "coco")))
    torch.save({"net": models.get("ssd_lite_mobilenet_v2", seed=5, device="cpu").net.state_dict()}, path)
    before = os.environ.get("SG_PRETRAINED_DIR")
    os.environ["SG_PRETRAINED_DIR"] = mirror
    try:
        pretrained = models.get("ssd_lite_mobilenet_v2", pretrained_weights="coco")
    finally:
        if before is None:
            del os.environ["SG_PRETRAINED_DIR"]
        else:
            os.environ["SG_PRETRAINED_DIR"] = before
    direct = models.get("ssd_lite_mobilenet_v2", checkpoint_path=path)
    images = request_images(np, 3)
    nms_exact.exact_nms_keep.launches = 0
    got = pretrained.predict(images)
    launches = nms_exact.exact_nms_keep.launches
    ref = direct.predict(images)
    same = all(np.array_equal(g.bboxes_xyxy, r.bboxes_xyxy) and np.array_equal(g.labels, r.labels)
               and np.array_equal(g.confidence, r.confidence) for g, r in zip(got, ref))
    steps = [type(p).__name__ for p in pretrained.get_processing_params().processings]
    print(f"[17g] models.get('ssd_lite_mobilenet_v2', pretrained_weights='coco') from a temporary $SG_PRETRAINED_DIR "
          f"({os.path.basename(path)}, written by the port from seed 5): predictions equal to the same file through "
          f"checkpoint_path=: {same} ({[len(g) for g in got]} detections); class names COCO: "
          f"{pretrained.class_names == COCO_DETECTION_CLASSES_LIST}; processing {steps}; K1 launches {launches}")
    check(same and sum(len(g) for g in got) > 0, "pretrained_weights and checkpoint_path= predict differently")
    check(pretrained.class_names == COCO_DETECTION_CLASSES_LIST, "the pretrained SSD lacks the COCO class names")
    check(steps == ["DetectionLongestMaxSizeRescale", "DetectionCenterPadding", "StandardizeImage"],
          f"the pretrained SSD's processing {steps}")
    check(launches == 1, f"the pretrained SSD's predict launched K1 {launches} times, expected 1")
    del pretrained, direct
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase 18: data parallelism

DDP_TIMEOUT = 900  # seconds a phase-18 launch may take before its whole session is killed
DDP_STEP_SAMPLES = 4  # 18b's global batch: phase 8's dataset (samples 0-1 its batch) extended to 4 images
DDP_STEP_HW = FP64_STEP_HW  # 18b's images
DDP_TRAIN_HW = 320  # 18a's and 18c's recipe images
DDP_BN_SHAPE = (4, 96, 160, 160)  # 18b's standalone BN check: a stage-1-sized activation of YOLO-NAS-M at 640
DDP_BN_TOL = 1e-5  # |global BN - one-process BN| over the largest magnitude, fp32 (TF32 off)
DDP_BN_BF16_SHAPE = (16, 96, 160, 160)  # 18a's bf16 BN check: a stage-1 activation of YOLO-NAS-M at 640, b16
DDP_BN_BF16_TOL = 1e-2  # the same, bf16 channels_last in and out (a bf16 ulp is 3.9e-3 of a value)
DDP_TIMED_STEPS = 3  # 18a's steps timed a variant in each of its two interleaved passes (phase 9 times 10)


def launch_ranks(torch_run_args, rank_args, timeout=DDP_TIMEOUT):
    """``python3 -m torch.distributed.run <args> chip_smoke.py --ddp-rank <rank_args>`` in a
    session of its own, killed whole past ``timeout``; returns (seconds, output)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", *torch_run_args, os.path.join(HERE, "chip_smoke.py"),
           "--ddp-rank", *rank_args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-6000:])
        check(False, f"{' '.join(cmd)}: no result after {timeout} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-12000:])
    check(proc.returncode == 0, f"{' '.join(cmd)}: exit code {proc.returncode}")
    return seconds, out


def rank_reports(work, world):
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def ddp_recipe_cuts(data_root, ckpt_root, n, hw=None):
    """The recipe overrides of 18a and 18c, ``num_devices`` last; ``hw`` resizes both splits."""
    sizes = [f"dataset_params.{split}_dataset_params.image_size=[{hw},{hw}]" for split in ("train", "val")] if hw else []
    return sizes + [
        f"dataset_params.train_dataset_params.data_dir={data_root}",
        f"dataset_params.val_dataset_params.data_dir={data_root}", "dataset_name=synthetic", "num_classes=80",
        "epochs=1", "batch_size=16", "val_batch_size=16", "num_workers=2", f"ckpt_root_dir={ckpt_root}",
        "training_hyperparams.mixed_precision=True", "training_hyperparams.sg_logger_params.tensorboard=False",
        f"num_devices={n}"]


def phase_ddp(torch, np, root, one_process_ms=None):
    """Phase 18: data parallelism (``one_process_ms``: phase 9's one-process step by part,
    {batch: ms}, which 18a's step is printed beside). Returns K1's launches on the ranks of
    18a and 18c."""
    t_phase = time.perf_counter()
    data_root = os.path.join(root, "rf100")
    make_rf100_dataset(np, data_root)
    launches = phase_ddp_entry(torch, np, data_root, os.path.join(root, "18a"), (one_process_ms or {}).get(16))
    work_b, work_c = os.path.join(root, "18b"), os.path.join(root, "18c")
    cuts = ddp_recipe_cuts(data_root, os.path.join(work_c, "ckpt"), 2, hw=DDP_TRAIN_HW)

    def launch():  # one two-rank launch runs 18b's rank body, then 18c's (one launch fewer to wait for)
        os.makedirs(work_c)
        return launch_ranks(["--standalone", "--nproc_per_node=2"],
                            ["step_train", work_b, work_c, "--config-name=roboflow_yolo_nas_m", *cuts])

    launched = phase_ddp_step(torch, np, work_b, launch)
    launches += phase_ddp_train(torch, np, data_root, work_c, launched)
    phase_ddp_across_cards(torch, os.path.join(root, "18d"))
    print(f"[18] phase 18 {time.perf_counter() - t_phase:.1f} s; K1 launches on its ranks: {launches}")
    return launches


def fmt_parts(ms):
    return ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + " ms"


def phase_ddp_entry(torch, np, data_root, work, one_process_ms=None):
    """18a: the real entry point under torch.distributed.run, one rank over NCCL; then, on
    that rank, the bf16 b16 step by part as the trainer builds it there (DDP, cuDNN BN),
    and with the global BN forced on (its two all-reduces a BN, at world size 1), beside
    ``one_process_ms``, phase 9's one-process step."""
    from super_gradients_tpu_torch.common import config

    os.makedirs(work)
    ckpt_root = os.path.join(work, "ckpt")
    cuts = ddp_recipe_cuts(data_root, ckpt_root, 1, hw=DDP_TRAIN_HW)
    seconds, out = launch_ranks(["--standalone", "--nproc_per_node=1"],
                                ["entry", work, "--config-name=roboflow_yolo_nas_m", *cuts])
    (report,) = rank_reports(work, 1)
    check("rank 0 of world size 1, backend nccl, device cuda:0" in out, "18a did not join a one-rank NCCL group")
    history = report["history"]
    check(len(history) == 1 and all(np.isfinite(history)), f"18a train losses {history}")
    n_valid_batches = -(-32 // 16)
    check(report["launches"] == n_valid_batches, f"K1 launched {report['launches']} times on the 18a rank, expected "
                                                  f"one a validation batch ({n_valid_batches})")
    check(report["collectives"] > 0, "18a ran no collective")
    print(f"[18a] python3 -m torch.distributed.run --standalone --nproc_per_node=1 -m "
          f"super_gradients_tpu_torch.train_from_recipe --config-name=roboflow_yolo_nas_m {' '.join(cuts)}: backend nccl, "
          f"world size 1, {seconds:.1f} s (launcher included); losses {history}; validation {json.dumps(report['valid'])}; "
          f"K1 launches on the rank {report['launches']}; all-reduces of the port's collectives in the run "
          f"{report['collectives']}")
    bn = report["bn"]
    check(max(bn["err"].values()) <= DDP_BN_BF16_TOL, f"18a: the global BN, forced on, differs from nn.BatchNorm2d "
                                                      f"in bf16: {bn['err']}")
    print(f"[18a] GlobalBatchNorm2d forced on (one-rank NCCL all-reduces) against nn.BatchNorm2d on "
          f"{list(DDP_BN_BF16_SHAPE)} bf16 channels_last, |difference| over the largest magnitude: {json.dumps(bn['err'])}, "
          f"limit {DDP_BN_BF16_TOL}; forward + backward {bn['global_ms']:.3f} ms against {bn['plain_ms']:.3f} ms (CUDA "
          f"events), device busy {bn['global_busy_ms']:.3f} against {bn['plain_busy_ms']:.3f} ms (profiler)")
    for v in ("global", "plain"):
        print(f"[18a] {v} BN, host time a forward + backward by op (self CPU, profiler): {bn[v + '_host']}")
    base = report["ms"]["one_process"]["step"]
    for what, ms in report["ms"].items():
        check(all(np.isfinite(v) and v > 0 for v in ms.values()), f"18a {what} timing {ms}")
        ratio = f"; {ms['step'] / one_process_ms['step']:.3f}x phase 9's step" if one_process_ms else ""
        print(f"[18a] {what} step, bf16 b16 on the NCCL rank of world size 1 (each variant timed twice, "
              f"interleaved): {fmt_parts(ms)}; {ms['step'] / base:.3f}x the one_process variant{ratio}")
    if one_process_ms:
        print(f"[18a] phase 9's one-process bf16 b16 step: {fmt_parts(one_process_ms)}")
    cfg = config.load_recipe("roboflow_yolo_nas_m", overrides=cuts)
    check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], report["ckpt_dir"], ckpt_root, "18a")
    return report["launches"]


def ddp_step_batch(torch, np):
    from super_gradients_tpu_torch.training import RandomDetectionDataset

    dataset = RandomDetectionDataset(num_samples=DDP_STEP_SAMPLES, image_size=(DDP_STEP_HW, DDP_STEP_HW), num_classes=80,
                                     max_boxes=120)
    return (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(DDP_STEP_SAMPLES))))


def ddp_one_step(torch, models, device, dtype, images, targets, assign=None):
    """One SGD step of phase 8's regime (``_one_step``) on ``device`` in ``dtype``, the
    assignment ``assign`` when given: (its own assignment, loss components, gradients,
    updated weights), fp64 on the CPU. Inside a process group the step is the DDP step."""
    import types

    from super_gradients_tpu_torch.training import Trainer

    net = models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu").net.to(device, dtype)
    model = types.SimpleNamespace(net=net, device=torch.device(device))
    x, t = images.to(device, dtype), targets.to(device, dtype)
    if device == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    params = dict(COCO_YOLO_NAS, optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-5},
                  ema=False, mixed_precision=False, lr_warmup_steps=0, initial_lr=1e-3)
    step = Trainer("chip_smoke_ddp_step").prepare(model, params, steps_per_epoch=1)
    out = step.forward(x)
    own = step.criterion.assign(out, t)
    if assign is not None:
        step.criterion.assigner = _FixedAssigner(type(assign)(*(
            a.to(device, a.dtype if not a.is_floating_point() else dtype) for a in assign)))
    loss, comps = step.loss(out, t)
    step.backward(loss)
    grads = {k: p.grad.detach().double().cpu() for k, p in step.state.net.named_parameters() if p.grad is not None}
    step.update()
    weights = {k: p.detach().double().cpu() for k, p in step.state.net.named_parameters()}
    return own, {k: float(v.detach()) for k, v in dict(comps, loss=loss).items()}, grads, weights


def phase_ddp_step(torch, np, work, launch):
    """18b: one fp32 SGD step of YOLO-NAS-M at DDP_STEP_HW on two ranks sharing the card over gloo
    (a global batch of 4), held to the fp64 CPU step within twice the one-process GPU
    step's distance (phase 8's rule, the fp64 assignment shared); and the global BN on the
    card against one-process BN. ``launch()`` starts the ranks, which run 18b's rank body and
    then 18c's (phase_ddp), once the batch is written. Returns the launch's (seconds, output)."""
    from super_gradients_tpu_torch import models

    os.makedirs(work)
    images, targets = ddp_step_batch(torch, np)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        ref_assign, ref_comps, ref_grads, ref_weights = ddp_one_step(torch, models, "cpu", torch.float64, images,
                                                                     targets)
        fp64_seconds = time.perf_counter() - t0
        _, gpu_comps, gpu_grads, gpu_weights = ddp_one_step(torch, models, "cuda", torch.float32, images, targets,
                                                            ref_assign)
        torch.save({"images": images, "targets": targets, "assign": tuple(ref_assign)}, os.path.join(work, "batch.pt"))
        seconds, out = launch()
        reports = rank_reports(work, 2)
        ddp = torch.load(os.path.join(work, "step.pt"), weights_only=True)
        # each rank prints its group once in 18b's body and twice more in 18c's
        check(out.count("backend gloo, device cuda:0 (gloo on CUDA") == 6,
              "18b ranks did not print their gloo group")
        init = {k: v.double() for k, v in models.get("yolo_nas_m", num_classes=80, seed=0, device="cpu").net.named_parameters()}
        print(f"[18b] two ranks on one card over gloo (setup_device(backend='gloo'), printed by each rank), CUDA "
              f"tensors, 2 of the 4 images a rank, TF32 off; launch {seconds:.1f} s (18c run on the same ranks); "
              f"fp64 CPU reference step {fp64_seconds:.1f} s")
        for key in ("loss_cls", "loss_iou", "loss_dfl", "loss"):
            two = float(np.mean([r["comps"][key] for r in reports]))  # the global loss: the mean of the ranks'
            errs = {"two ranks": abs(two - ref_comps[key]), "one GPU": abs(gpu_comps[key] - ref_comps[key])}
            # printed, not gated (the gate is on the gradients and the updated weights): a loss component's
            # fp32 error is one draw of the train-mode forward's rounding noise
            print(f"[18b] {key} {ref_comps[key]:.6f} (fp64 CPU): two-rank err {errs['two ranks']:.3g}, one-GPU err "
                  f"{errs['one GPU']:.3g}")
        for what, ref, gpu, two, base in (("gradients", ref_grads, gpu_grads, ddp["grads"], None),
                                          ("updated weights", ref_weights, gpu_weights, ddp["weights"], init)):
            for group in ("backbone", "neck", "heads", ""):
                keys = [k for k in ref if k.startswith(group)]
                scale = float(sum(((ref[k] - (base[k] if base else 0)) ** 2).sum() for k in keys) ** 0.5)
                errs = {name: float(sum(((g[k] - ref[k]) ** 2).sum() for k in keys) ** 0.5)
                        for name, g in (("two ranks", two), ("one GPU", gpu))}
                print(f"[18b] {what} {group or 'all'} ({'norm' if base is None else 'moved'} {scale:.4g}): two-rank L2 "
                      f"err {errs['two ranks']:.4g}, one-GPU L2 err {errs['one GPU']:.4g}")
                check(errs["two ranks"] <= 2 * errs["one GPU"] + 1e-7 * scale,
                      f"18b {what} ({group or 'all'}): the two-rank step more than twice as far from fp64 as the "
                      f"one-GPU step")
        bn = {k: max(r["bn"][k] for r in reports) for k in reports[0]["bn"]}  # the worse rank's
        print(f"[18b] GlobalBatchNorm2d on {list(DDP_BN_SHAPE)} split over the two ranks against nn.BatchNorm2d on the "
              f"whole batch in one process (fp32, TF32 off), |difference| over the largest magnitude: "
              f"{json.dumps(bn)}, limit {DDP_BN_TOL}")
        check(max(bn.values()) <= DDP_BN_TOL, f"18b: the global BN's batch statistics differ from one process: {bn}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.cuda.empty_cache()
    return seconds, out


def phase_ddp_train(torch, np, data_root, work, launched):
    """18c: Trainer.train through the recipe on two ranks sharing the card over gloo, with
    validation gathered over the ranks (``launched``: the (seconds, output) of the ranks,
    which ran 18b first). Returns the ranks' K1 launches."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.dataloaders import DataLoader
    from super_gradients_tpu_torch.training.metrics import MetricCollection, get_metric

    ckpt_root = os.path.join(work, "ckpt")
    cuts = ddp_recipe_cuts(data_root, ckpt_root, 2, hw=DDP_TRAIN_HW)
    seconds, out = launched
    reports = rank_reports(work, 2)
    check("backend gloo, device cuda:0 (gloo on CUDA" in out, "18c ranks did not print their gloo group on the card")
    valid = [r["valid"] for r in reports]
    check(valid[0] == valid[1], f"18c: the ranks' gathered metrics differ: {valid}")
    history = reports[0]["history"]
    check(history == reports[1]["history"] and len(history) == 1 and np.isfinite(history).all(),
          f"18c train losses {[r['history'] for r in reports]}")
    launches = [r["launches"] for r in reports]
    check(launches == [2, 2], f"18c K1 launches per rank in train_from_recipe {launches}, expected one a validation "
                              f"batch on each (2)")
    check(reports[1]["written"] == [] and reports[0]["written"], f"18c files written: rank 0 {reports[0]['written']}, "
                                                                  f"rank 1 {reports[1]['written']}")
    # one process over the whole validation set, the training's policy (bf16, EMA weights, channels_last) and
    # the ranks' batch of 8, so that every image meets the same convolutions as on its rank
    cfg = config.load_recipe("roboflow_yolo_nas_m", overrides=cuts[:-1] + ["val_batch_size=8"])
    best_path = os.path.join(reports[0]["ckpt_dir"], "ckpt_best.pth")
    model = models.get("yolo_nas_m", num_classes=80, checkpoint_path=best_path, device="cuda")
    net = model.net.to(memory_format=torch.channels_last)
    loader = Trainer._loader_from_cfg(cfg, "val")
    metrics = MetricCollection([get_metric(m) for m in cfg["training_hyperparams"]["valid_metrics_list"]])
    one = Trainer("chip_smoke_ddp_one")._run_eval_loop(net.eval(), None, metrics, loader, torch.device("cuda"), True,
                                                        None, None, None)
    close_loader(loader)
    best = valid[0][-1]
    diffs = {k: abs(best[k] - one[k]) for k in one}
    # the second set (rank 0's): the best checkpoint's own detections, jittered, evaluated on the ranks and
    # in one process at the ranks' 8 images a batch (fp32, TF32 off)
    own_valid = [r["own_valid"] for r in reports]
    check(own_valid[0] == own_valid[1], f"18c: the ranks' gathered metrics on the second set differ: {own_valid}")
    own_launches = [r["own_launches"] for r in reports]
    check(own_launches == [1, 1], f"18c K1 launches per rank in the second evaluation {own_launches}, expected 1")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        own_model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, checkpoint_path=best_path, device="cuda"))
        own = torch.load(os.path.join(work, "own.pt"), weights_only=True)  # rank 0's set
        own_one = Trainer("chip_smoke_ddp_own_one").evaluate(
            own_model, DataLoader(own, batch_size=DDP_OWN_IMAGES // 2, drop_last=False),
            metrics_list=[{"DetectionMetrics": {"num_cls": 80}}])
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    own_diffs = {k: abs(own_valid[0][k] - own_one[k]) for k in own_one}
    print(f"[18c] Trainer.train through train_from_recipe on two ranks sharing the card (gloo), 1 epoch of global "
          f"b16 (8 a rank) at {DDP_TRAIN_HW}, bf16, {seconds:.1f} s (launcher included, 18b run first); losses {history}; gathered validation, "
          f"equal on both ranks: {json.dumps(valid[0])}; K1 launches per rank {launches}; written by rank 0: "
          f"{sorted(set(os.path.basename(p) for p in reports[0]['written']))}, by rank 1: none; one-process validation "
          f"of ckpt_best.pth (bf16, b8): {json.dumps(one)}, |difference| {json.dumps(diffs)}, limit {RECIPE_EVAL_TOL}")
    print(f"[18c] Trainer.evaluate of ckpt_best.pth (cls_pred biases 0, fp32) over both ranks on {DDP_OWN_IMAGES} noise "
          f"images whose targets are its own detections jittered: {json.dumps(own_valid[0])}, equal on both ranks; one "
          f"process (b8): {json.dumps(own_one)}, |difference| {json.dumps(own_diffs)}, limit {RECIPE_EVAL_TOL}; K1 "
          f"launches per rank {own_launches}")
    check(max(diffs.values()) <= RECIPE_EVAL_TOL, f"18c: the gathered metrics differ from one process: {diffs}")
    check(0.2 <= own_valid[0]["mAP@0.50:0.95"] <= 0.9, f"18c: the second set's mAP {own_valid[0]['mAP@0.50:0.95']} "
                                                        f"outside [0.2, 0.9]")
    check(max(own_diffs.values()) <= RECIPE_EVAL_TOL, f"18c: the gathered metrics on the second set differ from one "
                                                      f"process: {own_diffs}")
    del model, net, own_model
    torch.cuda.empty_cache()
    return sum(launches) + sum(own_launches)


def phase_ddp_across_cards(torch, work):
    """18d: NCCL across cards, where the machine has two or more GPUs: the bf16 step at a
    global b32 timed by part on each rank."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"[18d] {count} GPU, NCCL across cards not run")
        return
    os.makedirs(work)
    seconds, _ = launch_ranks(["--standalone", "--nproc_per_node=2"], ["timing", work])
    for r, report in enumerate(rank_reports(work, 2)):
        print(f"[18d] rank {r} of 2 over NCCL on cuda:{r}, bf16 step at global b32 (16 a rank): {fmt_parts(report['ms'])}")
    print(f"[18d] launch {seconds:.1f} s")


# ---- the ranks' side (chip_smoke.py --ddp-rank <what> <work> [arguments])

class WriteLog:
    """Records every file this process opens for writing or saves with ``torch.save``."""

    def __init__(self, torch):
        import builtins

        self.torch, self.builtins, self.paths = torch, builtins, []
        self._open, self._save = builtins.open, torch.save

    def __enter__(self):
        def logged_open(file, mode="r", *a, **kw):
            if any(m in mode for m in "wax+"):
                self.paths.append(str(file))
            return self._open(file, mode, *a, **kw)

        def logged_save(obj, f, *a, **kw):
            self.paths.append(str(f))
            return self._save(obj, f, *a, **kw)

        self.builtins.open, self.torch.save = logged_open, logged_save
        return self

    def __exit__(self, *exc):
        self.builtins.open, self.torch.save = self._open, self._save


def count_collectives(torch):
    """Counts torch.distributed.all_reduce calls from here on; returns the counter."""
    import torch.distributed as dist

    counter = {"n": 0}
    original = dist.all_reduce

    def counted(*a, **kw):
        counter["n"] += 1
        return original(*a, **kw)

    dist.all_reduce = counted
    return counter


def write_report(work, report):
    import torch.distributed as dist

    with open(os.path.join(work, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(report, f)


def rank_entry(torch, work, argv):
    """18a's rank: the entry point module run as ``-m`` runs it."""
    import runpy

    from super_gradients_tpu_torch.ops.kernels import nms_exact

    collectives = count_collectives(torch)
    sys.argv = ["super_gradients_tpu_torch.train_from_recipe", *argv]
    runpy.run_module("super_gradients_tpu_torch.train_from_recipe", run_name="__main__", alter_sys=True)
    from super_gradients_tpu_torch.common.environment import get_latest_run_id, get_checkpoints_dir_path
    from super_gradients_tpu_torch.common import config

    cfg = config.load_recipe(argv[0].split("=", 1)[1], overrides=argv[1:])
    ckpt_dir = get_checkpoints_dir_path(cfg["experiment_name"], cfg["ckpt_root_dir"],
                                        get_latest_run_id(cfg["experiment_name"], cfg["ckpt_root_dir"]))
    ckpt = torch.load(os.path.join(ckpt_dir, "ckpt_latest.pth"), map_location="cpu", weights_only=False)
    with open(os.path.join(ckpt_dir, "events.jsonl")) as f:
        history = [e["value"] for e in map(json.loads, f) if e.get("tag") == "Train/loss"]
    launches = nms_exact.exact_nms_keep.launches
    write_report(work, {"launches": launches, "history": history, "valid": ckpt["metrics"], "ckpt_dir": ckpt_dir,
                        "collectives": collectives["n"], "bn": bn_bf16_check(torch),
                        "ms": ddp_step_ms(torch, 16, tuple(STEP_VARIANTS))})


def rank_step(torch, work):
    """18b's rank: its two images of the global batch of 4 with the fp64 run's assignment,
    then the global BN alone on a seeded activation."""
    import torch.distributed as dist

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.parallel import GlobalBatchNorm2d, local_batch_slice, setup_device
    from super_gradients_tpu_torch.training.losses.ppyolo_loss import AssignResult

    setup_device(backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = torch.load(os.path.join(work, "batch.pt"), weights_only=True)
    part = local_batch_slice(DDP_STEP_SAMPLES)
    assign = AssignResult(*(t[part] for t in batch["assign"]))
    _, comps, grads, weights = ddp_one_step(torch, models, "cuda", torch.float32, batch["images"][part],
                                            batch["targets"][part], assign)
    if dist.get_rank() == 0:
        torch.save({"grads": grads, "weights": weights}, os.path.join(work, "step.pt"))

    gen = torch.Generator(device="cuda").manual_seed(18)
    x = (torch.randn(DDP_BN_SHAPE, generator=gen, device="cuda") * 3.0 + 1.5).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(DDP_BN_SHAPE, generator=gen, device="cuda")
    ref = torch.nn.BatchNorm2d(DDP_BN_SHAPE[1], momentum=0.03).cuda()
    glob = GlobalBatchNorm2d(DDP_BN_SHAPE[1], momentum=0.03).cuda()
    xr, xg = x.clone().requires_grad_(), x[part].clone().requires_grad_()
    yr, yg = ref(xr), glob(xg)
    yr.backward(dy)
    yg.backward(dy[part])

    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    bn = {"output": rel(yg, yr[part]), "input gradient": rel(xg.grad, xr.grad[part]),
          "running_mean": rel(glob.running_mean, ref.running_mean), "running_var": rel(glob.running_var, ref.running_var)}
    write_report(work, {"comps": comps, "bn": bn})


DDP_OWN_IMAGES = 16  # 18c's second validation set: seeded noise images, targets the trained model's own detections


def own_detection_set(torch, np, model):
    """``DDP_OWN_IMAGES`` seeded noise images at 640 and, as targets, ``model``'s detections of
    them jittered by 8% of each box's size (phase 10's scheme), fp32 with TF32 off."""
    from super_gradients_tpu_torch.training.metrics import DetectionMetrics, to_host

    images = torch.rand((DDP_OWN_IMAGES, 3, 640, 640), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        x = images.cuda().contiguous(memory_format=torch.channels_last)
        own = own_detection_targets(np, to_host(DetectionMetrics(num_cls=80).preprocess_device(model.net(x), None)))
    wh = np.concatenate([own[..., 3:5] - own[..., 1:3]] * 2, -1)
    own[..., 1:5] += np.random.RandomState(8).randn(*wh.shape).astype(np.float32) * 0.08 * wh
    return [(images[i], torch.from_numpy(own[i])) for i in range(DDP_OWN_IMAGES)]


def rank_train(torch, work, argv):
    """18c's rank: train_from_recipe in a gloo group on the card (rank 1 records what it
    writes), then ``Trainer.evaluate`` of the best checkpoint, its ``cls_pred`` biases at 0,
    on a set whose targets are its own detections, over both ranks."""
    import numpy as np
    import torch.distributed as dist

    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.ops.kernels import nms_exact
    from super_gradients_tpu_torch.parallel import setup_device
    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.dataloaders import DataLoader

    setup_device(backend="gloo")
    with WriteLog(torch) as log:
        _, trainer = train_from_recipe.main(argv)
    launches = nms_exact.exact_nms_keep.launches
    root = os.path.dirname(os.path.dirname(trainer.ckpt_dir))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    best = os.path.join(trainer.ckpt_dir, "ckpt_best.pth")
    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, checkpoint_path=best, device="cuda"))
    own = own_detection_set(torch, np, model)
    if dist.get_rank() == 0:
        torch.save(own, os.path.join(work, "own.pt"))
    loader = DataLoader(own, batch_size=DDP_OWN_IMAGES, drop_last=False)  # the global batch: 8 images a rank
    nms_exact.exact_nms_keep.launches = 0
    own_valid = Trainer("chip_smoke_ddp_own").evaluate(model, loader, metrics_list=[{"DetectionMetrics": {"num_cls": 80}}])
    write_report(work, {"launches": launches, "own_launches": nms_exact.exact_nms_keep.launches,
                        "history": trainer.train_loss_history,
                        "valid": trainer.valid_metrics_history, "ckpt_dir": trainer.ckpt_dir,
                        "written": [p for p in log.paths if p.startswith(root)], "own_valid": own_valid})
    dist.barrier()


class forced_global_bn:
    """Within it, ``GlobalBatchNorm2d`` takes the global path even in a group of one rank
    (where the port keeps cuDNN's BN), so its cost on the card can be read there."""

    def __enter__(self):
        from super_gradients_tpu_torch.parallel import sync_batch_norm

        self.module, self.original = sync_batch_norm, sync_batch_norm.is_distributed
        sync_batch_norm.is_distributed = lambda: True

    def __exit__(self, *exc):
        self.module.is_distributed = self.original


def bn_bf16_check(torch):
    """18a's rank: the global BN, forced on, against nn.BatchNorm2d on one bf16 channels_last
    activation (output, gradients, running buffers), and both timed forward + backward."""
    from super_gradients_tpu_torch.parallel import GlobalBatchNorm2d

    gen = torch.Generator(device="cpu").manual_seed(18)
    c = DDP_BN_BF16_SHAPE[1]
    x = (torch.randn(DDP_BN_BF16_SHAPE, generator=gen) * 2 + 0.5).cuda().to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    gy = torch.randn(DDP_BN_BF16_SHAPE, generator=gen).cuda().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    weight, bias = torch.rand(c, generator=gen) + 0.5, torch.randn(c, generator=gen)
    out = {}
    for name, cls in (("global", GlobalBatchNorm2d), ("plain", torch.nn.BatchNorm2d)):
        bn = cls(c, momentum=0.03).cuda()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        with forced_global_bn():
            x.grad = None
            y = bn(x)
            y.backward(gy)
            out[name] = dict(output=y, input_gradient=x.grad, weight_gradient=bn.weight.grad,
                             bias_gradient=bn.bias.grad, running_mean=bn.running_mean, running_var=bn.running_var)
            out[name] = {k: v.detach().float().clone() for k, v in out[name].items()}

            def run(events=None):
                marks = [lambda: None] * 2 if events is None else [e.record for e in events]
                marks[0]()
                bn(x).backward(gy)
                marks[1]()

            for _ in range(3):
                run()
            events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(20)]
            for ev in events:
                run(ev)
            torch.cuda.synchronize()
            out[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in events) / len(events)
            prof, _ = profiled(torch, run, 10)
            out[f"{name}_busy_ms"] = sum(_self_device_us(e) for e in prof) / 1e4
            out[f"{name}_host"] = ", ".join(f"{e.key[:40]} x{e.count // 10} {e.self_cpu_time_total / 10:.0f} us"
                                            for e in sorted(prof, key=lambda e: -e.self_cpu_time_total)[:8])
    err = {k: float((out["global"][k] - ref).abs().max() / ref.abs().max()) for k, ref in out["plain"].items()}
    return {"err": err, **{f"{v}_{k}": out[f"{v}_{k}"] for v in ("global", "plain") for k in ("ms", "busy_ms", "host")}}


STEP_VARIANTS = {  # name: (through DDP, global BN forced on)
    "ddp": (True, False),  # as Trainer.prepare builds the step in the group
    "one_process": (False, False),  # the same step with DDP's wrapper left out
    "global_bn": (True, True),  # DDP, and the global BN even in a group of one rank
}


def ddp_step_ms(torch, global_batch, variants=("ddp",)):
    """The bf16 step of YOLO-NAS-M at 640 on this rank's slice of a global batch, as
    ``Trainer.prepare`` builds it in the process group, ms by part (CUDA events, phase 9's
    count), for each of ``variants`` (``STEP_VARIANTS``) on one model, timed in the order
    given and then in reverse, and averaged: {variant: ms by part}."""
    import contextlib

    import numpy as np

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.parallel import convert_batch_norm, local_batch_slice
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    model = models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda")
    step = Trainer("chip_smoke_ddp_timing").prepare(model, dict(COCO_YOLO_NAS, lr_warmup_steps=1000), steps_per_epoch=100)
    convert_batch_norm(step.state.net)  # in one rank it keeps nn.BatchNorm2d's path unless forced
    dataset = RandomDetectionDataset(num_samples=global_batch, image_size=(640, 640), num_classes=80, max_boxes=120)
    part = range(global_batch)[local_batch_slice(global_batch)]
    images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in part)))
    images = images.cuda().contiguous(memory_format=torch.channels_last)
    targets = targets.cuda()
    ddp, runs = step.ddp, {v: [] for v in variants}
    for name in [*variants, *reversed(variants)]:
        through_ddp, force = STEP_VARIANTS[name]
        step.ddp = ddp if through_ddp else None
        with forced_global_bn() if force else contextlib.nullcontext():
            runs[name].append(time_by_part(torch, step_runner(step, images, targets), iters=DDP_TIMED_STEPS))
    del step, model, images, targets
    torch.cuda.empty_cache()
    return {v: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]} for v, rs in runs.items()}


def rank_timing(torch, work):
    """18d's rank: the bf16 step at global b32 over NCCL, ms by part."""
    from super_gradients_tpu_torch.parallel import setup_device

    setup_device()
    write_report(work, {"ms": ddp_step_ms(torch, 32)["ddp"]})


def ddp_rank_main(args):
    """``chip_smoke.py --ddp-rank <entry|step_train|timing> <work> [arguments]``: one
    rank of phase 18, started by torch.distributed.run."""
    sys.path.insert(0, HERE)
    import torch

    what, work, rest = args[0], args[1], args[2:]
    if what == "entry":
        rank_entry(torch, work, rest)
    elif what == "step_train":  # 18b's body (TF32 off), then 18c's on the same ranks (TF32 back on)
        rank_step(torch, work)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        rank_train(torch, rest[0], rest[1:])
    elif what == "timing":
        rank_timing(torch, work)
    else:
        raise ValueError(f"unknown rank body {what!r}")
    return 0


# --------------------------------------------------- phase 19: DDRNet, RegSeg48 and SegFormer

SEG_ZOO_MODELS = ("ddrnet_23", "regseg48", "segformer_b0")
SEG_ZOO_HW = (1024, 2048)  # Cityscapes' full size
SEG_ZOO_FP64_IMAGES = 1  # images of 19(a)'s fp64 CPU logits (SegFormer-B0's first attention: 131,072 x 2,048 an image)
SEG_ZOO_RECIPES = ("cityscapes_ddrnet", "cityscapes_regseg48")
SEG_ZOO_STEP = dict(b=8, hw=(1024, 1024), arch_params={"use_aux_heads": True}, loss="OhemCELoss",
                    criterion_params={"threshold": 0.7, "mining_percent": 0.0625, "ignore_lb": 255})


def phase_seg_zoo(torch, np, nms_exact, root, cityscapes_root=None):
    """The Cityscapes segmentation zoo at 1024x2048, 19 classes, launching no kernel (K1 must
    count 0 here): (a) fp32 predict GPU vs CPU for DDRNet-23, RegSeg48 and SegFormer-B0, (b) the
    bf16 train step of DDRNet-23 with its aux head and OhemCELoss at b8 on 1024x1024 crops by part,
    (c) train_from_recipe of cityscapes_ddrnet and cityscapes_regseg48 for a few steps on a
    Cityscapes-layout tree: phase 15(d)'s at ``cityscapes_root``, else one written here."""
    launches_before = nms_exact.exact_nms_keep.launches
    t_phase = time.perf_counter()
    for name in SEG_ZOO_MODELS:
        phase_seg_zoo_predict(torch, np, name)
        print(f"[19a] {name} seconds {time.perf_counter() - t_phase:.1f}")
    phase_segmentation_step(torch, np, "ddrnet_23", tag="19b", **SEG_ZOO_STEP)
    print(f"[19b] seconds {time.perf_counter() - t_phase:.1f}")
    phase_seg_zoo_recipes(torch, np, root, cityscapes_root)
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 19 launched K1 {launched} times; segmentation has no NMS")
    print(f"[19] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 19: {launched}")


def phase_seg_zoo_predict(torch, np, name, hw=SEG_ZOO_HW, num_classes=19, images=None, tag="19a", cudnn_ratio=2.0):
    """(a) fp32 predict (TF32 off) of two images (two seeded 1024x2048 ones by default) at the
    model's ``hw`` on the card and on the CPU: class maps agree on >= SEG_AGREEMENT of the
    pixels; the card's logits of the first SEG_ZOO_FP64_IMAGES images within ``cudnn_ratio``
    times the CPU's distance to an fp64 CPU run, and, where that limit is looser than twice,
    the same forward with cuDNN off within twice; and the fp32 forward at b2 timed."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models.sg_model import SegmentationModel

    model = models.get(name, num_classes=num_classes, seed=0, input_hw=hw, device="cuda")
    cpu_model = models.get(name, num_classes=num_classes, seed=0, input_hw=hw, device="cpu")
    check(isinstance(model, SegmentationModel) and model.num_classes == num_classes,
          f"{name} is not a {num_classes}-class segmenter")
    images = seg_request(np, 33)[:2] if images is None else images
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = list(model.predict(images, batch_size=2))
        _, batches, _ = model._prep_host_batches(images[:SEG_ZOO_FP64_IMAGES], SEG_ZOO_FP64_IMAGES)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
        net = model._deploy_net(False, False)
        with torch.inference_mode():
            g_logits = net(x.cuda()).double().cpu()
            if cudnn_ratio > 2:
                torch.backends.cudnn.enabled = False
                try:
                    o_logits = net(x.cuda()).double().cpu()
                finally:
                    torch.backends.cudnn.enabled = True
            batch = torch.from_numpy(model._prep_host_batches(images, 2)[1][0]).permute(0, 3, 1, 2).cuda()
            forward_ms = cuda_ms(lambda: net(batch), iters=5)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    cpu = list(cpu_model.predict(images, batch_size=2))
    with torch.inference_mode():
        c_logits = cpu_model.net(x).double()
        r_logits = copy.deepcopy(cpu_model.net).double()(x.double())
    agree = [float((g.segmentation_map == c.segmentation_map).mean()) for g, c in zip(gpu, cpu)]
    e_gpu, e_cpu = float((g_logits - r_logits).abs().max()), float((c_logits - r_logits).abs().max())
    slack = 1e-6 * float(r_logits.abs().max())
    ratio = e_gpu / max(e_cpu, 1e-30)
    off = None
    if cudnn_ratio > 2:
        e_off = float((o_logits - r_logits).abs().max())
        off = (e_off, e_off / max(e_cpu, 1e-30))
    top2 = r_logits.topk(2, dim=1).values
    size = "x".join(map(str, hw))
    print(f"[{tag}] {name} {num_classes} classes at {size}, fp32 predict GPU vs CPU (TF32 off), two "
          f"{'x'.join(map(str, images[0].shape[:2]))} images: maps "
          f"{gpu[0].segmentation_map.shape} {gpu[0].segmentation_map.dtype}, pixels agreeing "
          f"{[round(a, 6) for a in agree]} (limit {SEG_AGREEMENT}); classes used "
          f"{len(np.unique(gpu[0].segmentation_map))}; logits of {SEG_ZOO_FP64_IMAGES} image(s) |GPU - fp64| max "
          f"{e_gpu:.3e}, |CPU - fp64| max {e_cpu:.3e}, ratio {ratio:.3f} (limit {cudnn_ratio}"
          f"{f'; cuDNN off: |GPU - fp64| max {off[0]:.3e}, ratio {off[1]:.3f}, limit 2' if off else ''}) (|logit| max "
          f"{float(r_logits.abs().max()):.2f}, top-2 gap median {float((top2[:, 0] - top2[:, 1]).median()):.3f}); fp32 "
          f"forward b2 on the card {forward_ms:.2f} ms (CUDA events, TF32 off)")
    check(len(gpu) == 2 and all(g.segmentation_map.shape == images[0].shape[:2] for g in gpu), f"{name} maps' shape")
    check(min(agree) >= SEG_AGREEMENT, f"{name}: GPU and CPU maps agree on {agree} of the pixels")
    check(e_gpu <= cudnn_ratio * e_cpu + slack, f"{name}: GPU logits {e_gpu} vs CPU {e_cpu} from fp64")
    check(off is None or off[0] <= 2 * e_cpu + slack,
          f"{name}: GPU logits with cuDNN off {off and off[0]} vs CPU {e_cpu} from fp64")
    del model, cpu_model, net, batch, g_logits, c_logits, r_logits
    torch.cuda.empty_cache()


def phase_seg_zoo_recipes(torch, np, root, data_root=None):
    """(c) train_from_recipe of cityscapes_ddrnet (DDRNet-23, OhemCELoss) and cityscapes_regseg48
    (RegSeg48, SegCrossEntropyLoss) with their own loaders (1024x1024 train crops, 1024x2048
    validation), b8, bf16, one epoch of two steps, on phase 15(d)'s Cityscapes-layout tree at
    ``data_root`` (16 train and 8 val 1024x2048 PNGs), or, without it, on a tree of 16 train and 4
    val written here by the same writer: losses and metrics finite, every parameter changed."""
    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.common import config
    from tools.cityscapes_synthetic import write_cityscapes_tree

    ckpt_root = os.path.join(root, "ckpt")
    if data_root is None:
        data_root = os.path.join(root, "cityscapes")
        t0 = time.perf_counter()
        write_cityscapes_tree(data_root, train=16, val=4, height=1024, width=2048, seed=1)
        print(f"[19c] Cityscapes-layout tree (16 train + 4 val 1024x2048 PNGs) written in "
              f"{time.perf_counter() - t0:.1f} s")
    else:
        print("[19c] on phase 15(d)'s Cityscapes-layout tree (16 train + 8 val 1024x2048 PNGs)")
    workers = min(8, os.cpu_count())
    for recipe in SEG_ZOO_RECIPES:
        cuts = ["epochs=1", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}", "training_hyperparams.mixed_precision=True",
                f"dataset_params.train_dataset_params.root={data_root}",
                f"dataset_params.val_dataset_params.root={data_root}",
                "training_hyperparams.sg_logger_params.tensorboard=False"]
        cfg = config.load_recipe(recipe, overrides=cuts)
        initial = {k: v.detach().clone() for k, v in models.get(cfg["architecture"], num_classes=19).net.named_parameters()}
        t0 = time.perf_counter()
        _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        live = dict(trainer.train_state.net.named_parameters())
        unchanged = [k for k, v in initial.items() if torch.equal(v, live[k])]
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        print(f"[19c] train_from_recipe {recipe} ({cfg['architecture']}, {cfg['training_hyperparams']['loss']}, "
              f"{cfg['train_dataloader']}, bf16, {workers} workers, cuts {cuts[:2]}): {trainer.train_state.step} steps "
              f"in {seconds:.1f} s; losses {history}; validation {json.dumps(valid)}; parameters unchanged "
              f"{len(unchanged)} of {len(initial)}")
        check(trainer.train_state.step == 2 and len(history) == 1 and all(np.isfinite(history)),
              f"{recipe}: {trainer.train_state.step} steps, losses {history}")
        check(len(valid) == 1 and "IoU" in valid[0] and np.isfinite(list(valid[0].values())).all(),
              f"{recipe} validation results {valid}")
        check(not unchanged, f"{recipe}: parameters the training left unchanged: {unchanged[:5]}")
        del trainer, initial, live
        torch.cuda.empty_cache()


# ------------------------------------- phase 20: ShelfNet, LadderNet and the COCO / Supervisely recipes

SHELF_MODELS = ("shelfnet34_lw", "shelfnet50", "laddernet_50")
SHELF_HW = (512, 512)  # the COCO segmentation recipe's size
SHELF_CLASSES = 21  # the recipe's COCO sub-classes
# 20(a)'s limit on |GPU - fp64| / |CPU - fp64| of the logits through cuDNN. Run alone on its fp64
# input, no convolution of the three models went past 8.6x the CPU's distance through cuDNN's fp32
# algorithms (medians 2.8-4.7x; TF32 off, deterministic or benchmarked alike), against medians of
# 1.1-1.3x with cuDNN off (tools/cudnn_conv_drift.py on an H100), so a net of them stays under its
# worst layer's ratio. The same forward with cuDNN off keeps phase 19's twice.
SHELF_CUDNN_RATIO = 9.0
SHELF_RECIPES = ("coco_segmentation_shelfnet_lw", "supervisely_unet")


def phase_shelfnet(torch, np, nms_exact, root):
    """ShelfNet-LW / HW and LadderNet at 512x512, 21 classes, and the COCO and Supervisely
    segmentation recipes, launching no kernel (K1 must count 0 here): (a) fp32 predict GPU vs
    CPU, (b) the COCO recipe's bf16 step of ShelfNet34-LW with ShelfNetOHEMLoss over its three
    heads at b32 by part, (c) train_from_recipe of coco_segmentation_shelfnet_lw and
    supervisely_unet on trees written here, each checkpoint evaluated again."""
    from super_gradients_tpu_torch.common import config

    launches_before = nms_exact.exact_nms_keep.launches
    t_phase = time.perf_counter()
    rng = np.random.RandomState(20)
    images = [rng.randint(0, 256, (*SHELF_HW, 3), dtype=np.uint8) for _ in range(2)]
    for name in SHELF_MODELS:
        phase_seg_zoo_predict(torch, np, name, hw=SHELF_HW, num_classes=SHELF_CLASSES, images=images, tag="20a",
                              cudnn_ratio=SHELF_CUDNN_RATIO)
        print(f"[20a] {name} seconds {time.perf_counter() - t_phase:.1f}")
    recipe_tp = config.load_recipe("coco_segmentation_shelfnet_lw")["training_hyperparams"]
    phase_segmentation_step(torch, np, "shelfnet34_lw", "ShelfNetOHEMLoss", 32, hw=SHELF_HW, tag="20b",
                            criterion_params=recipe_tp["criterion_params"], num_classes=SHELF_CLASSES,
                            training_params=recipe_tp)
    print(f"[20b] seconds {time.perf_counter() - t_phase:.1f}")
    phase_shelf_recipes(torch, np, root)
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 20 launched K1 {launched} times; segmentation has no NMS")
    print(f"[20] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 20: {launched}")


def phase_shelf_recipes(torch, np, root):
    """(c) train_from_recipe of the two recipes at their own image size and batch (bf16, as the
    card trains), one epoch of two steps on a seeded tree of two batches of train images and one
    of val images at that size: losses and metrics finite, every parameter changed;
    evaluate_checkpoint within 1e-6 of a direct Trainer.evaluate, a planted fault (a fresh model's
    BN statistics) beyond it."""
    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.common import config
    from tools.segmentation_synthetic import recipe_cuts, write_recipe_tree

    ckpt_root = os.path.join(root, "ckpt")
    workers = min(2, os.cpu_count())  # one a batch: an epoch has two train batches and one val batch
    for recipe in SHELF_RECIPES:
        own = config.load_recipe(recipe)["dataset_params"]["train_dataset_params"]
        batch, (h, w) = own["batch_size"], own["image_size"]
        t0 = time.perf_counter()
        data_root = write_recipe_tree(recipe, os.path.join(root, "data"), train=2 * batch, val=batch, height=h, width=w)
        print(f"[20c] {recipe}: tree of {2 * batch} train + {batch} val {h}x{w} images written in "
              f"{time.perf_counter() - t0:.1f} s")
        cuts = recipe_cuts(recipe, data_root, ckpt_root, workers=workers) + ["training_hyperparams.mixed_precision=True"]
        cfg = config.load_recipe(recipe, overrides=cuts)
        build = dict(num_classes=cfg["num_classes"], arch_params=cfg.get("arch_params"))
        initial = {k: v.detach().clone() for k, v in models.get(cfg["architecture"], **build).net.named_parameters()}
        t0 = time.perf_counter()
        _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        live = dict(trainer.train_state.net.named_parameters())
        unchanged = [k for k, v in initial.items() if torch.equal(v, live[k])]
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        print(f"[20c] train_from_recipe {recipe} ({cfg['architecture']}, {cfg['num_classes']} classes, "
              f"{cfg['training_hyperparams']['loss']}, {cfg['train_dataloader']}, bf16, b{batch} at {h}x{w}, {workers} "
              f"workers): {trainer.train_state.step} steps in {seconds:.1f} s; losses {history}; validation "
              f"{json.dumps(valid)}; parameters unchanged {len(unchanged)} of {len(initial)}")
        check(trainer.train_state.step == 2 and len(history) == 1 and all(np.isfinite(history)),
              f"{recipe}: {trainer.train_state.step} steps, losses {history}")
        check(len(valid) == 1 and np.isfinite(list(valid[0].values())).all(), f"{recipe} validation results {valid}")
        check(not unchanged, f"{recipe}: parameters the training left unchanged: {unchanged[:5]}")
        check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], trainer.ckpt_dir, ckpt_root, "20c", fault="bn")
        del trainer, initial, live
        torch.cuda.empty_cache()


# ------------------------------------- phase 21: the rest of the classification zoo, RMSProp and Lion

CLS_ZOO_MODELS = ("efficientnet_b0", "regnetY800", "repvgg_a0", "vit_base", "densenet121", "beit_base_patch16_224")
CLS_ZOO_FORWARD_B = 32  # the fp32 forward timed in 21(a)
CLS_ZOO_STEPS = (("imagenet_efficientnet", "efficientnet_b0", 128), ("imagenet_vit_base", "vit_base", 64))
CLS_ZOO_OPT_STEPS = 5  # 21(c)'s steps on identical gradients
CLS_ZOO_OPT_TOL = 1e-12  # |card - CPU| over max |parameter| of 21(c)'s fp64 runs
CLS_ZOO_RECIPES = ("imagenet_efficientnet", "imagenet_vit_base")
CLS_ZOO_RECIPE_BATCH = 100  # 21(d)'s batch: phase 14(c)'s 200 train PNGs make an epoch of two steps


def classifier_head(net):
    """The last ``Linear`` of a classification net: its head in every family of phase 21."""
    import torch

    return [m for m in net.modules() if isinstance(m, torch.nn.Linear)][-1]


def phase_cls_zoo(torch, np, nms_exact, root, imagenet_root):
    """The rest of the classification zoo at full width (ImageNet's 224, 1000 classes, seed 0),
    RMSProp and Lion, launching no kernel (K1 must count 0 here): (a) fp32 predict GPU vs CPU and
    the fp32 forward at b32, (b) the imagenet_efficientnet and imagenet_vit_base bf16 steps by part,
    (c) RMSProp and Lion on the card against the CPU, (d) train_from_recipe of the two recipes on
    phase 14(c)'s ImageFolder tree at ``imagenet_root``."""
    launches_before = nms_exact.exact_nms_keep.launches
    t_phase = time.perf_counter()
    for name in CLS_ZOO_MODELS:
        phase_cls_zoo_predict(torch, np, name)
    print(f"[21a] seconds {time.perf_counter() - t_phase:.1f}")
    for recipe, name, b in CLS_ZOO_STEPS:
        phase_cls_zoo_step(torch, np, recipe, name, b)
    print(f"[21b] seconds {time.perf_counter() - t_phase:.1f}")
    phase_cls_zoo_optimizers(torch, np)
    print(f"[21c] seconds {time.perf_counter() - t_phase:.1f}")
    phase_cls_zoo_recipes(torch, np, root, imagenet_root)
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 21 launched K1 {launched} times; classification has no NMS")
    print(f"[21] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 21: {launched}")


def card_copy(cpu_model):
    """A copy of ``cpu_model`` (its weights, processing and class names) on the card."""
    return type(cpu_model)(name=cpu_model.name, net=copy.deepcopy(cpu_model.net), num_classes=cpu_model.num_classes,
                           config=cpu_model.config, processing=cpu_model._processing,
                           class_names=cpu_model._class_names, device="cuda")


def calibrate_on(torch, net, x):
    """Every BN's running statistics from one eval-mode forward of ``x`` (``models.get``'s
    calibration, on a given batch in place of uniform noise)."""

    def set_stats(bn, inputs):
        bn.running_mean.copy_(inputs[0].mean(dim=(0, 2, 3)))
        bn.running_var.copy_(inputs[0].var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        with torch.no_grad():
            net.eval()(x)
    finally:
        for hook in hooks:
            hook.remove()


def phase_cls_zoo_predict(torch, np, name):
    """(a) ``name`` on the card and on the CPU from one seed, the BN statistics set on the
    standardized request itself (calibrated on uniform noise, the random-init BN nets amplify an
    fp32 rounding difference ~2x a block: EfficientNet-B0's CPU logits land ~15% of their std from
    fp64, which no top-1 gate survives) and its head scaled (the same factor on both) to a logit std
    of 2 on the request, as in phase 14: fp32 ``predict()`` of four seeded images, TF32 off, top-1
    equal and top-5 probabilities within ``CLS_CONF_TOL``; the logits' distances to an fp64 CPU run
    printed; the fp32 forward at b32 timed. RepVGG-A0 also in its deploy form (``fuse_repvgg``) on
    the card against the unfused CPU model."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.models.classification.repvgg import fuse_repvgg

    t0 = time.perf_counter()
    cpu_model = models.get(name, num_classes=1000, seed=0, device="cpu")
    images = request_images(np, 21)
    _, batches, _ = cpu_model._prep_host_batches(images, 4)
    x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
    calibrate_on(torch, cpu_model.net, x)
    with torch.inference_mode():
        std = float(cpu_model.net(x).std())
    with torch.no_grad():
        head = classifier_head(cpu_model.net)
        head.weight.mul_(2.0 / std)
        head.bias.mul_(2.0 / std)
    cpu_model._deploy_nets.clear()
    model = card_copy(cpu_model)
    variants = [("", model)]
    if name.startswith("repvgg"):
        fused = card_copy(cpu_model)
        fuse_repvgg(fused.net)
        variants.append((" fused", fused))
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = []
        for tag, m in variants:
            gpu = list(m.predict(images))
            with torch.inference_mode():
                g_logits = m._deploy_net(False, False)(x.cuda()).double().cpu()
            results.append((tag, gpu, g_logits))
        net = model._deploy_net(False, False)
        batch = torch.randn((CLS_ZOO_FORWARD_B, 3, 224, 224), generator=torch.Generator().manual_seed(21)).cuda()
        batch = batch.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: net(batch), iters=10)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    cpu = list(cpu_model.predict(images))
    with torch.inference_mode():
        c_logits = cpu_model.net(x).double()
        r_logits = copy.deepcopy(cpu_model.net).double()(x.double())
    e_cpu = float((c_logits - r_logits).abs().max())
    for tag, gpu, g_logits in results:
        top1 = [(g.prediction, c.prediction) for g, c in zip(gpu, cpu)]
        conf_err = max(float(np.abs(g.confidence - c.confidence).max()) for g, c in zip(gpu, cpu))
        e_gpu = float((g_logits - r_logits).abs().max())
        print(f"[21a] {name}{tag} 1000 classes 224 fp32 predict GPU vs CPU (TF32 off; BN statistics set on the "
              f"request; head scaled by {2.0 / std:.3e}), "
              f"4-image request: top-1 {top1}; top-5 probabilities |GPU - CPU| max {conf_err:.3e} (limit "
              f"{CLS_CONF_TOL}); logits |GPU - fp64| max {e_gpu:.3e}, |CPU - fp64| max {e_cpu:.3e} (|logit| max "
              f"{float(r_logits.abs().max()):.2f})")
        check(len(gpu) == 4 and all(g.labels.shape == (5,) and np.isfinite(g.confidence).all() for g in gpu),
              f"{name}{tag} predict: a result is not 5 finite labels")
        check(all(a == b for a, b in top1), f"{name}{tag}: GPU and CPU top-1 differ: {top1}")
        check(conf_err <= CLS_CONF_TOL, f"{name}{tag}: top-5 probabilities differ by {conf_err} between GPU and CPU")
    print(f"[21a] {name} fp32 forward b{CLS_ZOO_FORWARD_B} at 224 (TF32 off, channels_last): {forward_ms:.2f} ms a "
          f"batch (CUDA events), {CLS_ZOO_FORWARD_B * 1e3 / forward_ms:.1f} img/s; {time.perf_counter() - t0:.1f} s")
    del model, cpu_model, variants, results, net, batch
    torch.cuda.empty_cache()


def phase_cls_zoo_step(torch, np, recipe, name, b):
    """(b) ``recipe``'s bf16 train step of ``name`` (1000 classes, 224) at ``b`` by part (forward,
    loss, backward, optimizer + EMA), as ``Trainer.prepare`` builds it from the recipe's
    hyperparameters, with its idle share and peak memory."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer

    tp = dict(config.load_recipe(recipe)["training_hyperparams"])
    optimizer, ema, clip = {"imagenet_efficientnet": ("RMSProp", True, None),
                            "imagenet_vit_base": ("SGD", False, 1.0)}[recipe]
    check((tp["optimizer"], bool(tp.get("ema")), tp.get("clip_grad_norm")) == (optimizer, ema, clip)
          and tp["optimizer_params"] == {"momentum": 0.9, "weight_decay": 1e-4} and tp["mixed_precision"]
          and tp["zero_weight_decay_on_bias_and_bn"] and tp["criterion_params"] == {"smooth_eps": 0.1},
          f"the {recipe} regime changed: {tp}")
    t0 = time.perf_counter()
    model = models.get(name, num_classes=1000, seed=0, device="cuda")
    step = Trainer(f"chip_smoke_{recipe}_timing").prepare(model, tp, steps_per_epoch=100)
    build_s = time.perf_counter() - t0
    check(type(step.state.optimizer).__name__ == optimizer, f"{recipe}: {type(step.state.optimizer)}")
    images = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(b)).cuda()
    images = images.contiguous(memory_format=torch.channels_last)
    targets = torch.randint(0, 1000, (b,), generator=torch.Generator().manual_seed(b + 1)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = step_runner(step, images, targets)
    t0 = time.perf_counter()
    ms = time_by_part(torch, run)
    timed_s = time.perf_counter() - t0
    prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
    busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
    loss = run()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"{recipe} b{b} bf16 train loss not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[21b] {recipe} step ({name}, {optimizer}, EMA {ema}, clip {clip}, label smoothing 0.1) bf16 b{b} at "
          f"224: {ms['step']:.2f} ms/step, {b * 1e3 / ms['step']:.1f} img/s (CUDA events); forward "
          f"{ms['forward']:.2f}, loss {ms['loss']:.2f}, backward {ms['backward']:.2f}, optimizer + EMA "
          f"{ms['update']:.2f} ms; profiled (device activity only): "
          f"wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; peak "
          f"memory {peak:.2f} GiB; model and step built in {build_s:.1f} s, 3 warmup + 10 timed steps {timed_s:.1f} s")
    del model, step, images, targets, loss, prof_events
    torch.cuda.empty_cache()


def phase_cls_zoo_optimizers(torch, np):
    """(c) RMSProp (momentum 0.9, weight decay 1e-4 off the 1-D tensors) and Lion (weight decay
    0.1, the same mask) over EfficientNet-B0's parameters, CLS_ZOO_OPT_STEPS steps of seeded
    gradients at a changing LR, in fp64 on the card and on the CPU: |card - CPU| over the largest
    |parameter| within CLS_ZOO_OPT_TOL; then the fp32 step on the card timed."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training.optimizers import build_optimizer

    source = dict(models.get("efficientnet_b0", num_classes=1000, seed=0, device="cpu").net.named_parameters())
    rng = np.random.RandomState(21)
    grads = [{k: torch.from_numpy(rng.randn(*v.shape)) * scale for k, v in source.items()}
             for scale in (0.05, 3.0, 0.1, 6.0, 0.5)[:CLS_ZOO_OPT_STEPS]]
    lrs = (0.1, 0.05, 0.2, 0.01, 0.3)[:CLS_ZOO_OPT_STEPS]
    for name, params, lr_scale in (("RMSProp", {"momentum": 0.9, "weight_decay": 1e-4}, 1e-2),
                                   ("Lion", {"weight_decay": 0.1}, 1e-3)):
        finals = {}
        for device in ("cuda", "cpu"):
            tensors = {k: torch.nn.Parameter(v.detach().double().to(device)) for k, v in source.items()}
            opt = build_optimizer(name, list(tensors.items()), params, zero_weight_decay_on_bias_and_bn=True)
            for lr, g in zip(lrs, grads):
                for group in opt.param_groups:
                    group["lr"] = lr * lr_scale * group["lr_mult"]
                for k, t in tensors.items():
                    t.grad = g[k].to(device)
                opt.step()
            finals[device] = {k: t.detach().cpu() for k, t in tensors.items()}
        scale = max(float(v.abs().max()) for v in finals["cpu"].values())
        err = max(float((finals["cuda"][k] - finals["cpu"][k]).abs().max()) for k in source) / scale
        moved = max(float((finals["cpu"][k] - source[k].detach().double()).abs().max()) for k in source)
        tensors = {k: torch.nn.Parameter(v.detach().float().cuda()) for k, v in source.items()}
        opt = build_optimizer(name, list(tensors.items()), params, zero_weight_decay_on_bias_and_bn=True)
        for group in opt.param_groups:
            group["lr"] = 1e-3 * group["lr_mult"]
        for k, t in tensors.items():
            t.grad = grads[0][k].float().cuda()
        step_ms = cuda_ms(opt.step, iters=20)
        n = sum(v.numel() for v in source.values())
        print(f"[21c] {name} {params} over EfficientNet-B0's {n} parameters, {len(lrs)} steps at LRs "
              f"{[lr * lr_scale for lr in lrs]}, fp64: |card - CPU| / max |parameter| {err:.3e} (limit "
              f"{CLS_ZOO_OPT_TOL}), the parameters moved up to {moved:.3e}; fp32 step on the card {step_ms:.3f} ms "
              f"(CUDA events, foreach ops)")
        check(err <= CLS_ZOO_OPT_TOL, f"{name} on the card differs from the CPU by {err}")
        check(moved > 1e-4, f"{name} left the parameters where they were")
        del tensors, opt
    torch.cuda.empty_cache()


def phase_cls_zoo_recipes(torch, np, root, imagenet_root):
    """(d) train_from_recipe of imagenet_efficientnet (RMSProp, EMA) and imagenet_vit_base (SGD,
    clip_grad_norm) at their published widths on phase 14(c)'s ImageFolder tree (10 classes, 200
    train and 40 val PNGs read at 224), bf16, one epoch of two steps of b100 (the warmup cut to 0
    epochs, where it would hold the LR at its start), 8 workers, validated: losses and metrics
    finite, every parameter changed; evaluate_checkpoint within 1e-6 of a direct Trainer.evaluate,
    a planted fault beyond it."""
    from super_gradients_tpu_torch import models, train_from_recipe
    from super_gradients_tpu_torch.common import config

    ckpt_root = os.path.join(root, "ckpt")
    workers = min(8, os.cpu_count())
    for recipe in CLS_ZOO_RECIPES:
        cuts = ["epochs=1", "num_classes=10", f"batch_size={CLS_ZOO_RECIPE_BATCH}", "val_batch_size=40",
                f"num_workers={workers}",
                f"ckpt_root_dir={ckpt_root}", f"dataset_params.train_dataset_params.data_dir={imagenet_root}",
                f"dataset_params.val_dataset_params.data_dir={imagenet_root}",
                "training_hyperparams.lr_warmup_epochs=0",
                "training_hyperparams.sg_logger_params.tensorboard=False"]
        cfg = config.load_recipe(recipe, overrides=cuts)
        fresh = models.get(cfg["architecture"], num_classes=10, arch_params=cfg.get("arch_params"))
        initial = {k: v.detach().clone() for k, v in fresh.net.named_parameters()}
        del fresh
        t0 = time.perf_counter()
        _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        live = dict(trainer.train_state.net.named_parameters())
        unchanged = [k for k, v in initial.items() if torch.equal(v, live[k])]
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        tp = cfg["training_hyperparams"]
        print(f"[21d] train_from_recipe {recipe} ({cfg['architecture']}, {tp['optimizer']}, EMA {bool(tp.get('ema'))}, "
              f"{cfg['train_dataloader']}, bf16, {workers} workers, cuts {cuts[:4]}): {trainer.train_state.step} steps "
              f"in {seconds:.1f} s; losses {history}; validation {json.dumps(valid)}; parameters unchanged "
              f"{len(unchanged)} of {len(initial)}")
        check(trainer.train_state.step == 2 and len(history) == 1 and all(np.isfinite(history)),
              f"{recipe}: {trainer.train_state.step} steps, losses {history}")
        check(len(valid) == 1 and set(valid[0]) == {"Accuracy", "Top5", "Loss"}
              and np.isfinite(list(valid[0].values())).all(), f"{recipe} validation results {valid}")
        check(not unchanged, f"{recipe}: parameters the training left unchanged: {unchanged[:5]}")
        check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], trainer.ckpt_dir, ckpt_root, "21d",
                                  fault="ema" if tp.get("ema") else "fresh")
        del trainer, initial, live
        torch.cuda.empty_cache()


# phase 22: the exported programs' batches, and the KD recipe's batch in 22(b)'s recipe run (phase 14(c)'s
# 200 train PNGs make one epoch of two steps)
EXPORT_BATCHES = (1, 8)
KD_RECIPE_BATCH = 100
KD_STEP_B = 192  # imagenet_resnet50_kd.yaml's train batch
SEG_KD_STEP_B = 16  # cityscapes_kd_base.yaml's train batch, at its 512x1024


class CaptureK1:
    """Records each call of K1's op ``sg_torch::nms_exact_keep`` (its inputs and its keep mask)
    made inside a ``with`` block, as an exported program makes it."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        op, calls = torch.ops.sg_torch.nms_exact_keep.default, []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is op:
                    calls.append((args, out))
                return out

        self.mode, self.calls = Mode(), calls

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def letterboxed_uint8(np, model, images):
    """``images`` through ``model``'s host preprocessing (letterbox to its input, /255), with the
    division undone exactly: the uint8 batch an exported program takes."""
    _, batches, _ = model._prep_host_batches(images, len(images))
    return np.rint(batches[0] * 255.0).astype(np.uint8)


class ResultSet:
    """One image's detections or poses (numpy fields) as ``match_detections`` and ``pose_matched`` read them."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def __len__(self):
        return len(self.bboxes_xyxy)


def detections_of(np, out, i):
    """Image ``i`` of a batched ``NMSOutput``."""
    n = int(out.num_detections[i])
    return ResultSet(bboxes_xyxy=out.boxes[i, :n].float().cpu().numpy(), confidence=out.scores[i, :n].float().cpu().numpy(),
                     labels=out.labels[i, :n].cpu().numpy())


def poses_of(out, i):
    """Image ``i`` of a batched ``PoseNMSOutput``."""
    n = int(out.num_detections[i])
    return ResultSet(bboxes_xyxy=out.boxes[i, :n].cpu().numpy(), poses=out.poses[i, :n].cpu().numpy())


def phase_export(torch, np, nms_exact, matched_fraction, box_iou, root):
    """22(a) export at full width: YOLO-NAS-M (80 classes, 640, seed 0, cls_pred biases 0) exported
    fused bf16 with exact NMS at b1 and b8, saved, loaded, run on phase 3's letterboxed request and
    on noise: num_detections equal to the live predict_batch_tensor, >= 99% of the detections matched
    at IoU 0.99, K1 launched inside the loaded program and bit-equal to its plain version on the
    candidates captured there; export seconds, artifact MB, the exported and live b8 batch ms and
    K1's op dispatch against its direct launch. Then YOLO-NAS-POSE-S (640) and PP-LiteSeg-T
    (512x1024) exported in fp32 and held, on the card, to the CPU's live forward by phase 13(a)'s and
    phase 15(a)'s gates. Returns (K1 launches of the exported and live programs, the largest K1 vs
    plain difference)."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.conversion.export import load_exported

    t_phase = time.perf_counter()
    model = zero_cls_bias(models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda"))
    request = letterboxed_uint8(np, model, request_images(np, 3))  # [4, 640, 640, 3]
    noise = np.random.RandomState(22).randint(0, 256, (8, 640, 640, 3), dtype=np.uint8)
    kw = dict(nms_mode="exact", fuse_model=True, bf16=True)
    launches, max_err, programs = 0, 0.0, {}
    for b in EXPORT_BATCHES:
        path = os.path.join(root, f"yolo_nas_m_b{b}.pt2")
        t0 = time.perf_counter()
        result = model.export(path, batch_size=b, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = programs[b] = load_exported(path)
        load_s = time.perf_counter() - t0
        inputs = [request[i:i + 1] for i in range(len(request))] if b == 1 else \
            [np.concatenate([request, noise[:4]]), noise]
        fractions, bit_equal, dets = [], True, []
        for x in inputs:
            before = nms_exact.exact_nms_keep.launches
            with CaptureK1(torch) as capture:
                got = program.call(x)
            torch.cuda.synchronize()
            inside = nms_exact.exact_nms_keep.launches - before
            check(inside == 1 and len(capture.calls) == 1,
                  f"the loaded b{b} program launched K1 {inside} times ({len(capture.calls)} op calls), expected 1")
            (boxes, valid, t), keep = capture.calls[0]
            ref = nms_exact.exact_nms_keep_plain(boxes.cpu(), valid.cpu(), t)
            err = float((keep.cpu().float() - ref.float()).abs().max())
            check(err == 0.0, f"K1 inside the b{b} program differs from its plain version")
            max_err = max(max_err, err)
            live = model.predict_batch_tensor(torch.from_numpy(x).cuda().float() / 255.0, **kw)
            torch.cuda.synchronize()
            launches += nms_exact.exact_nms_keep.launches - before
            check(torch.equal(got.num_detections, live.num_detections),
                  f"b{b}: exported num_detections {got.num_detections.tolist()} vs live {live.num_detections.tolist()}")
            bit_equal = bit_equal and all(torch.equal(a, c) for a, c in zip(got, live))
            for i in range(len(x)):
                fractions.append(matched_fraction(detections_of(np, got, i), detections_of(np, live, i), 0.99))
            dets += got.num_detections.tolist()
        print(f"[22a] yolo_nas_m 80 classes 640 fused bf16 exact NMS exported at b{b}: {export_s:.1f} s to export and "
              f"save, {load_s:.1f} s to load, artifact {os.path.getsize(path) / 1e6:.1f} MB, input {result.input_dtype} "
              f"{list(result.input_shape)}; on phase 3's request and noise: detections {dets}, num_detections equal "
              f"to the live predict_batch_tensor, matched at IoU 0.99 min {min(fractions):.4f}, bit-equal to live "
              f"{bit_equal}; K1 launched once a call inside the loaded program, bit-equal to its plain version on the "
              f"captured candidates")
        check(min(fractions) >= 0.99, f"b{b}: exported vs live matched fractions {fractions}")
    # timing, outside the launch count: the exported program against the live path at b8, and the op's dispatch
    before = nms_exact.exact_nms_keep.launches
    x8 = torch.from_numpy(noise).cuda()
    xf = x8.float() / 255.0
    exported_ms = cuda_ms(lambda: programs[8].call(x8), iters=10)
    live_ms = cuda_ms(lambda: model.predict_batch_tensor(xf, **kw), iters=10)
    with CaptureK1(torch) as capture:
        programs[8].call(x8)
    (boxes, valid, t), _ = capture.calls[0]
    op_ms = cuda_ms(lambda: nms_exact.exact_nms_keep(boxes, valid, t), iters=200)
    direct_ms = cuda_ms(lambda: nms_exact._nms_exact_keep_cuda(boxes, valid, t), iters=200)
    torch.cuda.synchronize()
    nms_exact.exact_nms_keep.launches = before
    print(f"[22a] b8 batch (CUDA events, as the host issues it): exported program {exported_ms:.2f} ms, live "
          f"predict_batch_tensor {live_ms:.2f} ms (phase 5's path); K1 through its op {op_ms:.4f} ms a call, its "
          f"direct launch {direct_ms:.4f} ms: the op's dispatch costs {1e3 * (op_ms - direct_ms):.1f} us, "
          f"{100 * (op_ms - direct_ms) / live_ms:.3f}% of the live b8 batch")
    del programs, model, x8, xf, boxes, valid
    torch.cuda.empty_cache()
    print(f"[22a] detection seconds {time.perf_counter() - t_phase:.1f}")

    launches += phase_export_pose(torch, np, nms_exact, box_iou, root)
    phase_export_segmentation(torch, np, root)
    print(f"[22a] seconds {time.perf_counter() - t_phase:.1f}; K1 launches {launches}")
    return launches, max_err


def phase_export_pose(torch, np, nms_exact, box_iou, root):
    """YOLO-NAS-POSE-S at 640 exported in fp32 (exact NMS, conf 0.01, up to POSE_MAX_PREDICTIONS
    poses) at b2, run on the card on phase 3's letterboxed request (two images) and held to the CPU's
    live fp32 predict_batch_tensor (TF32 off) by phase 13(a)'s gate. Returns K1's launches."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.conversion.export import load_exported

    t0 = time.perf_counter()
    model = zero_cls_bias(models.get("yolo_nas_pose_s", seed=0, device="cuda"))
    cpu_model = zero_cls_bias(models.get("yolo_nas_pose_s", seed=0, device="cpu"))
    x = letterboxed_uint8(np, cpu_model, request_images(np, 3)[:2])
    kw = dict(confidence_threshold=0.01, max_predictions=POSE_MAX_PREDICTIONS, bf16=False, nms_mode="exact")
    path = os.path.join(root, "yolo_nas_pose_s.pt2")
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.export(path, batch_size=len(x), **kw)
        export_s = time.perf_counter() - t0
        before = nms_exact.exact_nms_keep.launches
        got = load_exported(path).call(x)
        torch.cuda.synchronize()
        launched = nms_exact.exact_nms_keep.launches - before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    ref = cpu_model.predict_batch_tensor(torch.from_numpy(x).float() / 255.0, conf=0.01, max_predictions=POSE_MAX_PREDICTIONS,
                                         bf16=False, fuse_model=False)

    def iou_np(a, b):
        return box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    fractions, worst = [], 0.0
    for i in range(len(x)):
        frac, px = pose_matched(np, iou_np, poses_of(got, i), poses_of(ref, i))
        fractions.append(frac)
        worst = max(worst, px)
    print(f"[22a] yolo_nas_pose_s 640 fp32 exported (exact NMS, conf 0.01) at b{len(x)}: {export_s:.1f} s, artifact "
          f"{os.path.getsize(path) / 1e6:.1f} MB; on the card vs the CPU's live forward (TF32 off): poses "
          f"{got.num_detections.tolist()} vs {ref.num_detections.tolist()}, matched at box IoU 0.99 "
          f"{[round(f, 4) for f in fractions]}, joints |card - CPU| max {worst:.4f} px (limit {POSE_PX_TOL}); K1 "
          f"launches {launched}")
    check(launched == 1, f"the loaded pose program launched K1 {launched} times, expected 1")
    check(min(fractions) >= 0.99 and int(got.num_detections.min()) > 0, f"exported pose matched fractions {fractions}")
    check(worst <= POSE_PX_TOL, f"exported poses differ by {worst} px from the CPU's")
    del model, cpu_model
    torch.cuda.empty_cache()
    return launched


def phase_export_segmentation(torch, np, root):
    """PP-LiteSeg-T (19 classes, 512x1024, seed 0) exported in fp32 at b2, run on the card on two of
    phase 15's images resized to its input, its class maps held to the CPU's live forward (TF32 off)
    by phase 15(a)'s SEG_AGREEMENT."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.conversion.export import load_exported
    from super_gradients_tpu_torch.inference.processing import resize

    t0 = time.perf_counter()
    model = models.get("pp_lite_t_seg", seed=0, device="cuda")
    cpu_model = models.get("pp_lite_t_seg", seed=0, device="cpu")
    x = np.stack([resize(img, (512, 1024)) for img in seg_request(np, 31)[:2]])
    path = os.path.join(root, "pp_lite_t_seg.pt2")
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.export(path, batch_size=len(x), image_hw=(512, 1024), bf16=False)
        export_s = time.perf_counter() - t0
        got = load_exported(path).call(x).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    proc = cpu_model.get_processing_params().get_equivalent_photometric_fn()
    with torch.inference_mode():
        ref = cpu_model.net(proc(torch.from_numpy(x).float()).permute(0, 3, 1, 2)).argmax(dim=1).int()
    agree = [float((got[i] == ref[i]).float().mean()) for i in range(len(x))]
    print(f"[22a] pp_lite_t_seg 19 classes 512x1024 fp32 exported at b{len(x)}: {export_s:.1f} s, artifact "
          f"{os.path.getsize(path) / 1e6:.1f} MB, output {got.dtype} {list(got.shape)}; class maps on the card vs the "
          f"CPU's live forward (TF32 off): pixels agreeing {[round(a, 6) for a in agree]} (limit {SEG_AGREEMENT}), "
          f"classes used {len(torch.unique(got))}")
    check(got.dtype == torch.int32 and tuple(got.shape) == (len(x), 512, 1024), "the exported class maps' type or shape")
    check(min(agree) >= SEG_AGREEMENT, f"exported PP-LiteSeg-T agrees with the CPU on {agree} of the pixels")
    del model, cpu_model
    torch.cuda.empty_cache()


def kd_step_by_part(torch, tag, recipe, cfg_overrides, b, hw, batch):
    """``recipe``'s train step of its ``kd_module`` (random weights, seed 0) in bf16 at ``b`` on
    ``batch`` (images, targets on the card), by part as Trainer.prepare builds it, with the teacher's
    and the student's forward alone, its idle share and peak memory; the teacher bit-unchanged."""
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.mixed_precision import autocast

    cfg = config.load_recipe(recipe, overrides=cfg_overrides)
    tp = dict(cfg["training_hyperparams"], mixed_precision=True)
    t0 = time.perf_counter()
    model = models.get("kd_module", num_classes=cfg["num_classes"], arch_params=cfg["arch_params"], seed=0)
    step = Trainer(f"chip_smoke_{recipe}_timing").prepare(model, tp, steps_per_epoch=100)
    build_s = time.perf_counter() - t0
    net = step.state.net
    teacher0 = {k: v.clone() for k, v in net.teacher.state_dict().items()}
    images, targets = batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = step_runner(step, images, targets)
    ms = time_by_part(torch, run)
    with torch.no_grad(), autocast(images.device, True):
        teacher_ms = cuda_ms(lambda: net.teacher(images), iters=5)
        student_ms = cuda_ms(lambda: net.student(images), iters=5)
    prof_events, wall_ms = profiled(torch, run, 5, with_cpu=False)
    busy_ms = sum(_self_device_us(e) for e in prof_events) / 1e3 / 5
    loss = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    changed = [k for k, v in net.teacher.state_dict().items() if not torch.equal(v, teacher0[k])]
    print(f"[{tag}] {recipe} step ({cfg['arch_params']['student']} from {cfg['arch_params']['teacher']}, "
          f"{tp['loss']}, {tp['optimizer']}, EMA {bool(tp.get('ema'))}) bf16 b{b} at {hw[0]}x{hw[1]}: {ms['step']:.2f} "
          f"ms/step, {b * 1e3 / ms['step']:.1f} img/s (CUDA events); forward {ms['forward']:.2f} (alone, no grad: "
          f"teacher {teacher_ms:.2f}, student {student_ms:.2f}), loss {ms['loss']:.2f}, backward {ms['backward']:.2f}, "
          f"optimizer + EMA {ms['update']:.2f} ms; profiled: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; peak memory {peak:.2f} GiB; built in {build_s:.1f} s; teacher "
          f"tensors changed {len(changed)} of {len(teacher0)}")
    check(bool(torch.isfinite(loss)), f"{recipe} bf16 b{b} KD loss not finite")
    check(not changed, f"{recipe}: the step changed the teacher's {changed[:5]}")
    del model, step, net, prof_events, loss
    torch.cuda.empty_cache()


def kd_fp32_step(torch, models, device, dtype, images, targets, teacher_sd, student_sd):
    """One KD SGD step (momentum 0.9, weight decay 1e-4, KDLogitsLoss T=2 c=0.5) of resnet18_cifar from
    resnet18_cifar on ``device`` in ``dtype``; returns the updated student state on the CPU in fp64."""
    from super_gradients_tpu_torch.training import Trainer

    model = models.get("kd_module", num_classes=10, device=device,
                       arch_params={"student": "resnet18_cifar", "teacher": "resnet18_cifar"})
    model.load_state_dict({**{f"student.{k}": v for k, v in student_sd.items()},
                           **{f"teacher.{k}": v for k, v in teacher_sd.items()}})
    model.net.to(dtype)
    tp = dict(loss="KDLogitsLoss", criterion_params={"temperature": 2.0}, initial_lr=0.1,
              optimizer_params={"momentum": 0.9, "weight_decay": 1e-4}, max_epochs=1)
    step = Trainer("chip_smoke_kd_fp32").prepare(model, tp, steps_per_epoch=1)
    step.run(images.to(device, dtype), targets.to(device))
    return {k: v.detach().cpu().double() for k, v in step.state.net.student.state_dict().items()}


def phase_kd(torch, np, nms_exact, root, imagenet_root, cityscapes_root):
    """22(b) knowledge distillation at full width, launching no kernel: imagenet_resnet50_kd's bf16
    step (ResNet-50 from BEiT-Base/16, 1000 classes, 224) at its b192 by part; the recipe through
    train_from_kd_recipe on phase 14(c)'s ImageFolder tree (10 classes), one epoch of two steps of
    b100, the teacher from a port-written .pth in a temporary $SG_PRETRAINED_DIR: the teacher
    bit-unchanged, the student moved, the losses finite, evaluate_checkpoint within 1e-6 of a direct
    Trainer.evaluate with a planted fault beyond it; one fp32 KD step of resnet18_cifar from
    resnet18_cifar at 32 px (TF32 off) within twice the CPU's distance to fp64; cityscapes_kd_base's
    bf16 step (DDRNet-23-slim from DDRNet-39, SegKDLoss) at its b16 and 512x1024 on a batch of phase
    15(d)'s Cityscapes tree, by part."""
    from super_gradients_tpu_torch import models, train_from_kd_recipe
    from super_gradients_tpu_torch.common import config
    from super_gradients_tpu_torch.training import Trainer

    launches_before = nms_exact.exact_nms_keep.launches
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(22)
    images = torch.randn((KD_STEP_B, 3, 224, 224), generator=gen).cuda().contiguous(memory_format=torch.channels_last)
    targets = torch.randint(0, 1000, (KD_STEP_B,), generator=gen).cuda()
    kd_step_by_part(torch, "22b", "imagenet_resnet50_kd", [], KD_STEP_B, (224, 224), (images, targets))
    del images, targets
    print(f"[22b] step seconds {time.perf_counter() - t_phase:.1f}")

    # the recipe, by overrides (its root: is not read by imagenet_train / _val, ROADMAP section 3)
    mirror, ckpt_root = os.path.join(root, "mirror"), os.path.join(root, "ckpt")
    os.makedirs(mirror)
    teacher = models.get("beit_base_patch16_224", num_classes=10, seed=7)
    teacher_sd = {k: v.detach().cpu().clone() for k, v in teacher.net.state_dict().items()}
    torch.save({"net": teacher_sd}, os.path.join(mirror, "beit_base_patch16_224_imagenet.pth"))
    del teacher
    workers = min(8, os.cpu_count())
    cuts = ["num_classes=10", "epochs=1", f"ckpt_root_dir={ckpt_root}", "training_hyperparams.lr_warmup_epochs=0",
            "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split, bs in (("train", KD_RECIPE_BATCH), ("val", 40)):
        cuts += [f"dataset_params.{split}_dataset_params.data_dir={os.path.join(imagenet_root, split)}",
                 f"dataset_params.{split}_dataset_params.batch_size={bs}",
                 f"dataset_params.{split}_dataset_params.num_workers={workers}"]
    cfg = config.load_recipe("imagenet_resnet50_kd", overrides=cuts)
    student0 = models.get("resnet50", num_classes=10, seed=0, device="cpu").net.state_dict()
    previous_mirror = os.environ.get("SG_PRETRAINED_DIR")
    os.environ["SG_PRETRAINED_DIR"] = mirror
    try:
        t0 = time.perf_counter()
        student, trainer = train_from_kd_recipe.main(["--config-name=imagenet_resnet50_kd", *cuts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trained_teacher = trainer.train_state.net.teacher.state_dict()
        changed = [k for k, v in teacher_sd.items() if not torch.equal(trained_teacher[k].cpu(), v)]
        moved = [k for k, v in student.net.state_dict().items() if not torch.equal(v.cpu(), student0[k])]
        history, valid = trainer.train_loss_history, trainer.valid_metrics_history
        print(f"[22b] train_from_kd_recipe imagenet_resnet50_kd (ResNet-50 from BEiT-Base/16 read from the mirror, "
              f"{cfg['training_hyperparams']['loss']}, {workers} workers, b{KD_RECIPE_BATCH}): "
              f"{trainer.train_state.step} steps in {seconds:.1f} s; losses {history}; validation {json.dumps(valid)}; "
              f"teacher tensors changed {len(changed)} of {len(teacher_sd)}; student tensors moved {len(moved)} of "
              f"{len(student0)}")
        check(trainer.train_state.step == 2 and len(history) == 1 and all(np.isfinite(history)),
              f"imagenet_resnet50_kd: {trainer.train_state.step} steps, losses {history}")
        check(len(valid) == 1 and np.isfinite(list(valid[0].values())).all(), f"KD validation results {valid}")
        check(not changed, f"the KD recipe changed the teacher's {changed[:5]}")
        check(len(moved) > len(student0) // 2, f"the KD recipe left the student where it was ({len(moved)} moved)")
        check_evaluate_checkpoint(torch, cfg, cfg["experiment_name"], trainer.ckpt_dir, ckpt_root, "22b", fault="ema")
    finally:
        if previous_mirror is None:
            os.environ.pop("SG_PRETRAINED_DIR", None)
        else:
            os.environ["SG_PRETRAINED_DIR"] = previous_mirror
    del student, trainer, trained_teacher
    torch.cuda.empty_cache()
    print(f"[22b] recipe seconds {time.perf_counter() - t_phase:.1f}")

    # one fp32 KD step of a cut pair on the card and on the CPU, held to an fp64 CPU step
    gen = torch.Generator().manual_seed(23)
    x, y = torch.rand((8, 3, 32, 32), generator=gen), torch.randint(0, 10, (8,), generator=gen)
    student_sd = models.get("resnet18_cifar", num_classes=10, seed=1, device="cpu").net.state_dict()
    teacher32 = models.get("resnet18_cifar", num_classes=10, seed=2, device="cpu").net.state_dict()
    tf32_before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = kd_fp32_step(torch, models, "cuda", torch.float32, x, y, teacher32, student_sd)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_before
    cpu = kd_fp32_step(torch, models, "cpu", torch.float32, x, y, teacher32, student_sd)
    ref = kd_fp32_step(torch, models, "cpu", torch.float64, x, y, teacher32, student_sd)
    keys = [k for k in ref if ref[k].is_floating_point()]

    def dist(a):
        return float(sum(((a[k] - ref[k]) ** 2).sum() for k in keys) ** 0.5)

    moved = float(sum(((ref[k] - student_sd[k].double()) ** 2).sum() for k in keys) ** 0.5)
    print(f"[22b] one fp32 KD SGD step of resnet18_cifar from resnet18_cifar at 32 px, b8 (TF32 off): the student's "
          f"distance to the fp64 CPU step: card {dist(card):.3e}, CPU {dist(cpu):.3e} (limit 2x); the step moved it "
          f"{moved:.3e}")
    check(dist(card) <= 2 * dist(cpu), f"the card's fp32 KD step lands {dist(card)} from fp64, the CPU's {dist(cpu)}")
    check(moved > 1e3 * dist(cpu), "the fp32 KD step did not move the student")

    # cityscapes_kd_base's step on a batch of phase 15(d)'s tree
    seg_cuts = [f"dataset_params.{s}_dataset_params.root={cityscapes_root}" for s in ("train", "val")]
    seg_cfg = config.load_recipe("cityscapes_kd_base", overrides=seg_cuts)
    loader = Trainer._loader_from_cfg(seg_cfg, "train")
    seg_images, seg_targets = next(iter(loader))
    close_loader(loader)
    check(tuple(seg_images.shape) == (SEG_KD_STEP_B, 3, 512, 1024), f"cityscapes_kd_base batch {tuple(seg_images.shape)}")
    seg_batch = (seg_images.cuda().float().contiguous(memory_format=torch.channels_last), seg_targets.cuda())
    kd_step_by_part(torch, "22b", "cityscapes_kd_base", seg_cuts, SEG_KD_STEP_B, (512, 1024), seg_batch)
    del seg_batch, seg_images, seg_targets
    torch.cuda.empty_cache()
    launched = nms_exact.exact_nms_keep.launches - launches_before
    check(launched == 0, f"phase 22(b) launched K1 {launched} times; KD has no NMS")
    print(f"[22b] seconds {time.perf_counter() - t_phase:.1f}; K1 launches {launched}")


def main():
    if not os.path.isdir(os.path.join(HERE, "super_gradients_tpu_torch")):
        print("chip_smoke: super_gradients_tpu_torch/ is not next to this script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.ops import bbox
    from super_gradients_tpu_torch.ops.kernels import build, nms_exact

    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t_script = t0 = time.perf_counter()
    lib = build.build("nms_exact.cu")
    print(f"[1] K1 library {lib.name} ready in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    max_err, timings = phase_kernel(torch, nms_exact, bbox.box_iou)
    model, launches = phase_slice(torch, np, models, nms_exact)
    phase_gpu_vs_cpu(torch, np, models, model, matched_fraction_fn(torch, np, bbox.box_iou))
    phase_timing(torch, model)
    max_err = max(max_err, phase_candidates(torch, model, nms_exact))
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_root:
        train_launches = phase_train(torch, np, models, nms_exact, ckpt_root)
        phase_train_gpu_vs_cpu(torch, np, models)
        one_process_ms = phase_train_timing(torch, np, models)
        phase_validation(torch, np, models, nms_exact, ckpt_root)
        max_err = max(max_err, phase_validation_timing(torch, np, models, nms_exact))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as root:
        recipe_launches = phase_recipe(torch, np, nms_exact, os.path.join(root, "ckpt"), os.path.join(root, "rf100"))
        os.makedirs(os.path.join(root, "surface"))
        surface_launches = phase_surface(torch, np, nms_exact, matched_fraction_fn(torch, np, bbox.box_iou),
                                         os.path.join(root, "rf100"), os.path.join(root, "surface"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_") as root:
        pose_launches, pose_err = phase_pose(torch, np, nms_exact, bbox.box_iou, root)
    max_err = max(max_err, pose_err)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as cls_root:  # its ImageFolder tree serves 21(d) too
        phase_classification(torch, np, nms_exact, cls_root)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_") as seg_root:  # its Cityscapes tree serves 19(c) too
            phase_segmentation(torch, np, nms_exact, seg_root)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as root:
                zoo_launches, zoo_err = phase_zoo(torch, np, nms_exact, matched_fraction_fn(torch, np, bbox.box_iou),
                                                  root)
            max_err = max(max_err, zoo_err)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ssd_") as root:
                ssd_launches, ssd_err = phase_mobilenet_ssd(torch, np, nms_exact,
                                                            matched_fraction_fn(torch, np, bbox.box_iou), root)
            max_err = max(max_err, ssd_err)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as root:
                ddp_launches = phase_ddp(torch, np, root, one_process_ms)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_zoo_") as root:
                phase_seg_zoo(torch, np, nms_exact, root, cityscapes_root=os.path.join(seg_root, "cityscapes"))
            with tempfile.TemporaryDirectory(prefix="chip_smoke_shelfnet_") as root:
                phase_shelfnet(torch, np, nms_exact, root)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_zoo_") as root:
                phase_cls_zoo(torch, np, nms_exact, root, imagenet_root=os.path.join(cls_root, "imagenet"))
            t_phase = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
                export_launches, export_err = phase_export(torch, np, nms_exact,
                                                           matched_fraction_fn(torch, np, bbox.box_iou), bbox.box_iou,
                                                           root)
            max_err = max(max_err, export_err)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_kd_") as root:
                phase_kd(torch, np, nms_exact, root, imagenet_root=os.path.join(cls_root, "imagenet"),
                         cityscapes_root=os.path.join(seg_root, "cityscapes"))
            print(f"[22] phase seconds {time.perf_counter() - t_phase:.1f}; K1 launches in phase 22: {export_launches}")

    print(f"chip_smoke: phases 1-22 passed in {time.perf_counter() - t_script:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else 'nvidia-smi unavailable'}")
    k1 = timings[8, 1024]  # the predict path's shape, every candidate valid
    print(json.dumps({"kernels": [{
        "name": "exact_nms_keep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches + train_launches + recipe_launches + surface_launches + pose_launches + zoo_launches
        + ssd_launches + ddp_launches + export_launches,
        "max_abs_err": max_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,  # PyTorch has no call for greedy NMS (torchvision.ops.nms is not PyTorch)
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ddp_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--ddp-rank"] else main())
