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
8. one fp32 SGD step (TF32 off) of YOLO-NAS-M at 640, b2, on the GPU and on the CPU,
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
   to 3 batches a worker: K1 4 launches inside it, every loss and metric finite,
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
   the ladder 8-64 with an 80 GB budget, each candidate's peak memory printed.

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


def matched_fraction_fn(torch, np, box_iou):
    def matched_fraction(a, b, iou_min):
        """One-to-one matches between two detection sets: same label, IoU >= iou_min
        (or identical boxes: clipping can make a box zero-area)."""
        if len(a) == 0 or len(b) == 0:
            return float(len(a) == len(b))
        iou = box_iou(torch.from_numpy(a.bboxes_xyxy), torch.from_numpy(b.bboxes_xyxy)).numpy()
        same = np.abs(a.bboxes_xyxy[:, None] - b.bboxes_xyxy[None]).max(-1) <= 1e-3
        ok = ((iou >= iou_min) | same) & (a.labels[:, None] == b.labels[None])
        used, matched = set(), 0
        for i in range(len(a)):
            for j in np.flatnonzero(ok[i]):
                if j not in used:
                    used.add(j)
                    matched += 1
                    break
        return matched / max(len(a), len(b))

    return matched_fraction


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


def _one_step(torch, model, images, targets, assign=None):
    """Forward, loss and backward of one fp32 SGD train step; returns the step,
    its assignment, its loss components and its gradients (fp64, on the CPU)."""
    from super_gradients_tpu_torch.training import Trainer

    params = dict(COCO_YOLO_NAS, optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-5},
                  ema=False, mixed_precision=False, lr_warmup_steps=0, initial_lr=1e-3)
    step = Trainer("chip_smoke_fp32").prepare(model, params, steps_per_epoch=1)
    out = step.forward(images)
    own = step.criterion.assign(out, targets)
    if assign is not None:
        step.criterion.assigner = _FixedAssigner(type(assign)(*(t.to(images.device, t.dtype if not t.is_floating_point()
                                                                          else images.dtype) for t in assign)))
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
        dataset = RandomDetectionDataset(num_samples=2, image_size=(640, 640), num_classes=80, max_boxes=120)
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


def phase_train_timing(torch, np, models):
    """bf16 train step of YOLO-NAS-M at 640, b16 and b32, on a batch already on the card."""
    from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer

    model = models.get("yolo_nas_m", num_classes=80, seed=0, device="cuda")
    for b in (16, 32):
        step = Trainer("chip_smoke_timing").prepare(model, dict(COCO_YOLO_NAS, lr_warmup_steps=1000), steps_per_epoch=100)
        dataset = RandomDetectionDataset(num_samples=b, image_size=(640, 640), num_classes=80, max_boxes=120)
        images, targets = (torch.from_numpy(np.stack(t)) for t in zip(*(dataset[i] for i in range(b))))
        images = images.cuda().contiguous(memory_format=torch.channels_last)
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
              f"forward {parts[0]:.2f}, loss {parts[1]:.2f}, backward {parts[2]:.2f}, optimizer+EMA {parts[3]:.2f} ms; "
              f"profiled (device activity only): wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms, "
              f"idle share {1 - busy_ms / wall_ms:.3f}; "
              f"peak memory {peak:.2f} GiB")
        print(f"[9] b{b} device time by kernel, per step: {len(kernels)} kinds, "
              f"{sum(e.count for e in kernels) // 5} launches; top: {top}")
        del step, images, targets, loss, events, kernels
        torch.cuda.empty_cache()


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
RECIPE_WAVES = 3  # train batches a loader worker makes an epoch in phase 11 (the set tiled by min_samples)
# evaluate_checkpoint against Trainer.evaluate of models.get(checkpoint_path=ckpt_best.pth), both
# fp32 on the same val set: |difference| of each metric, and of Loss relative to it
RECIPE_EVAL_TOL = 1e-6


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
            Image.fromarray(image).save(os.path.join(folder, f"{i:04d}.png"))
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
    """The loader alone at ``workers`` workers, one wave each, in turns: cv2's own pool in
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
        for name in list(variants) + list(variants)[::-1]:
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
    from super_gradients_tpu_torch import models, train_from_recipe
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
    best_path = os.path.join(trainer.ckpt_dir, "ckpt_best.pth")
    best = torch.load(best_path, map_location="cpu", weights_only=True)
    t2 = time.perf_counter()
    evaluated = Trainer.evaluate_checkpoint("roboflow_yolo_nas_m", ckpt_root_dir=ckpt_root, ckpt_name="ckpt_best")
    eval_seconds = time.perf_counter() - t2

    def differences(a, b):  # |a - b| of each metric, of Loss relative to b
        return {k: abs(a[k] - b[k]) / (abs(b[k]) if k == "Loss" else 1.0) for k in b}

    # the reference: the checkpoint loaded by models.get, evaluated directly on the recipe's val loader
    model = models.get(cfg["architecture"], num_classes=cfg["num_classes"], arch_params=cfg.get("arch_params"),
                       checkpoint_path=best_path)
    val_loader = Trainer._loader_from_cfg(cfg, "val")
    direct = Trainer("recipe_direct", ckpt_root_dir=ckpt_root).evaluate(model, val_loader, cfg["training_hyperparams"])
    diffs = differences(evaluated, direct)
    model.net.load_state_dict(best["net"])  # planted fault: the live weights where the EMA's belong
    fault = differences(Trainer("recipe_fault", ckpt_root_dir=ckpt_root).evaluate(model, val_loader,
                                                                                  cfg["training_hyperparams"]), direct)
    close_loader(val_loader)
    print(f"[11] resume_experiment: no step, state bit-equal, {resume_seconds:.1f} s; evaluate_checkpoint(ckpt_best, "
          f"epoch {best['epoch']}, fp32) {eval_seconds:.1f} s: {json.dumps(evaluated)}; |difference| to "
          f"Trainer.evaluate of models.get(checkpoint_path=ckpt_best.pth) (Loss relative): {json.dumps(diffs)}, limit "
          f"{RECIPE_EVAL_TOL}; planted fault (live weights for the EMA's): {json.dumps(fault)}; to the epoch's bf16 "
          f"validation: {json.dumps(differences(evaluated, valid[best['epoch']]))}")
    check(max(diffs.values()) <= RECIPE_EVAL_TOL, f"evaluate_checkpoint differs from Trainer.evaluate: {diffs}")
    check(max(fault.values()) > RECIPE_EVAL_TOL, f"the planted fault passes the evaluate_checkpoint gate: {fault}")
    del trainer, resumed, best, model

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
    print(f"[11] cv2 threads in the {workers} loader workers, loader alone in turns (img/s): "
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

    t0 = time.perf_counter()
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
        phase_train_timing(torch, np, models)
        phase_validation(torch, np, models, nms_exact, ckpt_root)
        max_err = max(max_err, phase_validation_timing(torch, np, models, nms_exact))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as root:
        recipe_launches = phase_recipe(torch, np, nms_exact, os.path.join(root, "ckpt"), os.path.join(root, "rf100"))
        os.makedirs(os.path.join(root, "surface"))
        surface_launches = phase_surface(torch, np, nms_exact, matched_fraction_fn(torch, np, bbox.box_iou),
                                         os.path.join(root, "rf100"), os.path.join(root, "surface"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else 'nvidia-smi unavailable'}")
    k1 = timings[8, 1024]  # the predict path's shape, every candidate valid
    print(json.dumps({"kernels": [{
        "name": "exact_nms_keep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches + train_launches + recipe_launches + surface_launches, "max_abs_err": max_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,  # PyTorch has no call for greedy NMS (torchvision.ops.nms is not PyTorch)
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
