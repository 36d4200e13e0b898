#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``super_gradients_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``. It
imports nothing of JAX or of the JAX package, and exits non-zero (printing no
result) without CUDA or without the port's sources next to it. Phases:

1. build kernel K1 (exact-NMS keep mask, ``csrc/nms_exact.cu``) from the sources;
2. K1 against its plain PyTorch version on the card: keep masks bit-equal on random
   fixtures at the predict path's shape (B=8, K=1024), the suppression chain and
   threshold-adjacent IoUs; both timed at B=8 and B=32, K=1024;
3. the slice at full width: YOLO-NAS-M, 80 classes, random weights from seed 0
   (``cls_pred`` biases at 0), a few ``predict()`` requests on mixed-size uint8
   images and ``predict_batch_tensor`` on [8, 640, 640, 3], fused bf16 and fp32
   unfused; K1's launch counter must rise and every image must detect something;
4. the fp32 unfused forward and predict on the GPU (TF32 off) against the same
   model on the CPU (plain path);
5. fused bf16 ``predict_batch_tensor`` throughput at b8 and b32.

The line before the last is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "super_gradients_tpu_torch/csrc/nms_exact.cu"
KERNEL_REPLACES = "super_gradients_tpu/ops/pallas/nms_kernel.py:93"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds of fn() over iters calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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

    max_err = 0.0
    for name, b, v, t in fixtures:
        got = nms_exact.exact_nms_keep(b, v, t)
        torch.cuda.synchronize()
        ref = nms_exact.exact_nms_keep_plain(b, v, t)
        err = (got.float() - ref.float()).abs().max().item()
        check(err == 0.0, f"K1 keep mask differs from the plain version on {name}")
        max_err = max(max_err, err)
    check(nms_exact.exact_nms_keep(chain, ones3, 0.3).tolist() == [[True, False, True]], "chain keep mask")
    check(nms_exact.exact_nms_keep(pair, ones2, 0.3).tolist() == [[True, True]], "IoU == t must not suppress")
    check(nms_exact.exact_nms_keep(pair, ones2, below).tolist() == [[True, False]], "IoU > t must suppress")

    timings = {}
    for b in (8, 32):
        boxes, valid = random_sorted_boxes(torch, gen, b, 1024)
        ms = cuda_ms(lambda: nms_exact.exact_nms_keep(boxes, valid, 0.7), iters=50)
        plain_ms = cuda_ms(lambda: nms_exact.exact_nms_keep_plain(boxes, valid, 0.7), iters=3, warmup=1)
        timings[b] = (ms, plain_ms)
        print(f"[2] K1 B={b} K=1024: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else 'nvidia-smi unavailable'}")
    ms, plain_ms = timings[8]
    print(json.dumps({"kernels": [{
        "name": "exact_nms_keep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
