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
   plain version on it and timed as in phase 2, and ``batched_nms`` is timed whole.

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
K1_CUDA_KERNELS = ("nms_mask_kernel", "nms_sweep_kernel")
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate (at a 700 W limit)
H100_FP32_FLOP_PER_S = 67e12
H100_BYTES_PER_S = 3.35e12
IOU_FLOPS = 13  # 2 min, 2 max, 2 sub, 2 clamps, mul, add, sub, +eps, div, with areas computed once


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


def k1_kernel_ms(torch, fn, iters=50):
    """Mean device ms per call of each of K1's CUDA kernels (torch.profiler key_averages)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = dict.fromkeys(K1_CUDA_KERNELS, 0.0)
    for evt in prof.key_averages():
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else 'nvidia-smi unavailable'}")
    k1 = timings[8, 1024]  # the predict path's shape, every candidate valid
    print(json.dumps({"kernels": [{
        "name": "exact_nms_keep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,  # PyTorch has no call for greedy NMS (torchvision.ops.nms is not PyTorch)
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
