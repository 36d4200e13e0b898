#!/usr/bin/env python3
"""How far a segmentation model's fp32 logits on the card land from fp64, against the CPU's,
under cuDNN's settings; then each convolution alone on its fp64 input:

    python3 tools/cudnn_conv_drift.py [--models shelfnet34_lw shelfnet50 laddernet_50] [--hw 512 512]
        [--classes 21] [--top 12]

Needs a GPU. TF32 is off throughout. For each model (seed 0, one seeded uint8 image through the
model's own preprocessing) it prints the largest |logit - fp64 CPU logit| of the CPU in fp32 and
of the card with cuDNN as it runs by default (channels_last, as ``predict`` deploys it, and
NCHW), with ``cudnn.deterministic``, with ``cudnn.benchmark`` and with cuDNN off, each over the
CPU's. Then every ``Conv2d`` / ``ConvTranspose2d`` is run alone on the input it saw in the fp64
run, on the CPU and on the card (cuDNN on and off), and the ``--top`` convolutions whose card
error is the largest multiple of the CPU's are listed with their shapes.
"""

import argparse
import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("default_cl", "default_nchw", "deterministic_cl", "benchmark_cl", "cudnn_off_cl")


@contextlib.contextmanager
def cudnn_settings(torch, **settings):
    """``torch.backends.cudnn``'s ``enabled`` / ``benchmark`` / ``deterministic`` set within, TF32
    left as it is (``cudnn.flags`` would turn it on)."""
    before = {k: getattr(torch.backends.cudnn, k) for k in settings}
    for k, v in settings.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            setattr(torch.backends.cudnn, k, v)


def max_err(a, ref):
    return float((a.double().cpu() - ref).abs().max())


def whole_model(torch, model, cpu_model, x, ref):
    """{variant: |logits - fp64| max} for the CPU and each of ``VARIANTS`` on the card."""
    errs = {"cpu": max_err(cpu_model.net.eval()(x), ref)}
    deploy, plain = model._deploy_net(False, False), copy.deepcopy(model.net).eval()
    for variant in VARIANTS:
        with cudnn_settings(torch, enabled=not variant.startswith("cudnn_off"), benchmark=variant.startswith("benchmark"),
                            deterministic=variant.startswith("deterministic")):
            errs[variant] = max_err((plain if variant.endswith("nchw") else deploy)(x.cuda()), ref)
    return errs


def each_convolution(torch, model, cpu_model, ref_net, x):
    """One row a convolution: (card / CPU error ratio, name, input shape, out channels, kernel,
    stride, CPU, card and card-without-cuDNN errors over the fp64 output's largest magnitude)."""
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: seen.__setitem__(n, (i[0], o)))
             for n, m in ref_net.named_modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    ref_net(x.double())
    for h in hooks:
        h.remove()
    cpu_mods, gpu_mods = dict(cpu_model.net.named_modules()), dict(model._deploy_net(False, False).named_modules())
    rows = []
    for name, (inp, out) in seen.items():
        scale = float(out.abs().max())
        on_card = inp.float().cuda().contiguous(memory_format=torch.channels_last)
        e_cpu = max_err(cpu_mods[name](inp.float()), out)
        e_gpu = max_err(gpu_mods[name](on_card), out)
        with cudnn_settings(torch, enabled=False):
            e_off = max_err(gpu_mods[name](on_card), out)
        m = cpu_mods[name]
        rows.append((e_gpu / max(e_cpu, 1e-30), name, tuple(inp.shape), m.out_channels, m.kernel_size, m.stride,
                     e_cpu / scale, e_gpu / scale, e_off / scale))
    return sorted(rows, reverse=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", nargs="+", default=["shelfnet34_lw", "shelfnet50", "laddernet_50"])
    parser.add_argument("--hw", nargs=2, type=int, default=[512, 512])
    parser.add_argument("--classes", type=int, default=21)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("cudnn_conv_drift: needs a GPU", file=sys.stderr)
        return 2
    from super_gradients_tpu_torch import models

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    image = np.random.RandomState(20).randint(0, 256, (*args.hw, 3), dtype=np.uint8)
    for name in args.models:
        build = dict(num_classes=args.classes, seed=0, input_hw=tuple(args.hw))
        model, cpu_model = models.get(name, device="cuda", **build), models.get(name, device="cpu", **build)
        _, batches, _ = model._prep_host_batches([image], 1)
        x = torch.from_numpy(batches[0]).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            ref_net = copy.deepcopy(cpu_model.net).double().eval()
            ref = ref_net(x.double())
            errs = whole_model(torch, model, cpu_model, x, ref)
            print(f"{name}: |logit| max {float(ref.abs().max()):.2f}; |logits - fp64| max {json.dumps(errs)}; over the "
                  f"CPU's {json.dumps({k: round(v / errs['cpu'], 3) for k, v in errs.items()})}", flush=True)
            rows = each_convolution(torch, model, cpu_model, ref_net, x)
        ratios = [r[0] for r in rows]
        off = [r[8] / r[6] for r in rows]
        print(f"{name}: {len(rows)} convolutions alone, card / CPU error: median {np.median(ratios):.3f}, range "
              f"{min(ratios):.3f}-{max(ratios):.3f}; with cuDNN off: median {np.median(off):.3f}, range "
              f"{min(off):.3f}-{max(off):.3f}. The {args.top} worst (ratio, name, input, out, kernel, stride, CPU, "
              f"card, card without cuDNN, each error over the output's largest magnitude):", flush=True)
        for row in rows[:args.top]:
            print("   ", row, flush=True)
        del model, cpu_model, ref_net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
