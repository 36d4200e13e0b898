"""The global-batch BatchNorm on the card: two ranks sharing one GPU over gloo (NCCL
refuses two ranks on one GPU), CUDA tensors, against ``nn.BatchNorm2d`` on the whole
batch on the card and its plain CPU result (fp32, TF32 off; the output, the input
gradient and the running buffers within 1e-5 of each array's largest magnitude). Needs a
GPU; skips without one. This file imports no JAX (run it on the card with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_*_cuda.py``)."""

import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks


@pytest.mark.cuda
def test_global_bn_on_the_card_over_gloo(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    results = ranks.run_ranks("bn_cuda", tmp_path, timeout=300,
                              env={"DDP_TEST_DEVICE": "cuda", "DDP_TEST_BACKEND": "gloo"})
    case = ranks.bn_case()
    per_rank = [r["bn_cuda"] for r in results]
    got = {k: np.concatenate([r[k] for r in per_rank]) for k in ("y", "dx")}
    got.update({k: sum(r[k] for r in per_rank) for k in ("dweight", "dbias")})
    got.update({k: per_rank[0][k] for k in ("running_mean", "running_var")})
    for device in ("cuda", "cpu"):
        bn = torch.nn.BatchNorm2d(ranks.BN_SHAPE[1], momentum=ranks.BN_MOMENTUM).to(device)
        with torch.no_grad():
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, k).copy_(torch.from_numpy(case[k]).float())
        x = torch.from_numpy(case["x"]).float().to(device).requires_grad_()
        y = bn(x)
        y.backward(torch.from_numpy(case["gy"]).float().to(device))
        ref = dict(y=y, dx=x.grad, dweight=bn.weight.grad, dbias=bn.bias.grad, running_mean=bn.running_mean,
                   running_var=bn.running_var)
        for k, r in ref.items():
            r = r.detach().cpu().double().numpy()
            assert np.abs(got[k] - r).max() <= 1e-5 * np.abs(r).max(), (device, k)
