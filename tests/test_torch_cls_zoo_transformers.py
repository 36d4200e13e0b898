"""ViT and BEiT of the PyTorch port against the JAX package's modules, on the same weights
(``tests/torch_cls_parity.py``: the weights carried both ways, the fp32 eval forward at
``rtol = 1e-4``, the fp64 train-mode forward at ``rtol = 1e-9``).

Cut sizes: dim 64, depth 2, 4 heads, patch 8 on 40x32 images (5x4 patches, so the position
embedding, the relative-position index and its bias table are not square), 2 images. Dropout is 0
on both sides; ViT's mask is tested on its own. The seeded
weights give the class token, the position embedding, BEiT's ``q_bias`` / ``v_bias``, LayerScale
and bias table nonzero values, so every one of them reaches the logits.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.classification import dpn_pnasnet_beit as jax_beit
from super_gradients_tpu.models.classification import vit as jax_vit
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.models.classification import dpn_pnasnet_beit, vit
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from torch_cls_parity import check_eval, check_train64, check_weights_carry, run_family

torch.set_num_threads(2)
HW = (40, 32)
CUT = dict(num_classes=5, patch_size=8, dim=64, depth=2, heads=4)

CASES = {
    "vit": (lambda: (jax_vit.ViT(**CUT), vit.ViT(image_size=HW, **CUT)), from_jax.VIT_RULES, tc.vit_key_mapper()),
    "beit": (lambda: (jax_beit.BEiT(**CUT), dpn_pnasnet_beit.BEiT(image_size=HW, **CUT)), from_jax.BEIT_RULES,
             tc.beit_key_mapper()),
}


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    build, rules, jax_rules = CASES[request.param]
    jmod, net = build()
    return run_family(request.param, jmod, net, rules, jax_rules, HW)


def test_weights_carry_both_ways(family):
    check_weights_carry(family)


def test_forward_eval_matches_jax(family):
    check_eval(family)


def test_forward_train_mode_matches_jax_in_fp64(family):
    check_train64(family)


def test_relative_position_index_matches_jax():
    for window in ((5, 4), (14, 14), (3, 7)):
        np.testing.assert_array_equal(dpn_pnasnet_beit.gen_relative_position_index(window),
                                      jax_beit.gen_relative_position_index(window))


def test_attention_scales_the_product_as_jax():
    """ViT scales ``q k^T`` after the product and BEiT scales ``q`` before it, as their JAX
    modules do: each port attention equals its own order in fp64 bit for bit on one input."""
    torch.manual_seed(0)
    attn = vit.Attention(16, 2).double()
    x = torch.randn(2, 5, 16, dtype=torch.float64)
    q, k, v = attn.to_qkv(x).reshape(2, 5, 3, 2, 8).permute(2, 0, 3, 1, 4)
    ref = attn.proj((torch.softmax((q @ k.transpose(-2, -1)) * 8 ** -0.5, -1) @ v).transpose(1, 2).reshape(2, 5, 16))
    assert torch.equal(attn(x), ref)


def test_registered_vit_base_follows_patch_and_image_size():
    """``vit_base`` reads ``patch_size`` / ``image_size``: the position embedding has a row a patch
    of that size plus the class token, and ``models.get`` builds and runs at it."""
    model = models.get("vit_base", num_classes=3, arch_params={"image_size": [64, 96], "patch_size": [32, 32]},
                       device="cpu")
    assert model.net.pos_embedding.shape == (1, 2 * 3 + 1, 768)
    with torch.no_grad():
        assert model.net.eval()(torch.zeros(1, 3, 64, 96)).shape == (1, 3)


def test_vit_mlp_dropout_mask():
    """ViT's dropout sits on the MLP's hidden features after the GELU: identity in eval mode; in
    train mode each hidden feature kept (scaled by 1 / (1 - p)) or zeroed, a fresh seeded mask each
    call; the registered ViTs build it at rate 0, as JAX's do."""
    net = vit.ViT(image_size=(32, 32), num_classes=5, patch_size=8, dim=16, depth=1, heads=2, dropout=0.5)
    seen = []
    net.transformer.blocks[0].mlp.fc2.register_forward_pre_hook(lambda m, i: seen.append(i[0].detach()))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.eval()(x)
        net.train()(x)
        net(x)
    eval_h, a, b = seen
    for h in (a, b):
        kept = h != 0
        assert 0.3 < float(kept.float().mean()) < 0.7
        torch.testing.assert_close(h[kept], 2.0 * eval_h[kept])
    assert not torch.equal(a != 0, b != 0)
    registered = models.get("vit_base", num_classes=3, arch_params={"image_size": [32, 32], "patch_size": [16, 16]},
                            device="cpu")
    assert all(m.p == 0.0 for m in registered.net.modules() if isinstance(m, SeededDropout))
