"""JAX variables -> PyTorch ``state_dict`` (the inverse of
``super_gradients_tpu/conversion/torch_converter.py`` for YOLO-NAS, PP-YOLOE, YOLOX,
YOLO-NAS-POSE, the ResNet family, STDC classification, the STDC, PP-LiteSeg, DDRNet, RegSeg,
UNet, SegFormer, ShelfNet and LadderNet segmentation models, MobileNet V1 / V2 / V3, SSD and the
rest of the classification zoo), and a knowledge-distillation composite of two of them
(``kd_variables_from_jax_to_torch``).

The JAX package names its flax modules after the original super-gradients
attributes and maps them with regex rules; this module carries a jax-free copy
of those rules (``YOLO_NAS_RULES``, ``PPYOLOE_RULES``, ``YOLOX_RULES``, ``YOLO_NAS_POSE_RULES``,
``RESNET_RULES``, ``STDC_CLS_RULES``, ``STDC_RULES``, ``PPLITESEG_RULES``, ``DDRNET_RULES``,
``REGSEG_RULES``, ``unet_rules``, ``SEGFORMER_RULES``, ``SHELFNET_RULES``, ``MOBILENET_V{1,2,3}_RULES``,
``SSD_V1_RULES``, ``SSD_LITE_V2_RULES``, the classification zoo's ``EFFICIENTNET_RULES`` ..
``vgg_rules``, ``_GENERIC_RULES``, ``_LEAF_MAP``) and inverts the layout transforms:

- conv kernel HWIO -> OIHW;
- dense kernel ``[in, out]`` -> ``Linear`` weight ``[out, in]``, and a squeeze-excitation 1x1
  conv ``[1, 1, in, out]`` -> the original's ``Linear`` weight ``[out, in]`` where the original
  holds a ``Linear`` (MobileNetV3's ``...fc.0`` / ``...fc.2``; the other families' SE convs stay
  convs);
- conv-transpose kernel ``[kh, kw, in, out]`` -> ``[in, out, kh, kw]`` (YOLO-NAS's neck
  ``upsample``, ShelfNet HW's ``up_conv_list``);
- BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``,
  plus a ``num_batches_tracked`` of 0 so that ``load_state_dict(strict=True)`` passes.

Both unfused trees and fused ones (``rbr_reparam``) convert. Batch statistics of
a module that has no parameters in the tree are dropped: the JAX ``fuse()`` keeps
the statistics of the BNs it folded away, which no module reads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from super_gradients_tpu_torch.models.segmentation.regseg import dblock_names

Rules = Sequence[Tuple[str, str]]

# applied to the dotted flax path AFTER the model-specific rules
_GENERIC_RULES: Rules = (
    # bottlenecks_0 -> bottlenecks.0
    (r"_(\d+)(?=[._]|$)", r".\1"),
    # model rules write `§` where a literal underscore-digit must survive the rule above
    (r"§", "_"),
)

_LEAF_MAP = {
    "scale": "weight",  # BN gamma
    "mean": "running_mean",
    "var": "running_var",
    "kernel": "weight",
    "bias": "bias",
}

YOLO_NAS_RULES: Rules = (
    # QARepVGG branch naming
    (r"branch_3x3_conv", "branch_3x3.conv"),
    (r"branch_3x3_bn", "branch_3x3.bn"),
    # heads use ConvBNReLU (-> .seq.conv/.seq.bn) and Sequential-wrapped convs
    (r"(head\d\.stem)\.conv", r"\1.seq.conv"),
    (r"(head\d\.stem)\.bn", r"\1.seq.bn"),
    (r"(head\d\.(?:cls|reg)_convs)\.conv", r"\1.0.seq.conv"),
    (r"(head\d\.(?:cls|reg)_convs)\.bn", r"\1.0.seq.bn"),
)

# PP-YOLOE (copy of the JAX package's PPYOLOE_RULES): ConvBNAct nests conv and BN under
# `seq`, the RepVGG branches are Sequentials, the identity BN (no PP-YOLOE block has one) is
# `no_conv_branch`
PPYOLOE_RULES: Rules = (
    (r"(?<!seq)\.(conv|bn)$", r".seq.\1"),
    (r"branch_3x3_conv", "branch_3x3.conv"),
    (r"branch_3x3_bn", "branch_3x3.bn"),
    (r"branch_1x1_conv", "branch_1x1.conv"),
    (r"branch_1x1_bn", "branch_1x1.bn"),
    (r"identity_bn", "no_conv_branch"),
    (r"convs_spp", "convs.spp"),
    (r"stem_conv(\d)", r"stem.conv\1"),
    (r"attn\.fc", "attn.project"),
    (r"stem_(cls|reg)_(\d+)_fc", r"stem_\1.\2.fc"),
    (r"stem_(cls|reg)_(\d+)_conv", r"stem_\1.\2.conv"),
)

# YOLOX (copy of the JAX package's YOLOX_RULES): the semantic flax names onto the flat
# indexed `_modules_list`s of the original backbone and PAFPN
YOLOX_RULES: Rules = (
    (r"^backbone\.stem", "_backbone._modules_list.0"),
    (r"^backbone\.dark2_conv", "_backbone._modules_list.1"),
    (r"^backbone\.dark2_csp", "_backbone._modules_list.2"),
    (r"^backbone\.dark3_conv", "_backbone._modules_list.3"),
    (r"^backbone\.dark3_csp", "_backbone._modules_list.4"),
    (r"^backbone\.dark4_conv", "_backbone._modules_list.5"),
    (r"^backbone\.dark4_csp", "_backbone._modules_list.6"),
    (r"^backbone\.dark5_conv", "_backbone._modules_list.7"),
    (r"^backbone\.dark5_spp", "_backbone._modules_list.8"),
    (r"^backbone\.dark5_csp", "_backbone._modules_list.9"),
    (r"^lateral5", "_head._modules_list.0"),
    (r"^fpn_c4", "_head._modules_list.3"),
    (r"^lateral4", "_head._modules_list.4"),
    (r"^fpn_c3", "_head._modules_list.7"),
    (r"^down3", "_head._modules_list.8"),
    (r"^pan_c4", "_head._modules_list.10"),
    (r"^down4", "_head._modules_list.11"),
    (r"^pan_c5", "_head._modules_list.13"),
    (r"^head(\d)_stem", r"_head._modules_list.14.stems.\1"),
    (r"^head(\d)_cls1", r"_head._modules_list.14.cls_convs.\1.0"),
    (r"^head(\d)_cls2", r"_head._modules_list.14.cls_convs.\1.1"),
    (r"^head(\d)_reg1", r"_head._modules_list.14.reg_convs.\1.0"),
    (r"^head(\d)_reg2", r"_head._modules_list.14.reg_convs.\1.1"),
    (r"^head(\d)_cls_pred", r"_head._modules_list.14.cls_preds.\1"),
    (r"^head(\d)_reg_pred", r"_head._modules_list.14.reg_preds.\1"),
    (r"^head(\d)_obj_pred", r"_head._modules_list.14.obj_preds.\1"),
    (r"\.b(\d+)_cv", r".bottlenecks.\1.cv"),
)

# YOLO-NAS-POSE: the pose heads add ConvBNReLU stems and a `pose_convs` Sequential, and
# the JAX model keeps its heads at the top level where the torch model nests them under
# `heads` (copy of the JAX package's YOLO_NAS_POSE_RULES)
YOLO_NAS_POSE_RULES: Rules = YOLO_NAS_RULES + (
    (r"(head\d\.(?:pose|bbox)_stem)\.conv$", r"\1.seq.conv"),
    (r"(head\d\.(?:pose|bbox)_stem)\.bn$", r"\1.seq.bn"),
    (r"(head\d)\.pose_convs_(\d+)\.conv$", r"\1.pose_convs.\2.seq.conv"),
    (r"(head\d)\.pose_convs_(\d+)\.bn$", r"\1.pose_convs.\2.seq.bn"),
    (r"^head(\d)", r"heads.head\1"),
)


# ResNet: the shortcut's conv and BN are a Sequential's items 0 and 1; the flat block
# names `layer1_0` become `layer1.0` by the generic rules
RESNET_RULES: Rules = (
    (r"shortcut_conv", "shortcut.0"),
    (r"shortcut_bn", "shortcut.1"),
)



# ShelfNet (copy of the JAX package's SHELFNET_RULES), and LadderNet, which has the same trunk and
# no JAX mapper: the trunk's stem is `backbone.conv1` / `backbone.bn1`, the FCN aux head a
# Sequential under `aux_head.fcn`; every other name is the flax module's
SHELFNET_RULES: Rules = RESNET_RULES + (
    (r"^backbone\.conv1\.conv$", "backbone.conv1"),
    (r"^backbone\.conv1\.bn$", "backbone.bn1"),
    (r"^aux_head_fcn", "aux_head.fcn"),
)


def _stdc_backbone_rules(prefix: str) -> Rules:
    """The STDC backbone's stages under ``prefix``: ``block_s{ratio}_{i}`` becomes
    ``stages.block_s{ratio}.{i}`` (``§`` keeps the ``_s``), every conv-BN under ``seq``, and
    the stride-2 block's depthwise conv and second conv ``conv_list.1.0`` / ``conv_list.1.1``."""
    stages = prefix + "backbone.stages.block§s"
    return (
        (r"^backbone\.block_s(\d+)_0\.conv_list_1_dw\.(conv|bn)$", stages + r"\1.0.conv_list.1.0.seq.\2"),
        (r"^backbone\.block_s(\d+)_0\.conv_list_1\.(conv|bn)$", stages + r"\1.0.conv_list.1.1.seq.\2"),
        (r"^backbone\.block_s(\d+)_(\d+)\.conv_list_(\d+)\.(conv|bn)$", stages + r"\1.\2.conv_list.\3.seq.\4"),
        (r"^backbone\.block_s(\d+)_(\d+)\.(conv|bn)$", stages + r"\1.\2.seq.\3"),
    )


# STDC classification: the backbone at the top level, then conv_last / fc / linear
STDC_CLS_RULES: Rules = _stdc_backbone_rules("") + ((r"^conv_last\.(conv|bn)$", r"conv_last.seq.\1"),)

# STDC segmentation: the context path under `cp`, each head `Sequential(SegmentationHead, upsample)`
STDC_RULES: Rules = _stdc_backbone_rules("cp.") + (
    (r"^(arm\d+)\.conv_first\.(conv|bn)$", r"cp.\1.conv_first.seq.\2"),
    (r"^(arm\d+)\.attention_conv\.(conv|bn)$", r"cp.\1.attention_block.1.seq.\2"),
    (r"^upsample(\d+)_conv\.(conv|bn)$", r"cp.upsample\1.1.seq.\2"),
    (r"^context_embedding\.(conv|bn)$", r"cp.context_embedding.context_embedding.1.seq.\1"),
    (r"^ffm\.pw_conv\.(conv|bn)$", r"ffm.pw_conv.seq.\1"),
    (r"^ffm\.attention_conv1$", "ffm.attention_block.1.seq.conv"),
    (r"^ffm\.attention_conv2$", "ffm.attention_block.2"),
    (r"^(segmentation_head|aux_head_s16|aux_head_s32|detail_head8)\.conv\.(conv|bn)$", r"\1.0.seg_head.0.seq.\2"),
    (r"^(segmentation_head|aux_head_s16|aux_head_s32|detail_head8)\.pred$", r"\1.0.seg_head.2"),
)

# PP-LiteSeg: the STDC backbone, SPPM and projections under `encoder`, the UAFMs under `decoder`
PPLITESEG_RULES: Rules = _stdc_backbone_rules("encoder.") + (
    (r"^context\.branch_(\d+)\.(conv|bn)$", r"encoder.context_module.branches.\1.1.seq.\2"),
    (r"^context\.conv_out\.(conv|bn)$", r"encoder.context_module.conv_out.seq.\1"),
    (r"^proj_(\d+)\.(conv|bn)$", r"encoder.proj_convs.\1.seq.\2"),
    (r"^up_stage_(\d+)\.conv_atten_(\d)\.(conv|bn)$", r"decoder.up_stages.\1.conv_atten.\2.seq.\3"),
    (r"^up_stage_(\d+)\.proj_skip\.(conv|bn)$", r"decoder.up_stages.\1.proj_skip.seq.\2"),
    (r"^up_stage_(\d+)\.conv_out\.(conv|bn)$", r"decoder.up_stages.\1.conv_out.seq.\2"),
    (r"^seg_head\.conv\.(conv|bn)$", r"seg_head.0.seg_head.0.seq.\1"),
    (r"^seg_head\.pred$", "seg_head.0.seg_head.2"),
    (r"^aux_head_(\d+)\.conv\.(conv|bn)$", r"aux_heads.\1.0.seg_head.0.seq.\2"),
    (r"^aux_head_(\d+)\.pred$", r"aux_heads.\1.0.seg_head.2"),
)


def _ddrnet_dappm_down_scale(m) -> str:
    """A DAPPM branch's ``down_scale`` index: branch 0 (stride 1) has no pooling layer, so its
    BN and conv sit at 0 / 2, every other branch's at 1 / 3."""
    b = int(m.group(1))
    bn_i, conv_i = (0, 2) if b == 0 else (1, 3)
    return f"spp.branches.{b}.down_scale.{bn_i if m.group(2) == 'bn' else conv_i}"


# DDRNet (copy of the JAX package's DDRNET_RULES): the trunk under `_backbone`, every ConvBN a
# Sequential(conv, bn), the DAPPM's Sequentials under `spp`, the blocks' shortcuts Sequentials
DDRNET_RULES: Rules = (
    (r"^stem_(\d)\.conv$", r"_backbone.stem.\1.0"),
    (r"^stem_(\d)\.bn$", r"_backbone.stem.\1.1"),
    (r"^layer3_(\d+)", r"_backbone.layer3.\1"),
    (r"^layer([124])_(\d+)", r"_backbone.layer\1.\2"),
    (r"^down3_(\d+)\.conv$", r"down3.\1.0"),
    (r"^down3_(\d+)\.bn$", r"down3.\1.1"),
    (r"^compression3_(\d+)\.conv$", r"compression3.\1.0"),
    (r"^compression3_(\d+)\.bn$", r"compression3.\1.1"),
    (r"^compression4\.conv$", "compression4.0"),
    (r"^compression4\.bn$", "compression4.1"),
    (r"^down4_(\d)\.conv$", r"down4.\1.0"),
    (r"^down4_(\d)\.bn$", r"down4.\1.1"),
    (r"^spp\.branch_(\d)\.(bn|conv)$", _ddrnet_dappm_down_scale),
    (r"^spp\.branch_(\d)\.process_bn$", r"spp.branches.\1.process.0"),
    (r"^spp\.branch_(\d)\.process_conv$", r"spp.branches.\1.process.2"),
    (r"^spp\.compression_bn$", "spp.compression.0"),
    (r"^spp\.compression_conv$", "spp.compression.2"),
    (r"^spp\.shortcut_bn$", "spp.shortcut.0"),
    (r"^spp\.shortcut_conv$", "spp.shortcut.2"),
    (r"shortcut_conv", "shortcut.0"),
    (r"shortcut_bn", "shortcut.1"),
)


def _regseg_block_prefix(m) -> str:
    return "backbone.stages.{}.{}".format(m.group(1), dblock_names()[(int(m.group(1)), int(m.group(2)))])


# RegSeg48 (copy of the JAX package's REGSEG_RULES): the blocks' names spell out their geometry,
# their layers are `d_block_path` Sequential indices
REGSEG_RULES: Rules = (
    (r"^stage(\d+)_(\d+)", _regseg_block_prefix),
    (r"\.conv1\.(conv|bn)$", r".d_block_path.0.seq.\1"),
    (r"\.dconv$", ".d_block_path.1"),
    (r"\.dconv_(\d+)$", r".d_block_path.1.convs.\1"),
    (r"\.bn2$", ".d_block_path.2"),
    (r"\.se_fc1$", ".d_block_path.4.se_block.1"),
    (r"\.se_fc2$", ".d_block_path.4.se_block.3"),
    (r"\.conv3\.(conv|bn)$", r".d_block_path.5.seq.\1"),
    (r"\.shortcut\.(conv|bn)$", r".shortcut.shortcut.1.seq.\1"),
    (r"^stem\.(conv|bn)$", r"stem.seq.\1"),
    (r"^proj(\d)\.(conv|bn)$", r"decoder.projections.\1.seq.\2"),
    (r"^decoder_conv\.(conv|bn)$", r"decoder.conv_bn_relu.seq.\1"),
    (r"^head_conv\.(conv|bn)$", r"head.head.0.seq.\1"),
    (r"^head_pred$", "head.head.1"),
)


def unet_rules(strides_list: Sequence[int]) -> Rules:
    """UNet (copy of the JAX package's ``unet_key_mapper``): a stride-2 stage's max pool shifts
    its blocks' indices by one; a decoder stage's repeats after the first nest under
    ``last_convs.1``."""
    strides = list(strides_list)

    def stage(m):
        i, j, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"encoder.backbone.stages.{i}.blocks.{j + (1 if strides[i] == 2 else 0)}.seq.{leaf}"

    def dec(m):
        i, r, leaf = m.group(1), int(m.group(2)), m.group(3)
        return f"decoder.up_stages.{i}.last_convs.{'0' if r == 0 else f'1.{r - 1}'}.seq.{leaf}"

    return (
        (r"^stage(\d+)_blk(\d+)\.(conv|bn)$", stage),
        (r"^dec(\d+)_conv(\d+)\.(conv|bn)$", dec),
        (r"^proj(\d+)\.(conv|bn)$", r"decoder.projection_blocks.\1.seq.\2"),
        (r"^head_conv\.(conv|bn)$", r"seg_head.0.seg_head.0.seq.\1"),
        (r"^head_pred$", "seg_head.0.seg_head.2"),
    )


def unet_classifier_rules(strides_list: Sequence[int]) -> Rules:
    """The UNet classifier (no JAX mapper): ``enc{i}_{1,2}`` onto the encoder's layout under
    ``backbone.stages``, ``fc`` as it is."""
    strides = list(strides_list)
    return ((r"^enc(\d+)_(\d)\.(conv|bn)$",
             lambda m: "backbone.stages.{}.blocks.{}.seq.{}".format(
                 m.group(1), int(m.group(2)) - (0 if strides[int(m.group(1))] == 2 else 1), m.group(3))),)


def _segformer_stage(fmt: str):
    def repl(m):
        return fmt.format(s=int(m.group(1)) + 1, b=int(m.group(2)) if m.lastindex > 1 else 0)

    return repl


# SegFormer (copy of the JAX package's SEGFORMER_RULES): the MiT stages 1-based under
# `_backbone`, the head under `decode_head`
SEGFORMER_RULES: Rules = (
    (r"^patch_embed(\d)$", _segformer_stage("_backbone.patch_embed{s}.proj")),
    (r"^embed_norm(\d)$", _segformer_stage("_backbone.patch_embed{s}.norm")),
    (r"^attn(\d)_(\d+)\.sr_norm$", _segformer_stage("_backbone.block{s}.{b}.attn.norm")),
    (r"^attn(\d)_(\d+)", _segformer_stage("_backbone.block{s}.{b}.attn")),
    (r"^norm1_(\d)_(\d+)$", _segformer_stage("_backbone.block{s}.{b}.norm1")),
    (r"^norm2_(\d)_(\d+)$", _segformer_stage("_backbone.block{s}.{b}.norm2")),
    (r"^ffn(\d)_(\d+)", _segformer_stage("_backbone.block{s}.{b}.mlp")),
    (r"^out_norm(\d)$", _segformer_stage("_backbone.norm{s}")),
    (r"^linear_c(\d)$", _segformer_stage("decode_head.linear_c{s}.proj")),
    (r"^linear_fuse\.conv$", "decode_head.linear_fuse.seq.conv"),
    (r"^linear_fuse\.bn$", "decode_head.linear_fuse.seq.bn"),
    (r"^linear_pred$", "decode_head.linear_pred"),
)


def _mnv2_block_index(m) -> str:
    """A MobileNetV2 block's conv ``Sequential`` index: block 0 has no pointwise expansion,
    which shifts the indices."""
    i, child, leaf = int(m.group(1)), m.group(2), m.group(3)
    if i == 0:
        idx = {("depthwise", "conv"): 0, ("depthwise", "bn"): 1, ("project", "conv"): 3, ("project", "bn"): 4}
    else:
        idx = {("expand", "conv"): 0, ("expand", "bn"): 1, ("depthwise", "conv"): 3, ("depthwise", "bn"): 4,
               ("project", "conv"): 6, ("project", "bn"): 7}
    return f"features.{i + 1}.conv.{idx[(child, leaf)]}"


# MobileNetV2 (copy of the JAX package's MOBILENET_V2_RULES): the classifier is Sequential(dropout, linear)
MOBILENET_V2_RULES: Rules = (
    (r"^block_(\d+)\.(expand|depthwise|project)\.(conv|bn)$", _mnv2_block_index),
    (r"^stem\.conv$", "features.0.0"),
    (r"^stem\.bn$", "features.0.1"),
    (r"^head_conv\.conv$", "features.18.0"),
    (r"^head_conv\.bn$", "features.18.1"),
    (r"^classifier$", "classifier.1"),
)

# MobileNetV1 (copy of the JAX package's MOBILENET_V1_RULES)
MOBILENET_V1_RULES: Rules = ((r"^layers_(\d+)_(conv\d|bn\d)$", r"layers.\1.\2"),)


def _mnv3_block_index(m) -> str:
    """A MobileNetV3 block's conv ``Sequential`` index: ``[pw, bn, act, dw, bn, SE, act, pwl, bn]``,
    and ``[dw, bn, act, SE, pwl, bn]`` for block 0, which has no expansion."""
    i, child, leaf = int(m.group(1)), m.group(2), m.group(3)
    if i == 0:
        table = {("depthwise", "conv"): 0, ("depthwise", "bn"): 1, ("project", "conv"): 4, ("project", "bn"): 5}
    else:
        table = {("expand", "conv"): 0, ("expand", "bn"): 1, ("depthwise", "conv"): 3, ("depthwise", "bn"): 4,
                 ("project", "conv"): 7, ("project", "bn"): 8}
    return f"features.{i + 1}.conv.{table[(child, leaf)]}"


def _mnv3_se_index(m) -> str:
    i, fc = int(m.group(1)), m.group(2)
    return f"features.{i + 1}.conv.{3 if i == 0 else 5}.fc.{0 if fc == 'fc1' else 2}"


# MobileNetV3 (copy of the JAX package's MOBILENET_V3_RULES)
MOBILENET_V3_RULES: Rules = (
    (r"^block_(\d+)\.(expand|depthwise|project)\.(conv|bn)$", _mnv3_block_index),
    (r"^block_(\d+)\.se\.(fc1|fc2)$", _mnv3_se_index),
    (r"^stem\.conv$", "features.0.0"),
    (r"^stem\.bn$", "features.0.1"),
    (r"^head_conv\.conv$", "conv.0"),
    (r"^head_conv\.bn$", "conv.1"),
    (r"^pre_classifier$", "classifier.0"),
    (r"^classifier$", "classifier.3"),
)

# SSD (copies of the JAX package's SSD_V1_RULES / SSD_LITE_V2_RULES): the trunk under
# backbone.multi_output_backbone.0, the neck blocks under neck.neck_blocks, the heads under heads
_SSD_BB = "backbone.multi_output_backbone.0"
_SSD_V1_NECK_IDX = {"conv1": 0, "bn1": 1, "conv2": 3, "bn2": 4}  # [conv1x1, BN, ReLU, convK, BN, ReLU]

SSD_V1_RULES: Rules = (
    (r"^(conv1|bn1)$", _SSD_BB + r".\1"),
    (r"^layers_(\d+)_(conv\d|bn\d)$", _SSD_BB + r".layers.\1.\2"),
    (r"^neck_(\d+)_(conv\d|bn\d)$", lambda m: f"neck.neck_blocks.{m.group(1)}.{_SSD_V1_NECK_IDX[m.group(2)]}"),
    (r"^(loc|conf)_(\d+)$", r"heads.\1.\2"),
)

_SSD_V2_NECK_IDX = {("expand", "conv"): 0, ("expand", "bn"): 1, ("depthwise", "conv"): 3, ("depthwise", "bn"): 4,
                    ("project", "conv"): 6, ("project", "bn"): 7}

SSD_LITE_V2_RULES: Rules = (
    (r"^block_(\d+)\.(expand|depthwise|project)\.(conv|bn)$", lambda m: _SSD_BB + "." + _mnv2_block_index(m)),
    (r"^stem\.conv$", _SSD_BB + ".features.0.0"),
    (r"^stem\.bn$", _SSD_BB + ".features.0.1"),
    (r"^head_conv\.conv$", _SSD_BB + ".features.18.0"),
    (r"^head_conv\.bn$", _SSD_BB + ".features.18.1"),
    (r"^neck_(\d+)\.(expand|depthwise|project)\.(conv|bn)$",
     lambda m: f"neck.neck_blocks.{m.group(1)}.conv.{_SSD_V2_NECK_IDX[(m.group(2), m.group(3))]}"),
    # the separable head: [dw conv (with bias), BN, ReLU, pw conv]
    (r"^(loc|conf)_(\d+)_dw$", r"heads.\1.\2.0"),
    (r"^(loc|conf)_(\d+)_dwbn$", r"heads.\1.\2.1"),
    (r"^(loc|conf)_(\d+)_pw$", r"heads.\1.\2.3"),
    (r"^(loc|conf)_(\d+)$", r"heads.\1.\2"),
)


# ---- the classification zoo (copies of the JAX package's rules of the same names)

# EfficientNet: flat underscore-prefixed attributes
EFFICIENTNET_RULES: Rules = (
    (r"^stem\.conv$", "_conv_stem"),
    (r"^stem\.bn$", "_bn0"),
    (r"^block_(\d+)\.expand\.conv$", r"_blocks.\1._expand_conv"),
    (r"^block_(\d+)\.expand\.bn$", r"_blocks.\1._bn0"),
    (r"^block_(\d+)\.depthwise\.conv$", r"_blocks.\1._depthwise_conv"),
    (r"^block_(\d+)\.depthwise\.bn$", r"_blocks.\1._bn1"),
    (r"^block_(\d+)\.se\.fc1$", r"_blocks.\1._se_reduce"),
    (r"^block_(\d+)\.se\.fc2$", r"_blocks.\1._se_expand"),
    (r"^block_(\d+)\.project\.conv$", r"_blocks.\1._project_conv"),
    (r"^block_(\d+)\.project\.bn$", r"_blocks.\1._bn2"),
    (r"^head_conv\.conv$", "_conv_head"),
    (r"^head_conv\.bn$", "_bn1"),
    (r"^fc$", "_fc"),
)

# RegNet: under `net`, the blocks' layers Sequential indices; `§` guards the literal underscores
REGNET_RULES: Rules = (
    (r"^stem\.conv$", "net.stem.conv"),
    (r"^stem\.bn$", "net.stem.bn"),
    (r"^stage_(\d+)_(\d+)", r"net.stage§\1.blocks.block§\2"),
    (r"\.conv1\.conv$", ".conv_block§1.0"),
    (r"\.conv1\.bn$", ".conv_block§1.1"),
    (r"\.conv2\.conv$", ".conv_block§2.0"),
    (r"\.conv2\.bn$", ".conv_block§2.1"),
    (r"\.conv3\.conv$", ".conv_block§3.0"),
    (r"\.conv3\.bn$", ".conv_block§3.1"),
    (r"\.se\.fc1$", ".se.1"),
    (r"\.se\.fc2$", ".se.3"),
    (r"\.shortcut\.conv$", ".shortcut.0"),
    (r"\.shortcut\.bn$", ".shortcut.1"),
    (r"^fc$", "net.head.fc"),
)

# classic RepVGG blocks: both branches Sequential(conv, bn), the identity a bare BN `no_conv_branch`
REPVGG_RULES: Rules = (
    (r"branch_3x3_conv", "branch_3x3.conv"),
    (r"branch_3x3_bn", "branch_3x3.bn"),
    (r"branch_1x1_conv", "branch_1x1.conv"),
    (r"branch_1x1_bn", "branch_1x1.bn"),
    (r"identity_bn", "no_conv_branch"),
)

VIT_RULES: Rules = (
    (r"^patch_embed\b", "patch_embedding.proj"),
    (r"^block_(\d+)", r"transformer.blocks.\1"),
    (r"\.mlp_fc(\d)", r".mlp.fc\1"),
    (r"^norm$", "pre_head_norm"),
)

BEIT_RULES: Rules = (
    (r"^patch_embed$", "patch_embed.proj"),
    (r"^block_(\d+)\.fc(\d)$", r"blocks.\1.mlp.fc\2"),
    (r"^block_(\d+)", r"blocks.\1"),
)

# torchvision's DenseNet tree under `features`
DENSENET_RULES: Rules = (
    (r"^denseblock(\d)_layer(\d+)", r"features.denseblock\1.denselayer\2"),
    (r"^transition(\d)_norm$", r"features.transition\1.norm"),
    (r"^transition(\d)_conv$", r"features.transition\1.conv"),
    (r"^conv0$", "features.conv0"),
    (r"^norm0$", "features.norm0"),
    (r"^norm5$", "features.norm5"),
)

SHUFFLENET_RULES: Rules = (
    (r"^stem\.conv$", "conv1.0"),
    (r"^stem\.bn$", "conv1.1"),
    (r"^stage_(\d+)_(\d+)", lambda m: f"layer{int(m.group(1)) + 2}.{m.group(2)}"),
    (r"\.b_conv1\.conv$", ".branch2.0"),
    (r"\.b_conv1\.bn$", ".branch2.1"),
    (r"\.b_dw\.conv$", ".branch2.3"),
    (r"\.b_dw\.bn$", ".branch2.4"),
    (r"\.b_conv2\.conv$", ".branch2.5"),
    (r"\.b_conv2\.bn$", ".branch2.6"),
    (r"\.l_dw\.conv$", ".branch1.0"),
    (r"\.l_dw\.bn$", ".branch1.1"),
    (r"\.l_conv\.conv$", ".branch1.2"),
    (r"\.l_conv\.bn$", ".branch1.3"),
    (r"^head_conv\.conv$", "conv5.0"),
    (r"^head_conv\.bn$", "conv5.1"),
)

SENET_RULES: Rules = (
    (r"^conv1\.conv$", "conv1"),
    (r"^conv1\.bn$", "bn1"),
    (r"shortcut_conv", "shortcut.0"),
)

PREACT_RULES: Rules = ((r"\.shortcut$", ".shortcut.0"),)

# ResNeXt (torchvision layout) and DPN (its projection is `shortcut`)
_BOTTLENECK_RULES: Rules = (
    (r"^stem\.conv$", "conv1"),
    (r"^stem\.bn$", "bn1"),
    (r"\.conv1\.conv$", ".conv1"),
    (r"\.conv1\.bn$", ".bn1"),
    (r"\.conv2\.conv$", ".conv2"),
    (r"\.conv2\.bn$", ".bn2"),
    (r"\.conv3\.conv$", ".conv3"),
    (r"\.conv3\.bn$", ".bn3"),
)
RESNEXT_RULES: Rules = _BOTTLENECK_RULES + (
    (r"\.shortcut\.conv$", ".downsample.0"),
    (r"\.shortcut\.bn$", ".downsample.1"),
)
DPN_RULES: Rules = _BOTTLENECK_RULES + (
    (r"\.shortcut\.conv$", ".shortcut.0"),
    (r"\.shortcut\.bn$", ".shortcut.1"),
)

# PNASNet-A: cells under layer1..layer5, the separable conv `sep_conv1.{conv1, bn1}`
PNASNET_RULES: Rules = (
    (r"^stem\.conv$", "conv1"),
    (r"^stem\.bn$", "bn1"),
    (r"^cells1_(\d+)", r"layer1.\1"),
    (r"^down1\b", "layer2"),
    (r"^cells2_(\d+)", r"layer3.\1"),
    (r"^down2\b", "layer4"),
    (r"^cells3_(\d+)", r"layer5.\1"),
    (r"\.sep\.conv$", ".sep_conv1.conv1"),
    (r"\.sep\.bn$", ".sep_conv1.bn1"),
    (r"\.proj\.conv$", ".conv1"),
    (r"\.proj\.bn$", ".bn1"),
)

# Darknet-53: one flat `modules_list`, the stages at the even slots
_DN53_LEAF = {"conv": "Conv2d", "bn": "BatchNorm2d"}
DARKNET53_RULES: Rules = (
    (r"^stem\.(conv|bn)$", lambda m: f"modules_list.0.{_DN53_LEAF[m.group(1)]}"),
    (r"^down(\d+)\.(conv|bn)$", lambda m: f"modules_list.{2 * int(m.group(1)) + 1}.{_DN53_LEAF[m.group(2)]}"),
    (r"^stage(\d+)_(\d+)\.conv(\d)\.(conv|bn)$",
     lambda m: f"modules_list.{2 * int(m.group(1)) + 2}.{m.group(2)}.layer{m.group(3)}.{_DN53_LEAF[m.group(4)]}"),
    (r"^fc$", "modules_list.11.fc"),
)

# CSPDarknet-53: the YOLOX trunk's `_modules_list` without the `_backbone` prefix, the head at slot 12
CSP_DARKNET53_RULES: Rules = tuple(
    (pat, repl.replace("_backbone.", "")) for pat, repl in YOLOX_RULES if pat.startswith(r"^backbone")
) + ((r"\.b(\d+)_cv", r".bottlenecks.\1.cv"), (r"^fc$", "_modules_list.12"))


def vgg_rules(cfg: Sequence) -> Rules:
    """VGG's features are one flat Sequential, three entries a conv (conv, BN, ReLU) and one a
    pool: ``conv_{i}`` onto its flat index (copy of the JAX package's ``vgg_key_mapper``)."""
    idxs, ci, flat = {}, 0, 0
    for v in cfg:
        if v == "M":
            flat += 1
        else:
            idxs[ci] = flat
            ci, flat = ci + 1, flat + 3
    return ((r"^conv_(\d+)\.(conv|bn)$",
             lambda m: f"features.{idxs[int(m.group(1))] + (0 if m.group(2) == 'conv' else 1)}"),)


def _translate(path: Tuple[str, ...], rules: Rules) -> str:
    *parents, leaf = path
    name = ".".join(parents)
    for pat, repl in tuple(rules) + tuple(_GENERIC_RULES):
        name = re.sub(pat, repl, name)
    if leaf == "alpha":  # a bare Parameter in torch
        return name + ".alpha" if name else "alpha"
    torch_leaf = _LEAF_MAP.get(leaf, leaf)
    return f"{name}.{torch_leaf}" if name else torch_leaf


def _to_torch_layout(value: np.ndarray, path: Tuple[str, ...], torch_name: str) -> np.ndarray:
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:
        return value.T  # dense [in, out] -> Linear [out, in]
    if re.search(r"\.fc\.[02]$", torch_name):
        return value[0, 0].T  # the JAX SE's 1x1 convs [1, 1, in, out] -> the original's Linear [out, in]
    if value.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: only conv and dense kernels are converted, got shape {value.shape}")
    if "upsample" in path[-2] or "up_conv_list" in path[-2]:
        return value.transpose(2, 3, 0, 1)  # [kh, kw, in, out] -> ConvTranspose2d [in, out, kh, kw]
    return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for k, v in tree.items():
        p = prefix + (str(k),)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, p))
        else:
            flat[p] = v
    return flat


def _torch_entries(variables_np: Mapping, rules: Rules):
    """(torch name, value in the torch layout) of each tensor of the JAX trees, the batch statistics of
    modules without parameters dropped."""
    param_modules = {path[:-1] for path in _flatten(variables_np.get("params", {}))}
    for collection, tree in variables_np.items():
        for path, value in _flatten(tree).items():
            if collection == "batch_stats" and path[:-1] not in param_modules:
                continue
            name = _translate(path, rules)
            yield name, _to_torch_layout(np.asarray(value), path, name[: -len(".weight")])


def variables_from_jax_to_torch(variables_np: Mapping, rules: Rules = YOLO_NAS_RULES) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` trees of numpy arrays -> torch ``state_dict``."""
    state_dict = {name: torch.tensor(np.ascontiguousarray(arr)) for name, arr in _torch_entries(variables_np, rules)}
    for key in [k for k in state_dict if k.endswith(".running_mean")]:
        state_dict[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state_dict


def state_dict_shapes_from_jax(shapes: Mapping, rules: Rules = YOLO_NAS_RULES) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of :func:`variables_from_jax_to_torch`'s ``state_dict`` for trees whose
    leaves have a ``shape`` (arrays, ``jax.ShapeDtypeStruct``), nothing allocated."""
    def views(tree):
        return {k: views(v) if isinstance(v, Mapping) else np.broadcast_to(np.float32(0), v.shape) for k, v in tree.items()}

    out = {name: tuple(arr.shape) for name, arr in _torch_entries(views(shapes), rules)}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = ()
    return out


def kd_variables_from_jax_to_torch(variables_np: Mapping, student_rules: Rules, teacher_rules: Rules) -> Dict[str, torch.Tensor]:
    """A JAX ``KDModule``'s variables (``params`` / ``batch_stats`` trees with ``student`` and
    ``teacher`` subtrees) -> the port's ``kd_module`` ``state_dict`` (``student.*`` / ``teacher.*``),
    each net through its own rules."""
    state_dict: Dict[str, torch.Tensor] = {}
    for role, rules in (("student", student_rules), ("teacher", teacher_rules)):
        sub = {collection: tree[role] for collection, tree in variables_np.items() if role in tree}
        state_dict.update({f"{role}.{k}": v for k, v in variables_from_jax_to_torch(sub, rules).items()})
    return state_dict
