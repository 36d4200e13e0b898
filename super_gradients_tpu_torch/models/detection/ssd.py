"""SSD-MobileNetV1 and SSD-lite-MobileNetV2, NCHW (counterpart of
``super_gradients_tpu/models/detection/ssd.py``).

Attribute names are the original super-gradients ones (``CustomizableDetector`` assemblies):
the trunk under ``backbone.multi_output_backbone.0`` (``conv1`` / ``layers.N`` of
MobileNetV1, ``features.N`` of MobileNetV2), the neck blocks under ``neck.neck_blocks.N``,
the prediction convs under ``heads.loc.N`` / ``heads.conf.N``. So
``conversion/from_jax.py``'s ``SSD_V1_RULES`` / ``SSD_LITE_V2_RULES`` carry the JAX
variables across and a ``.pth`` of the original layout loads.

As in the JAX modules:

- default boxes are size-major within a level and clamped to ``[0, fig_size]``
  (:func:`generate_ssd_anchors`), in pixels;
- the head convs are coordinate-major: channel ``c = col * na + anchor``;
- SSD-MobileNetV1 taps the MobileNetV1 trunk after ``layers.9`` (stride 8; the rest of the
  trunk is not built), and its neck pads only its stride-2 convs;
- SSD-lite-MobileNetV2 taps the expanded features of block 14 (``features.14.conv.2``, 576
  channels, stride 16) and ``features.18`` (1280 channels, stride 32); its neck is four
  stride-2 inverted residuals, its heads separable convs (a depthwise conv with a bias and a
  BN, a ReLU, a pointwise conv) on all levels but the last 1x1 one;
- the decode runs in fp32: ``xy = loc_xy * scale_xy * anchor_wh + anchor_xy``,
  ``wh = exp(clip(loc_wh * scale_wh, -20, 20)) * anchor_wh``; ``pred_scores`` is the softmax
  without the background column.

The outputs are :class:`YoloNASOutputs` with ``cls_logits`` the raw ``[B, A, C + 1]`` confs
and ``reg_distri`` the raw ``[B, A, 4]`` locs (what ``SSDLoss`` reads), as the JAX package
returns them. So ``DetectionModel.predict`` suppresses on the sigmoid of the raw confs,
background column included, as the JAX predict program does (a fault of the JAX package,
kept: ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from super_gradients_tpu_torch.models.classification.mobilenet import (
    InvertedResidual,
    MobileNetV1,
    conv_bn_act,
    mobilenet_v2_blocks,
    reset_mobilenet_parameters,
)
from super_gradients_tpu_torch.models.detection.yolo_nas import YoloNASOutputs

# lite-MobileNetV2 assembly (ssd_lite_mobilenetv2_arch_params.yaml)
_LITE_V2_FEAT = (20, 10, 5, 3, 2, 1)
_LITE_V2_SCALES = (32, 82, 133, 184, 235, 285, 336)
_LITE_V2_ARS = ((2, 3),) * 6
# MobileNetV1 assembly (ssd_mobilenetv1_arch_params.yaml)
_V1_FEAT = (40, 20, 10, 5, 3, 2)
_V1_SCALES = (22, 48, 106, 163, 221, 278, 336)
_V1_ARS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))


def generate_ssd_anchors(
    fig_size: int = 320,
    feat_sizes: Tuple[int, ...] = _LITE_V2_FEAT,
    scales: Tuple[int, ...] = _LITE_V2_SCALES,
    aspect_ratios: Tuple[Tuple[int, ...], ...] = _LITE_V2_ARS,
) -> np.ndarray:
    """Default boxes ``[A, 4]`` in cxcywh pixels: size-major within each level, clamped to
    ``[0, fig_size]``."""
    anchors = []
    for idx, (fs, ars) in enumerate(zip(feat_sizes, aspect_ratios)):
        sk1, sk2 = scales[idx], scales[idx + 1]
        sk3 = math.sqrt(sk1 * sk2)
        all_sizes = [(sk1, sk1), (sk3, sk3)]
        for ar in ars:
            w, h = sk1 * math.sqrt(ar), sk1 / math.sqrt(ar)
            all_sizes.append((w, h))
            all_sizes.append((h, w))
        for w, h in all_sizes:
            for i, j in itertools.product(range(fs), repeat=2):
                cx, cy = (j + 0.5) * fig_size / fs, (i + 0.5) * fig_size / fs
                anchors.append([cx, cy, w, h])
    return np.clip(np.asarray(anchors, np.float32), 0.0, fig_size)


def anchors_per_location(aspect_ratios) -> List[int]:
    return [2 + 2 * len(ars) for ars in aspect_ratios]


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int = 80  # without background
    fig_size: int = 320
    feat_sizes: Tuple[int, ...] = _LITE_V2_FEAT
    scales: Tuple[int, ...] = _LITE_V2_SCALES
    aspect_ratios: Tuple[Tuple[int, ...], ...] = _LITE_V2_ARS
    scale_xy: float = 0.1
    scale_wh: float = 0.2


def v1_config(num_classes: int = 80, fig_size: int = 320) -> SSDConfig:
    return SSDConfig(num_classes=num_classes, fig_size=fig_size, feat_sizes=_V1_FEAT, scales=_V1_SCALES,
                     aspect_ratios=_V1_ARS)


class _Container(nn.Module):
    """A named holder of submodules (the original ``backbone`` / ``neck`` / ``heads``)."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, module in modules.items():
            setattr(self, name, module)


class _SSDBase(nn.Module):
    """The shared head, decode and init of both assemblies."""

    def __init__(self, cfg: SSDConfig):
        super().__init__()
        self.cfg = cfg
        self.na_list = anchors_per_location(cfg.aspect_ratios)
        self._anchors = generate_ssd_anchors(cfg.fig_size, cfg.feat_sizes, cfg.scales, cfg.aspect_ratios)
        self._anchor_cache: Dict[torch.device, torch.Tensor] = {}

    def anchors(self, device) -> torch.Tensor:
        """The default boxes ``[A, 4]`` cxcywh fp32 on ``device`` (made once a device)."""
        device = torch.device(device)
        if device not in self._anchor_cache:
            self._anchor_cache[device] = torch.from_numpy(self._anchors).to(device)
        return self._anchor_cache[device]

    def reset_parameters(self, generator: torch.Generator) -> "_SSDBase":
        return reset_mobilenet_parameters(self, generator)

    def _decode(self, locs: Sequence[torch.Tensor], confs: Sequence[torch.Tensor]) -> YoloNASOutputs:
        cfg = self.cfg

        def flat(o: torch.Tensor, ncols: int, na: int) -> torch.Tensor:
            b, _, h, w = o.shape
            return o.reshape(b, ncols, na, h, w).permute(0, 2, 3, 4, 1).reshape(b, na * h * w, ncols)

        loc = torch.cat([flat(o, 4, na) for o, na in zip(locs, self.na_list)], 1).float()
        conf = torch.cat([flat(o, cfg.num_classes + 1, na) for o, na in zip(confs, self.na_list)], 1).float()
        anchors = self.anchors(loc.device)
        axy, awh = anchors[:, :2], anchors[:, 2:]
        xy = loc[..., :2] * cfg.scale_xy * awh[None] + axy[None]
        wh = torch.exp((loc[..., 2:] * cfg.scale_wh).clamp(-20.0, 20.0)) * awh[None]
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        probs = torch.softmax(conf, -1)[..., 1:]
        nums = tuple(fs * fs * na for fs, na in zip(cfg.feat_sizes, self.na_list))
        return YoloNASOutputs(pred_bboxes=boxes, pred_scores=probs, cls_logits=conf, reg_distri=loc,
                              anchor_points=axy, stride_tensor=torch.ones_like(axy[:, :1]), num_anchors_list=nums)

    def _heads(self, feats: Sequence[torch.Tensor]) -> YoloNASOutputs:
        locs = [head(f) for head, f in zip(self.heads.loc, feats)]
        confs = [head(f) for head, f in zip(self.heads.conf, feats)]
        return self._decode(locs, confs)


class SSDMobileNetV1(_SSDBase):
    """MobileNetV1 trunk to ``layers.9``, five bottleneck neck blocks, plain 3x3 heads."""

    _TRUNK = (64, 128, (128, 2), 256, (256, 2), 512, 512, 512, 512, 512)
    _NECK = ((1024, 256, 3, 2), (512, 256, 3, 2), (256, 128, 3, 2), (256, 128, 3, 1), (256, 128, 2, 1))

    def __init__(self, cfg: SSDConfig):
        super().__init__(cfg)
        trunk = MobileNetV1(cfg=self._TRUNK, backbone_mode=True)
        self.backbone = _Container(multi_output_backbone=nn.ModuleList([trunk]))
        blocks, cin = [], 512
        for out, mid, k, s in self._NECK:
            pad = 1 if s == 2 else 0
            blocks.append(nn.Sequential(nn.Conv2d(cin, mid, 1, bias=False), nn.BatchNorm2d(mid), nn.ReLU(),
                                        nn.Conv2d(mid, out, k, s, pad, bias=False), nn.BatchNorm2d(out), nn.ReLU()))
            cin = out
        self.neck = _Container(neck_blocks=nn.ModuleList(blocks))
        channels = [512] + [out for out, *_ in self._NECK]
        nc1 = cfg.num_classes + 1
        self.heads = _Container(
            loc=nn.ModuleList([nn.Conv2d(c, na * 4, 3, padding=1) for c, na in zip(channels, self.na_list)]),
            conf=nn.ModuleList([nn.Conv2d(c, na * nc1, 3, padding=1) for c, na in zip(channels, self.na_list)]),
        )

    def forward(self, x: torch.Tensor) -> YoloNASOutputs:
        feats = [self.backbone.multi_output_backbone[0](x)]
        for block in self.neck.neck_blocks:
            feats.append(block(feats[-1]))
        return self._heads(feats)


class _MobileNetV2Trunk(nn.Module):
    """MobileNetV2's ``features`` (stem, 17 blocks, head conv) with block 14's expanded
    features tapped."""

    TAP_BLOCK = 13  # features.14

    def __init__(self):
        super().__init__()
        blocks, cin = mobilenet_v2_blocks(32, tap_block=self.TAP_BLOCK)
        self.features = nn.Sequential(conv_bn_act(3, 32, 3, 2, "relu6"), *blocks, conv_bn_act(cin, 1280, 1, 1, "relu6"))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == self.TAP_BLOCK + 1:
                x, expanded = x
                taps.append(expanded)
        return taps + [x]


def _separable_head(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=True), nn.BatchNorm2d(cin), nn.ReLU(),
                         nn.Conv2d(cin, cout, 1, bias=True))


class SSDLiteMobileNetV2(_SSDBase):
    """MobileNetV2 trunk tapped at stride 16 and 32, four stride-2 inverted-residual neck
    blocks, separable heads (a plain 3x3 conv on the last level)."""

    _NECK = ((512, 0.2), (256, 0.25), (256, 0.5), (64, 0.25))

    def __init__(self, cfg: SSDConfig):
        super().__init__(cfg)
        self.backbone = _Container(multi_output_backbone=nn.ModuleList([_MobileNetV2Trunk()]))
        blocks, cin = [], 1280
        for out, ratio in self._NECK:
            blocks.append(InvertedResidual(cin, out, 2, ratio))
            cin = out
        self.neck = _Container(neck_blocks=nn.ModuleList(blocks))
        channels = [576, 1280] + [out for out, _ in self._NECK]
        last = len(channels) - 1

        def head(i: int, c: int, cout: int) -> nn.Module:
            return nn.Conv2d(c, cout, 3, padding=1) if i == last else _separable_head(c, cout)

        nc1 = cfg.num_classes + 1
        self.heads = _Container(
            loc=nn.ModuleList([head(i, c, na * 4) for i, (c, na) in enumerate(zip(channels, self.na_list))]),
            conf=nn.ModuleList([head(i, c, na * nc1) for i, (c, na) in enumerate(zip(channels, self.na_list))]),
        )

    def forward(self, x: torch.Tensor) -> YoloNASOutputs:
        feats = self.backbone.multi_output_backbone[0](x)
        for block in self.neck.neck_blocks:
            feats.append(block(feats[-1]))
        return self._heads(feats)
