"""YOLOX N/T/S/M/L/X in PyTorch (counterpart of
``super_gradients_tpu/models/detection/yolox.py``).

NCHW modules under the original super-gradients layout: the backbone and the PAFPN are
flat indexed ``_modules_list``s (``_backbone._modules_list.4.bottlenecks.0.cv2.conv``,
``_head._modules_list.14.cls_preds.2``; the upsample and concat entries hold no
weights), so that ``conversion/from_jax.py``'s ``YOLOX_RULES`` carry the JAX variables
across. The decoupled head decodes in fp32 as the JAX module does: anchor points
WITHOUT a half-cell offset, ``xy = (reg + point) * stride``, ``wh = exp(clip(reg, -10,
8)) * stride``, scores ``sigmoid(obj) * sigmoid(cls)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.detection.yolo_nas import CLS_PRIOR_BIAS
from super_gradients_tpu_torch.modules.blocks import ConvBNAct
from super_gradients_tpu_torch.ops.pooling import chained_max_pools


def _w(c: int, width: float) -> int:
    return max(round(c * width), 1)


def _d(n: int, depth: float) -> int:
    return max(round(n * depth), 1)


class Bottleneck(nn.Module):
    def __init__(self, channels: int, shortcut: bool, act: str):
        super().__init__()
        self.cv1 = ConvBNAct(channels, channels, 1, act=act)
        self.cv2 = ConvBNAct(channels, channels, 3, act=act)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class CSPLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n: int, shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv2 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv3 = ConvBNAct(2 * hidden, out_channels, 1, act=act)
        self.bottlenecks = nn.Sequential(*(Bottleneck(hidden, shortcut, act) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(torch.cat([self.bottlenecks(self.conv1(x)), self.conv2(x)], dim=1))


class SPPBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, k: Sequence[int] = (5, 9, 13), act: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.k = tuple(k)
        self.cv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.cv2 = ConvBNAct(hidden * (len(self.k) + 1), out_channels, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat((x,) + chained_max_pools(x, self.k), dim=1))


class _Upsample2x(nn.Module):
    """``jax.image.resize(..., 2x, "nearest")``: at exactly 2x it is torch's floor rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest")


class CSPDarknet(nn.Module):
    """The CSPDarknet53 trunk in its YOLOX form (6x6 stride-2 stem); returns (c3, c4, c5)."""

    def __init__(self, width: float = 1.0, depth: float = 1.0, act: str = "silu", in_channels: int = 3):
        super().__init__()
        w = lambda c: _w(c, width)  # noqa: E731
        self._modules_list = nn.ModuleList([
            ConvBNAct(in_channels, w(64), 6, 2, act=act, padding=2),
            ConvBNAct(w(64), w(128), 3, 2, act=act),
            CSPLayer(w(128), w(128), _d(3, depth), act=act),
            ConvBNAct(w(128), w(256), 3, 2, act=act),
            CSPLayer(w(256), w(256), _d(9, depth), act=act),
            ConvBNAct(w(256), w(512), 3, 2, act=act),
            CSPLayer(w(512), w(512), _d(9, depth), act=act),
            ConvBNAct(w(512), w(1024), 3, 2, act=act),
            SPPBlock(w(1024), w(1024), act=act),
            CSPLayer(w(1024), w(1024), _d(3, depth), shortcut=False, act=act),
        ])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        m = self._modules_list
        c3 = m[4](m[3](m[2](m[1](m[0](x)))))
        c4 = m[6](m[5](c3))
        c5 = m[9](m[8](m[7](c4)))
        return c3, c4, c5


class YoloXOutputs(NamedTuple):
    """Decoded + raw outputs (layout of the JAX package's YoloXOutputs)."""

    pred_bboxes: torch.Tensor  # [B, A, 4] xyxy px, fp32
    pred_scores: torch.Tensor  # [B, A, C] sigmoid(obj) * sigmoid(cls), fp32
    reg_raw: torch.Tensor  # [B, A, 4] (dx, dy, log w, log h), fp32
    obj_logits: torch.Tensor  # [B, A], fp32
    cls_logits: torch.Tensor  # [B, A, C], fp32
    anchor_points: torch.Tensor  # [A, 2] grid coordinates, no half-cell offset
    stride_tensor: torch.Tensor  # [A, 1]
    num_anchors_list: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class YoloXConfig:
    num_classes: int = 80
    width: float = 1.0
    depth: float = 1.0
    act: str = "silu"
    strides: Tuple[int, ...] = (8, 16, 32)


class DetectX(nn.Module):
    """The decoupled head: per level a 1x1 stem, two 3x3 convs each for the class and the
    box branch, and the class, box and objectness predictions."""

    def __init__(self, cfg: YoloXConfig, in_channels: Sequence[int], inter: int):
        super().__init__()
        act = cfg.act
        self.stems = nn.ModuleList(ConvBNAct(c, inter, 1, act=act) for c in in_channels)
        def branch():
            return nn.Sequential(ConvBNAct(inter, inter, 3, act=act), ConvBNAct(inter, inter, 3, act=act))

        self.cls_convs = nn.ModuleList(branch() for _ in in_channels)
        self.reg_convs = nn.ModuleList(branch() for _ in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(inter, cfg.num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(inter, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(nn.Conv2d(inter, 1, 1) for _ in in_channels)


class YoloX(nn.Module):
    """CSPDarknet backbone + PAFPN + decoupled head. Input NCHW."""

    def __init__(self, cfg: YoloXConfig):
        super().__init__()
        self.cfg = cfg
        act, width = cfg.act, cfg.width
        w256, w512, w1024 = _w(256, width), _w(512, width), _w(1024, width)
        nrep = _d(3, cfg.depth)
        self._backbone = CSPDarknet(width, cfg.depth, act)
        self._head = nn.Module()
        # the reference's list: weightless upsample and concat entries at 1-2, 5-6, 9 and 12
        # (the forward concatenates itself)
        self._head._modules_list = nn.ModuleList([
            ConvBNAct(w1024, w512, 1, act=act),  # 0 lateral5
            _Upsample2x(), nn.Identity(),
            CSPLayer(2 * w512, w512, nrep, shortcut=False, act=act),  # 3 fpn_c4
            ConvBNAct(w512, w256, 1, act=act),  # 4 lateral4
            _Upsample2x(), nn.Identity(),
            CSPLayer(2 * w256, w256, nrep, shortcut=False, act=act),  # 7 fpn_c3
            ConvBNAct(w256, w256, 3, 2, act=act),  # 8 down3
            nn.Identity(),
            CSPLayer(2 * w256, w512, nrep, shortcut=False, act=act),  # 10 pan_c4
            ConvBNAct(w512, w512, 3, 2, act=act),  # 11 down4
            nn.Identity(),
            CSPLayer(2 * w512, w1024, nrep, shortcut=False, act=act),  # 13 pan_c5
            DetectX(cfg, (w256, w512, w1024), w256),  # 14
        ])

    def forward(self, x: torch.Tensor) -> YoloXOutputs:
        c = self.cfg
        m = self._head._modules_list
        c3, c4, c5 = self._backbone(x)
        lat5 = m[0](c5)
        f4 = m[3](torch.cat([m[1](lat5), c4], dim=1))
        lat4 = m[4](f4)
        p3 = m[7](torch.cat([m[5](lat4), c3], dim=1))
        p4 = m[10](torch.cat([m[8](p3), lat4], dim=1))
        p5 = m[13](torch.cat([m[11](p4), lat5], dim=1))

        head = m[14]
        reg_list, obj_list, cls_list, points, strides, nums = [], [], [], [], [], []
        for i, feat in enumerate((p3, p4, p5)):
            b, _, hh, ww = feat.shape
            s = head.stems[i](feat)
            cls_out = head.cls_preds[i](head.cls_convs[i](s))
            rf = head.reg_convs[i](s)
            reg_out, obj_out = head.reg_preds[i](rf), head.obj_preds[i](rf)
            a = hh * ww
            reg_list.append(reg_out.permute(0, 2, 3, 1).reshape(b, a, 4))
            obj_list.append(obj_out.reshape(b, a))
            cls_list.append(cls_out.permute(0, 2, 3, 1).reshape(b, a, c.num_classes))
            gy, gx = torch.meshgrid(torch.arange(hh, dtype=torch.float32, device=feat.device),
                                    torch.arange(ww, dtype=torch.float32, device=feat.device), indexing="ij")
            points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
            strides.append(torch.full((a, 1), float(c.strides[i]), device=feat.device))
            nums.append(a)

        f32 = (lambda t: t) if x.dtype == torch.float64 else (lambda t: t.float())
        reg_raw = f32(torch.cat(reg_list, dim=1))
        obj_logits = f32(torch.cat(obj_list, dim=1))
        cls_logits = f32(torch.cat(cls_list, dim=1))
        pts = torch.cat(points, dim=0)
        st = torch.cat(strides, dim=0)
        xy = (reg_raw[..., :2] + pts[None]) * st[None]
        wh = torch.exp(reg_raw[..., 2:4].clamp(-10, 8)) * st[None]
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        scores = torch.sigmoid(obj_logits)[..., None] * torch.sigmoid(cls_logits)
        return YoloXOutputs(boxes, scores, reg_raw, obj_logits, cls_logits, pts, st, tuple(nums))

    def reset_parameters(self, generator: torch.Generator) -> "YoloX":
        """Seeded random init: He-normal conv weights, zero biases except the class and
        objectness prior (sigmoid 0.01) of ``cls_preds`` / ``obj_preds``, unit BN affine
        and (0, 1) running stats."""
        with torch.no_grad():
            for name, module in self.named_modules():
                if isinstance(module, nn.Conv2d):
                    fan_in = module.weight[0].numel()
                    module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
                    if module.bias is not None:
                        prior = ".cls_preds." in name or ".obj_preds." in name
                        module.bias.fill_(CLS_PRIOR_BIAS if prior else 0.0)
                elif isinstance(module, nn.BatchNorm2d):
                    module.reset_parameters()
        return self


YOLOX_VARIANTS = {
    "yolox_n": (0.33, 0.25),
    "yolox_t": (0.33, 0.375),
    "yolox_s": (0.33, 0.5),
    "yolox_m": (0.67, 0.75),
    "yolox_l": (1.0, 1.0),
}


def yolox_config(variant: str, num_classes: int = 80) -> YoloXConfig:
    depth, width = YOLOX_VARIANTS[variant]
    return YoloXConfig(num_classes=num_classes, width=width, depth=depth)
