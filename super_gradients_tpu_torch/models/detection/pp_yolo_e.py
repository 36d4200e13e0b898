"""PP-YOLOE S/M/L/X in PyTorch (counterpart of
``super_gradients_tpu/models/detection/pp_yolo_e.py``).

NCHW modules under the original super-gradients attribute names
(``backbone.stem.conv1.seq.conv``, ``backbone.stages.0.blocks.0.conv2.branch_3x3.conv``,
``backbone.stages.0.attn.project``, ``neck.fpn_stages.0.0.convs.spp.conv.seq.conv``,
``head.stem_cls.0.fc``, ``head.pred_reg.2``), so that ``conversion/from_jax.py``'s
``PPYOLOE_RULES`` carry the JAX variables across. The forward returns
:class:`YoloNASOutputs`, levels in the JAX order (stride 32, 16, 8), anchors at
``grid_cell_offset`` 0.5 and the DFL decode in fp32, so ``PPYoloELoss``,
``DetectionMetrics`` and the logits-prefilter NMS of the predict path apply unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.detection.yolo_nas import CLS_PRIOR_BIAS, YoloNASOutputs
from super_gradients_tpu_torch.modules.blocks import ConvBNReLU, RepVGGBlock
from super_gradients_tpu_torch.ops.bbox import batch_distance2bbox
from super_gradients_tpu_torch.ops.dfl import dfl_decode
from super_gradients_tpu_torch.ops.pooling import chained_max_pools


def _round(v, mult) -> int:
    return max(round(v * mult), 1)


def _conv(cin: int, cout: int, kernel: int, act: str, stride: int = 1) -> ConvBNReLU:
    """The reference ``ConvBNAct`` (conv, BN, activation under ``seq``), padding k // 2."""
    return ConvBNReLU(cin, cout, kernel, stride=stride, act=act)


@dataclasses.dataclass(frozen=True)
class PPYoloEConfig:
    num_classes: int = 80
    width_mult: float = 1.0
    depth_mult: float = 1.0
    reg_max: int = 16
    grid_cell_offset: float = 0.5
    act: str = "silu"
    fused: bool = False  # every RepVGG block built in deploy form


class EffectiveSE(nn.Module):
    """``y = x * hardsigmoid(project(mean(x)))`` (reference ``EffectiveSEBlock``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.project = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.hardsigmoid(self.project(x.mean(dim=(2, 3), keepdim=True)))


class CSPResNetBasicBlock(nn.Module):
    """ConvBNAct 3x3 + RepVGG block (+ residual)."""

    def __init__(self, channels: int, act: str, use_residual: bool = True, fused: bool = False):
        super().__init__()
        self.conv1 = _conv(channels, channels, 3, act)
        self.conv2 = RepVGGBlock(channels, channels, act=act, fused=fused)
        self.use_residual = use_residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return x + y if self.use_residual else y


class CSPResStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_blocks: int, stride: int, act: str,
                 use_attention: bool = True, fused: bool = False):
        super().__init__()
        half = (in_channels + out_channels) // 2 // 2
        mid = 2 * half
        cin = in_channels
        if stride != 1:
            self.conv_down = _conv(in_channels, mid, 3, act, stride=stride)
            cin = mid
        else:
            self.conv_down = None
        self.conv1 = _conv(cin, half, 1, act)
        self.conv2 = _conv(cin, half, 1, act)
        self.blocks = nn.Sequential(*(CSPResNetBasicBlock(half, act, True, fused) for _ in range(num_blocks)))
        self.attn = EffectiveSE(mid) if use_attention else None
        self.conv3 = _conv(mid, out_channels, 1, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_down is not None:
            x = self.conv_down(x)
        y = torch.cat([self.conv1(x), self.blocks(self.conv2(x))], dim=1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPResNetBackbone(nn.Module):
    """Large stem (three ConvBNAct) + 4 CSPResStages; returns the stages of ``return_idx``."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0, layers: Sequence[int] = (3, 6, 6, 3),
                 channels: Sequence[int] = (64, 128, 256, 512, 1024), return_idx: Sequence[int] = (1, 2, 3),
                 act: str = "silu", fused: bool = False, in_channels: int = 3):
        super().__init__()
        ch = [_round(c, width_mult) for c in channels]
        layers = [_round(n, depth_mult) for n in layers]
        self.stem = nn.Sequential()
        self.stem.add_module("conv1", _conv(in_channels, ch[0] // 2, 3, act, stride=2))
        self.stem.add_module("conv2", _conv(ch[0] // 2, ch[0] // 2, 3, act))
        self.stem.add_module("conv3", _conv(ch[0] // 2, ch[0], 3, act))
        self.stages = nn.ModuleList(CSPResStage(ch[i], ch[i + 1], n, 2, act, fused=fused) for i, n in enumerate(layers))
        self.return_idx = tuple(return_idx)
        self.out_channels = tuple(ch[i + 1] for i in self.return_idx)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs


class PPYoloESPP(nn.Module):
    """SPP inside the first CSP PAN stage: the input and its chained 5/9/13 max pools, concatenated, then a ConvBNAct."""

    def __init__(self, in_channels: int, out_channels: int, act: str, pool_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        self.pool_sizes = tuple(pool_sizes)
        self.conv = _conv(in_channels * (len(self.pool_sizes) + 1), out_channels, 1, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat((x,) + chained_max_pools(x, self.pool_sizes), dim=1))


class CSPStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block_num: int, spp: bool, act: str, fused: bool = False):
        super().__init__()
        mid = out_channels // 2
        self.conv1 = _conv(in_channels, mid, 1, act)
        self.conv2 = _conv(in_channels, mid, 1, act)
        self.convs = nn.Sequential()
        for i in range(block_num):
            self.convs.add_module(str(i), CSPResNetBasicBlock(mid, act, use_residual=False, fused=fused))
            if i == (block_num - 1) // 2 and spp:
                self.convs.add_module("spp", PPYoloESPP(mid, mid, act))
        self.conv3 = _conv(2 * mid, out_channels, 1, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(torch.cat([self.conv1(x), self.convs(self.conv2(x))], dim=1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., 2x, "nearest")``: at exactly 2x it is torch's floor rule."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PPYoloECSPPAN(nn.Module):
    """Inputs ``[c3 (s8), c4 (s16), c5 (s32)]`` -> outputs ``(s32, s16, s8)``."""

    def __init__(self, in_channels: Sequence[int], width_mult: float = 1.0, depth_mult: float = 1.0,
                 out_channels: Sequence[int] = (768, 384, 192), block_num: int = 3, stage_num: int = 1,
                 spp: bool = True, act: str = "silu", fused: bool = False):
        super().__init__()
        out_ch = [_round(c, width_mult) for c in out_channels]
        block_num = _round(block_num, depth_mult)
        blocks_ch = list(in_channels)[::-1]  # top-down: c5, c4, c3
        n = len(blocks_ch)
        self.fpn_stages, self.fpn_routes = nn.ModuleList(), nn.ModuleList()
        route_ch = 0
        for i, cin in enumerate(blocks_ch):
            cin += route_ch
            stage = nn.Sequential()
            for j in range(stage_num):
                stage.add_module(str(j), CSPStage(cin if j == 0 else out_ch[i], out_ch[i], block_num,
                                                  spp=(spp and i == 0), act=act, fused=fused))
            self.fpn_stages.append(stage)
            if i < n - 1:
                self.fpn_routes.append(_conv(out_ch[i], out_ch[i] // 2, 1, act))
                route_ch = out_ch[i] // 2
        # pan_routes[i] / pan_stages[i] serve level i, built (and run) from the bottom level up
        pan_routes, pan_stages = [None] * (n - 1), [None] * (n - 1)
        route_ch = out_ch[-1]
        for i in reversed(range(n - 1)):
            pan_routes[i] = _conv(route_ch, route_ch, 3, act, stride=2)
            stage = nn.Sequential()
            for j in range(stage_num):
                stage.add_module(str(j), CSPStage(route_ch + out_ch[i] if j == 0 else out_ch[i], out_ch[i], block_num,
                                                  spp=False, act=act, fused=fused))
            pan_stages[i] = stage
            route_ch = out_ch[i]
        self.pan_routes, self.pan_stages = nn.ModuleList(pan_routes), nn.ModuleList(pan_stages)
        self.out_channels = tuple(out_ch)  # (s32, s16, s8)

    def forward(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        blocks = list(blocks)[::-1]
        n = len(blocks)
        fpn_feats, route = [], None
        for i, block in enumerate(blocks):
            if i > 0:
                block = torch.cat([route, block], dim=1)
            x = self.fpn_stages[i](block)
            fpn_feats.append(x)
            if i < n - 1:
                route = _upsample2x(self.fpn_routes[i](x))
        pan_feats = [fpn_feats[-1]]
        route = fpn_feats[-1]
        for i in reversed(range(n - 1)):
            route = self.pan_routes[i](route)
            route = self.pan_stages[i](torch.cat([route, fpn_feats[i]], dim=1))
            pan_feats.append(route)
        return pan_feats[::-1]


class ESEAttn(nn.Module):
    """A head stem: ``conv(x * sigmoid(fc(mean(x))))``, the mean computed once by the head."""

    def __init__(self, channels: int, act: str):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)
        self.conv = _conv(channels, channels, 1, act)

    def forward(self, feat: torch.Tensor, avg: torch.Tensor) -> torch.Tensor:
        return self.conv(feat * torch.sigmoid(self.fc(avg)))


class PPYoloEHead(nn.Module):
    """ESE-attention head with the DFL decode."""

    def __init__(self, cfg: PPYoloEConfig, in_channels: Sequence[int], strides: Sequence[int] = (32, 16, 8)):
        super().__init__()
        self.cfg = cfg
        self.strides = tuple(strides)
        nreg = 4 * (cfg.reg_max + 1)
        self.stem_cls = nn.ModuleList(ESEAttn(c, cfg.act) for c in in_channels)
        self.stem_reg = nn.ModuleList(ESEAttn(c, cfg.act) for c in in_channels)
        self.pred_cls = nn.ModuleList(nn.Conv2d(c, cfg.num_classes, 3, padding=1) for c in in_channels)
        self.pred_reg = nn.ModuleList(nn.Conv2d(c, nreg, 3, padding=1) for c in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> YoloNASOutputs:
        c = self.cfg
        cls_list, reg_list, points, strides, num_anchors = [], [], [], [], []
        for i, feat in enumerate(feats):
            b, _, hh, ww = feat.shape
            avg = feat.mean(dim=(2, 3), keepdim=True)
            cls_logit = self.pred_cls[i](self.stem_cls[i](feat, avg) + feat)
            reg_distri = self.pred_reg[i](self.stem_reg[i](feat, avg))
            a = hh * ww
            cls_list.append(cls_logit.permute(0, 2, 3, 1).reshape(b, a, c.num_classes))
            reg_list.append(reg_distri.permute(0, 2, 3, 1).reshape(b, a, 4 * (c.reg_max + 1)))
            sx = torch.arange(ww, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            sy = torch.arange(hh, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
            strides.append(torch.full((a, 1), float(self.strides[i]), device=feat.device))
            num_anchors.append(a)

        cls_logits = torch.cat(cls_list, dim=1)
        reg_distri = torch.cat(reg_list, dim=1)
        b, a, _ = reg_distri.shape
        distances = dfl_decode(reg_distri.reshape(b, a, 4, c.reg_max + 1), c.reg_max)
        anchor_points = torch.cat(points, dim=0)
        stride_tensor = torch.cat(strides, dim=0)
        pred_bboxes = batch_distance2bbox(anchor_points[None], distances) * stride_tensor[None]
        return YoloNASOutputs(
            pred_bboxes=pred_bboxes,
            pred_scores=torch.sigmoid(cls_logits if cls_logits.dtype == torch.float64 else cls_logits.float()),
            cls_logits=cls_logits,
            reg_distri=reg_distri,
            anchor_points=anchor_points,
            stride_tensor=stride_tensor,
            num_anchors_list=tuple(num_anchors),
        )


class PPYoloE(nn.Module):
    """backbone -> neck -> head. Input NCHW."""

    def __init__(self, cfg: PPYoloEConfig):
        super().__init__()
        self.backbone = CSPResNetBackbone(cfg.width_mult, cfg.depth_mult, act=cfg.act, fused=cfg.fused)
        self.neck = PPYoloECSPPAN(self.backbone.out_channels, cfg.width_mult, cfg.depth_mult, act=cfg.act,
                                  fused=cfg.fused)
        self.head = PPYoloEHead(cfg, self.neck.out_channels)

    def forward(self, x: torch.Tensor) -> YoloNASOutputs:
        return self.head(self.neck(self.backbone(x)))

    def reset_parameters(self, generator: torch.Generator) -> "PPYoloE":
        """Seeded random init (:func:`reset_ppyoloe_parameters`)."""
        return reset_ppyoloe_parameters(self, generator)


@torch.no_grad()
def reset_ppyoloe_parameters(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """He-normal conv weights and zero biases, unit BN affine and (0, 1) running stats;
    the prediction convs as the JAX module starts them: zero kernels, the class prior
    bias on ``pred_cls`` and a bias of 1 on ``pred_reg`` (every class score 0.01 and
    every box alike until trained)."""
    for name, module in net.named_modules():
        if isinstance(module, nn.Conv2d):
            leaf = name.split(".")[-2] if name[-1].isdigit() else ""
            if leaf in ("pred_cls", "pred_reg"):
                module.weight.zero_()
                module.bias.fill_(CLS_PRIOR_BIAS if leaf == "pred_cls" else 1.0)
                continue
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / module.weight[0].numel()))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return net


def ppyoloe_s_config(num_classes: int = 80, **kw) -> PPYoloEConfig:
    return PPYoloEConfig(num_classes=num_classes, width_mult=0.5, depth_mult=0.33, **kw)


def ppyoloe_m_config(num_classes: int = 80, **kw) -> PPYoloEConfig:
    return PPYoloEConfig(num_classes=num_classes, width_mult=0.75, depth_mult=0.67, **kw)


def ppyoloe_l_config(num_classes: int = 80, **kw) -> PPYoloEConfig:
    return PPYoloEConfig(num_classes=num_classes, width_mult=1.0, depth_mult=1.0, **kw)


def ppyoloe_x_config(num_classes: int = 80, **kw) -> PPYoloEConfig:
    return PPYoloEConfig(num_classes=num_classes, width_mult=1.25, depth_mult=1.33, **kw)
