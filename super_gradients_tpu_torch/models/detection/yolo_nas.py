"""YOLO-NAS S/M/L in PyTorch (counterpart of
``super_gradients_tpu/models/detection/yolo_nas.py``).

NCHW modules whose attribute names are those of the original super-gradients
model (``backbone.stem.conv.branch_3x3.conv``, ``neck.neck1.upsample``,
``heads.head1.cls_convs.0.seq.bn``, ``...bottlenecks.0.alpha``). The forward
returns :class:`YoloNASOutputs` in the JAX package's layout: anchors are
flattened row-major over ``(y, x)`` of each level (``a = y * w + x``), levels
concatenated stride 8, 16, 32, and the decode (DFL expectation, distance to
box, sigmoid) runs in fp32 whatever the dtype of the convolutions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from super_gradients_tpu_torch.modules.blocks import ConvBNAct, ConvBNReLU, QARepVGGBlock, width_multiplier
from super_gradients_tpu_torch.ops.bbox import batch_distance2bbox
from super_gradients_tpu_torch.ops.dfl import dfl_decode
from super_gradients_tpu_torch.ops.pooling import chained_max_pools

# --------------------------------------------------------------------- configs


@dataclasses.dataclass(frozen=True)
class StageCfg:
    out_channels: int
    num_blocks: int
    hidden_channels: int
    concat_intermediates: bool = False
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class UpStageCfg:
    out_channels: int
    num_blocks: int
    hidden_channels: int
    width_mult: float = 1.0
    depth_mult: float = 1.0
    reduce_channels: bool = True
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class DownStageCfg:
    out_channels: int
    num_blocks: int
    hidden_channels: int
    width_mult: float = 1.0
    depth_mult: float = 1.0
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class HeadCfg:
    inter_channels: int
    width_mult: float
    stride: int
    first_conv_group_size: int = 0


@dataclasses.dataclass(frozen=True)
class YoloNASConfig:
    """Full architecture config (mirrors yolo_nas_*_arch_params.yaml)."""

    stem_channels: int
    stages: Tuple[StageCfg, ...]
    spp_channels: int
    spp_k: Tuple[int, ...]
    neck1: UpStageCfg
    neck2: UpStageCfg
    neck3: DownStageCfg
    neck4: DownStageCfg
    heads: Tuple[HeadCfg, ...]
    num_classes: int = 80
    reg_max: int = 16
    in_channels: int = 3
    bn_eps: float = 1e-3
    bn_momentum: float = 0.03
    grid_cell_offset: float = 0.5
    fused: bool = False  # every QARepVGG block built in deploy form


def _num_blocks(n: int, depth_mult: float) -> int:
    return max(round(n * depth_mult), 1) if n > 1 else n


# ---------------------------------------------------------------- core layers


class YoloNASBottleneck(nn.Module):
    """Two conv blocks + alpha-weighted residual (ref yolo_stages.py:23-64; every
    YOLO-NAS bottleneck has the shortcut and its alpha)."""

    def __init__(self, channels: int, block: Callable[[int, int], nn.Module]):
        super().__init__()
        self.cv1 = block(channels, channels)
        self.cv2 = block(channels, channels)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha * x + self.cv2(self.cv1(x))


class YoloNASCSPLayer(nn.Module):
    """Cross-stage layer (ref yolo_stages.py:88-152)."""

    def __init__(self, in_channels: int, out_channels: int, num_bottlenecks: int, block, hidden_channels: int,
                 act: str, bn_eps: float, bn_momentum: float, concat_intermediates: bool = False):
        super().__init__()

        def conv(cin, cout):
            return ConvBNAct(cin, cout, 1, act=act, bn_eps=bn_eps, bn_momentum=bn_momentum)

        h = hidden_channels
        self.conv1 = conv(in_channels, h)
        self.conv2 = conv(in_channels, h)
        self.bottlenecks = nn.ModuleList(YoloNASBottleneck(h, block) for _ in range(num_bottlenecks))
        self.concat_intermediates = concat_intermediates
        n_feats = num_bottlenecks + 2 if concat_intermediates else 2
        self.conv3 = conv(h * n_feats, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        intermediates = [x1]
        for bottleneck in self.bottlenecks:
            x1 = bottleneck(x1)
            intermediates.append(x1)
        x2 = self.conv2(x)
        feats = intermediates + [x2] if self.concat_intermediates else [intermediates[-1], x2]
        return self.conv3(torch.cat(feats, dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling (ref csp_darknet53.py:136-157), SPPF-chained pools."""

    def __init__(self, in_channels: int, out_channels: int, k: Sequence[int], act: str, bn_eps: float,
                 bn_momentum: float):
        super().__init__()
        hidden = in_channels // 2
        self.k = tuple(k)
        self.cv1 = ConvBNAct(in_channels, hidden, 1, act=act, bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.cv2 = ConvBNAct(hidden * (len(self.k) + 1), out_channels, 1, act=act, bn_eps=bn_eps, bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat((x,) + chained_max_pools(x, self.k), dim=1))


def _qarep(cfg: YoloNASConfig, act: str):
    """In-CSP QARepVGG block factory: stride 1, residual, no alpha."""

    def make(cin: int, cout: int) -> QARepVGGBlock:
        return QARepVGGBlock(cin, cout, act=act, use_residual=True, use_alpha=False, bn_eps=cfg.bn_eps,
                             bn_momentum=cfg.bn_momentum, fused=cfg.fused)

    return make


class YoloNASStem(nn.Module):
    """Single stride-2 QARepVGG block (ref yolo_stages.py:155-183)."""

    def __init__(self, cfg: YoloNASConfig):
        super().__init__()
        self.conv = QARepVGGBlock(cfg.in_channels, cfg.stem_channels, stride=2, use_residual=False,
                                  bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum, fused=cfg.fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class YoloNASStage(nn.Module):
    """Downsample QARepVGG + CSP layer (ref yolo_stages.py:186-236)."""

    def __init__(self, cfg: YoloNASConfig, stage: StageCfg, in_channels: int):
        super().__init__()
        self.downsample = QARepVGGBlock(in_channels, stage.out_channels, stride=2, act=stage.act, use_residual=False,
                                        bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum, fused=cfg.fused)
        self.blocks = YoloNASCSPLayer(stage.out_channels, stage.out_channels, stage.num_blocks, _qarep(cfg, stage.act),
                                      stage.hidden_channels, stage.act, cfg.bn_eps, cfg.bn_momentum,
                                      concat_intermediates=stage.concat_intermediates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class YoloNASUpStage(nn.Module):
    """Upsample stage with 2 skips (ref yolo_stages.py:239-337, 3-input form)."""

    def __init__(self, cfg: YoloNASConfig, stage: UpStageCfg, in_channels: int, skip1_channels: int,
                 skip2_channels: int):
        super().__init__()
        out = width_multiplier(stage.out_channels, stage.width_mult, 8)
        self.out_channels = out

        def conv(cin, cout, k=1, s=1):
            return ConvBNAct(cin, cout, k, s, act=stage.act, bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum)

        if not stage.reduce_channels:
            raise ValueError("only reduce_channels=True (every published YOLO-NAS config) is ported")
        self.reduce_skip1 = conv(skip1_channels, out)
        self.reduce_skip2 = conv(skip2_channels, out)
        self.downsample = conv(out, out, 3, 2)
        self.conv = conv(in_channels, out)
        self.upsample = nn.ConvTranspose2d(out, out, kernel_size=2, stride=2)
        self.reduce_after_concat = conv(3 * out, out)
        self.blocks = YoloNASCSPLayer(out, out, _num_blocks(stage.num_blocks, stage.depth_mult), _qarep(cfg, stage.act),
                                      stage.hidden_channels, stage.act, cfg.bn_eps, cfg.bn_momentum)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        x, skip_x1, skip_x2 = inputs
        skip_x1 = self.reduce_skip1(skip_x1)
        skip_x2 = self.downsample(self.reduce_skip2(skip_x2))
        x_inter = self.conv(x)
        y = self.reduce_after_concat(torch.cat([self.upsample(x_inter), skip_x1, skip_x2], dim=1))
        return x_inter, self.blocks(y)


class YoloNASDownStage(nn.Module):
    """Downsample stage (ref yolo_stages.py:340-395)."""

    def __init__(self, cfg: YoloNASConfig, stage: DownStageCfg, in_channels: int, skip_channels: int):
        super().__init__()
        out = width_multiplier(stage.out_channels, stage.width_mult, 8)
        self.out_channels = out
        bn = dict(bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum)
        self.conv = ConvBNAct(in_channels, out // 2, 3, 2, act=stage.act, **bn)

        def block(cin, cout):
            return ConvBNAct(cin, cout, 3, 1, act=stage.act, **bn)

        self.blocks = YoloNASCSPLayer(out // 2 + skip_channels, out, _num_blocks(stage.num_blocks, stage.depth_mult),
                                      block, stage.hidden_channels, stage.act, cfg.bn_eps, cfg.bn_momentum)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        x, skip_x = inputs
        return self.blocks(torch.cat([self.conv(x), skip_x], dim=1))


class NStageBackbone(nn.Module):
    """Stem + 4 stages + SPP; returns (c2, c3, c4, c5) (ref nstage_backbone.py)."""

    def __init__(self, cfg: YoloNASConfig):
        super().__init__()
        self.stem = YoloNASStem(cfg)
        cin = cfg.stem_channels
        for i, stage in enumerate(cfg.stages):
            setattr(self, f"stage{i + 1}", YoloNASStage(cfg, stage, cin))
            cin = stage.out_channels
        self.num_stages = len(cfg.stages)
        self.context_module = SPP(cin, cfg.spp_channels, cfg.spp_k, "relu", cfg.bn_eps, cfg.bn_momentum)
        self.out_channels = tuple(s.out_channels for s in cfg.stages[:3]) + (cfg.spp_channels,)

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"stage{i + 1}")(x)
            outs.append(x)
        return outs[0], outs[1], outs[2], self.context_module(outs[-1])


class YoloNASPANNeckWithC2(nn.Module):
    """PAN neck, 2 up + 2 down stages with C2 skip (ref panneck.py:13-66)."""

    def __init__(self, cfg: YoloNASConfig):
        super().__init__()
        c2, c3, c4 = (s.out_channels for s in cfg.stages[:3])
        self.neck1 = YoloNASUpStage(cfg, cfg.neck1, cfg.spp_channels, c4, c3)
        self.neck2 = YoloNASUpStage(cfg, cfg.neck2, self.neck1.out_channels, c3, c2)
        self.neck3 = YoloNASDownStage(cfg, cfg.neck3, self.neck2.out_channels, self.neck2.out_channels)
        self.neck4 = YoloNASDownStage(cfg, cfg.neck4, self.neck3.out_channels, self.neck1.out_channels)
        self.out_channels = (self.neck2.out_channels, self.neck3.out_channels, self.neck4.out_channels)

    def forward(self, feats):
        c2, c3, c4, c5 = feats
        x_n1_inter, x = self.neck1([c5, c4, c3])
        x_n2_inter, p3 = self.neck2([x, c3, c2])
        p4 = self.neck3([p3, x_n2_inter])
        p5 = self.neck4([p4, x_n1_inter])
        return p3, p4, p5


class YoloNASDFLHead(nn.Module):
    """Per-level DFL head (ref dfl_heads.py:21-112)."""

    def __init__(self, cfg: YoloNASConfig, head: HeadCfg, in_channels: int):
        super().__init__()
        inter = width_multiplier(head.inter_channels, head.width_mult, 8)
        bn = dict(bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum)
        self.stem = ConvBNReLU(in_channels, inter, 1, **bn)
        self.cls_convs = nn.Sequential(ConvBNReLU(inter, inter, 3, **bn))
        self.cls_pred = nn.Conv2d(inter, cfg.num_classes, 1)
        self.reg_convs = nn.Sequential(ConvBNReLU(inter, inter, 3, **bn))
        self.reg_pred = nn.Conv2d(inter, 4 * (cfg.reg_max + 1), 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        return self.reg_pred(self.reg_convs(x)), self.cls_pred(self.cls_convs(x))


# class prior of the classification bias: sigmoid(bias) = 0.01 at init
CLS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class YoloNASOutputs(NamedTuple):
    """Decoded + raw outputs (layout of the JAX package's YoloNASOutputs)."""

    pred_bboxes: torch.Tensor  # [B, A, 4] xyxy in input-image pixels, fp32
    pred_scores: torch.Tensor  # [B, A, C] sigmoid scores, fp32
    cls_logits: torch.Tensor  # [B, A, C] in the network's dtype
    reg_distri: torch.Tensor  # [B, A, 4*(reg_max+1)]
    anchor_points: torch.Tensor  # [A, 2] grid-cell centers (stride units)
    stride_tensor: torch.Tensor  # [A, 1]
    num_anchors_list: Tuple[int, ...]


class NDFLHeads(nn.Module):
    """Multi-level head + decode (ref dfl_heads.py:113-283)."""

    def __init__(self, cfg: YoloNASConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        for i, (head, cin) in enumerate(zip(cfg.heads, in_channels)):
            setattr(self, f"head{i + 1}", YoloNASDFLHead(cfg, head, cin))

    def forward(self, feats: Sequence[torch.Tensor]) -> YoloNASOutputs:
        c = self.cfg
        cls_list: List[torch.Tensor] = []
        reg_list: List[torch.Tensor] = []
        points, strides, num_anchors = [], [], []
        for i, feat in enumerate(feats):
            b, _, hh, ww = feat.shape
            reg_out, cls_out = getattr(self, f"head{i + 1}")(feat)
            # NCHW -> [B, A, C] with anchors row-major over (y, x), as the JAX NHWC reshape
            cls_list.append(cls_out.permute(0, 2, 3, 1).reshape(b, hh * ww, c.num_classes))
            reg_list.append(reg_out.permute(0, 2, 3, 1).reshape(b, hh * ww, 4 * (c.reg_max + 1)))
            sx = torch.arange(ww, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            sy = torch.arange(hh, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
            strides.append(torch.full((hh * ww, 1), float(c.heads[i].stride), device=feat.device))
            num_anchors.append(hh * ww)

        cls_logits = torch.cat(cls_list, dim=1)
        reg_distri = torch.cat(reg_list, dim=1)
        b, a, _ = reg_distri.shape
        distances = dfl_decode(reg_distri.reshape(b, a, 4, c.reg_max + 1), c.reg_max)  # side-major 4 x 17
        anchor_points = torch.cat(points, dim=0)
        stride_tensor = torch.cat(strides, dim=0)
        pred_bboxes = batch_distance2bbox(anchor_points[None], distances) * stride_tensor[None]
        return YoloNASOutputs(
            pred_bboxes=pred_bboxes,
            pred_scores=torch.sigmoid(cls_logits.float()),
            cls_logits=cls_logits,
            reg_distri=reg_distri,
            anchor_points=anchor_points,
            stride_tensor=stride_tensor,
            num_anchors_list=tuple(num_anchors),
        )


class YoloNAS(nn.Module):
    """backbone -> neck -> heads (ref customizable_detector.py:30-95). Input NCHW."""

    def __init__(self, cfg: YoloNASConfig):
        super().__init__()
        self.backbone = NStageBackbone(cfg)
        self.neck = YoloNASPANNeckWithC2(cfg)
        self.heads = NDFLHeads(cfg, self.neck.out_channels)

    def forward(self, x: torch.Tensor) -> YoloNASOutputs:
        return self.heads(self.neck(self.backbone(x)))

    def reset_parameters(self, generator: torch.Generator) -> "YoloNAS":
        """Seeded random init (:func:`reset_yolo_nas_parameters`)."""
        return reset_yolo_nas_parameters(self, generator)


@torch.no_grad()
def reset_yolo_nas_parameters(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of a YOLO-NAS family network: He-normal conv weights, zero
    conv biases except the classification prior of every ``cls_pred``, unit BN affine
    and (0, 1) running stats, alpha 1."""
    for name, module in net.named_modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            # a 2x2 stride-2 transposed conv feeds each output from one tap of `in` channels
            fan_in = module.weight[0].numel() if isinstance(module, nn.Conv2d) else module.weight.shape[0]
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            if module.bias is not None:
                module.bias.fill_(CLS_PRIOR_BIAS if name.endswith("cls_pred") else 0.0)
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    for name, p in net.named_parameters():
        if name.endswith("alpha"):
            p.fill_(1.0)
    return net


def yolo_nas_s_config(num_classes: int = 80, fused: bool = False) -> YoloNASConfig:
    return YoloNASConfig(
        stem_channels=48,
        stages=(
            StageCfg(96, 2, 32, False),
            StageCfg(192, 3, 64, False),
            StageCfg(384, 5, 96, False),
            StageCfg(768, 2, 192, False),
        ),
        spp_channels=768,
        spp_k=(5, 9, 13),
        neck1=UpStageCfg(192, 2, 64, reduce_channels=True),
        neck2=UpStageCfg(96, 2, 48, reduce_channels=True),
        neck3=DownStageCfg(192, 2, 64),
        neck4=DownStageCfg(384, 2, 64),
        heads=(HeadCfg(128, 0.5, 8), HeadCfg(256, 0.5, 16), HeadCfg(512, 0.5, 32)),
        num_classes=num_classes,
        fused=fused,
    )


def yolo_nas_m_config(num_classes: int = 80, fused: bool = False) -> YoloNASConfig:
    return YoloNASConfig(
        stem_channels=48,
        stages=(
            StageCfg(96, 2, 64, True),
            StageCfg(192, 3, 128, True),
            StageCfg(384, 5, 256, True),
            StageCfg(768, 2, 384, False),
        ),
        spp_channels=768,
        spp_k=(5, 9, 13),
        neck1=UpStageCfg(192, 2, 192, reduce_channels=True),
        neck2=UpStageCfg(96, 3, 64, reduce_channels=True),
        neck3=DownStageCfg(192, 2, 192),
        neck4=DownStageCfg(384, 3, 256),
        heads=(HeadCfg(128, 0.75, 8), HeadCfg(256, 0.75, 16), HeadCfg(512, 0.75, 32)),
        num_classes=num_classes,
        fused=fused,
    )


def yolo_nas_l_config(num_classes: int = 80, fused: bool = False) -> YoloNASConfig:
    return YoloNASConfig(
        stem_channels=48,
        stages=(
            StageCfg(96, 2, 96, True),
            StageCfg(192, 3, 128, True),
            StageCfg(384, 5, 256, True),
            StageCfg(768, 2, 512, True),
        ),
        spp_channels=768,
        spp_k=(5, 9, 13),
        neck1=UpStageCfg(192, 4, 128, reduce_channels=True),
        neck2=UpStageCfg(96, 4, 128, reduce_channels=True),
        neck3=DownStageCfg(192, 4, 128),
        neck4=DownStageCfg(384, 4, 256),
        heads=(HeadCfg(128, 1.0, 8), HeadCfg(256, 1.0, 16), HeadCfg(512, 1.0, 32)),
        num_classes=num_classes,
        fused=fused,
    )
