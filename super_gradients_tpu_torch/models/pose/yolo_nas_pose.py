"""YOLO-NAS-POSE N/S/M/L in PyTorch (counterpart of
``super_gradients_tpu/models/pose/yolo_nas_pose.py``).

The detection ``NStageBackbone`` and ``YoloNASPANNeckWithC2`` of
``models/detection/yolo_nas.py``, then one pose head per level. Each head has a
box branch (``bbox_stem`` -> ``cls_convs`` / ``reg_convs``) and a pose branch
(``pose_stem`` -> ``pose_convs`` -> ``pose_pred``); its ``cls_pred`` has ``1 + J``
channels: channel 0 is the person score, channels 1..J the joints' visibility
logits. Attribute names are those of the original super-gradients model
(``heads.head1.pose_stem.seq.conv``, ``heads.head1.pose_convs.0.seq.bn``).

The forward returns :class:`YoloNASPoseOutputs` in the JAX package's layout
(anchors row-major over ``(y, x)`` of each level, levels stride 8, 16, 32). The
box decode (DFL expectation, distance to box), the keypoint decode
``(pose_reg * mult + anchor - offset) * stride`` and the sigmoids run in fp32
whatever the dtype of the convolutions (fp64 in an fp64 network).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from super_gradients_tpu_torch.models.detection.customizable_detector import (
    parse_module_spec,
    yolo_nas_config_from_arch_params,
)
from super_gradients_tpu_torch.models.detection.yolo_nas import (
    DownStageCfg,
    NStageBackbone,
    StageCfg,
    UpStageCfg,
    YoloNASConfig,
    YoloNASPANNeckWithC2,
    reset_yolo_nas_parameters,
    yolo_nas_l_config,
    yolo_nas_m_config,
    yolo_nas_s_config,
)
from super_gradients_tpu_torch.modules.blocks import ConvBNReLU, width_multiplier
from super_gradients_tpu_torch.ops.bbox import batch_distance2bbox
from super_gradients_tpu_torch.ops.dfl import dfl_decode


@dataclasses.dataclass(frozen=True)
class PoseHeadCfg:
    bbox_inter_channels: int
    pose_inter_channels: int
    pose_regression_blocks: int
    width_mult: float
    stride: int


@dataclasses.dataclass(frozen=True)
class YoloNASPoseConfig:
    base: YoloNASConfig  # backbone and neck channels (its num_classes and heads are not read)
    heads: Tuple[PoseHeadCfg, ...]
    num_joints: int = 17
    reg_max: int = 16
    pose_offset_multiplier: float = 1.0
    compensate_grid_cell_offset: bool = True
    grid_cell_offset: float = 0.5
    bn_eps: float = 1e-3
    bn_momentum: float = 0.03
    fused: bool = False  # every QARepVGG block (backbone and neck) built in deploy form


class YoloNASPoseDFLHead(nn.Module):
    """Per-level pose head (reference ``yolo_nas_pose_dfl_head.py`` with
    ``shared_stem=False``, ``pose_conf_in_class_head=True``,
    ``pose_block_use_repvgg=False``, as every published variant)."""

    def __init__(self, cfg: YoloNASPoseConfig, head: PoseHeadCfg, in_channels: int):
        super().__init__()
        bi = width_multiplier(head.bbox_inter_channels, head.width_mult, 8)
        pi = width_multiplier(head.pose_inter_channels, head.width_mult, 8)
        bn = dict(bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum)
        self.num_joints = cfg.num_joints
        self.pose_stem = ConvBNReLU(in_channels, pi, 1, **bn)
        self.bbox_stem = ConvBNReLU(in_channels, bi, 1, **bn)
        self.cls_convs = nn.Sequential(ConvBNReLU(bi, bi, 3, **bn))
        self.cls_pred = nn.Conv2d(bi, 1 + cfg.num_joints, 1)
        self.reg_convs = nn.Sequential(ConvBNReLU(bi, bi, 3, **bn))
        self.reg_pred = nn.Conv2d(bi, 4 * (cfg.reg_max + 1), 1)
        self.pose_convs = nn.Sequential(*(ConvBNReLU(pi, pi, 3, **bn) for _ in range(head.pose_regression_blocks)))
        self.pose_pred = nn.Conv2d(pi, 2 * cfg.num_joints, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (reg_out ``[B, 4*(reg_max+1), H, W]``, cls_out ``[B, 1+J, H, W]``, pose_out ``[B, 2J, H, W]``)."""
        pose_feat = self.pose_stem(x)
        bbox_feat = self.bbox_stem(x)
        cls_out = self.cls_pred(self.cls_convs(bbox_feat))
        reg_out = self.reg_pred(self.reg_convs(bbox_feat))
        pose_out = self.pose_pred(self.pose_convs(pose_feat))
        return reg_out, cls_out, pose_out


class YoloNASPoseOutputs(NamedTuple):
    """Decoded + raw outputs (layout of the JAX package's YoloNASPoseOutputs)."""

    pred_bboxes: torch.Tensor  # [B, A, 4] xyxy px, fp32
    pred_scores: torch.Tensor  # [B, A, 1] fp32
    pred_pose_coords: torch.Tensor  # [B, A, J, 2] px, fp32
    pred_pose_scores: torch.Tensor  # [B, A, J] fp32
    cls_logits: torch.Tensor  # [B, A, 1] in the network's dtype
    reg_distri: torch.Tensor  # [B, A, 4*(reg_max+1)]
    pose_logits: torch.Tensor  # [B, A, J]
    anchor_points: torch.Tensor  # [A, 2] grid-cell centers (stride units)
    stride_tensor: torch.Tensor  # [A, 1]
    num_anchors_list: Tuple[int, ...]


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 for narrower floats; fp64 stays fp64 (the tests' fp64 reference runs)."""
    return t if t.dtype == torch.float64 else t.float()


class YoloNASPoseNDFLHeads(nn.Module):
    """The three pose heads + decode (reference ``yolo_nas_pose_ndfl_heads.py``)."""

    def __init__(self, cfg: YoloNASPoseConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        for i, (head, cin) in enumerate(zip(cfg.heads, in_channels)):
            setattr(self, f"head{i + 1}", YoloNASPoseDFLHead(cfg, head, cin))

    def forward(self, feats: Sequence[torch.Tensor]) -> YoloNASPoseOutputs:
        c = self.cfg
        j = c.num_joints
        cls_list, reg_list, pose_list = [], [], []
        points, strides, num_anchors = [], [], []
        for i, feat in enumerate(feats):
            b, _, hh, ww = feat.shape
            a = hh * ww
            reg_out, cls_out, pose_out = getattr(self, f"head{i + 1}")(feat)
            # NCHW -> [B, A, C] with anchors row-major over (y, x), as the JAX NHWC reshape
            cls_list.append(cls_out.permute(0, 2, 3, 1).reshape(b, a, 1 + j))
            reg_list.append(reg_out.permute(0, 2, 3, 1).reshape(b, a, 4 * (c.reg_max + 1)))
            pose_list.append(pose_out.permute(0, 2, 3, 1).reshape(b, a, j, 2))  # channel 2j + (x, y)
            sx = torch.arange(ww, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            sy = torch.arange(hh, dtype=torch.float32, device=feat.device) + c.grid_cell_offset
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
            strides.append(torch.full((a, 1), float(c.heads[i].stride), device=feat.device))
            num_anchors.append(a)

        cls_all = torch.cat(cls_list, dim=1)
        cls_logits, pose_logits = cls_all[..., :1], cls_all[..., 1:]
        reg_distri = torch.cat(reg_list, dim=1)
        b, a, _ = reg_distri.shape
        distances = dfl_decode(reg_distri.reshape(b, a, 4, c.reg_max + 1), c.reg_max)
        anchor_points = torch.cat(points, dim=0)
        stride_tensor = torch.cat(strides, dim=0)
        pred_bboxes = batch_distance2bbox(anchor_points[None], distances) * stride_tensor[None]

        pose_reg = _at_least_f32(torch.cat(pose_list, dim=1))
        offset = c.grid_cell_offset if c.compensate_grid_cell_offset else 0.0
        coords = (pose_reg * c.pose_offset_multiplier + anchor_points[None, :, None, :] - offset) \
            * stride_tensor[None, :, None, :]
        return YoloNASPoseOutputs(
            pred_bboxes=pred_bboxes,
            pred_scores=torch.sigmoid(_at_least_f32(cls_logits)),
            pred_pose_coords=coords,
            pred_pose_scores=torch.sigmoid(_at_least_f32(pose_logits)),
            cls_logits=cls_logits,
            reg_distri=reg_distri,
            pose_logits=pose_logits,
            anchor_points=anchor_points,
            stride_tensor=stride_tensor,
            num_anchors_list=tuple(num_anchors),
        )


class YoloNASPose(nn.Module):
    """backbone -> neck -> pose heads (reference ``yolo_nas_pose_variants.py``). Input NCHW."""

    def __init__(self, cfg: YoloNASPoseConfig):
        super().__init__()
        base = dataclasses.replace(cfg.base, fused=cfg.fused)
        self.backbone = NStageBackbone(base)
        self.neck = YoloNASPANNeckWithC2(base)
        self.heads = YoloNASPoseNDFLHeads(cfg, self.neck.out_channels)

    def forward(self, x: torch.Tensor) -> YoloNASPoseOutputs:
        return self.heads(self.neck(self.backbone(x)))

    def reset_parameters(self, generator: torch.Generator) -> "YoloNASPose":
        """Seeded random init (:func:`reset_yolo_nas_parameters`; every ``cls_pred``
        channel, person and joints, gets the classification prior, as in JAX)."""
        return reset_yolo_nas_parameters(self, generator)


# ------------------------------------------------------------------- variants


def _pose_heads(width_mult: float, blocks=(2, 2, 3)) -> Tuple[PoseHeadCfg, ...]:
    return (
        PoseHeadCfg(128, 128, blocks[0], width_mult, 8),
        PoseHeadCfg(256, 512, blocks[1], width_mult, 16),
        PoseHeadCfg(512, 512, blocks[2], width_mult, 32),
    )


def yolo_nas_pose_n_config(num_joints: int = 17, fused: bool = False) -> YoloNASPoseConfig:
    """The slim N backbone and neck (``yolo_nas_pose_n_arch_params.yaml``)."""
    base = YoloNASConfig(
        stem_channels=32,
        stages=(
            StageCfg(64, 2, 32, False),
            StageCfg(128, 3, 48, False),
            StageCfg(256, 4, 64, False),
            StageCfg(512, 2, 128, False),
        ),
        spp_channels=512,
        spp_k=(5, 9, 13),
        neck1=UpStageCfg(128, 2, 48, reduce_channels=True),
        neck2=UpStageCfg(64, 2, 32, reduce_channels=True),
        neck3=DownStageCfg(128, 2, 48),
        neck4=DownStageCfg(256, 2, 48),
        heads=(),  # the pose heads are built instead
        num_classes=1,
    )
    return YoloNASPoseConfig(base=base, heads=_pose_heads(0.33), num_joints=num_joints, fused=fused)


def yolo_nas_pose_s_config(num_joints: int = 17, fused: bool = False) -> YoloNASPoseConfig:
    return YoloNASPoseConfig(base=yolo_nas_s_config(1), heads=_pose_heads(0.5), num_joints=num_joints, fused=fused)


def yolo_nas_pose_m_config(num_joints: int = 17, fused: bool = False) -> YoloNASPoseConfig:
    return YoloNASPoseConfig(base=yolo_nas_m_config(1), heads=_pose_heads(0.75), num_joints=num_joints, fused=fused)


def yolo_nas_pose_l_config(num_joints: int = 17, fused: bool = False) -> YoloNASPoseConfig:
    return YoloNASPoseConfig(base=yolo_nas_l_config(1), heads=_pose_heads(1.0), num_joints=num_joints, fused=fused)


def yolo_nas_pose_config_from_arch_params(arch_params: Mapping, num_joints: Optional[int] = None) -> YoloNASPoseConfig:
    """A :class:`YoloNASPoseConfig` from a pose arch_params module-spec tree
    (``recipes/arch_params/yolo_nas_pose_*_arch_params.yaml``: the detector's
    ``NStageBackbone`` / ``YoloNASPANNeckWithC2`` specs, then ``heads:
    {YoloNASPoseNDFLHeads: {heads_list}}``), read as the JAX package reads it."""
    base = yolo_nas_config_from_arch_params({k: v for k, v in arch_params.items() if k != "heads"}, 1)
    hspec = parse_module_spec(arch_params["heads"])[1] if "heads" in arch_params else {}
    nj = num_joints or hspec.get("num_classes") or 17
    heads = []
    for entry in hspec.get("heads_list", []):
        hp = parse_module_spec(entry)[1]
        heads.append(PoseHeadCfg(
            bbox_inter_channels=int(hp["bbox_inter_channels"]),
            pose_inter_channels=int(hp["pose_inter_channels"]),
            pose_regression_blocks=int(hp.get("pose_regression_blocks", 2)),
            width_mult=float(hp.get("width_mult", 1.0)),
            stride=int(hp["stride"]),
        ))
    return YoloNASPoseConfig(
        base=base, heads=tuple(heads) if heads else _pose_heads(1.0), num_joints=int(nj),
        reg_max=int(hspec.get("reg_max", 16)),
        pose_offset_multiplier=float(hspec.get("pose_offset_multiplier", 1.0)),
        compensate_grid_cell_offset=bool(hspec.get("compensate_grid_cell_offset", True)),
    )
