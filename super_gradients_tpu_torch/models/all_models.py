"""Architecture registrations of the port (every row of
``super_gradients_tpu/models/all_models.py`` but DEKR and the pose rescoring nets)."""

from __future__ import annotations

import dataclasses

from super_gradients_tpu_torch.common.registry import register_model
from super_gradients_tpu_torch.inference.processing import (
    default_imagenet_processing,
    default_segmentation_processing,
    default_yolo_nas_coco_processing,
)
from super_gradients_tpu_torch.models.classification import (
    darknet,
    dpn_pnasnet_beit,
    efficientnet,
    misc_models,
    more_models,
    regnet,
    repvgg,
    vit,
)
from super_gradients_tpu_torch.models.classification.mobilenet import MobileNetV1, MobileNetV2, MobileNetV3
from super_gradients_tpu_torch.models.classification.resnet import CifarResNet, ResNet
from super_gradients_tpu_torch.models.class_names import (
    CITYSCAPES_CLASSES_LIST,
    COCO_DETECTION_CLASSES_LIST,
    COCO_POSE_EDGE_LINKS,
    COCO_POSE_KEYPOINTS,
)
from super_gradients_tpu_torch.models.detection.customizable_detector import yolo_nas_config_from_arch_params
from super_gradients_tpu_torch.models.detection.pp_yolo_e import (
    PPYoloE,
    ppyoloe_l_config,
    ppyoloe_m_config,
    ppyoloe_s_config,
    ppyoloe_x_config,
)
from super_gradients_tpu_torch.models.detection.yolo_nas import (
    YoloNAS,
    yolo_nas_l_config,
    yolo_nas_m_config,
    yolo_nas_s_config,
)
from super_gradients_tpu_torch.models.detection.ssd import SSDConfig, SSDLiteMobileNetV2, SSDMobileNetV1, v1_config
from super_gradients_tpu_torch.models.detection.yolox import YoloX, YoloXConfig, yolox_config
from super_gradients_tpu_torch.models.model_factory import ModelSpec
from super_gradients_tpu_torch.models.pose.yolo_nas_pose import (
    YoloNASPose,
    yolo_nas_pose_config_from_arch_params,
    yolo_nas_pose_l_config,
    yolo_nas_pose_m_config,
    yolo_nas_pose_n_config,
    yolo_nas_pose_s_config,
)
from super_gradients_tpu_torch.models.segmentation.ddrnet import (
    DDRNET_23_CFG,
    DDRNET_23_SLIM_CFG,
    DDRNET_39_CFG,
    DDRNet,
    DDRNetCfg,
)
from super_gradients_tpu_torch.models.segmentation.ppliteseg import PP_LITE_B_CFG, PP_LITE_T_CFG, PPLiteSeg
from super_gradients_tpu_torch.models.segmentation.regseg import RegSeg, RegSegCfg
from super_gradients_tpu_torch.models.segmentation.shelfnet_laddernet import (
    LadderNet,
    LadderNetCfg,
    ShelfNet,
    ShelfNetCfg,
)
from super_gradients_tpu_torch.models.segmentation.stdc import (
    STDC1_CFG,
    STDC2_CFG,
    STDCClassification,
    STDCSegCfg,
    STDCSegmentation,
)
from super_gradients_tpu_torch.models.segmentation.unet_segformer import (
    SEGFORMER_B0,
    SEGFORMER_B1,
    SEGFORMER_B2,
    SEGFORMER_B3,
    SEGFORMER_B4,
    SEGFORMER_B5,
    SegFormer,
    UNet,
    UNetCfg,
    UNetClassifier,
)
from super_gradients_tpu_torch.models.sg_model import ClassificationModel, PoseEstimationModel, SegmentationModel


def _resnet_spec(num_blocks, block, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    """An ImageNet ResNet at 224x224 with the ImageNet processing; ``arch_params`` gives
    ``num_classes`` (1000 by default) and ``width_mult``, as in the JAX zoo."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 1000)
    net = ResNet(num_blocks=tuple(num_blocks), num_classes=nc, block=block, width_mult=arch_params.get("width_mult", 1.0))
    return ModelSpec(net=net, num_classes=nc, input_hw=(224, 224), processing=default_imagenet_processing(),
                     model_cls=ClassificationModel)


@register_model("resnet18")
def resnet18(**kw):
    return _resnet_spec([2, 2, 2, 2], "basic", **kw)


@register_model("resnet34")
def resnet34(**kw):
    return _resnet_spec([3, 4, 6, 3], "basic", **kw)


@register_model("resnet50")
def resnet50(**kw):
    return _resnet_spec([3, 4, 6, 3], "bottleneck", **kw)


@register_model("resnet101")
def resnet101(**kw):
    return _resnet_spec([3, 4, 23, 3], "bottleneck", **kw)


@register_model("resnet152")
def resnet152(**kw):
    return _resnet_spec([3, 8, 36, 3], "bottleneck", **kw)


@register_model("resnet18_cifar")
def resnet18_cifar(num_classes=None, arch_params=None, **kw):
    """The CIFAR ResNet-18 at 32x32 (10 classes by default), without processing: as in
    the JAX zoo, it reads neither ``arch_params`` nor a width."""
    nc = num_classes or 10
    return ModelSpec(net=CifarResNet(num_blocks=(2, 2, 2, 2), num_classes=nc, block="basic"), num_classes=nc,
                     input_hw=(32, 32), model_cls=ClassificationModel)


@register_model("custom_resnet")
@register_model("custom_resnet50")
def custom_resnet(num_classes=None, arch_params=None, **kw):
    """A ResNet of ``arch_params`` ``structure`` (ResNet-50's by default) and ``block``
    (``bottleneck``)."""
    ap = arch_params or {}
    return _resnet_spec(tuple(ap.get("structure", (3, 4, 6, 3))), ap.get("block", "bottleneck"), num_classes, ap, **kw)


@register_model("resnet50_3343")
def resnet50_3343(**kw):
    return _resnet_spec([3, 3, 4, 3], "bottleneck", **kw)


@register_model("custom_resnet_cifar")
@register_model("custom_resnet50_cifar")
def custom_resnet_cifar(num_classes=None, arch_params=None, **kw):
    """A CIFAR ResNet of ``arch_params`` ``structure`` and ``block`` (ResNet-18's by default)."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 10)
    net = CifarResNet(num_blocks=tuple(ap.get("structure", (2, 2, 2, 2))), num_classes=nc, block=ap.get("block", "basic"))
    return ModelSpec(net=net, num_classes=nc, input_hw=(32, 32), model_cls=ClassificationModel)


def _cls_spec(net, nc: int, input_hw=(224, 224)) -> ModelSpec:
    """A classifier at ``input_hw`` with the ImageNet processing cropped to it."""
    return ModelSpec(net=net, num_classes=nc, input_hw=input_hw,
                     processing=default_imagenet_processing(crop=input_hw[0]), model_cls=ClassificationModel)


@register_model("mobilenet_v2")
def mobilenet_v2(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(MobileNetV2(num_classes=nc, width_mult=(arch_params or {}).get("width_mult", 1.0)), nc)


@register_model("mobile_net_v2_135")
def mobile_net_v2_135(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(MobileNetV2(num_classes=nc, width_mult=1.35), nc)


@register_model("custom_mobilenet_v2")
def custom_mobilenet_v2(num_classes=None, arch_params=None, **kw):
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    return _cls_spec(MobileNetV2(num_classes=nc, width_mult=ap.get("width_mult", 1.0)), nc)


def _mobilenet_v3(mode: str, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    """MobileNetV3; ``arch_params`` gives ``num_classes`` (1000), ``mode`` and ``width_mult`` (1.0)."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes") or 1000
    return _cls_spec(MobileNetV3(num_classes=nc, mode=ap.get("mode") or mode, width_mult=float(ap.get("width_mult") or 1.0)), nc)


@register_model("mobilenet_v3_large")
def mobilenet_v3_large(**kw):
    return _mobilenet_v3("large", **kw)


@register_model("mobilenet_v3_small")
def mobilenet_v3_small(**kw):
    return _mobilenet_v3("small", **kw)


@register_model("mobilenet_v3_custom")
def mobilenet_v3_custom(num_classes=None, arch_params=None, **kw):
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    return _cls_spec(MobileNetV3(num_classes=nc, width_mult=ap.get("width_mult", 1.0), mode=ap.get("mode", "large")), nc)


@register_model("mobilenet_v1")
def mobilenet_v1(num_classes=None, arch_params=None, **kw):
    """MobileNetV1 at 64x64 (10 classes by default): the original's 2x2 average-pool head is
    sized for it, as the JAX module's ``Dense`` is."""
    nc = num_classes or (arch_params or {}).get("num_classes", 10)
    return _cls_spec(MobileNetV1(num_classes=nc, input_hw=(64, 64)), nc, input_hw=(64, 64))


def _stdc_cls_spec(backbone_cfg, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    """STDC classification at 224 with the ImageNet processing; ``arch_params`` gives
    ``num_classes`` (1000 by default) and ``dropout`` (0.2)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 1000)
    net = STDCClassification(backbone_cfg, num_classes=nc, dropout=arch_params.get("dropout", 0.2))
    return ModelSpec(net=net, num_classes=nc, input_hw=(224, 224), processing=default_imagenet_processing(crop=224),
                     model_cls=ClassificationModel)


@register_model("stdc1_classification")
def stdc1_classification(**kw):
    return _stdc_cls_spec(STDC1_CFG, **kw)


@register_model("stdc2_classification")
@register_model("stdc_custom_cls")
def stdc2_classification(**kw):
    return _stdc_cls_spec(STDC2_CFG, **kw)


_FUSED = {"none": False, "full": True}  # the JAX package's `fused` values that the port builds


def _detection_spec(net, nc: int, cfg, image_size: int) -> ModelSpec:
    """A detector at ``image_size`` with the YOLO-NAS COCO processing (the JAX zoo gives it PP-YOLOE and YOLOX too)."""
    return ModelSpec(
        net=net,
        num_classes=nc,
        input_hw=(image_size, image_size),
        config=cfg,
        processing=default_yolo_nas_coco_processing(image_size),
        class_names=COCO_DETECTION_CLASSES_LIST if nc == 80 else None,
    )


def _yolo_nas_spec(config_fn, num_classes=None, arch_params=None, image_size: int = 640) -> ModelSpec:
    """The variant's config, or the one an arch_params module-spec tree describes
    (``common/config.py::load_arch_params``)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 80)
    fused = _FUSED[arch_params.get("fused", "none")]
    if "backbone" in arch_params:
        cfg = dataclasses.replace(yolo_nas_config_from_arch_params(arch_params, nc), fused=fused)
    else:
        cfg = config_fn(num_classes=nc, fused=fused)
    return _detection_spec(YoloNAS(cfg), nc, cfg, image_size)


@register_model("yolo_nas_s")
def yolo_nas_s(**kw):
    return _yolo_nas_spec(yolo_nas_s_config, **kw)


@register_model("yolo_nas_m")
def yolo_nas_m(**kw):
    return _yolo_nas_spec(yolo_nas_m_config, **kw)


@register_model("yolo_nas_l")
def yolo_nas_l(**kw):
    return _yolo_nas_spec(yolo_nas_l_config, **kw)


def _ppyoloe_spec(config_fn, num_classes=None, arch_params=None, image_size: int = 640) -> ModelSpec:
    """A PP-YOLOE variant; ``arch_params`` ``width_mult`` / ``depth_mult``
    (``recipes/arch_params/ppyoloe_*_arch_params.yaml``) reshape the whole net, ``fused``
    builds it in deploy form."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 80)
    cfg = config_fn(num_classes=nc, fused=_FUSED[arch_params.get("fused", "none")])
    if "width_mult" in arch_params or "depth_mult" in arch_params:
        cfg = dataclasses.replace(cfg, width_mult=float(arch_params.get("width_mult", cfg.width_mult)),
                                  depth_mult=float(arch_params.get("depth_mult", cfg.depth_mult)))
    return _detection_spec(PPYoloE(cfg), nc, cfg, image_size)


@register_model("ppyoloe_s")
def ppyoloe_s(**kw):
    return _ppyoloe_spec(ppyoloe_s_config, **kw)


@register_model("ppyoloe_m")
def ppyoloe_m(**kw):
    return _ppyoloe_spec(ppyoloe_m_config, **kw)


@register_model("ppyoloe_l")
def ppyoloe_l(**kw):
    return _ppyoloe_spec(ppyoloe_l_config, **kw)


@register_model("ppyoloe_x")
def ppyoloe_x(**kw):
    return _ppyoloe_spec(ppyoloe_x_config, **kw)


def _yolox_spec(variant, num_classes=None, arch_params=None, image_size: int = 640) -> ModelSpec:
    """A YOLOX variant; ``arch_params`` ``depth_mult_factor`` / ``width_mult_factor``
    (``recipes/arch_params/yolox_*_arch_params.yaml``) reshape the whole net."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 80)
    cfg = yolox_config(variant, nc)
    if "depth_mult_factor" in ap or "width_mult_factor" in ap:
        cfg = dataclasses.replace(cfg, depth=float(ap.get("depth_mult_factor", cfg.depth)),
                                  width=float(ap.get("width_mult_factor", cfg.width)))
    return _detection_spec(YoloX(cfg), nc, cfg, image_size)


@register_model("yolox_n")
def yolox_n(**kw):
    return _yolox_spec("yolox_n", **kw)


@register_model("yolox_t")
def yolox_t(**kw):
    return _yolox_spec("yolox_t", **kw)


@register_model("yolox_s")
def yolox_s(**kw):
    return _yolox_spec("yolox_s", **kw)


@register_model("yolox_m")
def yolox_m(**kw):
    return _yolox_spec("yolox_m", **kw)


@register_model("yolox_l")
def yolox_l(**kw):
    return _yolox_spec("yolox_l", **kw)


@register_model("custom_yolox")
def custom_yolox(num_classes=None, arch_params=None, image_size: int = 640):
    """YOLOX of any ``depth_mult`` / ``width_mult`` (or ``depth`` / ``width``), 1.0 by default."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 80)
    cfg = YoloXConfig(num_classes=nc, depth=ap.get("depth_mult", ap.get("depth", 1.0)),
                      width=ap.get("width_mult", ap.get("width", 1.0)))
    return _detection_spec(YoloX(cfg), nc, cfg, image_size)


@register_model("yolox_x")
def yolox_x(num_classes=None, arch_params=None, **kw):
    """YOLOX-X (depth 1.33, width 1.25) at 640, whatever ``image_size`` says, as in the JAX zoo."""
    nc = num_classes or (arch_params or {}).get("num_classes", 80)
    cfg = YoloXConfig(num_classes=nc, depth=1.33, width=1.25)
    return _detection_spec(YoloX(cfg), nc, cfg, 640)


def _ssd_anchor_overrides(arch_params) -> dict:
    """``SSDConfig`` fields from the original ``heads.SSDHead`` subtree of an arch_params file
    (its ``anchors`` DefaultBoxes spec and ``num_classes``)."""
    head = ((arch_params or {}).get("heads", {}) or {}).get("SSDHead", {})
    a = head.get("anchors", {})
    out = {}
    if a.get("fig_size"):
        out["fig_size"] = int(a["fig_size"])
    if a.get("feat_size"):
        out["feat_sizes"] = tuple(int(x) for x in a["feat_size"])
    if a.get("scales"):
        out["scales"] = tuple(int(x) for x in a["scales"])
    if a.get("aspect_ratios"):
        out["aspect_ratios"] = tuple(tuple(int(x) for x in ar) for ar in a["aspect_ratios"])
    if a.get("scale_xy"):
        out["scale_xy"] = float(a["scale_xy"])
    if a.get("scale_wh"):
        out["scale_wh"] = float(a["scale_wh"])
    if head.get("num_classes"):
        out["num_classes"] = int(head["num_classes"])
    return out


def _ssd_spec(net_cls, base_cfg: SSDConfig, num_classes=None, arch_params=None, image_size: int = 320) -> ModelSpec:
    over = _ssd_anchor_overrides(arch_params)
    over["num_classes"] = num_classes or (arch_params or {}).get("num_classes") or over.get("num_classes", 80)
    cfg = dataclasses.replace(base_cfg, **over)
    return _detection_spec(net_cls(cfg), cfg.num_classes, cfg, image_size)


@register_model("ssd_lite_mobilenet_v2")
def ssd_lite_mobilenet_v2(image_size: int = 320, **kw):
    return _ssd_spec(SSDLiteMobileNetV2, SSDConfig(fig_size=image_size), image_size=image_size, **kw)


@register_model("ssd_mobilenet_v1")
def ssd_mobilenet_v1(image_size: int = 320, **kw):
    return _ssd_spec(SSDMobileNetV1, v1_config(fig_size=image_size), image_size=image_size, **kw)


def _pose_spec(config_fn, num_classes=None, arch_params=None, image_size: int = 640) -> ModelSpec:
    """A YOLO-NAS-POSE spec: ``num_classes`` is the joint count (17 by default); an
    arch_params module-spec tree (``load_arch_params("yolo_nas_pose_s_arch_params")``)
    reshapes the model. Predict uses the YOLO-NAS COCO processing, as the JAX zoo does."""
    arch_params = arch_params or {}
    fused = _FUSED[arch_params.get("fused", "none")]
    if "backbone" in arch_params:
        cfg = dataclasses.replace(yolo_nas_pose_config_from_arch_params(arch_params, num_joints=num_classes),
                                  fused=fused)
    else:
        cfg = config_fn(num_joints=num_classes or arch_params.get("num_joints", 17), fused=fused)
    nj = cfg.num_joints
    return ModelSpec(
        net=YoloNASPose(cfg),
        num_classes=nj,
        input_hw=(image_size, image_size),
        config=cfg,
        processing=default_yolo_nas_coco_processing(image_size),
        class_names=COCO_POSE_KEYPOINTS if nj == 17 else None,
        model_cls=PoseEstimationModel,
        model_kwargs={"edge_links": COCO_POSE_EDGE_LINKS if nj == 17 else None},
    )


@register_model("yolo_nas_pose_n")
def yolo_nas_pose_n(**kw):
    return _pose_spec(yolo_nas_pose_n_config, **kw)


@register_model("yolo_nas_pose_s")
def yolo_nas_pose_s(**kw):
    return _pose_spec(yolo_nas_pose_s_config, **kw)


@register_model("yolo_nas_pose_m")
def yolo_nas_pose_m(**kw):
    return _pose_spec(yolo_nas_pose_m_config, **kw)


@register_model("yolo_nas_pose_l")
def yolo_nas_pose_l(**kw):
    return _pose_spec(yolo_nas_pose_l_config, **kw)


def _seg_spec(net, nc: int, input_hw, config) -> ModelSpec:
    """A segmentation model at ``input_hw`` (Seg50's 512x1024 by default) with the JAX zoo's
    processing; its BN statistics are calibrated at 128x128, the JAX zoo's ``init_hw``."""
    input_hw = tuple(input_hw)
    return ModelSpec(net=net, num_classes=nc, input_hw=input_hw, config=config,
                     processing=default_segmentation_processing(input_hw),
                     class_names=CITYSCAPES_CLASSES_LIST if nc == 19 else None, model_cls=SegmentationModel,
                     init_hw=(128, 128))


def _stdc_seg(backbone_cfg, num_classes=None, arch_params=None, input_hw=(512, 1024), **kw) -> ModelSpec:
    """STDC segmentation; ``arch_params`` gives ``num_classes`` (19) and ``use_aux_heads``
    (True: the aux and detail heads that ``STDCLoss`` trains)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 19)
    cfg = STDCSegCfg(backbone=backbone_cfg, num_classes=nc, use_aux_heads=arch_params.get("use_aux_heads", True))
    return _seg_spec(STDCSegmentation(cfg), nc, input_hw, cfg)


@register_model("stdc1_seg")
@register_model("stdc1_seg50")
@register_model("stdc1_seg75")
def stdc1_seg(**kw):
    return _stdc_seg(STDC1_CFG, **kw)


@register_model("stdc2_seg")
@register_model("stdc2_seg50")
@register_model("stdc2_seg75")
def stdc2_seg(**kw):
    return _stdc_seg(STDC2_CFG, **kw)


def _ppliteseg(base, num_classes=None, arch_params=None, input_hw=(512, 1024), **kw) -> ModelSpec:
    """PP-LiteSeg; ``arch_params`` gives ``num_classes`` (19) and ``use_aux_heads`` (False)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 19)
    cfg = dataclasses.replace(base, num_classes=nc, use_aux_heads=arch_params.get("use_aux_heads", False))
    return _seg_spec(PPLiteSeg(cfg), nc, input_hw, cfg)


@register_model("stdc_custom")
def stdc_custom(num_classes=None, arch_params=None, input_hw=(512, 1024), **kw):
    """STDC segmentation on the ``arch_params`` ``backbone`` (``stdc1`` or ``stdc2``)."""
    backbone = STDC2_CFG if (arch_params or {}).get("backbone", "stdc1") == "stdc2" else STDC1_CFG
    return _stdc_seg(backbone, num_classes, arch_params, input_hw)


@register_model("pp_lite_t_seg")
@register_model("pp_lite_t_seg50")
@register_model("pp_lite_t_seg75")
def pp_lite_t_seg(**kw):
    return _ppliteseg(PP_LITE_T_CFG, **kw)


@register_model("pp_lite_b_seg")
@register_model("pp_lite_b_seg50")
@register_model("pp_lite_b_seg75")
def pp_lite_b_seg(**kw):
    return _ppliteseg(PP_LITE_B_CFG, **kw)


def _ddrnet(base, num_classes=None, arch_params=None, input_hw=(512, 1024), **kw) -> ModelSpec:
    """DDRNet; ``arch_params`` gives ``num_classes`` (19) and ``use_aux_heads`` (False)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 19)
    cfg = dataclasses.replace(base, num_classes=nc, use_aux_heads=arch_params.get("use_aux_heads", False))
    return _seg_spec(DDRNet(cfg), nc, input_hw, cfg)


@register_model("ddrnet_23")
def ddrnet_23(**kw):
    return _ddrnet(DDRNET_23_CFG, **kw)


@register_model("ddrnet_23_slim")
def ddrnet_23_slim(**kw):
    return _ddrnet(DDRNET_23_SLIM_CFG, **kw)


@register_model("ddrnet_39")
def ddrnet_39(**kw):
    return _ddrnet(DDRNET_39_CFG, **kw)


@register_model("custom_ddrnet_23")
def custom_ddrnet_23(num_classes=None, arch_params=None, input_hw=(512, 1024), **kw):
    """DDRNet-23's depths at the ``arch_params`` widths ``planes`` (64), ``highres_planes`` (128)
    and ``head_planes`` (128)."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 19)
    cfg = DDRNetCfg(num_classes=nc, planes=ap.get("planes", 64), highres_planes=ap.get("highres_planes", 128),
                    head_planes=ap.get("head_planes", 128), use_aux_heads=ap.get("use_aux_heads", False))
    return _seg_spec(DDRNet(cfg), nc, input_hw, cfg)


@register_model("regseg48")
def regseg48(num_classes=None, arch_params=None, input_hw=(512, 1024), **kw):
    """RegSeg48 (it reads no ``arch_params``, as in the JAX zoo)."""
    nc = num_classes or 19
    cfg = RegSegCfg(num_classes=nc)
    return _seg_spec(RegSeg(cfg), nc, input_hw, cfg)


@register_model("unet")
def unet(num_classes=None, arch_params=None, input_hw=(512, 512), **kw):
    """The classic UNet at 512x512 (it reads no ``arch_params``, as in the JAX zoo)."""
    nc = num_classes or 19
    cfg = UNetCfg(num_classes=nc)
    return _seg_spec(UNet(cfg), nc, input_hw, cfg)


@register_model("unet_custom")
def unet_custom(num_classes=None, arch_params=None, input_hw=(512, 512), **kw):
    """A UNet of the ``arch_params`` ``backbone_params`` / ``decoder_params`` (the recipes'
    ``unet_arch_params`` layout), ``final_upsample_factor``, ``head_hidden_channels`` and
    ``dropout``."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 19)
    bp, dp = ap.get("backbone_params", {}), ap.get("decoder_params", {})
    cfg = UNetCfg(
        num_classes=nc,
        strides_list=tuple(bp.get("strides_list", (1, 2, 2, 2, 2))),
        width_list=tuple(bp.get("width_list", ap.get("widths", (64, 128, 256, 512, 512)))),
        num_blocks_list=tuple(bp.get("num_blocks_list", (2, 2, 2, 2, 2))),
        decoder_scale=dp.get("decoder_scale", 0.5),
        skip_expansion=dp.get("skip_expansion", 1.0),
        up_block_repeat_list=tuple(dp.get("up_block_repeat_list", (2, 2, 2, 1))),
        min_decoder_channels=dp.get("min_decoder_channels", 1),
        final_upsample_factor=ap.get("final_upsample_factor", 1),
        head_hidden_channels=ap.get("head_hidden_channels") or 0,
        dropout=ap.get("dropout", 0.0),
    )
    return _seg_spec(UNet(cfg), nc, input_hw, cfg)


@register_model("unet_custom_cls")
def unet_custom_cls(num_classes=None, arch_params=None, **kw):
    """The UNet encoder of the ``arch_params`` ``widths`` (64-1024) as a 224x224 classifier."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    cfg = UNetCfg(num_classes=nc, width_list=tuple(ap.get("widths", (64, 128, 256, 512, 1024))),
                  strides_list=(1, 2, 2, 2, 2))
    return _cls_spec(UNetClassifier(cfg, num_classes=nc), nc)


def _segformer(base, num_classes=None, arch_params=None, input_hw=(512, 1024), **kw) -> ModelSpec:
    """SegFormer (it reads no ``arch_params``, as in the JAX zoo)."""
    nc = num_classes or 19
    cfg = dataclasses.replace(base, num_classes=nc)
    return _seg_spec(SegFormer(cfg), nc, input_hw, cfg)


for _name, _base in (("segformer_b0", SEGFORMER_B0), ("segformer_b1", SEGFORMER_B1), ("segformer_b2", SEGFORMER_B2),
                     ("segformer_b3", SEGFORMER_B3), ("segformer_b4", SEGFORMER_B4), ("segformer_b5", SEGFORMER_B5)):
    register_model(_name)(lambda _base=_base, **kw: _segformer(_base, **kw))


def _shelfnet(variant, num_classes=None, arch_params=None, input_hw=(512, 1024), **kw) -> ModelSpec:
    """ShelfNet (it reads ``arch_params.aux_outputs`` alone, as in the JAX zoo: every head's
    output in eval mode too)."""
    nc = num_classes or 19
    cfg = ShelfNetCfg(num_classes=nc, variant=variant, aux_outputs=bool((arch_params or {}).get("aux_outputs", False)))
    return _seg_spec(ShelfNet(cfg), nc, input_hw, cfg)


for _name, _variant in (("shelfnet18_lw", "18_lw"), ("shelfnet34_lw", "34_lw"), ("shelfnet50", "50"),
                        ("shelfnet50_3343", "50_3343"), ("shelfnet101", "101")):
    register_model(_name)(lambda _variant=_variant, **kw: _shelfnet(_variant, **kw))


@register_model("laddernet_50")
def laddernet_50(num_classes=None, arch_params=None, input_hw=(512, 1024), **kw):
    """LadderNet on a BasicBlock 2-2-2-2 trunk, as the JAX zoo builds it (it reads no
    ``arch_params``)."""
    nc = num_classes or 19
    cfg = LadderNetCfg(num_classes=nc)
    return _seg_spec(LadderNet(cfg), nc, input_hw, cfg)


# ------------------------------------------------------------------ the rest of the classification zoo
# Each registration reads the arch_params the JAX zoo's does, and no others (ROADMAP.md section 3 lists
# where that departs from the original).


def _efficientnet(variant, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    """EfficientNet at its published coefficients, which the ``arch_params`` ``width_coefficient``,
    ``depth_coefficient``, ``dropout_rate`` and ``image_size`` override where they are set."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes") or 1000
    w, d, res, drop = efficientnet.EFFICIENTNET_PARAMS[variant]
    w = float(ap.get("width_coefficient") or w)
    d = float(ap.get("depth_coefficient") or d)
    drop = float(ap.get("dropout_rate") or drop)
    res = int(ap.get("image_size") or res)
    return _cls_spec(efficientnet.EfficientNet(num_classes=nc, width_coeff=w, depth_coeff=d, dropout=drop), nc,
                     (res, res))


for _variant in efficientnet.EFFICIENTNET_PARAMS:
    register_model(f"efficientnet_{_variant}")(lambda _variant=_variant, **kw: _efficientnet(_variant, **kw))


@register_model("CustomizedEfficientnet")
def customized_efficientnet(num_classes=None, arch_params=None, **kw):
    """EfficientNet of the ``arch_params`` coefficients at the ``res`` size (not ``image_size``,
    as in the JAX zoo)."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    net = efficientnet.EfficientNet(num_classes=nc, width_coeff=ap.get("width_coefficient", 1.0),
                                    depth_coeff=ap.get("depth_coefficient", 1.0), dropout=ap.get("dropout_rate", 0.2))
    return _cls_spec(net, nc, (ap.get("res", 224), ap.get("res", 224)))


def _regnety(variant, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    nc = num_classes or 1000
    iw, slope, q, depth, gw, se = regnet.REGNETY_PARAMS[variant]
    return _cls_spec(regnet.RegNetY(num_classes=nc, initial_width=iw, slope=slope, quantized_param=q, depth=depth,
                                    group_width=gw, se_ratio=se), nc)


for _variant in regnet.REGNETY_PARAMS:
    register_model(_variant)(lambda _variant=_variant, **kw: _regnety(_variant, **kw))


@register_model("custom_regnet")
@register_model("custom_anynet")
@register_model("nas_regnet")
def custom_regnet(num_classes=None, arch_params=None, **kw):
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    net = regnet.RegNetY(num_classes=nc, initial_width=ap.get("initial_width", 24), slope=ap.get("slope", 36.44),
                         quantized_param=ap.get("quantized_param", 2.49),
                         depth=ap.get("network_depth", ap.get("depth", 13)), group_width=ap.get("group_width", 8),
                         se_ratio=ap.get("se_ratio", 0.25))
    return _cls_spec(net, nc)


def _repvgg(variant, num_classes=None, arch_params=None, **kw) -> ModelSpec:
    """RepVGG; the ``arch_params`` ``struct`` (blocks a stage), ``width_multiplier`` (its first and
    last entries) and ``use_se`` (a squeeze-excitation of ratio 0.25) reshape it."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes") or 1000
    cfg = dataclasses.replace(repvgg.REPVGG_VARIANTS[variant], num_classes=nc)
    if ap.get("struct"):
        cfg = dataclasses.replace(cfg, blocks_per_stage=tuple(ap["struct"]))
    if ap.get("width_multiplier"):
        wm = list(ap["width_multiplier"])
        cfg = dataclasses.replace(cfg, width_a=float(wm[0]), width_b=float(wm[-1]))
    if ap.get("use_se"):
        cfg = dataclasses.replace(cfg, se_ratio=0.25)
    return _cls_spec(repvgg.RepVGG(cfg), nc)


for _variant in repvgg.REPVGG_VARIANTS:
    register_model(_variant)(lambda _variant=_variant, **kw: _repvgg(_variant, **kw))


@register_model("repvgg_custom")
def repvgg_custom(num_classes=None, arch_params=None, **kw):
    """RepVGG of the ``arch_params`` ``struct`` and ``width_multiplier`` (or ``width_a`` / ``width_b``);
    it reads no ``use_se``, as in the JAX zoo."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    wm = ap.get("width_multiplier", [0.75, 2.5])
    cfg = repvgg.RepVGGCfg(num_classes=nc, blocks_per_stage=tuple(ap.get("struct", (2, 4, 14, 1))),
                           width_a=wm[0] if "width_multiplier" in ap else ap.get("width_a", 0.75),
                           width_b=wm[-1] if "width_multiplier" in ap else ap.get("width_b", 2.5))
    return _cls_spec(repvgg.RepVGG(cfg), nc)


@register_model("vit_base")
def vit_base(num_classes=None, arch_params=None, **kw):
    """ViT-Base/16; ``arch_params`` ``patch_size`` and ``image_size`` reshape it (the position
    embedding has a row a patch of ``image_size``)."""
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes") or 1000
    patch = ap.get("patch_size") or 16
    patch = int(patch[0] if isinstance(patch, (list, tuple)) else patch)
    im = ap.get("image_size")
    hw = (int(im[0]), int(im[1])) if isinstance(im, (list, tuple)) else ((int(im), int(im)) if im else (224, 224))
    return _cls_spec(vit.ViT(num_classes=nc, image_size=hw, patch_size=patch, dim=768, depth=12, heads=12), nc, hw)


@register_model("vit_large")
def vit_large(num_classes=None, arch_params=None, **kw):
    """ViT-Large/16 at 224; it reads neither ``patch_size`` nor ``image_size``, as in the JAX zoo."""
    nc = num_classes or (arch_params or {}).get("num_classes") or 1000
    return _cls_spec(vit.ViT(num_classes=nc, dim=1024, depth=24, heads=16), nc)


@register_model("vit_huge")
def vit_huge(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(vit.ViT(num_classes=nc, dim=1280, depth=32, heads=16), nc)


@register_model("beit_base_patch16_224")
def beit_base(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(dpn_pnasnet_beit.BEiT(num_classes=nc), nc)


@register_model("beit_large_patch16_224")
def beit_large(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(dpn_pnasnet_beit.BEiT(num_classes=nc, dim=1024, depth=24, heads=16), nc)


@register_model("dpn26")
def dpn26(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(dpn_pnasnet_beit.DPN(num_classes=nc, **dpn_pnasnet_beit.DPN26), nc, (32, 32))


@register_model("dpn92")
def dpn92(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(dpn_pnasnet_beit.DPN(num_classes=nc, **dpn_pnasnet_beit.DPN92), nc, (32, 32))


@register_model("pnasnet")
def pnasnet(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(dpn_pnasnet_beit.PNASNet(num_classes=nc), nc, (32, 32))


@register_model("vgg16")
def vgg16(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(misc_models.VGG(misc_models.VGG_CFGS["vgg16"], num_classes=nc), nc, (32, 32))


@register_model("vgg19_bn")
def vgg19_bn(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(misc_models.VGG(misc_models.VGG_CFGS["vgg19"], num_classes=nc), nc, (32, 32))


@register_model("lenet")
def lenet(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(misc_models.LeNet(num_classes=nc), nc, (32, 32))


SHUFFLENET_WIDTHS = {"shufflenet_v2_x0_5": (48, 96, 192), "shufflenet_v2_x1_0": (116, 232, 464),
                     "shufflenet_v2_x1_5": (176, 352, 704), "shufflenet_v2_x2_0": (244, 488, 976)}

for _name, _widths in SHUFFLENET_WIDTHS.items():
    register_model(_name)(lambda _widths=_widths, num_classes=None, **kw: _cls_spec(
        misc_models.ShuffleNetV2(num_classes=num_classes or 1000, stage_channels=_widths), num_classes or 1000))


@register_model("shufflenet_v2_custom5")
def shufflenet_v2_custom5(num_classes=None, arch_params=None, **kw):
    ap = arch_params or {}
    nc = num_classes or ap.get("num_classes", 1000)
    return _cls_spec(misc_models.ShuffleNetV2(num_classes=nc, stage_channels=tuple(ap.get("channels", (48, 96, 192)))),
                     nc)


def _densenet(growth, blocks, init_features, num_classes=None) -> ModelSpec:
    nc = num_classes or 1000
    return _cls_spec(misc_models.DenseNet(num_classes=nc, growth_rate=growth, block_config=tuple(blocks),
                                          init_features=init_features), nc)


for _name, (_growth, _blocks, _init) in {"densenet121": (32, (6, 12, 24, 16), 64),
                                         "densenet161": (48, (6, 12, 36, 24), 96),
                                         "densenet169": (32, (6, 12, 32, 32), 64),
                                         "densenet201": (32, (6, 12, 48, 32), 64)}.items():
    register_model(_name)(lambda _g=_growth, _b=_blocks, _i=_init, num_classes=None, **kw: _densenet(
        _g, _b, _i, num_classes))


@register_model("custom_densenet")
def custom_densenet(num_classes=None, arch_params=None, **kw):
    ap = arch_params or {}
    return _densenet(ap.get("growth_rate", 32), tuple(ap.get("structure", (6, 12, 24, 16))),
                     ap.get("num_init_features", 64), num_classes or ap.get("num_classes"))


@register_model("resnext50")
def resnext50(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(misc_models.ResNeXt(num_classes=nc), nc)


@register_model("resnext101")
def resnext101(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(misc_models.ResNeXt(num_classes=nc, num_blocks=(3, 4, 23, 3)), nc)


@register_model("preact_resnet18")
def preact_resnet18(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(more_models.PreActResNet(num_classes=nc), nc, (32, 32))


@register_model("googlenet_v1")
def googlenet_v1(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(more_models.GoogLeNet(num_classes=nc), nc)


@register_model("senet18")
def senet18(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 10
    return _cls_spec(more_models.SENetCifar(num_classes=nc), nc, (32, 32))


@register_model("darknet53")
def darknet53(num_classes=None, arch_params=None, **kw):
    nc = num_classes or 1000
    return _cls_spec(darknet.Darknet53(num_classes=nc), nc)


@register_model("csp_darknet53")
def csp_darknet53(num_classes=None, arch_params=None, **kw):
    """The classifier on the YOLOX CSPDarknet trunk, as in the JAX zoo."""
    nc = num_classes or 1000
    return _cls_spec(darknet.CSPDarknet53(num_classes=nc), nc)


@register_model("kd_module")
def kd_module(num_classes=None, arch_params=None, **kw):
    """The knowledge-distillation composite (``training/losses/kd_losses.py::KDModule``):
    ``arch_params`` names the ``student`` and the ``teacher`` (or ``student_architecture`` /
    ``teacher_architecture``), registered names or built networks, with their
    ``<name>_arch_params`` or ``student_arch_params`` / ``teacher_arch_params``. As in the JAX
    zoo, a name equal to the student's takes the student's arch_params, and the composite is a
    1000-class classification model at 224 unless ``num_classes`` says otherwise."""
    from super_gradients_tpu_torch.models.model_factory import get_architecture
    from super_gradients_tpu_torch.training.losses.kd_losses import KDModule

    ap = dict(arch_params or {})
    ap.setdefault("student", ap.get("student_architecture"))
    ap.setdefault("teacher", ap.get("teacher_architecture"))
    if not ap.get("student") or not ap.get("teacher"):
        raise ValueError("kd_module requires arch_params with `student`/`teacher` "
                         "(or student_architecture/teacher_architecture)")

    def resolve(entry):
        if isinstance(entry, str):
            params = ap.get(f"{entry}_arch_params") or ap.get(
                "student_arch_params" if entry == ap["student"] else "teacher_arch_params")
            return get_architecture(entry)(num_classes=num_classes, arch_params=params or {}).net
        return entry

    student, teacher = resolve(ap["student"]), resolve(ap["teacher"])
    nc = num_classes or ap.get("num_classes", 1000)
    return ModelSpec(net=KDModule(student, teacher), num_classes=nc, input_hw=(224, 224),
                     model_cls=ClassificationModel)
