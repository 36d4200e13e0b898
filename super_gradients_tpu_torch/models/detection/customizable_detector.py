"""Detectors composed from registered module names (counterpart of
``super_gradients_tpu/models/detection/customizable_detector.py``).

A recipe's arch_params name each part with its parameters::

    backbone: {NStageBackbone: {stem_channels: 48, stages: [...], ...}}
    neck:     {YoloNASPANNeckWithC2: {neck1: {...}, ..., neck4: {...}}}
    heads:    {NDFLHeads: {num_classes: 80, heads: [...]}}

Each entry of :data:`DETECTION_MODULES` is a builder ``(params, in_channels) -> nn.Module``:
PyTorch modules need their input widths, which each part takes from the ``out_channels``
of the part before it (the JAX builders take ``params`` alone, flax infers the widths).
Backbones return a list of feature maps, necks map it to another, heads to the outputs.
Unknown names raise ``KeyError`` listing the registered ones, as in JAX.

:func:`yolo_nas_config_from_arch_params` reads the YOLO-NAS arch_params trees
(``recipes/arch_params/yolo_nas_*_arch_params.yaml``) into a :class:`YoloNASConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from super_gradients_tpu_torch.common.registry import create_register_decorator
from super_gradients_tpu_torch.models.detection.yolo_nas import (
    DownStageCfg,
    HeadCfg,
    NDFLHeads,
    NStageBackbone,
    StageCfg,
    UpStageCfg,
    YoloNASConfig,
    YoloNASPANNeckWithC2,
    reset_yolo_nas_parameters,
    yolo_nas_s_config,
)

DETECTION_MODULES: Dict[str, Callable[[Dict, Optional[Tuple[int, ...]]], nn.Module]] = {}
register_detection_module = create_register_decorator(DETECTION_MODULES)

Spec = Union[str, Tuple[str, Mapping], Mapping]


def parse_module_spec(spec: Spec) -> Tuple[str, Dict[str, Any]]:
    """Accept ``"Name"``, ``("Name", params)`` or ``{"Name": params}`` (YAML form)."""
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, tuple) and len(spec) == 2:
        return spec[0], dict(spec[1] or {})
    if isinstance(spec, Mapping):
        if len(spec) != 1:
            raise ValueError(f"module spec must have exactly one top-level key, got {list(spec)}")
        name, params = next(iter(spec.items()))
        return name, dict(params or {})
    raise TypeError(f"bad module spec: {spec!r}")


def build_detection_module(spec: Spec, in_channels: Optional[Sequence[int]] = None, **extra) -> nn.Module:
    """Resolve a registered detection-module builder by name and build it for ``in_channels``."""
    name, params = parse_module_spec(spec)
    if name not in DETECTION_MODULES:
        raise KeyError(f"unknown detection module `{name}`; registered: {sorted(DETECTION_MODULES)}")
    params.update(extra)
    return DETECTION_MODULES[name](params, tuple(in_channels) if in_channels is not None else None)


class CustomizableDetector(nn.Module):
    """backbone -> neck -> heads, each resolved by registered name."""

    def __init__(self, backbone: Spec, heads: Spec, neck: Optional[Spec] = None, num_classes: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.backbone = build_detection_module(backbone, (in_channels,))
        channels = self.backbone.out_channels
        self.neck = build_detection_module(neck, channels) if neck is not None else None
        if self.neck is not None:
            channels = self.neck.out_channels
        extra = {"num_classes": num_classes} if num_classes is not None else {}
        self.heads = build_detection_module(heads, channels, **extra)

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x)
        if self.neck is not None:
            feats = self.neck(feats)
        return self.heads(feats)

    def reset_parameters(self, generator: torch.Generator) -> "CustomizableDetector":
        """Seeded random init of the YOLO-NAS family (:func:`reset_yolo_nas_parameters`)."""
        return reset_yolo_nas_parameters(self, generator)


def _params(spec) -> Dict:
    return parse_module_spec(spec)[1]


def yolo_nas_config_from_arch_params(arch_params: Mapping, num_classes: Optional[int] = None) -> YoloNASConfig:
    """A :class:`YoloNASConfig` from an arch_params module-spec tree
    (``recipes/arch_params/yolo_nas_*_arch_params.yaml``: ``backbone: {NStageBackbone:
    {stem, stages, context_module}}``, ``neck: {YoloNASPANNeckWithC2: {neck1..4}}``,
    ``heads: {NDFLHeads: {heads_list}}``), read as the JAX package reads it. ``heads`` may
    be absent (the pose config parses its own heads)."""
    bb = _params(arch_params["backbone"])
    stem = _params(bb["stem"])
    spp = _params(bb["context_module"])
    neck = _params(arch_params["neck"])
    heads = _params(arch_params["heads"]) if "heads" in arch_params else {}

    def stage(p):
        return StageCfg(out_channels=p["out_channels"], num_blocks=p["num_blocks"], hidden_channels=p["hidden_channels"],
                        concat_intermediates=bool(p.get("concat_intermediates", False)),
                        act=p.get("activation_type", "relu"))

    def up(p):
        return UpStageCfg(out_channels=p["out_channels"], num_blocks=p["num_blocks"], hidden_channels=p["hidden_channels"],
                          width_mult=float(p.get("width_mult", 1.0)), depth_mult=float(p.get("depth_mult", 1.0)),
                          reduce_channels=bool(p.get("reduce_channels", True)), act=p.get("activation_type", "relu"))

    def down(p):
        return DownStageCfg(out_channels=p["out_channels"], num_blocks=p["num_blocks"],
                            hidden_channels=p["hidden_channels"], width_mult=float(p.get("width_mult", 1.0)),
                            depth_mult=float(p.get("depth_mult", 1.0)), act=p.get("activation_type", "relu"))

    def head(p):
        return HeadCfg(inter_channels=p["inter_channels"], width_mult=float(p["width_mult"]), stride=p["stride"],
                       first_conv_group_size=int(p.get("first_conv_group_size", 0)))

    return YoloNASConfig(
        stem_channels=stem["out_channels"],
        stages=tuple(stage(_params(s)) for s in bb["stages"]),
        spp_channels=spp["output_channels"],
        spp_k=tuple(spp.get("k", (5, 9, 13))),
        neck1=up(_params(neck["neck1"])), neck2=up(_params(neck["neck2"])),
        neck3=down(_params(neck["neck3"])), neck4=down(_params(neck["neck4"])),
        heads=tuple(head(_params(h)) for h in heads.get("heads_list", [])),
        num_classes=num_classes or heads.get("num_classes") or 80,
        reg_max=int(heads.get("reg_max", 16)),
        in_channels=int(arch_params.get("in_channels", 3)),
        bn_eps=float(arch_params.get("bn_eps", 1e-3)),
        bn_momentum=float(arch_params.get("bn_momentum", 0.03)),
    )


# ------------------------------------------------------------------- builders
# The JAX builders' parameter names, with the S config's values where a part is built
# alone; the input widths come from the part before.

def _fused(value) -> bool:
    return value not in (False, None, "none")


def _with_inputs(cfg: YoloNASConfig, in_channels: Optional[Tuple[int, ...]]) -> YoloNASConfig:
    """``cfg`` whose stage and SPP widths are the backbone outputs ``(c2, c3, c4, c5)`` a neck receives."""
    if in_channels is None:
        return cfg
    stages = tuple(dataclasses.replace(s, out_channels=c) for s, c in zip(cfg.stages, in_channels[:3]))
    return dataclasses.replace(cfg, stages=stages + cfg.stages[3:], spp_channels=in_channels[3])


@register_detection_module("NStageBackbone")
def _build_nstage_backbone(params: Mapping, in_channels=None) -> nn.Module:
    base = yolo_nas_s_config()
    cfg = dataclasses.replace(
        base,
        in_channels=in_channels[0] if in_channels else base.in_channels,
        stem_channels=params.get("stem_channels", base.stem_channels),
        stages=tuple(StageCfg(**dict(s)) for s in params["stages"]) if "stages" in params else base.stages,
        spp_channels=params.get("spp_channels", base.spp_channels),
        spp_k=tuple(params.get("spp_k", base.spp_k)),
        bn_eps=params.get("bn_eps", base.bn_eps),
        fused=_fused(params.get("fused", "none")),
    )
    return NStageBackbone(cfg)


@register_detection_module("YoloNASPANNeckWithC2")
def _build_yolo_nas_neck(params: Mapping, in_channels=None) -> nn.Module:
    base = yolo_nas_s_config()
    cfg = dataclasses.replace(
        _with_inputs(base, in_channels),
        neck1=UpStageCfg(**params["neck1"]) if "neck1" in params else base.neck1,
        neck2=UpStageCfg(**params["neck2"]) if "neck2" in params else base.neck2,
        neck3=DownStageCfg(**params["neck3"]) if "neck3" in params else base.neck3,
        neck4=DownStageCfg(**params["neck4"]) if "neck4" in params else base.neck4,
        bn_eps=params.get("bn_eps", base.bn_eps),
        fused=_fused(params.get("fused", "none")),
    )
    return YoloNASPANNeckWithC2(cfg)


@register_detection_module("NDFLHeads")
def _build_ndfl_heads(params: Mapping, in_channels=None) -> nn.Module:
    base = yolo_nas_s_config()
    cfg = dataclasses.replace(
        base,
        heads=tuple(HeadCfg(**h) for h in params["heads"]) if "heads" in params else base.heads,
        num_classes=params.get("num_classes", base.num_classes),
        reg_max=params.get("reg_max", base.reg_max),
        bn_eps=params.get("bn_eps", base.bn_eps),
    )
    return NDFLHeads(cfg, in_channels or YoloNASPANNeckWithC2(base).out_channels)


def _tuplify(params: Mapping) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in params.items()}


@register_detection_module("CSPResNetBackbone")
def _build_cspresnet_backbone(params: Mapping, in_channels=None) -> nn.Module:
    from super_gradients_tpu_torch.models.detection.pp_yolo_e import CSPResNetBackbone

    p = _tuplify(params)
    p["fused"] = _fused(p.get("fused", "none"))
    return CSPResNetBackbone(in_channels=in_channels[0] if in_channels else 3, **p)


@register_detection_module("PPYoloECSPPAN")
def _build_ppyoloe_pan(params: Mapping, in_channels=None) -> nn.Module:
    from super_gradients_tpu_torch.models.detection.pp_yolo_e import PPYoloECSPPAN

    p = _tuplify(params)
    p["fused"] = _fused(p.get("fused", "none"))
    given = p.pop("in_channels", (256, 512, 1024))
    return PPYoloECSPPAN(in_channels or given, **p)
