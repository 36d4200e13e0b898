"""ShelfNet (LW and HW) and LadderNet, NCHW (counterpart of
``super_gradients_tpu/models/segmentation/shelfnet_laddernet.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py::SHELFNET_RULES`` carries the JAX parameters across and the JAX
package's ``shelfnet_key_mapper`` reads the port's ``state_dict``: the ResNet trunk under
``backbone`` (``conv1`` / ``bn1`` stem, ``layer1``-``layer4``), the channel reducers
``conv_out_list``, the shelf's ``decoder`` and ``ladder`` (``bottom``, ``inconv``,
``down_module_list``, ``down_conv_list``, ``up_conv_list``, ``up_dense_list``), the LW heads
``net_output_list``, and the HW heads ``final``, ``se_layer`` and ``aux_head.fcn``.

As in the JAX modules:

- a ``ShelfBlock`` applies its one ``conv1`` twice, each time followed by its own BN
  (``bn1``, then ``bn2``), so the kernel's gradient sums both uses; ``conv0`` and a ReLU
  come first only where the channels change. In train mode it drops whole channels at
  0.25 between the two uses, and the HW FCN aux head at 0.1, from explicit generators
  (:class:`~super_gradients_tpu_torch.models.segmentation.stdc.SeededChannelDropout`);
- the HW shelf upsamples with ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``, the LW
  shelf with an attention refinement module, then ``nearest`` by 2; the heads upsample with
  the align-corners bilinear grid by the input's stride, LadderNet with the half-pixel grid;
- the stem's max pool pads with ``-inf``; inputs are multiples of 32;
- LW returns its three maps (strides 8, 16, 32, each at the input size) in train mode or
  with ``aux_outputs``, else the first; HW returns ``(main, se [B, C], aux)`` likewise, ``se``
  from the spatial max of the ladder's bottom map, ``aux`` from the trunk's stride-16 map.
  In eval mode without ``aux_outputs`` the other heads are not computed.

The original ``DecoderBase.inconv`` conv is in an original checkpoint but no forward calls
it, and the JAX package has no counterpart: a decoder drops its ``inconv.*`` entries when a
``state_dict`` is loaded, and has no such parameter.

``laddernet_50`` builds a BasicBlock 2-2-2-2 trunk, as the JAX ``LadderNet`` does (its
``_ResNetFeatures(widths)`` keeps the default blocks; ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.resnet import BasicResNetBlock, BottleneckBlock
from super_gradients_tpu_torch.models.segmentation.stdc import (
    SeededChannelDropout,
    reset_segmentation_parameters,
    resize_to,
    upsample,
)
from super_gradients_tpu_torch.modules.blocks import ConvBNAct

SHELF_DROPOUT = 0.25  # a ShelfBlock's channel dropout
FCN_DROPOUT = 0.1  # the HW FCN aux head's channel dropout


class ShelfBlock(nn.Module):
    """``[conv0, relu,] conv1, bn1, relu, channel dropout, conv1 (the same kernel), bn2``, plus
    the block's input, then a ReLU."""

    def __init__(self, in_planes: int, planes: int, dropout: float = SHELF_DROPOUT, seed: int = 0):
        super().__init__()
        if in_planes != planes:
            self.conv0 = nn.Conv2d(in_planes, planes, 3, padding=1)
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(planes, momentum=0.1)
        self.dropout = SeededChannelDropout(dropout, seed)
        self.bn2 = nn.BatchNorm2d(planes, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv0"):
            x = F.relu(self.conv0(x))
        y = self.dropout(F.relu(self.bn1(self.conv1(x))))
        return F.relu(self.bn2(self.conv1(y)) + x)


class AttentionRefinementModule(nn.Module):
    """ShelfNet's own ARM: a 3x3 conv-BN-ReLU, scaled by the sigmoid of a 1x1 conv and BN of
    its global mean."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvBNAct(in_channels, out_channels, 3)
        self.conv_atten = nn.Conv2d(out_channels, out_channels, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_channels, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True))))


def conv_transpose_3x3s2(in_channels: int, out_channels: int) -> nn.ConvTranspose2d:
    """Doubles H and W: the JAX zero-dilated conv with the flipped kernel and padding
    ``((1, 2), (1, 2))``; its ``[3, 3, in, out]`` kernel is this weight ``[in, out, 3, 3]``
    with no flip."""
    return nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1, output_padding=1)


class ShelfResNetBackBone(nn.Module):
    """The ResNet trunk (7x7 stride-2 stem, ``-inf``-padded max pool) returning its four stage
    maps at strides 4, 8, 16 and 32."""

    def __init__(self, blocks: Sequence[int] = (2, 2, 2, 2), block: str = "basic",
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        cls, expansion = (BasicResNetBlock, 1) if block == "basic" else (BottleneckBlock, 4)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, momentum=0.1)
        cin = 64
        self.out_channels: List[int] = []
        for li, (w, n) in enumerate(zip(widths, blocks)):
            layer = []
            for bi in range(n):
                layer.append(cls(cin, w, stride=2 if (bi == 0 and li > 0) else 1, expansion=expansion))
                cin = w * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            self.out_channels.append(cin)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


class NetOutput(nn.Module):
    """A LW head: a 3x3 conv-BN-ReLU, then a 3x3 conv without bias to the classes."""

    def __init__(self, in_channels: int, mid_channels: int, num_classes: int):
        super().__init__()
        self.conv = ConvBNAct(in_channels, mid_channels, 3)
        self.conv_out = nn.Conv2d(mid_channels, num_classes, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class _Shelf(nn.Module):
    """The layout both shelf columns share: ``bottom`` (a ShelfBlock at ``planes * 2 **
    (layers - 1)``), then ``layers - 1`` up steps (``up_conv_list`` / ``up_dense_list``) of
    widths ``planes * 2 ** max(0, layers - j - 2)``."""

    def __init__(self, planes: int, layers: int, lw: bool, seeds):
        super().__init__()
        self.layers, self.lw = layers, lw
        top = planes * 2 ** (layers - 1)
        self.bottom = ShelfBlock(top, top, seed=next(seeds))
        self.up_conv_list, self.up_dense_list = nn.ModuleList(), nn.ModuleList()
        cin = top
        for j in range(layers - 1):
            w = planes * 2 ** max(0, layers - j - 2)
            if lw:
                self.up_conv_list.append(AttentionRefinementModule(cin, w))
                self.up_dense_list.append(ConvBNAct(w, w, 3))
            else:
                self.up_conv_list.append(conv_transpose_3x3s2(cin, w))
                self.up_dense_list.append(ShelfBlock(w, w, seed=next(seeds)))
            cin = w

    def up(self, out: torch.Tensor, skips: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The bottom block on ``out``, then each up step adding ``skips[layers - j - 2]``;
        returns every level's map, the bottom first."""
        out = self.bottom(out)
        ups = [out]
        for j in range(self.layers - 1):
            out = self.up_conv_list[j](out)
            if self.lw:
                out = upsample(out, 2, "nearest")
            out = self.up_dense_list[j](out + skips[self.layers - j - 2])
            ups.append(out)
        return ups


class Decoder(_Shelf):
    """The first shelf column (``DecoderLW`` / ``DecoderHW``): the bottom block on the deepest
    map, then the up steps over the shallower ones."""

    def __init__(self, planes: int, layers: int, lw: bool, seeds):
        super().__init__(planes, layers, lw, seeds)
        self._register_load_state_dict_pre_hook(self._drop_unused_inconv)

    @staticmethod
    def _drop_unused_inconv(state_dict, prefix, *args):
        """An original checkpoint's ``DecoderBase.inconv``, which no forward calls, is left out."""
        for key in [k for k in state_dict if k.startswith(prefix + "inconv.")]:
            del state_dict[key]

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.up(feats[-1], feats)


class LadderBlock(_Shelf):
    """The second shelf column (``LadderBlockLW`` / ``LadderBlockHW``): ``inconv`` on the
    decoder's shallowest map, a down branch (``down_module_list`` ShelfBlocks, each output
    kept, then a strided 3x3 ``down_conv_list`` conv and a ReLU) adding the decoder's maps,
    then the bottom block and the up steps adding the down branch's maps."""

    def __init__(self, planes: int, layers: int, lw: bool, seeds):
        super().__init__(planes, layers, lw, seeds)
        self.inconv = ShelfBlock(planes, planes, seed=next(seeds))
        self.down_module_list, self.down_conv_list = nn.ModuleList(), nn.ModuleList()
        for i in range(layers - 1):
            w = planes * 2 ** i
            self.down_module_list.append(ShelfBlock(w, w, seed=next(seeds)))
            self.down_conv_list.append(nn.Conv2d(w, w * 2, 3, stride=2, padding=1))

    def forward(self, x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = self.inconv(x[-1])
        down_out = []
        for i in range(self.layers - 1):
            out = self.down_module_list[i](out + x[-i - 1])
            down_out.append(out)
            out = F.relu(self.down_conv_list[i](out))
        return self.up(out, down_out)


class FCNHead(nn.Module):
    """``fcn = Sequential(conv 3x3 to in / 4, BN, ReLU, channel dropout, conv 1x1)``."""

    def __init__(self, in_channels: int, num_classes: int, seed: int):
        super().__init__()
        inter = in_channels // 4
        self.fcn = nn.Sequential(nn.Conv2d(in_channels, inter, 3, padding=1, bias=False),
                                 nn.BatchNorm2d(inter, momentum=0.1), nn.ReLU(),
                                 SeededChannelDropout(FCN_DROPOUT, seed), nn.Conv2d(inter, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fcn(x)


@dataclasses.dataclass(frozen=True)
class ShelfNetCfg:
    num_classes: int = 19
    variant: str = "18_lw"  # 18_lw | 34_lw | 50 | 50_3343 | 101
    aux_outputs: bool = False  # every head's output in eval mode too

    @property
    def is_lw(self) -> bool:
        return self.variant.endswith("_lw")


BACKBONES = {
    "18_lw": ("basic", (2, 2, 2, 2)),
    "34_lw": ("basic", (3, 4, 6, 3)),
    "50": ("bottleneck", (3, 4, 6, 3)),
    "50_3343": ("bottleneck", (3, 3, 4, 3)),
    "101": ("bottleneck", (3, 4, 23, 3)),
}


def _init_transposed(net: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal transposed kernels over their ``3 * 3 * in`` fan-in (the JAX
    initializer's), zero biases."""
    for module in net.modules():
        if isinstance(module, nn.ConvTranspose2d):
            fan_in = module.weight.shape[0] * module.weight[0, 0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(1.0 / fan_in))
            module.bias.zero_()


class ShelfNet(nn.Module):
    """The five registered ShelfNets: LW (ResNet-18 / 34, three levels at strides 8-32, ARM
    up steps, three ``NetOutput`` heads) and HW (ResNet-50 / 101 bottlenecks, four levels at
    strides 4-32 reduced to 64-512, transposed-conv up steps, the ``final`` head, the SE
    encoding and the FCN aux head)."""

    def __init__(self, cfg: ShelfNetCfg):
        super().__init__()
        self.cfg = cfg
        nc = cfg.num_classes
        block, blocks = BACKBONES[cfg.variant]
        self.backbone = ShelfResNetBackBone(blocks, block)
        seeds = itertools.count()
        if cfg.is_lw:
            planes = 64 if cfg.variant == "18_lw" else 128
            chans = self.backbone.out_channels[1:]
            if cfg.variant == "18_lw":  # 1x1 reducers; ResNet-34's widths are the shelf's already
                self.conv_out_list = nn.ModuleList([ConvBNAct(c, planes * 2 ** i, 1) for i, c in enumerate(chans)])
            self.decoder = Decoder(planes, 3, True, seeds)
            self.ladder = LadderBlock(planes, 3, True, seeds)
            self.net_output_list = nn.ModuleList([NetOutput(planes * 2 ** i, planes if i == 0 else 64, nc)
                                                  for i in range(3)])
            return
        planes = 64
        chans = self.backbone.out_channels
        self.conv_out_list = nn.ModuleList([ConvBNAct(c, planes * 2 ** i, 1) for i, c in enumerate(chans)])
        self.decoder = Decoder(planes, 4, False, seeds)
        self.ladder = LadderBlock(planes, 4, False, seeds)
        self.final = nn.Conv2d(planes, nc, 1)
        self.se_layer = nn.Linear(planes * 8, nc)
        self.aux_head = FCNHead(chans[2], nc, next(seeds))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "ShelfNet":
        reset_segmentation_parameters(self, generator)
        _init_transposed(self, generator)
        return self

    def forward(self, x: torch.Tensor):
        h_in = x.shape[-2]
        feats = self.backbone(x)
        want_aux = self.training or self.cfg.aux_outputs
        if self.cfg.is_lw:
            fe = feats[1:]
            if hasattr(self, "conv_out_list"):
                fe = [conv(f) for conv, f in zip(self.conv_out_list, fe)]
            lad = self.ladder(self.decoder(fe))[::-1]  # strides 8, 16, 32
            heads = list(zip(self.net_output_list, lad))[:3 if want_aux else 1]
            outs = []
            for head, f in heads:
                y = head(f)
                outs.append(upsample(y, h_in // y.shape[-2], "bilinear_ac"))
            return tuple(outs) if want_aux else outs[0]
        fe = [conv(f) for conv, f in zip(self.conv_out_list, feats)]
        lad = self.ladder(self.decoder(fe))
        main = self.final(lad[-1])
        main = upsample(main, h_in // main.shape[-2], "bilinear_ac")
        if not want_aux:
            return main
        se = self.se_layer(lad[0].amax(dim=(2, 3)))
        aux = self.aux_head(feats[2])
        return main, se, upsample(aux, h_in // aux.shape[-2], "bilinear_ac")


@dataclasses.dataclass(frozen=True)
class LadderNetCfg:
    num_classes: int = 19
    widths: Tuple[int, ...] = (64, 128, 256, 512)


class LadderNet(nn.Module):
    """One ladder over a BasicBlock 2-2-2-2 trunk: from the stride-32 map, three up steps
    (``up_proj{i}`` 1x1 conv-BN-ReLU, bilinear x2, plus the trunk's map, ReLU, ``up_block{i}``
    residual block), then ``final`` 1x1 to the classes, resized bilinearly to the input."""

    def __init__(self, cfg: LadderNetCfg):
        super().__init__()
        self.cfg = cfg
        w = cfg.widths
        self.backbone = ShelfResNetBackBone(widths=w)
        for i in (2, 1, 0):
            setattr(self, f"up_proj{i}", ConvBNAct(w[i + 1], w[i], 1))
            setattr(self, f"up_block{i}", BasicResNetBlock(w[i], w[i]))
        self.final = nn.Conv2d(w[0], cfg.num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> "LadderNet":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        d = feats[3]
        for i in (2, 1, 0):
            d = getattr(self, f"up_proj{i}")(d)
            d = F.relu(resize_to(d, d.shape[-2] * 2, d.shape[-1] * 2) + feats[i])
            d = getattr(self, f"up_block{i}")(d)
        return resize_to(self.final(d), *x.shape[-2:])
