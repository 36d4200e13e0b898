"""Reusable conv blocks, NCHW (counterpart of ``super_gradients_tpu/modules/blocks.py``).

Attribute names are those of the original super-gradients PyTorch modules
(``conv``/``bn``, ``seq.conv``, ``branch_3x3.conv``, ``rbr_reparam``), so that the
JAX converter's name rules map the JAX variables onto these ``state_dict`` keys.
Padding is the symmetric ``k // 2`` of torch's autopad. BatchNorm takes the
torch momentum convention (the JAX package stores ``1 - momentum``).

QARepVGG and RepVGG re-parameterization is a method that fuses one block in place
(:meth:`QARepVGGBlock.fuse_`, :meth:`RepVGGBlock.fuse_`), with the math of the JAX
``fuse_qarepvgg_params`` / ``fuse_repvgg_params`` written for OIHW kernels.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the activations the ported families' configs can name (the JAX table has more); relu6,
# hardswish and hardsigmoid are JAX's min(relu(x), 6), x * relu6(x + 3) / 6 and relu6(x + 3) / 6
ACTIVATIONS: Dict[Optional[str], Callable[[], nn.Module]] = {
    "relu": nn.ReLU,
    "relu6": nn.ReLU6,
    "silu": nn.SiLU,
    "swish": nn.SiLU,
    "hardswish": nn.Hardswish,
    "hardsigmoid": nn.Hardsigmoid,
    "identity": nn.Identity,
    None: nn.Identity,
}


def get_activation(name) -> nn.Module:
    """A new activation module by name."""
    if name not in ACTIVATIONS:
        raise KeyError(f"Unknown activation `{name}`; known: {sorted(k for k in ACTIVATIONS if k)}")
    return ACTIVATIONS[name]()


def width_multiplier(original: int, factor: float, divisor: Optional[int] = None) -> int:
    """Channel scaling helper (reference ``modules/utils.py`` width_multiplier)."""
    if divisor is None:
        return int(original * factor)
    return math.ceil(int(original * factor) / divisor) * divisor


def _bn(channels: int, eps: float, momentum: float) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=momentum)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA's ``SAME`` padding of a ``kernel`` / ``stride`` conv: ``ceil(n / stride)`` outputs, the
    odd pixel of padding at the bottom or right (flax's default conv padding; EfficientNet's
    ``padding="same"``)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ConvBNAct(nn.Module):
    """Conv2d (no bias, padding k // 2 unless given) -> BatchNorm -> activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1, act="relu",
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1, padding: Optional[int] = None):
        super().__init__()
        padding = kernel // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, padding, bias=False)
        self.bn = _bn(out_channels, bn_eps, bn_momentum)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class ConvBNReLU(nn.Module):
    """The same block with its layers under ``seq`` (the reference ``ConvBNReLU`` /
    ``ConvBNAct``, used by the detection heads: ``heads.head1.stem.seq.conv``, by the STDC
    and PP-LiteSeg segmentation models, some without the BN or without the ReLU, and with
    ``act="silu"`` by PP-YOLOE)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 stride: int = 1, groups: int = 1, use_normalization: bool = True, use_activation: bool = True,
                 act="relu", bias: bool = False):
        super().__init__()
        layers = OrderedDict(conv=nn.Conv2d(in_channels, out_channels, kernel, stride, kernel // 2, groups=groups,
                                            bias=bias))
        if use_normalization:
            layers["bn"] = _bn(out_channels, bn_eps, bn_momentum)
        if use_activation:
            layers["act"] = get_activation(act)
        self.seq = nn.Sequential(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq(x)


class SEBlock(nn.Module):
    """Squeeze-and-excitation: the global mean, ``fc.0`` (with bias), the activation, ``fc.2``
    (with bias), the gate, times the input. The JAX block's two 1x1 convs on the pooled
    map are the original's ``Linear`` layers here, so that an original checkpoint loads."""

    def __init__(self, channels: int, squeeze_channels: int, act="relu", gate="hardsigmoid"):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, squeeze_channels), get_activation(act),
                                nn.Linear(squeeze_channels, channels), get_activation(gate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ConvSEBlock(nn.Module):
    """The JAX ``SEBlock`` with its two 1x1 convs kept as convs (``fc1``, ``fc2``, with bias):
    the global mean, ``fc1``, ReLU, ``fc2``, the sigmoid gate, times the input (RepVGG's
    squeeze-excitation)."""

    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))))


def _fuse_bn(kernel: torch.Tensor, bias: Optional[torch.Tensor], bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN into an OIHW kernel + bias (same op order as the JAX ``_fuse_bn``)."""
    std = torch.sqrt(bn.running_var + bn.eps)
    a = bn.weight / std
    fused_kernel = kernel * a[:, None, None, None]
    fused_bias = (bias if bias is not None else 0.0) * a + bn.bias - bn.weight * bn.running_mean / std
    return fused_kernel, fused_bias


class QARepVGGBlock(nn.Module):
    """QARepVGG block (reference ``modules/qarepvgg_block.py``), as YOLO-NAS uses it.

    Branches ``branch_3x3`` (conv + BN), ``branch_1x1`` (conv + bias, times
    ``alpha``) and identity; their sum goes through ``post_bn`` and the
    activation. ``fused=True`` builds the deploy form: one ``rbr_reparam`` 3x3
    conv with bias, then the activation. :meth:`fuse_` turns an unfused block
    into that form in place. Groups, dilation, squeeze-excitation and the
    bias-free / post-BN-free variants of the JAX block are not ported: no
    YOLO-NAS block uses them.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        stride: int = 1,
        act="relu",
        use_residual: bool = True,
        use_alpha: bool = False,
        bn_eps: float = 1e-5,
        bn_momentum: float = 0.1,
        fused: bool = False,
    ):
        super().__init__()
        if use_residual and (in_channels != out_channels or stride != 1):
            raise ValueError("a residual QARepVGG block needs in_channels == out_channels and stride 1")
        self.in_channels, self.out_channels, self.stride = in_channels, out_channels, stride
        self.use_residual, self.use_alpha = use_residual, use_alpha
        self.fused = fused
        self.act = get_activation(act)
        if fused:
            self.rbr_reparam = self._conv3x3(bias=True)
            return
        self.branch_3x3 = nn.Sequential(OrderedDict(
            conv=self._conv3x3(bias=False),
            bn=_bn(out_channels, bn_eps, bn_momentum),
        ))
        self.branch_1x1 = nn.Conv2d(in_channels, out_channels, 1, stride, 0)
        if use_alpha:
            self.alpha = nn.Parameter(torch.ones(1))
        self.post_bn = _bn(out_channels, bn_eps, bn_momentum)

    def _conv3x3(self, bias: bool) -> nn.Conv2d:
        return nn.Conv2d(self.in_channels, self.out_channels, 3, self.stride, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self.act(self.rbr_reparam(x))
        y1 = self.branch_1x1(x)
        if self.use_alpha:
            y1 = self.alpha * y1
        y = self.branch_3x3(x) + y1
        if self.use_residual:
            y = y + x
        return self.act(self.post_bn(y))

    @torch.no_grad()
    def fused_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel OIHW, bias) of the equivalent single 3x3 conv (deploy form)."""
        kernel3, bias3 = _fuse_bn(self.branch_3x3.conv.weight, None, self.branch_3x3.bn)
        k1 = nn.functional.pad(self.branch_1x1.weight, (1, 1, 1, 1))
        alpha = self.alpha[0] if self.use_alpha else 1.0
        kernel = kernel3 + alpha * k1
        bias = bias3 + alpha * self.branch_1x1.bias
        if self.use_residual:
            idx = torch.arange(self.out_channels, device=kernel.device)
            identity = torch.zeros_like(kernel)
            identity[idx, idx, 1, 1] = 1.0
            kernel = kernel + identity
        return _fuse_bn(kernel, bias, self.post_bn)

    @torch.no_grad()
    def fuse_(self) -> "QARepVGGBlock":
        """Re-parameterize this block in place into its deploy form."""
        if self.fused:
            return self
        kernel, bias = self.fused_weights()
        conv = self._conv3x3(bias=True).to(device=kernel.device, dtype=kernel.dtype)
        conv.weight.copy_(kernel)
        conv.bias.copy_(bias)
        for name in ("branch_3x3", "branch_1x1", "alpha", "post_bn"):
            if hasattr(self, name):
                delattr(self, name)
        self.rbr_reparam = conv
        self.fused = True
        return self


class RepVGGBlock(nn.Module):
    """Classic RepVGG block (reference ``modules/repvgg_block.py``): ``branch_3x3`` (conv + BN)
    plus ``branch_1x1`` (conv + BN) plus, with ``use_residual``, the identity BN
    ``no_conv_branch``, summed, then the activation, then the squeeze-excitation ``se`` where
    ``se_ratio`` is given (``int(out_channels * se_ratio)`` squeeze channels, ReLU, sigmoid).
    ``groups`` and ``dilation`` apply to both convs (the 3x3 pads ``dilation``). ``fused=True``
    builds the deploy form, one ``rbr_reparam`` 3x3 conv with bias; :meth:`fuse_` turns an
    unfused block into it in place, folding the identity branch as the JAX
    ``fuse_repvgg_params`` does. PP-YOLOE's blocks take the defaults: no identity, no groups,
    no SE.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, act="relu", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, fused: bool = False, use_residual: bool = False, groups: int = 1,
                 dilation: int = 1, se_ratio: Optional[float] = None):
        super().__init__()
        if use_residual and (in_channels != out_channels or stride != 1):
            raise ValueError("a residual RepVGG block needs in_channels == out_channels and stride 1")
        self.in_channels, self.out_channels, self.stride = in_channels, out_channels, stride
        self.groups, self.dilation, self.use_residual = groups, dilation, use_residual
        self.fused = fused
        self.act = get_activation(act)
        if fused:
            self.rbr_reparam = self._conv3x3(bias=True)
        else:
            self.branch_3x3 = nn.Sequential(OrderedDict(conv=self._conv3x3(bias=False),
                                                        bn=_bn(out_channels, bn_eps, bn_momentum)))
            self.branch_1x1 = nn.Sequential(OrderedDict(
                conv=nn.Conv2d(in_channels, out_channels, 1, stride, 0, groups=groups, bias=False),
                bn=_bn(out_channels, bn_eps, bn_momentum),
            ))
            if use_residual:
                self.no_conv_branch = _bn(in_channels, bn_eps, bn_momentum)
        self.se = ConvSEBlock(out_channels, max(1, int(out_channels * se_ratio))) if se_ratio else None

    def _conv3x3(self, bias: bool) -> nn.Conv2d:
        return nn.Conv2d(self.in_channels, self.out_channels, 3, self.stride, self.dilation, dilation=self.dilation,
                         groups=self.groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            out = self.act(self.rbr_reparam(x))
        else:
            y = self.branch_3x3(x) + self.branch_1x1(x)
            if self.use_residual:
                y = y + self.no_conv_branch(x)
            out = self.act(y)
        return out if self.se is None else self.se(out)

    @torch.no_grad()
    def fuse_(self) -> "RepVGGBlock":
        """Re-parameterize this block in place into its deploy form."""
        if self.fused:
            return self
        k3, b3 = _fuse_bn(self.branch_3x3.conv.weight, None, self.branch_3x3.bn)
        k1, b1 = _fuse_bn(nn.functional.pad(self.branch_1x1.conv.weight, (1, 1, 1, 1)), None, self.branch_1x1.bn)
        kernel, bias = k3 + k1, b3 + b1
        if self.use_residual:
            in_dim = self.in_channels // self.groups
            idx = torch.arange(self.out_channels, device=k3.device)
            identity = torch.zeros_like(k3)
            identity[idx, idx % in_dim, 1, 1] = 1.0
            kid, bid = _fuse_bn(identity, None, self.no_conv_branch)
            kernel, bias = kernel + kid, bias + bid
        conv = self._conv3x3(bias=True).to(device=k3.device, dtype=k3.dtype)
        conv.weight.copy_(kernel)
        conv.bias.copy_(bias)
        for name in ("branch_3x3", "branch_1x1", "no_conv_branch"):
            if hasattr(self, name):
                delattr(self, name)
        self.rbr_reparam = conv
        self.fused = True
        return self
