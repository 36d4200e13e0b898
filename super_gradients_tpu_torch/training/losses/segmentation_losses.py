"""Segmentation losses (counterpart of
``super_gradients_tpu/training/losses/segmentation_losses.py``).

Each loss is ``loss(outputs, targets) -> (loss, {name: value})``. Outputs are ``[B, C, H, W]``
logits, or the tuple ``(main, *aux)`` of a model in train mode; targets ``[B, H, W]`` int
class ids, ``ignore_index`` (255 by default) marking void pixels. Every loss computes in
fp32 on bf16 or fp32 logits (in fp64 on fp64 ones, for reference runs), and an ignored
pixel weighs nothing: the mean
cross-entropy divides by ``max(valid pixels, 1)``, so an all-void batch gives 0 where
``F.cross_entropy(ignore_index=)`` gives NaN.

OHEM is batch-global, as in JAX: the valid pixels' losses are sorted in descending order;
where the ``num_mining``-th exceeds ``-log(threshold)`` every pixel above it is kept, else
the top ``num_mining``. ``DiceCEEdgeLoss`` is the JAX package's: CE and soft dice on the
main map and weighted CE on the auxiliary maps, with no edge term.

ShelfNet's losses: ``ShelfNetOHEMLoss`` sums the OHEM of every head; ``ShelfNetSemanticEncodingLoss``
takes HW's ``(main, se [B, C], aux)``: CE on both maps and the BCE of ``se`` against each image's
class-presence indicator. ``MaskAttentionLoss`` weighs a per-pixel criterion's mean over the
valid pixels and its mean over a mask's foreground.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_mean, global_normalizer, refuse_across_ranks


def _fp32(x: torch.Tensor) -> torch.Tensor:
    """fp32, or fp64 where the input is fp64."""
    return x if x.dtype == torch.float64 else x.float()


def _main(outputs) -> torch.Tensor:
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


def _valid_mask(targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (targets != ignore_index).float()


def _safe_targets(targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return torch.where(targets == ignore_index, 0, targets).long()


def pixel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel cross-entropy ``[B, H, W]``, 0 at ignored pixels."""
    logp = F.log_softmax(_fp32(logits), dim=1)
    ce = -logp.gather(1, _safe_targets(targets, ignore_index)[:, None])[:, 0]
    return ce * _valid_mask(targets, ignore_index)


@register_loss("SegCrossEntropyLoss")
class SegCrossEntropyLoss:
    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, Dict]:
        ce = pixel_cross_entropy(_main(outputs), targets, self.ignore_index)
        loss = ce.sum() / global_normalizer(_valid_mask(targets, self.ignore_index).sum())
        return loss, {"SegCrossEntropyLoss": loss}


@register_loss("OhemCELoss")
class OhemCELoss:
    """Online hard-example-mining cross-entropy over the batch's valid pixels: at least
    ``mining_percent`` of them, more where more exceed ``-log(threshold)``."""

    def __init__(self, threshold: float = 0.7, mining_percent: float = 0.1, ignore_lb: int = 255):
        if not 0 <= mining_percent <= 1:
            raise ValueError(f"mining percent must be in [0, 1], got {mining_percent}")
        # float32 values held as Python floats, which a float32 tensor takes exactly
        self.thresh = float(-np.log(np.float32(threshold)))
        self.mining_percent = float(np.float32(mining_percent))
        self.ignore_lb = ignore_lb

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, Dict]:
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        ce = pixel_cross_entropy(_main(outputs), targets, self.ignore_lb).reshape(-1)
        valid = _valid_mask(targets, self.ignore_lb).reshape(-1)
        n_valid = valid.sum().to(torch.int32)
        # int32(float32(mining_percent) * float32(n_valid)), as JAX computes it
        num_mining = torch.minimum((n_valid.float() * self.mining_percent).to(torch.int32), n_valid - 1).clamp(min=0)
        sorted_ce = torch.sort(ce * valid, descending=True).values  # void pixels are 0s at the tail
        pivot = sorted_ce[num_mining.long()]
        idx = torch.arange(sorted_ce.shape[0], device=ce.device)
        # thresh > 0, so `> thresh` also leaves out the zero tail
        keep = torch.where(pivot > self.thresh, sorted_ce > self.thresh, idx < num_mining) & (idx < n_valid)
        loss = (sorted_ce * keep).sum() / keep.sum().clamp(min=1)
        loss = torch.where(n_valid == 0, torch.zeros_like(loss), loss)
        return loss, {"OhemCELoss": loss}


def soft_dice(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = 255, eps: float = 1e-5) -> torch.Tensor:
    """One minus the mean over images and classes of the soft dice of the softmax against
    the one-hot targets, void pixels left out. The per-class sums over the target class are
    scattered, not taken from a ``[B, H, W, C]`` one-hot."""
    b, c = logits.shape[:2]
    valid = _valid_mask(targets, ignore_index)
    probs = F.softmax(_fp32(logits), dim=1) * valid[:, None]
    safe = _safe_targets(targets, ignore_index).reshape(b, -1)
    p_target = probs.reshape(b, c, -1).gather(1, safe[:, None])[:, 0]
    inter = probs.new_zeros((b, c)).scatter_add_(1, safe, p_target)
    target_sum = probs.new_zeros((b, c)).scatter_add_(1, safe, valid.reshape(b, -1).to(probs.dtype))
    dice = (2 * inter + eps) / (probs.sum(dim=(2, 3)) + target_sum + eps)
    return 1.0 - dice.mean()


@register_loss("DiceLoss")
class DiceLoss:
    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index

    def __call__(self, outputs, targets):
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        loss = soft_dice(_main(outputs), targets, self.ignore_index)
        return loss, {"DiceLoss": loss}


@register_loss("BinaryDiceLoss")
class BinaryDiceLoss:
    """Dice of ``sigmoid(logits [B, 1, H, W])`` against a binary map ``[B, H, W]``, smoothed by 1."""

    def __call__(self, logits, targets_binary):
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        p = torch.sigmoid(_fp32(logits))[:, 0]
        inter = (p * targets_binary).sum(dim=(1, 2))
        denom = p.sum(dim=(1, 2)) + targets_binary.sum(dim=(1, 2))
        loss = 1.0 - ((2 * inter + 1.0) / (denom + 1.0)).mean()
        return loss, {"BinaryDiceLoss": loss}


_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def detail_target(targets: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """The STDC boundary ground truth ``[B, H, W]``: the Laplacian of the class map at
    strides 1, 2 and 4 (padding 1), each clipped to [0, 1], resized back (``nearest``:
    torch's ``nearest-exact``) and binarized at 0.1, fused with weights 0.6 / 0.3 / 0.1 and
    binarized at 0.1."""
    t = torch.where(targets == ignore_index, 0, targets).float()[:, None]
    lap = torch.tensor(_LAPLACIAN, device=t.device).reshape(1, 1, 3, 3)

    def edge(stride: int) -> torch.Tensor:
        y = F.conv2d(t, lap, stride=stride, padding=1).abs().clamp(0, 1.0)
        if stride > 1:
            y = F.interpolate(y, size=t.shape[-2:], mode="nearest-exact")
        return (y > 0.1).float()

    fused = 0.6 * edge(1) + 0.3 * edge(2) + 0.1 * edge(4)
    return (fused > 0.1).float()[:, 0]


def _bce_with_logits(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(z, 0) - z * t + log1p(exp(-|z|))``, JAX's form."""
    return z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


@register_loss("STDCLoss")
class STDCLoss:
    """OHEM cross-entropy on the main and the two auxiliary maps, and BCE (a mean over every
    pixel, void ones included) plus binary dice of the detail map against
    :func:`detail_target`."""

    def __init__(self, num_classes: int = 19, ignore_index: int = 255, threshold: float = 0.7,
                 mining_percent: float = 0.1, weights: Sequence[float] = (1.0, 1.0, 1.0),
                 detail_weights: Sequence[float] = (1.0, 1.0)):
        self.ignore_index = ignore_index
        self.ohem = OhemCELoss(threshold, mining_percent, ignore_index)
        self.weights = tuple(weights)  # main, aux32, aux16
        self.detail_weights = tuple(detail_weights)  # bce, dice

    def __call__(self, outputs, targets):
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        if not isinstance(outputs, (tuple, list)):
            loss, _ = self.ohem(outputs, targets)
            return loss, {"STDCLoss/main": loss}
        main, aux32, aux16, detail8 = outputs
        l_main, _ = self.ohem(main, targets)
        l_a32, _ = self.ohem(aux32, targets)
        l_a16, _ = self.ohem(aux16, targets)
        dt = detail_target(targets, self.ignore_index)
        l_bce = _bce_with_logits(_fp32(detail8)[:, 0], dt).mean()
        l_dice, _ = BinaryDiceLoss()(detail8, dt)
        loss = (self.weights[0] * l_main + self.weights[1] * l_a32 + self.weights[2] * l_a16
                + self.detail_weights[0] * l_bce + self.detail_weights[1] * l_dice)
        return loss, {"loss_main": l_main, "loss_aux": l_a32 + l_a16, "loss_detail": l_bce + l_dice}


@register_loss("DiceCEEdgeLoss")
class DiceCEEdgeLoss:
    """Cross-entropy plus soft dice on the main map and ``aux_weights``-weighted
    cross-entropy on each auxiliary map (the last weight repeats). ``num_aux_heads``,
    ``ce_edge_weights`` and ``weights`` are accepted and not read, as in the JAX package."""

    def __init__(self, num_classes: int = 19, ignore_index: int = 255, num_aux_heads: int = 1,
                 ce_edge_weights: Sequence[float] = (0.5, 0.5), weights: Sequence[float] = (1.0,),
                 aux_weights: Sequence[float] = (0.4,)):
        self.ignore_index = ignore_index
        self.aux_weights = tuple(aux_weights)
        self.ce = SegCrossEntropyLoss(ignore_index)

    def __call__(self, outputs, targets):
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        main = outputs[0]
        l_main_ce, _ = self.ce(main, targets)
        l_dice = soft_dice(main, targets, self.ignore_index)
        loss = l_main_ce + l_dice
        for i, aux in enumerate(outputs[1:]):
            w = self.aux_weights[min(i, len(self.aux_weights) - 1)]
            loss = loss + w * self.ce(aux, targets)[0]
        return loss, {"loss_ce": l_main_ce, "loss_dice": l_dice}


@register_loss("BCEDiceLoss")
class BCEDiceLoss:
    """``w0 * BCE-with-logits + w1 * binary dice`` on a one-channel map against a binary
    target ``[B, H, W]``."""

    def __init__(self, loss_weights: Sequence[float] = (0.5, 0.5), logits: bool = True):
        self.loss_weights = tuple(loss_weights)

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, Dict]:
        refuse_across_ranks(type(self).__name__)  # a statistic over the whole batch
        logits = _main(outputs)
        t = targets.float()
        z = logits[:, 0] if logits.dim() == t.dim() + 1 else logits
        bce = _bce_with_logits(_fp32(z), t).mean()
        dice, _ = BinaryDiceLoss()(z[:, None], t)
        loss = self.loss_weights[0] * bce + self.loss_weights[1] * dice
        return loss, {"bce": bce, "dice": dice}


@register_loss("ShelfNetOHEMLoss")
class ShelfNetOHEMLoss(OhemCELoss):
    """:class:`OhemCELoss` of each ShelfNet head, summed; each head's logged as ``ohem_{i}``."""

    def __init__(self, threshold: float = 0.7, mining_percent: float = 1e-4, ignore_lb: int = 255):
        super().__init__(threshold=threshold, mining_percent=mining_percent, ignore_lb=ignore_lb)

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, Dict]:
        outputs = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
        losses = [super(ShelfNetOHEMLoss, self).__call__(o, targets)[0] for o in outputs]
        return sum(losses), {f"ohem_{i}": loss for i, loss in enumerate(losses)}


@register_loss("ShelfNetSemanticEncodingLoss")
class ShelfNetSemanticEncodingLoss:
    """``CE(main) + aux_weight * CE(aux) + se_weight * BCE(sigmoid(se), presence)`` on
    ``(main [B, C, H, W], se [B, C], aux [B, C, H, W])``: ``presence[b, c]`` is 1 where a valid
    pixel of image ``b`` has class ``c`` (a class id clipped into ``[0, nclass)``), and the BCE
    is a mean over ``B x C`` with ``1e-12`` inside its logs."""

    def __init__(self, se_weight: float = 0.2, nclass: int = 21, aux_weight: float = 0.4, ignore_index: int = -1):
        self.se_weight, self.nclass, self.aux_weight = se_weight, nclass, aux_weight
        self.ignore_index = ignore_index
        self.ce = SegCrossEntropyLoss(ignore_index)

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, Dict]:
        pred1, se_pred, pred2 = outputs
        loss1, _ = self.ce(pred1, targets)
        loss2, _ = self.ce(pred2, targets)
        b = targets.shape[0]
        se = _fp32(se_pred)
        classes = targets.clamp(0, self.nclass - 1).long().reshape(b, -1)
        valid = _valid_mask(targets, self.ignore_index).reshape(b, -1).to(se.dtype)
        presence = (se.new_zeros((b, self.nclass)).scatter_add_(1, classes, valid) > 0).to(se.dtype)
        p = torch.sigmoid(se)
        loss3 = global_mean(-(presence * torch.log(p + 1e-12) + (1 - presence) * torch.log(1 - p + 1e-12)))
        total = loss1 + self.aux_weight * loss2 + self.se_weight * loss3
        return total, {"ce_main": loss1, "ce_aux": loss2, "se_bce": loss3}


@register_loss("MaskAttentionLoss")
class MaskAttentionLoss:
    """``w0 * mean(per-pixel loss over valid pixels) + w1 * mean(per-pixel loss over the mask's
    valid foreground)``, each mean's count clamped at 1 (a mask with no foreground adds 0).

    ``criterion(logits, targets)`` returns the unreduced ``[B, H, W]`` loss
    (:func:`pixel_cross_entropy` by default). The mask comes as ``mask=`` or packed with the
    targets as ``(targets, mask)``, ``[B, H, W]`` or with a trailing channel ``[B, H, W, 1]``."""

    def __init__(self, criterion=None, loss_weights: Sequence[float] = (1.0, 1.0), ignore_index: int = 255):
        if len(loss_weights) != 2:
            raise ValueError(f"loss_weights must have 2 values, found {len(loss_weights)}")
        if loss_weights[1] <= 0:
            raise ValueError("mask loss weight must be positive; use the bare criterion otherwise")
        self.criterion = criterion or (lambda logits, t: pixel_cross_entropy(logits, t, ignore_index))
        self.loss_weights = tuple(loss_weights)
        self.ignore_index = ignore_index

    def __call__(self, outputs, targets, mask=None) -> Tuple[torch.Tensor, Dict]:
        if mask is None:
            targets, mask = targets
        per_pixel = self.criterion(_main(outputs), targets)
        if mask.dim() == per_pixel.dim() + 1:
            mask = mask[..., 0]
        valid = _valid_mask(targets, self.ignore_index).to(per_pixel.dtype)
        base = per_pixel.sum() / global_normalizer(valid.sum())
        fg = mask.to(per_pixel.dtype) * valid
        mask_term = (per_pixel * fg).sum() / global_normalizer(fg.sum())
        loss = self.loss_weights[0] * base + self.loss_weights[1] * mask_term
        return loss, {"loss_base": base, "loss_mask": mask_term}


@register_loss("CWDKlDivLoss")
@register_loss("SegKDLoss")
class ChannelWiseKnowledgeDistillationLoss:
    """Channel-wise distillation of a :class:`~super_gradients_tpu_torch.training.losses.kd_losses.KDOutput`:
    for each image and channel, the KL divergence from the teacher's softmax over the ``H * W``
    pixels to the student's, at temperature ``tau``, averaged over ``[B, C]`` and times
    ``tau**2`` (the first map of a tuple output; ``targets`` are not read)."""

    def __init__(self, temperature: float = 4.0, normalization_mode: str = "channel_wise"):
        self.temperature = temperature

    def __call__(self, outputs, targets=None) -> Tuple[torch.Tensor, Dict]:
        s, t = _main(outputs.student_output), _main(outputs.teacher_output)
        tau = self.temperature
        b, c = s.shape[:2]
        s_logp = F.log_softmax(s.reshape(b, c, -1) / tau, dim=2)
        t_p = F.softmax(t.reshape(b, c, -1) / tau, dim=2)
        kl = torch.sum(t_p * (torch.log(t_p + 1e-12) - s_logp), dim=2)  # [B, C]
        loss = global_mean(kl) * (tau**2)
        return loss, {"cwd_loss": loss}
