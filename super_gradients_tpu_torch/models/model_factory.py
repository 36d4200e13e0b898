"""models.get — the port's model zoo entry point (counterpart of
``super_gradients_tpu/models/model_factory.py``).

Each registered architecture is a builder returning a :class:`ModelSpec`; ``get``
initializes the network from a seeded ``torch.Generator`` on the CPU, moves it to
the requested device and wraps it in the task model that the spec names
(:class:`DetectionModel`, :class:`PoseEstimationModel`, :class:`ClassificationModel` or
:class:`SegmentationModel`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn

from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.inference.processing import Processing
from super_gradients_tpu_torch.models.sg_model import DetectionModel, SgModel


@dataclasses.dataclass
class ModelSpec:
    """What an architecture builder returns (network + metadata)."""

    net: nn.Module
    num_classes: int
    input_hw: Tuple[int, int]
    config: Any = None
    processing: Optional[Processing] = None
    class_names: Optional[List[str]] = None
    model_cls: Type[SgModel] = DetectionModel  # the task model that wraps the network
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)  # its task-specific arguments
    # the size the BN statistics are calibrated at, where it is not input_hw (the fully
    # convolutional segmentation models: their parameters are the same at any size)
    init_hw: Optional[Tuple[int, int]] = None


def get_architecture(model_name: str):
    if model_name not in ARCHITECTURES:
        import difflib

        low = model_name.lower()
        close = [k for k in ARCHITECTURES if low in k.lower() or k.lower() in low]
        close += [k for k in difflib.get_close_matches(low, ARCHITECTURES, n=5, cutoff=0.75) if k not in close]
        hint = f" Close matches: {close[:5]}" if close else ""
        raise KeyError(f"Unknown architecture `{model_name}`.{hint} ({len(ARCHITECTURES)} registered)")
    return ARCHITECTURES[model_name]


@torch.no_grad()
def _calibrate_batch_norm(net: nn.Module, generator: torch.Generator, shape: Tuple[int, ...]) -> None:
    """Set every BatchNorm's running statistics from one eval-mode forward of
    uniform noise images drawn from ``generator``, at the model's input size (or the
    spec's ``init_hw``).

    With (0, 1) running statistics a randomly initialized deep network has no
    normalization in eval mode, and its activations grow or vanish with depth
    (YOLO-NAS-M logits reach ~1e9 at 640x640). Each BN takes the mean and variance
    of the input it sees in this forward, after the BNs before it were set, so
    eval-mode activations stay at unit scale and random-weight outputs are finite
    and spread like a trained network's.
    """

    def set_stats(bn, inputs):
        x = inputs[0]
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    try:
        net.eval()(torch.rand(shape, generator=generator))
    finally:
        for hook in hooks:
            hook.remove()


def get(
    model_name: str,
    num_classes: Optional[int] = None,
    arch_params: Optional[Dict] = None,
    seed: int = 0,
    device="cuda",
    checkpoint_path: Optional[str] = None,
    pretrained_weights: Optional[str] = None,
    checkpoint_num_classes: Optional[int] = None,
    load_backbone: bool = False,
    strict_load: Optional[bool] = None,
    **kwargs,
) -> SgModel:
    """Instantiate a model from the zoo with random weights made from ``seed``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is visible; pass
    ``device="cpu"`` to run on the CPU. ``checkpoint_path`` loads a ``.pth`` file
    of the original super-gradients layout (``ema_net`` preferred over ``net``, as
    ``Trainer.train`` writes them) through ``load_state_dict``: only its backbone with
    ``load_backbone``, only the tensors whose name and shape match with
    ``strict_load=False`` (the default when ``load_backbone``). A checkpoint of another
    class count (``checkpoint_num_classes``) is loaded at that count, then the head is
    replaced (:func:`replace_head`). ``pretrained_weights`` (``"coco"``, ``"imagenet"``, ...)
    attaches the processing parameters the published checkpoint was evaluated with, then,
    unless ``checkpoint_path`` is given, loads ``$SG_PRETRAINED_DIR/<basename of its URL>``
    (``models/pretrained_models.py``); an absent file raises ``FileNotFoundError`` naming
    the URL. Nothing is downloaded.
    """
    if checkpoint_num_classes is not None and num_classes is not None and checkpoint_num_classes != num_classes:
        base = get(model_name, num_classes=checkpoint_num_classes, arch_params=arch_params, seed=seed, device=device,
                   checkpoint_path=checkpoint_path, pretrained_weights=pretrained_weights, load_backbone=load_backbone,
                   strict_load=strict_load, **kwargs)
        return replace_head(base, num_classes, seed=seed, arch_params=arch_params, **kwargs)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"models.get(..., device='{device}'): CUDA is not available; pass device='cpu' to run on the CPU")

    spec = get_architecture(model_name)(num_classes=num_classes, arch_params=arch_params or {}, **kwargs)
    generator = torch.Generator().manual_seed(seed)
    spec.net.reset_parameters(generator)
    _calibrate_batch_norm(spec.net, generator, (2, 3, *(spec.init_hw or spec.input_hw)))
    model = spec.model_cls(
        name=model_name, net=spec.net, num_classes=spec.num_classes, config=spec.config,
        processing=spec.processing, class_names=spec.class_names, device=device, input_hw=spec.input_hw,
        **spec.model_kwargs,
    )
    if pretrained_weights is not None:
        from super_gradients_tpu_torch.inference.processing import get_pretrained_processing_params

        proc_params = get_pretrained_processing_params(model_name, pretrained_weights)
        if proc_params:
            model.set_dataset_processing_params(**proc_params)
    if pretrained_weights is not None and checkpoint_path is None:
        from super_gradients_tpu_torch.models.pretrained_models import resolve_pretrained_path

        checkpoint_path = resolve_pretrained_path(model_name, pretrained_weights)
    if checkpoint_path is not None:
        from super_gradients_tpu_torch.training.checkpoints import load_checkpoint_into_model

        load_checkpoint_into_model(model, checkpoint_path, only_subtree="backbone" if load_backbone else None,
                                   strict=strict_load if strict_load is not None else not load_backbone)
    return model


def replace_head(model: SgModel, new_num_classes: int, seed: int = 0, **kwargs) -> SgModel:
    """The same architecture at ``new_num_classes``, with every tensor whose name and
    shape match taken from ``model`` (the backbone and neck stay bit-identical) and only
    the class-dependent head tensors freshly initialized from ``seed``."""
    from super_gradients_tpu_torch.training.checkpoints import transfer_weights

    new_model = get(model.name, num_classes=new_num_classes, seed=seed, device=model.device, **kwargs)
    new_model.load_state_dict(transfer_weights(model.net.state_dict(), new_model.net.state_dict()))
    new_model._processing = model._processing
    return new_model
