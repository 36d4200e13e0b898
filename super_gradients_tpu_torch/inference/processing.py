"""Host-side image processing for predict (the subset of
``super_gradients_tpu/inference/processing.py`` that the YOLO-NAS and YOLO-NAS-POSE
COCO processing, the ImageNet classification processing and the segmentation
processing use, and ``get_pretrained_processing_params`` with the published
parameters of the families the port has).

numpy in, numpy out, one image at a time. The letterbox resize is the JAX
package's call, ``cv2.resize(..., INTER_LINEAR)``, wherever cv2 imports (cv2 is
imported at the call, never with the module). Without cv2 it is
:func:`resize_bilinear`, ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` rounded back to uint8: the same half-pixel sampling, within one
grey level of cv2 (whose fixed-point weights round differently). A segmentation map
goes back to the image's size with ``cv2.resize(..., INTER_NEAREST)``, or without cv2
with :func:`resize_nearest_torch`, the same floor rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ProcessingMetadata:
    scale: float = 1.0
    pad_top: int = 0
    pad_left: int = 0
    original_hw: Tuple[int, int] = (0, 0)
    pad_bottom: int = 0
    pad_right: int = 0
    scale_h: float = 1.0  # DetectionRescale's two scales
    scale_w: float = 1.0


class Processing:
    """preprocess(image) -> (image, metadata); postprocess_boxes / postprocess_keypoints /
    postprocess_segmentation undo the geometry (keypoints ``[..., >=2]``: x, y first, any
    other column as is)."""

    def preprocess_image(self, image: np.ndarray) -> Tuple[np.ndarray, ProcessingMetadata]:
        raise NotImplementedError

    def postprocess_boxes(self, boxes: np.ndarray, meta: ProcessingMetadata) -> np.ndarray:
        return boxes

    def postprocess_keypoints(self, kpts: np.ndarray, meta: ProcessingMetadata) -> np.ndarray:
        return kpts

    def postprocess_segmentation(self, seg_map: np.ndarray, meta: ProcessingMetadata) -> np.ndarray:
        return seg_map

    def get_equivalent_photometric_fn(self):
        """This op's photometric effect as a function on ``[B, H, W, 3]`` tensors, which an
        exported program traces (``conversion/export.py``); None for a geometric op."""
        return None


def cv2_module():
    """The cv2 module where it imports, else None. The port's image code takes the JAX
    package's cv2 calls where it can, and its numpy / torch stand-ins only without cv2."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def resize(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image to ``out_hw``: ``cv2.resize(INTER_LINEAR)``,
    or :func:`resize_bilinear` without cv2."""
    cv2 = cv2_module()
    if cv2 is None:
        return resize_bilinear(image, out_hw)
    return cv2.resize(image, dsize=(out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)


def resize_bilinear(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image (half-pixel centers, no antialias), in torch:
    the stand-in for cv2's ``INTER_LINEAR``, within one grey level of it."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def resize_nearest(seg: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """A class map to ``out_hw`` as uint8: ``cv2.resize(INTER_NEAREST)``, or
    :func:`resize_nearest_torch` without cv2."""
    seg = seg.astype(np.uint8)
    cv2 = cv2_module()
    if cv2 is None:
        return resize_nearest_torch(seg, out_hw)
    return cv2.resize(seg, dsize=(out_hw[1], out_hw[0]), interpolation=cv2.INTER_NEAREST)


def resize_nearest_torch(seg: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``F.interpolate(mode="nearest")`` of a 2-D map: each output pixel takes the source
    pixel ``floor(i * in / out)``, cv2's ``INTER_NEAREST`` rule."""
    x = torch.from_numpy(np.ascontiguousarray(seg))[None, None]
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")[0, 0].numpy()


class DetectionLongestMaxSizeRescale(Processing):
    """Rescale so the longest side fits output_shape, keeping aspect ratio."""

    def __init__(self, output_shape: Sequence[int]):
        self.output_shape = tuple(output_shape)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        scale = min(th / h, tw / w)
        if scale != 1.0:
            image = resize(image, (round(h * scale), round(w * scale)))
        return image, ProcessingMetadata(scale=scale, original_hw=(h, w))

    def postprocess_boxes(self, boxes, meta):
        return boxes / meta.scale

    def postprocess_keypoints(self, kpts, meta):
        out = kpts.copy()
        out[..., :2] = out[..., :2] / meta.scale
        return out


class DetectionRescale(Processing):
    """A direct resize to output_shape that does not keep the aspect ratio."""

    def __init__(self, output_shape: Sequence[int]):
        self.output_shape = tuple(output_shape)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        out = resize(image, (th, tw)) if (h, w) != (th, tw) else image
        return out, ProcessingMetadata(original_hw=(h, w), scale_h=th / h, scale_w=tw / w)

    def postprocess_boxes(self, boxes, meta):
        return boxes / np.array([meta.scale_w, meta.scale_h, meta.scale_w, meta.scale_h], dtype=np.float32)

    def postprocess_keypoints(self, kpts, meta):
        out = kpts.copy()
        out[..., 0] = out[..., 0] / meta.scale_w
        out[..., 1] = out[..., 1] / meta.scale_h
        return out


class DetectionBottomRightPadding(Processing):
    def __init__(self, output_shape: Sequence[int], pad_value: int = 114):
        self.output_shape = tuple(output_shape)
        self.pad_value = pad_value

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        out = np.full((th, tw) + image.shape[2:], self.pad_value, dtype=image.dtype)
        out[:h, :w] = image
        return out, ProcessingMetadata(original_hw=(h, w))


class DetectionCenterPadding(Processing):
    def __init__(self, output_shape: Sequence[int], pad_value: int = 114):
        self.output_shape = tuple(output_shape)
        self.pad_value = pad_value

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        top, left = (th - h) // 2, (tw - w) // 2
        out = np.full((th, tw) + image.shape[2:], self.pad_value, dtype=image.dtype)
        out[top : top + h, left : left + w] = image
        return out, ProcessingMetadata(pad_top=top, pad_left=left, original_hw=(h, w))

    def postprocess_boxes(self, boxes, meta):
        shift = np.array([meta.pad_left, meta.pad_top, meta.pad_left, meta.pad_top], dtype=boxes.dtype)
        return boxes - shift

    def postprocess_keypoints(self, kpts, meta):
        out = kpts.copy()
        out[..., 0] -= meta.pad_left
        out[..., 1] -= meta.pad_top
        return out


class KeypointsLongestMaxSizeRescale(DetectionLongestMaxSizeRescale):
    """The same geometry for pose inputs."""


class KeypointsBottomRightPadding(DetectionBottomRightPadding):
    """Bottom-right padding for pose inputs (pad value 127 by default)."""

    def __init__(self, output_shape: Sequence[int], pad_value: int = 127):
        super().__init__(output_shape, pad_value)


class StandardizeImage(Processing):
    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def preprocess_image(self, image):
        return image.astype(np.float32) / self.max_value, ProcessingMetadata(original_hw=image.shape[:2])

    def get_equivalent_photometric_fn(self):
        max_value = self.max_value
        return lambda x: x / max_value


class NormalizeImage(Processing):
    """``(image - mean) / std`` per channel, in float32."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def preprocess_image(self, image):
        return (image.astype(np.float32) - self.mean) / self.std, ProcessingMetadata(original_hw=image.shape[:2])

    def get_equivalent_photometric_fn(self):
        """float32 mean and std: a bf16 input computes in float32, as the JAX function promotes."""
        mean, std = self.mean.copy(), self.std.copy()
        return lambda x: (x - torch.as_tensor(mean, device=x.device)) / torch.as_tensor(std, device=x.device)


class Resize(Processing):
    """Scale so that the shorter side reaches ``size`` (``max(size / h, size / w)``), the
    new sides truncated by ``int``."""

    def __init__(self, size: int = 224):
        self.size = int(size)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        scale = max(self.size / h, self.size / w)
        if scale != 1.0:
            image = resize(image, (int(h * scale), int(w * scale)))
        return image, ProcessingMetadata(scale=scale, original_hw=(h, w))


class CenterCrop(Processing):
    """The centred ``size`` x ``size`` crop."""

    def __init__(self, size: int = 224):
        self.size = int(size)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        top, left = (h - self.size) // 2, (w - self.size) // 2
        return image[top : top + self.size, left : left + self.size], ProcessingMetadata(original_hw=(h, w))


class ClassificationResize(Processing):
    """Resize to ``size`` x ``size``, the aspect ratio not kept."""

    def __init__(self, size: int):
        self.size = size

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        return resize(image, (self.size, self.size)), ProcessingMetadata(original_hw=(h, w))


class ClassificationResizeShortestCrop(Processing):
    """Scale the shorter side to ``resize`` (the new sides rounded, where :class:`Resize`
    truncates), then the centred ``crop`` x ``crop``: the ImageNet evaluation geometry."""

    def __init__(self, resize: int = 256, crop: int = 224):
        self.resize, self.crop = resize, crop

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        scale = self.resize / min(h, w)
        image = resize(image, (round(h * scale), round(w * scale)))
        hh, ww = image.shape[:2]
        top, left = (hh - self.crop) // 2, (ww - self.crop) // 2
        return image[top : top + self.crop, left : left + self.crop], ProcessingMetadata(original_hw=(h, w))


class SegmentationResizeWithPadding(Processing):
    """Aspect-preserving resize (the new sides rounded) and centred padding to
    ``output_shape``; the class map is cropped back and resized to the image's size."""

    def __init__(self, output_shape: Sequence[int], pad_value: int = 0):
        self.output_shape = tuple(output_shape)
        self.pad_value = pad_value

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        scale = min(th / h, tw / w)
        if scale != 1.0:
            image = resize(image, (round(h * scale), round(w * scale)))
        hh, ww = image.shape[:2]
        top, left = (th - hh) // 2, (tw - ww) // 2
        out = np.full((th, tw) + image.shape[2:], self.pad_value, dtype=image.dtype)
        out[top : top + hh, left : left + ww] = image
        return out, ProcessingMetadata(scale=scale, original_hw=(h, w), pad_top=top, pad_left=left,
                                       pad_bottom=th - hh - top, pad_right=tw - ww - left)

    def postprocess_segmentation(self, seg_map, meta):
        h, w = seg_map.shape[:2]
        seg = seg_map[meta.pad_top : h - meta.pad_bottom, meta.pad_left : w - meta.pad_right]
        return resize_nearest(seg, meta.original_hw)


class SegmentationRescale(Processing):
    """Aspect-preserving rescale by ``scale_factor``, or so that the short side is
    ``short_size``, or the long side ``long_size`` (the new sides truncated)."""

    def __init__(self, scale_factor: Optional[float] = None, short_size: Optional[int] = None,
                 long_size: Optional[int] = None):
        self.scale_factor, self.short_size, self.long_size = scale_factor, short_size, long_size

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        if self.scale_factor is not None:
            scale = float(self.scale_factor)
        elif self.short_size is not None:
            scale = self.short_size / min(h, w)
        else:
            scale = self.long_size / max(h, w)
        out = resize(image, (int(scale * h), int(scale * w))) if scale != 1.0 else image
        return out, ProcessingMetadata(scale=scale, original_hw=(h, w))

    def postprocess_segmentation(self, seg_map, meta):
        return resize_nearest(seg_map, meta.original_hw)


class SegmentationResize(Processing):
    """Resize to ``output_shape``, the aspect ratio not kept; the class map back to the
    image's size. (The JAX zoo's ``_SegResize`` for non-square inputs does the same.)"""

    def __init__(self, output_shape: Sequence[int]):
        self.output_shape = tuple(output_shape)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        return resize(image, self.output_shape), ProcessingMetadata(original_hw=(h, w))

    def postprocess_segmentation(self, seg_map, meta):
        return resize_nearest(seg_map, meta.original_hw)


class SegmentationPadShortToCropSize(Processing):
    """Centred padding up to ``crop_size`` where a side is shorter; cropped back after."""

    def __init__(self, crop_size, fill_image=0):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, (int, float)) else tuple(crop_size)
        self.fill_image = fill_image

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = max(h, int(self.crop_size[0])), max(w, int(self.crop_size[1]))
        top, left = (th - h) // 2, (tw - w) // 2
        out = np.full((th, tw) + image.shape[2:], self.fill_image, dtype=image.dtype)
        out[top : top + h, left : left + w] = image
        return out, ProcessingMetadata(original_hw=(h, w), pad_top=top, pad_left=left, pad_bottom=th - h - top,
                                       pad_right=tw - w - left)

    def postprocess_segmentation(self, seg_map, meta):
        h, w = seg_map.shape[:2]
        return seg_map[meta.pad_top : h - meta.pad_bottom, meta.pad_left : w - meta.pad_right]


class SegmentationPadToDivisible(Processing):
    """Bottom-right padding to multiples of ``divisible_value``; cropped back after."""

    def __init__(self, divisible_value: int, fill_image=0):
        self.divisible_value = int(divisible_value)
        self.fill_image = fill_image

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        d = self.divisible_value
        th, tw = -(-h // d) * d, -(-w // d) * d
        out = np.full((th, tw) + image.shape[2:], self.fill_image, dtype=image.dtype)
        out[:h, :w] = image
        return out, ProcessingMetadata(original_hw=(h, w), pad_bottom=th - h, pad_right=tw - w)

    def postprocess_segmentation(self, seg_map, meta):
        h, w = seg_map.shape[:2]
        return seg_map[: h - meta.pad_bottom, : w - meta.pad_right]


class ReverseImageChannels(Processing):
    """RGB <-> BGR."""

    def preprocess_image(self, image):
        return image[..., ::-1], ProcessingMetadata(original_hw=image.shape[:2])

    def get_equivalent_photometric_fn(self):
        return lambda x: x.flip(-1)


class ComposeProcessing(Processing):
    """Sequential composition; the metadata is the list of (op, metadata) pairs."""

    def __init__(self, processings: Sequence[Processing]):
        self.processings = list(processings)

    def get_equivalent_photometric_fn(self):
        """The photometric members' functions in order (geometric ones contribute none);
        None when no member has one."""
        fns = [f for f in (p.get_equivalent_photometric_fn() for p in self.processings) if f is not None]
        if not fns:
            return None

        def composed(x):
            for f in fns:
                x = f(x)
            return x

        return composed

    def preprocess_image(self, image):
        metas: List[Tuple[Processing, ProcessingMetadata]] = []
        for p in self.processings:
            image, meta = p.preprocess_image(image)
            metas.append((p, meta))
        return image, metas

    def postprocess_boxes(self, boxes, metas):
        for p, m in reversed(metas):
            boxes = p.postprocess_boxes(boxes, m)
        return boxes

    def postprocess_keypoints(self, kpts, metas):
        for p, m in reversed(metas):
            kpts = p.postprocess_keypoints(kpts, m)
        return kpts

    def postprocess_segmentation(self, seg_map, metas):
        for p, m in reversed(metas):
            seg_map = p.postprocess_segmentation(seg_map, m)
        return seg_map


def default_yolo_nas_coco_processing(image_size: int = 640) -> ComposeProcessing:
    """The published YOLO-NAS COCO processing: LongestMaxSizeRescale(636, 636) +
    CenterPadding(640, 640) + /255 (at image_size 640)."""
    return ComposeProcessing(
        [
            DetectionLongestMaxSizeRescale((image_size - 4, image_size - 4)),
            DetectionCenterPadding((image_size, image_size), 114),
            StandardizeImage(255.0),
        ]
    )


def _coco_class_names() -> List[str]:
    from super_gradients_tpu_torch.models.class_names import COCO_DETECTION_CLASSES_LIST

    return COCO_DETECTION_CLASSES_LIST


def default_yolox_coco_processing_params() -> Dict[str, Any]:
    """The published YOLOX COCO processing parameters: BGR, longest side 640, bottom-right
    padding with 114, raw 0-255 values, IoU 0.65, conf 0.1."""
    return dict(
        class_names=_coco_class_names(),
        image_processor=ComposeProcessing(
            [ReverseImageChannels(), DetectionLongestMaxSizeRescale((640, 640)), DetectionBottomRightPadding((640, 640), 114)]
        ),
        iou=0.65,
        conf=0.1,
    )


def default_ppyoloe_coco_processing_params() -> Dict[str, Any]:
    """The published PP-YOLOE COCO processing parameters: BGR, a direct resize to 640x640,
    the mean and std of 0-255 values, IoU 0.65, conf 0.5."""
    return dict(
        class_names=_coco_class_names(),
        image_processor=ComposeProcessing(
            [
                ReverseImageChannels(),
                DetectionRescale((640, 640)),
                NormalizeImage(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
            ]
        ),
        iou=0.65,
        conf=0.5,
    )


def default_yolo_nas_coco_processing_params() -> Dict[str, Any]:
    """The published YOLO-NAS COCO processing parameters: :func:`default_yolo_nas_coco_processing`
    at 640, IoU 0.7, conf 0.25."""
    return dict(class_names=_coco_class_names(), image_processor=default_yolo_nas_coco_processing(640), iou=0.7,
                conf=0.25)


IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


def default_imagenet_processing(resize: int = 256, crop: int = 224) -> ComposeProcessing:
    """What ``models.get("resnet*")`` predicts with: the shorter side to 256, the centred
    224 crop, /255, then the ImageNet mean and std."""
    return ComposeProcessing(
        [
            ClassificationResizeShortestCrop(resize, crop),
            StandardizeImage(255.0),
            NormalizeImage(mean=IMAGENET_MEAN, std=IMAGENET_STD),
        ]
    )


def default_imagenet_processing_params() -> Dict[str, Any]:
    """The published ImageNet processing parameters: :class:`Resize` (256), :class:`CenterCrop`
    (224), /255 and the ImageNet mean and std."""
    return dict(
        image_processor=ComposeProcessing(
            [Resize(256), CenterCrop(224), StandardizeImage(255.0), NormalizeImage(mean=IMAGENET_MEAN, std=IMAGENET_STD)]
        ),
    )


# the COCO skeleton as the pose processing parameters draw it, one colour a link and a joint
COCO_POSE_DEFAULT_EDGE_LINKS = [
    [0, 1], [0, 2], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 6], [5, 7], [5, 11],
    [6, 8], [6, 12], [7, 9], [8, 10], [11, 12], [11, 13], [12, 14], [13, 15], [14, 16],
]
COCO_POSE_DEFAULT_EDGE_COLORS = [
    (214, 39, 40), (148, 103, 189), (44, 160, 44), (140, 86, 75), (227, 119, 194),
    (127, 127, 127), (188, 189, 34), (127, 127, 127), (188, 189, 34), (140, 86, 75),
    (23, 190, 207), (227, 119, 194), (31, 119, 180), (255, 127, 14), (148, 103, 189),
    (255, 127, 14), (214, 39, 40), (31, 119, 180), (44, 160, 44),
]
COCO_POSE_DEFAULT_KEYPOINT_COLORS = [(148, 103, 189), (31, 119, 180)] * 8 + [(148, 103, 189)]


def default_yolo_nas_pose_coco_processing_params() -> Dict[str, Any]:
    """The published YOLO-NAS-POSE COCO processing parameters: BGR, longest side 640,
    bottom-right padding with 127, /255, conf 0.5 and the COCO skeleton's colours.
    (``models.get("yolo_nas_pose_*")`` predicts with
    :func:`default_yolo_nas_coco_processing`, as the JAX zoo does.)"""
    return dict(
        image_processor=ComposeProcessing(
            [
                ReverseImageChannels(),
                KeypointsLongestMaxSizeRescale((640, 640)),
                KeypointsBottomRightPadding((640, 640), 127),
                StandardizeImage(255.0),
            ]
        ),
        conf=0.5,
        edge_links=COCO_POSE_DEFAULT_EDGE_LINKS,
        edge_colors=COCO_POSE_DEFAULT_EDGE_COLORS,
        keypoint_colors=COCO_POSE_DEFAULT_KEYPOINT_COLORS,
    )


def default_segmentation_processing(input_hw: Tuple[int, int]) -> ComposeProcessing:
    """What ``models.get`` of a segmentation model predicts with: a resize to ``input_hw``
    (:class:`ClassificationResize` when square, else :class:`SegmentationResize`), /255,
    then the ImageNet mean and std."""
    h, w = input_hw
    return ComposeProcessing(
        [
            ClassificationResize(h) if h == w else SegmentationResize((h, w)),
            StandardizeImage(255.0),
            NormalizeImage(mean=IMAGENET_MEAN, std=IMAGENET_STD),
        ]
    )


def default_cityscapes_processing_params(scale: float = 1.0) -> Dict[str, Any]:
    """The published Cityscapes processing parameters: resize with padding to
    ``scale * (1024, 2048)``, the ImageNet mean and std, then /255 (in this order, as the
    JAX package composes them)."""
    from super_gradients_tpu_torch.models.class_names import CITYSCAPES_CLASSES_LIST

    return dict(
        class_names=CITYSCAPES_CLASSES_LIST,
        image_processor=ComposeProcessing(
            [
                SegmentationResizeWithPadding((int(1024 * scale), int(2048 * scale)), pad_value=0),
                NormalizeImage(mean=IMAGENET_MEAN, std=IMAGENET_STD),
                StandardizeImage(255.0),
            ]
        ),
    )


def get_pretrained_processing_params(model_name: str, pretrained_weights: str) -> Dict[str, Any]:
    """The processing parameters a published checkpoint was evaluated with (the JAX
    package's table, for the families the port registers; ``{}`` where it names none)."""
    if pretrained_weights == "coco":
        if "yolox" in model_name:
            return default_yolox_coco_processing_params()
        if "ppyoloe" in model_name or "pp_yoloe" in model_name:
            return default_ppyoloe_coco_processing_params()
        if "yolo_nas" in model_name:
            return default_yolo_nas_coco_processing_params()
    if pretrained_weights == "coco_pose" and model_name.startswith("yolo_nas_pose"):
        return default_yolo_nas_pose_coco_processing_params()
    if pretrained_weights == "imagenet":
        return default_imagenet_processing_params()
    if pretrained_weights == "cityscapes":
        if model_name in {"pp_lite_t_seg75", "pp_lite_b_seg75", "stdc1_seg75", "stdc2_seg75"}:
            return default_cityscapes_processing_params(0.75)
        if model_name in {"pp_lite_t_seg50", "pp_lite_b_seg50", "stdc1_seg50", "stdc2_seg50"}:
            return default_cityscapes_processing_params(0.50)
    return {}
