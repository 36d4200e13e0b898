"""SgModel / DetectionModel / PoseEstimationModel / ClassificationModel / SegmentationModel: an ``nn.Module`` +
task metadata with a predict() surface (counterpart of ``super_gradients_tpu/models/sg_model.py``).

The JAX package compiles preprocess-forward-decode-NMS into one XLA program per
shape. Here the same steps run eagerly: host processing per image (numpy), then
per batch one forward of the deploy-form network on the model's device, the
fp32 decode, and ``batched_nms`` (detection) or ``batched_pose_nms`` (pose) whose
exact mode is the hand-written CUDA kernel K1 on a GPU; classification takes a softmax on
the device and the top-k on the host; segmentation an argmax on the device. ``predict`` takes arrays, PIL
images, image files, folders and video files (``predict_video``); ``predict_webcam``
runs on a capture device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from super_gradients_tpu_torch.inference.media import images_to_list
from super_gradients_tpu_torch.inference.prediction_results import (
    ClassificationPrediction,
    DetectionPrediction,
    ImagesPredictions,
    PoseEstimationPrediction,
    SegmentationPrediction,
    VideoPredictions,
)
from super_gradients_tpu_torch.inference.processing import Processing
from super_gradients_tpu_torch.inference.video import includes_video_extension, lazy_load_video
from super_gradients_tpu_torch.models.detection.yolo_nas import YoloNASOutputs
from super_gradients_tpu_torch.modules.blocks import QARepVGGBlock, RepVGGBlock
from super_gradients_tpu_torch.ops.nms import NMSOutput, PoseNMSOutput, batched_nms, batched_pose_nms


class SgModel:
    """A network in eval mode on one device, with its processing and class names.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is visible; pass
    ``device="cpu"`` to run on the CPU.
    """

    task: str = "generic"

    def __init__(
        self,
        name: str,
        net: nn.Module,
        num_classes: Optional[int] = None,
        config: Any = None,
        processing: Optional[Processing] = None,
        class_names: Optional[List[str]] = None,
        device="cuda",
        input_hw: Tuple[int, int] = (224, 224),
    ):
        self.name = name
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(..., device='{self.device}'): CUDA is not available; "
                               f"pass device='cpu' to run on the CPU")
        self.net = net.to(self.device).eval()
        self.num_classes = num_classes
        self.config = config
        self._processing = processing
        self._class_names = class_names
        self._input_hw = tuple(input_hw)  # the size an export takes unless told another
        self._deploy_nets: Dict[Tuple[bool, bool], nn.Module] = {}  # derived from net's weights

    @property
    def class_names(self) -> Optional[List[str]]:
        return self._class_names

    def num_params(self) -> int:
        return sum(p.numel() for p in self.net.parameters())

    def replace_head(self, new_num_classes: int, seed: int = 0) -> "SgModel":
        """A NEW model of ``new_num_classes`` whose backbone and neck are this model's, bit
        for bit; only the class-dependent head tensors are drawn anew from ``seed``."""
        from super_gradients_tpu_torch.models.model_factory import replace_head

        return replace_head(self, new_num_classes, seed=seed)

    def set_dataset_processing_params(
        self,
        class_names: Optional[List[str]] = None,
        image_processor: Optional[Processing] = None,
        conf: Optional[float] = None,
        iou: Optional[float] = None,
        edge_links=None,
        edge_colors=None,
        keypoint_colors=None,
        **kwargs,
    ) -> None:
        """Attach a dataset's inference parameters: class names, the preprocessing, the NMS
        conf and IoU defaults, the pose skeleton and its colours (``None`` keeps a value)."""
        if class_names is not None:
            self._class_names = list(class_names)
        if image_processor is not None:
            self._processing = image_processor
        if conf is not None:
            self._default_nms_conf = float(conf)
        if iou is not None:
            self._default_nms_iou = float(iou)
        if edge_links is not None:
            self._edge_links = edge_links
        if edge_colors is not None:
            self._edge_colors = edge_colors
        if keypoint_colors is not None:
            self._keypoint_colors = keypoint_colors
        self._deploy_nets.clear()

    def get_processing_params(self) -> Optional[Processing]:
        return self._processing

    def predict(self, images, **kwargs):
        raise NotImplementedError(f"predict() is not implemented for task `{self.task}`")

    def export(self, output_path: str, **kwargs):
        """Write the fused inference program of this model's task to a ``torch.export``
        artifact (``conversion/export.py``): detection, pose estimation or segmentation."""
        from super_gradients_tpu_torch.conversion import export as export_mod

        fn = {
            "detection": export_mod.export_detection_model,
            "pose_estimation": export_mod.export_pose_estimation_model,
            "segmentation": export_mod.export_segmentation_model,
        }.get(self.task)
        if fn is None:
            raise NotImplementedError(f"export() is not supported for task `{self.task}`")
        return fn(self, output_path, **kwargs)

    def predict_video(self, video_path: str, batch_size: int = 32, max_frames: Optional[int] = None,
                      **kwargs) -> VideoPredictions:
        """``predict`` over a video file's frames, read lazily in chunks of ``batch_size``;
        the result's ``save()`` writes the drawn video at the source frame rate."""
        frames, fps, _ = lazy_load_video(video_path, max_frames)
        preds: list = []
        buf: list = []
        for f in frames:
            buf.append(f)
            if len(buf) == batch_size:
                preds.extend(self.predict(buf, batch_size=batch_size, **kwargs))
                buf = []
        if buf:
            preds.extend(self.predict(buf, batch_size=batch_size, **kwargs))
        return VideoPredictions(preds, fps)

    def predict_webcam(self, capture: int = 0, **kwargs) -> None:
        """Predict and draw each frame of a capture device live; ``q`` quits."""
        from super_gradients_tpu_torch.inference.stream import WebcamStreaming

        def process(frame):
            return self.predict([frame], batch_size=1, **kwargs)[0].draw()

        WebcamStreaming(window_name=f"{type(self).__name__} predictions", frame_processing_fn=process,
                        capture=capture).run()

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load new weights into ``net`` (strict) and drop every copy derived from the
        old ones (counterpart of the JAX ``SgModel.update_variables``). ``Trainer.train``
        hands its weights back through this method only."""
        self.net.load_state_dict(state_dict, strict=True)
        self._deploy_nets.clear()

    def fuse(self) -> "SgModel":
        """A NEW model of the same task whose every QARepVGG and RepVGG block is
        re-parameterized to its deploy form (one 3x3 conv); this model is left as it is.
        A config without ``fused`` (YOLOX: no such blocks) returns this model."""
        if getattr(self.config, "fused", True):
            return self
        net = copy.deepcopy(self.net)
        for module in net.modules():
            if isinstance(module, (QARepVGGBlock, RepVGGBlock)):
                module.fuse_()
        fused = copy.copy(self)
        fused.name = self.name + "_fused"
        fused.net = net.eval()
        fused.config = dataclasses.replace(self.config, fused=True)
        fused._deploy_nets = {}
        return fused

    def _deploy_net(self, fuse_model: bool, bf16: bool) -> nn.Module:
        """Deploy form of the network: optionally fused and bf16, channels_last on CUDA."""
        key = (fuse_model, bf16)
        if key not in self._deploy_nets:
            net = self.fuse().net if fuse_model else self.net
            if bf16 or self.device.type == "cuda":
                net = copy.deepcopy(net) if net is self.net else net
                if bf16:
                    net = net.to(torch.bfloat16)
                if self.device.type == "cuda":
                    net = net.to(memory_format=torch.channels_last)
            self._deploy_nets[key] = net.eval()
        return self._deploy_nets[key]

    def _prep_host_batches(self, images, batch_size: int, pad_last: bool = False):
        """Host side: geometric + photometric preprocessing per image, grouped in batches;
        with ``pad_last`` the last batch is filled up to ``batch_size`` with zero images."""
        image_list = images_to_list(images)
        processed, metas = [], []
        for img in image_list:
            if self._processing is not None:
                out, meta = self._processing.preprocess_image(img)
            else:
                out, meta = img, None
            processed.append(np.asarray(out, dtype=np.float32))
            metas.append(meta)
        if pad_last and len(processed) % batch_size:
            processed += [np.zeros_like(processed[0])] * (batch_size - len(processed) % batch_size)
        batches = [np.stack(processed[i : i + batch_size]) for i in range(0, len(processed), batch_size)]
        return image_list, batches, metas


class DetectionModel(SgModel):
    """Detection task wrapper: forward + decode + NMS predict path."""

    task = "detection"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # defaults mirror CustomizableDetector (customizable_detector.py:84-92)
        self._default_nms_iou = 0.7
        self._default_nms_conf = 0.25
        self._default_nms_top_k = 1024
        self._default_max_predictions = 300
        self._default_multi_label_per_box = True
        self._default_class_agnostic_nms = False

    @torch.inference_mode()
    def _predict_tensor(self, images, conf, iou, nms_top_k, max_predictions, multi_label, class_agnostic, nms_mode,
                        fuse_model, bf16, prefilter) -> NMSOutput:
        net = self._deploy_net(fuse_model, bf16)
        images = torch.as_tensor(images)
        # an NHWC tensor permuted to NCHW is already in channels_last memory order
        x = images.to(self.device, torch.bfloat16 if bf16 else torch.float32).permute(0, 3, 1, 2)
        outputs = net(x)
        # YoloNASOutputs (YOLO-NAS, PP-YOLOE) score sigmoid(cls_logits): NMS prefilters on
        # the logits and applies the sigmoid to the gathered candidates only (see
        # ops/nms.py); every other output (YOLOX's obj * cls product) suppresses on its
        # score map, as the JAX predict program chooses by the output's type
        use_logits = isinstance(outputs, YoloNASOutputs)
        return batched_nms(
            outputs.pred_bboxes, outputs.cls_logits if use_logits else outputs.pred_scores, score_threshold=conf,
            iou_threshold=iou, nms_top_k=nms_top_k, max_predictions=max_predictions, multi_label=multi_label,
            class_agnostic=class_agnostic, mode=nms_mode, prefilter=prefilter, scores_are_logits=use_logits,
        )

    def predict(
        self,
        images,
        iou: Optional[float] = None,
        conf: Optional[float] = None,
        batch_size: int = 8,
        max_predictions: Optional[int] = None,
        nms_top_k: Optional[int] = None,
        multi_label_per_box: Optional[bool] = None,
        class_agnostic_nms: Optional[bool] = None,
        nms_mode: str = "exact",
        fuse_model: bool = True,
        bf16: bool = True,
        nms_prefilter: str = "two_stage",
    ) -> ImagesPredictions:
        """Predict on RGB images of any sizes: an HWC / NHWC array, a PIL image, an image
        file, a folder of them or a list of these (``inference/media.py``), or a video file
        (``predict_video``, a :class:`VideoPredictions`).

        Returns per-image :class:`DetectionPrediction`s in original-image pixels.
        """
        if isinstance(images, str) and includes_video_extension(images):
            return self.predict_video(
                images, batch_size=batch_size, iou=iou, conf=conf, max_predictions=max_predictions,
                nms_top_k=nms_top_k, multi_label_per_box=multi_label_per_box, class_agnostic_nms=class_agnostic_nms,
                nms_mode=nms_mode, fuse_model=fuse_model, bf16=bf16,
            )
        iou = iou if iou is not None else self._default_nms_iou
        conf = conf if conf is not None else self._default_nms_conf
        max_predictions = max_predictions or self._default_max_predictions
        nms_top_k = nms_top_k or self._default_nms_top_k
        multi_label = self._default_multi_label_per_box if multi_label_per_box is None else multi_label_per_box
        class_agnostic = self._default_class_agnostic_nms if class_agnostic_nms is None else class_agnostic_nms

        image_list, batches, metas = self._prep_host_batches(images, batch_size)
        predictions: List[DetectionPrediction] = []
        for batch in batches:
            out = self._predict_tensor(torch.from_numpy(batch), conf, iou, nms_top_k, max_predictions, multi_label,
                                       class_agnostic, nms_mode, fuse_model, bf16, nms_prefilter)
            boxes, scores, labels, nums = (t.cpu().numpy() for t in out)
            for j in range(len(batch)):
                idx = len(predictions)
                n = int(nums[j])
                b = boxes[j, :n]
                if metas[idx] is not None:
                    b = self._processing.postprocess_boxes(b.copy(), metas[idx])
                h, w = image_list[idx].shape[:2]
                b[:, 0::2] = np.clip(b[:, 0::2], 0, w)
                b[:, 1::2] = np.clip(b[:, 1::2], 0, h)
                predictions.append(DetectionPrediction(
                    bboxes_xyxy=b, confidence=scores[j, :n], labels=labels[j, :n],
                    class_names=self._class_names, image=image_list[idx],
                ))
        return ImagesPredictions(predictions)

    def predict_batch_tensor(self, images, **kwargs) -> NMSOutput:
        """Raw path for uniform pre-sized, standardized input ``[B, H, W, 3]`` (bench/serving)."""
        return self._predict_tensor(
            images,
            kwargs.get("conf", self._default_nms_conf),
            kwargs.get("iou", self._default_nms_iou),
            kwargs.get("nms_top_k", self._default_nms_top_k),
            kwargs.get("max_predictions", self._default_max_predictions),
            kwargs.get("multi_label_per_box", self._default_multi_label_per_box),
            kwargs.get("class_agnostic_nms", self._default_class_agnostic_nms),
            kwargs.get("nms_mode", "exact"),
            kwargs.get("fuse_model", True),
            kwargs.get("bf16", True),
            "two_stage",
        )


class PoseEstimationModel(SgModel):
    """Pose task wrapper: forward + decode + pose NMS predict path (defaults of the JAX
    ``PoseEstimationModel``: conf 0.5, IoU 0.7, 1024 candidates before NMS, 30 after)."""

    task = "pose_estimation"

    def __init__(self, *args, edge_links=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._edge_links = edge_links
        self._default_nms_conf = 0.5
        self._default_nms_iou = 0.7
        self._default_pre_nms_max_predictions = 1024
        self._default_post_nms_max_predictions = 30

    @torch.inference_mode()
    def _predict_tensor(self, images, conf, iou, nms_top_k, max_predictions, nms_mode, fuse_model,
                        bf16) -> PoseNMSOutput:
        net = self._deploy_net(fuse_model, bf16)
        images = torch.as_tensor(images)
        # an NHWC tensor permuted to NCHW is already in channels_last memory order
        x = images.to(self.device, torch.bfloat16 if bf16 else torch.float32).permute(0, 3, 1, 2)
        out = net(x)
        return batched_pose_nms(
            out.pred_bboxes, out.pred_scores, out.pred_pose_coords, out.pred_pose_scores, score_threshold=conf,
            iou_threshold=iou, nms_top_k=nms_top_k, max_predictions=max_predictions, mode=nms_mode,
        )

    def predict(
        self,
        images,
        conf: Optional[float] = None,
        iou: Optional[float] = None,
        batch_size: int = 8,
        max_predictions: Optional[int] = None,
        pre_nms_max_predictions: Optional[int] = None,
        nms_mode: str = "exact",
        bf16: bool = True,
        fuse_model: bool = True,
    ) -> ImagesPredictions:
        """Predict poses on RGB images of any sizes (the inputs of
        :meth:`DetectionModel.predict`, a video file included).

        Returns per-image :class:`PoseEstimationPrediction`s: poses ``[N, J, 3]`` and
        boxes in original-image pixels (not clipped, as in the JAX package).
        """
        if isinstance(images, str) and includes_video_extension(images):
            return self.predict_video(
                images, batch_size=batch_size, conf=conf, iou=iou, max_predictions=max_predictions,
                pre_nms_max_predictions=pre_nms_max_predictions, nms_mode=nms_mode, bf16=bf16,
                fuse_model=fuse_model,
            )
        conf = conf if conf is not None else self._default_nms_conf
        iou = iou if iou is not None else self._default_nms_iou
        max_predictions = max_predictions or self._default_post_nms_max_predictions
        nms_top_k = pre_nms_max_predictions or self._default_pre_nms_max_predictions

        image_list, batches, metas = self._prep_host_batches(images, batch_size)
        predictions: List[PoseEstimationPrediction] = []
        for batch in batches:
            out = self._predict_tensor(torch.from_numpy(batch), conf, iou, nms_top_k, max_predictions, nms_mode,
                                       fuse_model, bf16)
            poses, boxes, scores, nums = (t.cpu().numpy() for t in out)
            for j in range(len(batch)):
                idx = len(predictions)
                n = int(nums[j])
                pj, bj = poses[j, :n].copy(), boxes[j, :n].copy()
                if metas[idx] is not None:
                    pj = self._processing.postprocess_keypoints(pj, metas[idx])
                    bj = self._processing.postprocess_boxes(bj, metas[idx])
                predictions.append(PoseEstimationPrediction(
                    poses=pj, scores=scores[j, :n], bboxes_xyxy=bj, edge_links=self._edge_links, image=image_list[idx],
                ))
        return ImagesPredictions(predictions)

    def predict_batch_tensor(self, images, conf: Optional[float] = None, iou: Optional[float] = None,
                             nms_top_k: Optional[int] = None, max_predictions: Optional[int] = None,
                             nms_mode: str = "exact", bf16: bool = True, fuse_model: bool = True) -> PoseNMSOutput:
        """Raw path for uniform pre-sized, standardized input ``[B, H, W, 3]`` (bench/serving)."""
        return self._predict_tensor(
            images,
            conf if conf is not None else self._default_nms_conf,
            iou if iou is not None else self._default_nms_iou,
            nms_top_k or self._default_pre_nms_max_predictions,
            max_predictions or self._default_post_nms_max_predictions,
            nms_mode, fuse_model, bf16,
        )


class ClassificationModel(SgModel):
    """Classification task wrapper: an fp32 forward in eval mode, the softmax on the device
    and the top-k on the host (``np.argsort(-probs)``, as the JAX model ranks them)."""

    task = "classification"

    @torch.inference_mode()
    def _probabilities(self, images) -> torch.Tensor:
        net = self._deploy_net(False, False)
        x = torch.as_tensor(images).to(self.device, torch.float32).permute(0, 3, 1, 2)
        return torch.softmax(net(x), dim=-1)

    def predict(self, images, batch_size: int = 32, top_k: int = 5) -> ImagesPredictions:
        """Predict on RGB images of any sizes (an HWC / NHWC array, a PIL image, an image
        file, a folder of them or a list of these). The last batch is filled up with zero
        images, as in the JAX package. Returns per-image :class:`ClassificationPrediction`s
        of the ``top_k`` most probable classes."""
        image_list, batches, _ = self._prep_host_batches(images, batch_size, pad_last=True)
        predictions: List[ClassificationPrediction] = []
        for batch in batches:
            probs = self._probabilities(torch.from_numpy(batch)).cpu().numpy()
            for j in range(min(len(batch), len(image_list) - len(predictions))):
                order = np.argsort(-probs[j])[:top_k]
                predictions.append(ClassificationPrediction(
                    confidence=probs[j][order], labels=order, class_names=self._class_names,
                    image=image_list[len(predictions)],
                ))
        return ImagesPredictions(predictions)


def smallest_int_dtype(num_classes: int) -> torch.dtype:
    """The narrowest torch integer type that holds the class ids ``0 .. num_classes - 1``."""
    if num_classes <= 256:
        return torch.uint8
    return torch.int16 if num_classes <= 2**15 else torch.int32


class SegmentationModel(SgModel):
    """Segmentation task wrapper: an fp32 forward in eval mode and the argmax over classes on
    the device; the class map comes to the host in the narrowest integer type and is undone
    to the image's size by the processing (as the JAX model: no fuse, no bf16)."""

    task = "segmentation"

    @torch.inference_mode()
    def _class_maps(self, images) -> torch.Tensor:
        net = self._deploy_net(False, False)
        x = torch.as_tensor(images).to(self.device, torch.float32).permute(0, 3, 1, 2)
        logits = net(x)
        return logits.argmax(dim=1).to(smallest_int_dtype(logits.shape[1]))

    def predict(self, images, batch_size: int = 4) -> ImagesPredictions:
        """Predict on RGB images of any sizes (an HWC / NHWC array, a PIL image, an image
        file, a folder of them or a list of these). The last batch is filled up with zero
        images, as in the JAX package. Returns per-image :class:`SegmentationPrediction`s
        whose maps have the image's size: int32 where no resize was needed, else uint8 (the
        JAX package's types)."""
        image_list, batches, metas = self._prep_host_batches(images, batch_size, pad_last=True)
        predictions: List[SegmentationPrediction] = []
        for batch in batches:
            maps = self._class_maps(torch.from_numpy(batch)).cpu().numpy()
            for j in range(min(len(batch), len(image_list) - len(predictions))):
                idx = len(predictions)
                seg = maps[j].astype(np.int32)
                h, w = image_list[idx].shape[:2]
                if metas[idx] is not None and self._processing is not None:
                    seg = self._processing.postprocess_segmentation(seg, metas[idx])
                if seg.shape != (h, w):  # no processing, or one that does not undo the resize
                    from PIL import Image

                    seg = np.asarray(Image.fromarray(seg.astype(np.uint8)).resize((w, h), Image.NEAREST))
                predictions.append(SegmentationPrediction(segmentation_map=seg, class_names=self._class_names,
                                                          image=image_list[idx]))
        return ImagesPredictions(predictions)
