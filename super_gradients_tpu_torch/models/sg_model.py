"""SgModel / DetectionModel: an ``nn.Module`` + task metadata with a predict() surface
(counterpart of ``super_gradients_tpu/models/sg_model.py``).

The JAX package compiles preprocess-forward-decode-NMS into one XLA program per
shape. Here the same steps run eagerly: host processing per image (numpy), then
per batch one forward of the deploy-form network on the model's device, the
fp32 decode, and ``batched_nms`` whose exact mode is the hand-written CUDA
kernel K1 on a GPU. ``predict`` takes arrays, PIL images, image files, folders and
video files (``predict_video``); ``predict_webcam`` runs on a capture device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from super_gradients_tpu_torch.inference.media import images_to_list
from super_gradients_tpu_torch.inference.prediction_results import (
    DetectionPrediction,
    ImagesPredictions,
    VideoPredictions,
)
from super_gradients_tpu_torch.inference.processing import Processing
from super_gradients_tpu_torch.inference.video import includes_video_extension, lazy_load_video
from super_gradients_tpu_torch.modules.blocks import QARepVGGBlock
from super_gradients_tpu_torch.ops.nms import NMSOutput, batched_nms


class SgModel:
    """A network in eval mode on one device, with its processing and class names."""

    task: str = "generic"

    def __init__(
        self,
        name: str,
        net: nn.Module,
        num_classes: Optional[int] = None,
        config: Any = None,
        processing: Optional[Processing] = None,
        class_names: Optional[List[str]] = None,
        device: torch.device = torch.device("cpu"),
    ):
        self.name = name
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()
        self.num_classes = num_classes
        self.config = config
        self._processing = processing
        self._class_names = class_names
        self._deploy_nets: Dict[Tuple[bool, bool], nn.Module] = {}  # derived from net's weights

    def predict(self, images, **kwargs):
        raise NotImplementedError(f"predict() is not implemented for task `{self.task}`")

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

    def _prep_host_batches(self, images, batch_size: int):
        """Host side: geometric + photometric preprocessing per image, grouped in batches."""
        image_list = images_to_list(images)
        processed, metas = [], []
        for img in image_list:
            if self._processing is not None:
                out, meta = self._processing.preprocess_image(img)
            else:
                out, meta = img, None
            processed.append(np.asarray(out, dtype=np.float32))
            metas.append(meta)
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

    def fuse(self) -> "DetectionModel":
        """A NEW DetectionModel whose every QARepVGG block is re-parameterized to
        its deploy form (one 3x3 conv); this model is left as it is."""
        if getattr(self.config, "fused", True):
            return self
        import dataclasses

        net = copy.deepcopy(self.net)
        for module in net.modules():
            if isinstance(module, QARepVGGBlock):
                module.fuse_()
        return DetectionModel(
            name=self.name + "_fused", net=net, num_classes=self.num_classes,
            config=dataclasses.replace(self.config, fused=True), processing=self._processing,
            class_names=self._class_names, device=self.device,
        )

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

    @torch.inference_mode()
    def _predict_tensor(self, images, conf, iou, nms_top_k, max_predictions, multi_label, class_agnostic, nms_mode,
                        fuse_model, bf16, prefilter) -> NMSOutput:
        net = self._deploy_net(fuse_model, bf16)
        images = torch.as_tensor(images)
        # an NHWC tensor permuted to NCHW is already in channels_last memory order
        x = images.to(self.device, torch.bfloat16 if bf16 else torch.float32).permute(0, 3, 1, 2)
        outputs = net(x)
        # YOLO-NAS scores are sigmoid(cls_logits): NMS prefilters on the logits and
        # applies the sigmoid to the gathered candidates only (see ops/nms.py)
        return batched_nms(
            outputs.pred_bboxes, outputs.cls_logits, score_threshold=conf, iou_threshold=iou, nms_top_k=nms_top_k,
            max_predictions=max_predictions, multi_label=multi_label, class_agnostic=class_agnostic, mode=nms_mode,
            prefilter=prefilter, scores_are_logits=True,
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
