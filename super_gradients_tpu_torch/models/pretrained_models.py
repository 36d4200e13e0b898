"""The published checkpoints (the JAX package's ``models/pretrained_models.py``, a copy).

``models.get(..., pretrained_weights="coco")`` reads them from a local mirror:
``$SG_PRETRAINED_DIR`` (else ``~/.cache/sg_tpu/pretrained``) holding the ``.pth`` files
under the basenames of their URLs, in the original super-gradients layout. Nothing is
downloaded; without the file the error names the URL to fetch.
"""

from __future__ import annotations

import os
from typing import Optional

MODEL_URLS = {
    "beit_base_patch16_224_cifar10": "https://sg-hub-nv.s3.amazonaws.com/models/beit_base_patch16_224_cifar10.pth",
    "beit_base_patch16_224_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/beit_base_patch16_224_imagenet.pth",
    "ddrnet_23_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/ddrnet_23_cityscapes.pth",
    "ddrnet_23_slim_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/ddrnet_23_slim_cityscapes.pth",
    "ddrnet_39_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/ddrnet_39_cityscapes.pth",
    "dekr_w32_no_dc_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/dekr_w32_no_dc_coco_pose.pth",
    "efficientnet_b0_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/efficientnet_b0_imagenet.pth",
    "mobilenet_v2_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/mobilenet_v2_imagenet.pth",
    "mobilenet_v3_large_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/mobilenet_v3_large_imagenet.pth",
    "mobilenet_v3_small_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/mobilenet_v3_small_imagenet.pth",
    "pose_rescoring_coco_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/pose_rescoring_coco_coco_pose.pth",
    "pp_lite_b_seg50_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/pp_lite_b_seg50_cityscapes.pth",
    "pp_lite_b_seg75_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/pp_lite_b_seg75_cityscapes.pth",
    "pp_lite_t_seg50_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/pp_lite_t_seg50_cityscapes.pth",
    "pp_lite_t_seg75_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/pp_lite_t_seg75_cityscapes.pth",
    "ppyoloe_l_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ppyoloe_l_coco.pth",
    "ppyoloe_m_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ppyoloe_m_coco.pth",
    "ppyoloe_s_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ppyoloe_s_coco.pth",
    "ppyoloe_x_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ppyoloe_x_coco.pth",
    "regnetY200_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/regnetY200_imagenet.pth",
    "regnetY400_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/regnetY400_imagenet.pth",
    "regnetY600_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/regnetY600_imagenet.pth",
    "regnetY800_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/regnetY800_imagenet.pth",
    "regseg48_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/regseg48_cityscapes.pth",
    "repvgg_a0_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/repvgg_a0_imagenet.pth",
    "resnet18_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/resnet18_imagenet.pth",
    "resnet34_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/resnet34_imagenet.pth",
    "resnet50_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/resnet50_imagenet.pth",
    "segformer_b0_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b0_cityscapes.pth",
    "segformer_b1_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b1_cityscapes.pth",
    "segformer_b2_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b2_cityscapes.pth",
    "segformer_b3_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b3_cityscapes.pth",
    "segformer_b4_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b4_cityscapes.pth",
    "segformer_b5_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/segformer_b5_cityscapes.pth",
    "shelfnet34_lw_coco_segmentation_subclass": "https://sg-hub-nv.s3.amazonaws.com/models/shelfnet34_lw_coco_segmentation_subclass.pth",
    "ssd_lite_mobilenet_v2_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ssd_lite_mobilenet_v2_coco.pth",
    "ssd_mobilenet_v1_coco": "https://sg-hub-nv.s3.amazonaws.com/models/ssd_mobilenet_v1_coco.pth",
    "stdc1_seg50_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/stdc1_seg50_cityscapes.pth",
    "stdc1_seg75_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/stdc1_seg75_cityscapes.pth",
    "stdc2_seg50_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/stdc2_seg50_cityscapes.pth",
    "stdc2_seg75_cityscapes": "https://sg-hub-nv.s3.amazonaws.com/models/stdc2_seg75_cityscapes.pth",
    "vit_base_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/vit_base_imagenet.pth",
    "vit_base_imagenet21k": "https://sg-hub-nv.s3.amazonaws.com/models/vit_base_imagenet21k.pth",
    "vit_large_imagenet": "https://sg-hub-nv.s3.amazonaws.com/models/vit_large_imagenet.pth",
    "vit_large_imagenet21k": "https://sg-hub-nv.s3.amazonaws.com/models/vit_large_imagenet21k.pth",
    "yolo_nas_l_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_l_coco.pth",
    "yolo_nas_m_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_m_coco.pth",
    "yolo_nas_pose_l_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_pose_l_coco_pose.pth",
    "yolo_nas_pose_m_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_pose_m_coco_pose.pth",
    "yolo_nas_pose_n_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_pose_n_coco_pose.pth",
    "yolo_nas_pose_s_coco_pose": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_pose_s_coco_pose.pth",
    "yolo_nas_s_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_s_coco.pth",
    "yolox_l_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolox_l_coco.pth",
    "yolox_m_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolox_m_coco.pth",
    "yolox_n_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolox_n_coco.pth",
    "yolox_s_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolox_s_coco.pth",
    "yolox_t_coco": "https://sg-hub-nv.s3.amazonaws.com/models/yolox_t_coco.pth",
}

# dataset tag -> class count of the pretraining head
PRETRAINED_NUM_CLASSES = {
    "cifar10": 10,
    "cityscapes": 19,
    "coco": 80,
    "coco_pose": 17,
    "coco_segmentation_subclass": 21,
    "imagenet": 1000,
    "imagenet21k": 21843,
}


def pretrained_key(model_name: str, dataset_tag: str) -> str:
    return f"{model_name}_{dataset_tag}"


def get_pretrained_url(model_name: str, dataset_tag: str) -> Optional[str]:
    return MODEL_URLS.get(pretrained_key(model_name, dataset_tag))


def resolve_pretrained_path(model_name: str, dataset_tag: str) -> str:
    """The mirror's file for ``model_name`` and ``dataset_tag``; raises naming the URL when it is absent."""
    key = pretrained_key(model_name, dataset_tag)
    url = MODEL_URLS.get(key)
    if url is None:
        raise ValueError(
            f"no pretrained weights published for `{key}`; known tags for this model: "
            + ", ".join(k[len(model_name) + 1:] for k in MODEL_URLS if k.startswith(model_name + "_"))
        )
    mirror = os.environ.get("SG_PRETRAINED_DIR", os.path.expanduser("~/.cache/sg_tpu/pretrained"))
    path = os.path.join(mirror, os.path.basename(url))
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        f"pretrained checkpoint for `{key}` not found at {path}. Nothing is downloaded: "
        f"fetch {url} and place it in $SG_PRETRAINED_DIR ({mirror}), or pass checkpoint_path= directly."
    )
