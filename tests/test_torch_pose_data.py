"""Keypoint data of the port against the JAX package's, byte for byte.

- The keypoint transforms on seeded samples: flip (the port draws from a passed
  ``random.Random``, the JAX transform from the global ``random``, both seeded alike),
  longest-max-size (the same PIL bilinear call), pad, standardize, remove-small, and
  ``PoseSample.to_padded_targets``.
- ``COCOPoseEstimationDataset`` on a small person-keypoints json written here (PNGs of
  mixed sizes, a crowd person, a person with too few labelled joints, an image without
  a person): images (float32, after the JAX division by 255) and targets equal.
- ``RandomPoseDataset``, ``pose_test_dataloader`` and ``coco2017_pose_train`` /
  ``coco2017_pose_val`` batches in the JAX loaders' order over two epochs.
"""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

from super_gradients_tpu.training import dataloaders as jax_loaders
from super_gradients_tpu.training import datasets as jax_datasets
from super_gradients_tpu.training.transforms import keypoints as jkp
from super_gradients_tpu_torch.training import dataloaders, datasets
from super_gradients_tpu_torch.training.transforms import keypoints as pkp

J = 17
SIZES = [(48, 80), (90, 60), (64, 64), (33, 100), (70, 41), (100, 100)]  # (h, w)


def sample(seed, h=50, w=70, n=3):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (h, w, 3), np.uint8)
    xy = rng.rand(n, 2) * [w * 0.6, h * 0.6]
    wh = rng.rand(n, 2) * [w * 0.4, h * 0.4] + 2
    joints = np.stack([rng.uniform(xy[:, :1], xy[:, :1] + wh[:, :1], (n, J)),
                       rng.uniform(xy[:, 1:], xy[:, 1:] + wh[:, 1:], (n, J)),
                       rng.randint(0, 3, (n, J))], -1).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return image, boxes, joints


def _equal(p, j):
    np.testing.assert_array_equal(p.image, j.image)
    np.testing.assert_array_equal(p.boxes_xyxy, j.boxes_xyxy)
    np.testing.assert_array_equal(p.joints, j.joints)
    assert p.image.dtype == j.image.dtype


TRANSFORMS = {
    "flip": lambda m: m.KeypointsHorizontalFlip(prob=0.5),
    "longest_max_size": lambda m: m.KeypointsLongestMaxSize(max_height=40, max_width=56),
    "longest_max_size_up": lambda m: m.KeypointsLongestMaxSize(max_height=128, max_width=96),
    "pad": lambda m: m.KeypointsPadIfNeeded(min_height=64, min_width=80, image_pad_value=114),
    "standardize": lambda m: m.KeypointsStandardize(max_value=255.0),
    "remove_small": lambda m: m.KeypointsRemoveSmallObjects(min_visible_joints=9, min_area=120.0),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_keypoint_transforms_byte_equal(name):
    jt, pt = TRANSFORMS[name](jkp), TRANSFORMS[name](pkp)
    rng = random.Random(7)
    random.seed(7)
    flips = 0
    for seed in range(12):
        image, boxes, joints = sample(seed)
        j = jt(jkp.PoseSample(image.copy(), boxes.copy(), joints.copy()))
        p = pt(pkp.PoseSample(image.copy(), boxes.copy(), joints.copy()), rng)
        _equal(p, j)
        flips += not np.array_equal(p.image, image)
        np.testing.assert_array_equal(p.to_padded_targets(5), j.to_padded_targets(5))
        np.testing.assert_array_equal(p.to_padded_targets(2), j.to_padded_targets(2))
    if name == "flip":
        assert 0 < flips < 12


def test_compose_runs_the_chain_in_order():
    chain = pkp.ComposeKeypointTransforms([pkp.KeypointsPadIfNeeded(64, 80), pkp.KeypointsStandardize(255.0)])
    ref = jkp.ComposeKeypointTransforms([jkp.KeypointsPadIfNeeded(64, 80), jkp.KeypointsStandardize(255.0)])
    image, boxes, joints = sample(0)
    out = chain(pkp.PoseSample(image, boxes, joints), random.Random(0))
    assert out.image.dtype == np.float32 and out.image.shape == (64, 80, 3)
    _equal(out, ref(jkp.PoseSample(image, boxes, joints)))


def write_pose_coco(root, split="train", seed=0):
    """A COCO person-keypoints split: ``<root>/images/<split>/*.png`` and
    ``<root>/person_keypoints_<split>.json``."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images", split)
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        name = f"{i:04d}.png"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(os.path.join(img_dir, name))
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        if i == 4:
            continue  # an image without a person
        for k in range(rng.randint(1, 4)):
            x, y = rng.rand() * w * 0.5, rng.rand() * h * 0.5
            bw, bh = rng.rand() * w * 0.5 + 4, rng.rand() * h * 0.5 + 4
            vis = rng.randint(0, 3, J)
            kps = np.stack([rng.uniform(x, x + bw, J), rng.uniform(y, y + bh, J), vis], -1)
            kps[vis == 0, :2] = 0
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1, "bbox": [x, y, bw, bh],
                         "keypoints": kps.reshape(-1).tolist(), "num_keypoints": int((vis > 0).sum()),
                         "iscrowd": int(i == 1 and k == 0), "area": bw * bh})
    anns.append({"id": len(anns) + 1, "image_id": 1, "category_id": 1, "bbox": [1, 1, 9, 9],
                 "keypoints": [0] * (3 * J), "num_keypoints": 0, "iscrowd": 0, "area": 81})
    with open(os.path.join(root, f"person_keypoints_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "person"}]}, f)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_coco"))
    write_pose_coco(root, "train", 0)
    write_pose_coco(root, "val", 1)
    return root


@pytest.mark.parametrize("train", [True, False])
def test_coco_pose_dataset_byte_equal(coco_root, train):
    split = "train" if train else "val"
    kw = dict(data_dir=coco_root, json_annotation_file=f"person_keypoints_{split}.json", images_dir=f"images/{split}",
              max_poses=4)
    ref = jax_datasets.COCOPoseEstimationDataset(**kw, transforms=jax_loaders._pose_transforms((64, 64), train))
    got = datasets.COCOPoseEstimationDataset(**kw, transforms=dataloaders._pose_transforms((64, 64), train), seed=3)
    assert len(got) == len(ref) >= 3 and getattr(got, "max_value", None) is None
    random.seed(3)
    for i in range(len(got)):
        ri, rt = ref[i]
        gi, gt = got[i]
        assert gi.dtype == np.float32 and gi.shape == (3, 64, 64)
        np.testing.assert_array_equal(gi.transpose(1, 2, 0), ri)
        np.testing.assert_array_equal(gt, rt)
    # crowd persons and those under min_visible_joints are not targets
    with open(os.path.join(coco_root, f"person_keypoints_{split}.json")) as f:
        anns = json.load(f)["annotations"]
    kept = [a for a in anns if not a["iscrowd"] and a["num_keypoints"] >= 1]
    assert len(kept) < len(anns) - 1
    assert sum(int((got[i][1][:, 0] >= 0).sum()) for i in range(len(got))) == len(kept)


def test_random_pose_dataset_and_test_loader_in_jax_order():
    ref_ds = jax_loaders.RandomPoseDataset(6, (32, 40), J, 8, seed=2)
    got_ds = dataloaders.RandomPoseDataset(6, (32, 40), J, 8, seed=2)
    for i in range(6):
        (ri, rt), (gi, gt) = ref_ds[i], got_ds[i]
        np.testing.assert_array_equal(gi.transpose(1, 2, 0), ri)
        np.testing.assert_array_equal(gt, rt)
    ref = jax_loaders.pose_test_dataloader(batch_size=4, dataset_size=12)
    got = dataloaders.get("pose_test_dataloader", dataloader_params={"batch_size": 4, "dataset_size": 12})
    assert len(got) == len(ref) == 3
    for epoch in range(2):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        for (ri, rt), (gi, gt) in zip(ref, got):
            np.testing.assert_array_equal(gi.permute(0, 2, 3, 1).numpy(), ri)
            np.testing.assert_array_equal(gt.numpy(), rt)


def test_coco_pose_loaders_in_jax_order(coco_root):
    params = dict(data_dir=coco_root, image_size=(64, 64), max_poses=4)
    for name, split, bs in (("coco2017_pose_train", "train", 2), ("coco2017_pose_val", "val", 3)):
        files = dict(json_file=f"person_keypoints_{split}.json", subdir=f"images/{split}")
        ref = getattr(jax_loaders, name)(batch_size=bs, **params, **files)
        got = dataloaders.get(name, dataset_params={**params, **files}, dataloader_params={"batch_size": bs})
        assert len(got) == len(ref) and got.max_value is None
        random.seed(0)  # the port's train dataset flips from its own generator, seeded 0
        for epoch in range(2):
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            n = 0
            for (ri, rt), (gi, gt) in zip(ref, got):
                np.testing.assert_array_equal(gi.permute(0, 2, 3, 1).numpy(), ri)
                np.testing.assert_array_equal(gt.numpy(), rt)
                n += 1
            assert n == len(got)
