#!/usr/bin/env python3
"""Write COCO-segmentation, Supervisely-Persons, Pascal VOC and Mapillary layout trees from a seed:

    python tools/segmentation_synthetic.py <coco|supervisely|voc|mapillary> <root> [--train 8] [--val 4]
        [--height 512] [--width 512] [--seed 0]

- ``coco``: ``<root>/images/{train2017,val2017}/<id>.jpg`` and
  ``<root>/annotations/instances_{train2017,val2017}.json``. Each image holds polygon
  instances of the 21 classes of the COCO segmentation recipe (two of them overlapping), one
  instance as a compressed RLE string, one crowd as an uncompressed RLE, one crowd polygon and
  one instance of a class outside the 21 (both dropped by the dataset). Every ``area`` is the
  instance's own pixel count.
- ``supervisely``: ``<root>/images/<i>.jpg``, ``<root>/masks/<i>.png`` (0 background, 255
  person) and ``train.csv`` / ``val.csv`` of ``images/<i>.jpg,masks/<i>.png`` rows; each csv
  also lists one pair whose files do not exist.
- ``voc``: ``JPEGImages/<name>.jpg``, ``SegmentationClass/<name>.png`` (palette mode, 21 classes
  and 255 void) and ``ImageSets/Segmentation/{train,val}.txt``.
- ``mapillary``: ``config_v1.2.json`` (66 labels, the last ``Unlabeled``) and
  ``{training,validation}/images/<name>.jpg`` with 3-channel ``{...}/v1.2/labels/<name>.png``.

Every image is its label map's colours (one colour a class, drawn once from the seed) plus
noise, so that a model can learn the labels from it.

``write_recipe_tree`` and ``recipe_cuts`` give the ``coco_segmentation_shelfnet_lw`` and
``supervisely_unet`` recipes a tree each and the overrides that train them one epoch on it.
"""

import argparse
import json
import os
from typing import List, Optional, Tuple

import numpy as np

# the COCO category ids of the recipe's 21 classes, background (0) first, and one outside them
COCO_RECIPE_CATEGORY_IDS = (0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4, 1, 64, 20, 63, 7, 72)
COCO_OTHER_CATEGORY_ID = 90


def encode_compressed_rle(mask: np.ndarray) -> str:
    """A binary ``[H, W]`` mask as COCO's compressed RLE string (column-major runs, each after
    the second stored as the difference from the run two before, in 5-bit chunks from ``'0'``)."""
    runs = uncompressed_rle(mask)
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not c & 0x10) or (x == -1 and c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def uncompressed_rle(mask: np.ndarray) -> List[int]:
    """A binary mask as COCO's uncompressed run lengths (column-major, starting with zeros)."""
    flat = mask.T.reshape(-1).astype(np.uint8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return np.diff(np.concatenate([[0], edges])).tolist()


def _noisy_image(rng, labels: np.ndarray, colours: np.ndarray) -> np.ndarray:
    noise = rng.randint(-20, 21, (*labels.shape, 3)).astype(np.int16)
    return np.clip(colours[labels] + noise, 0, 255).astype(np.uint8)


def _polygon_mask(poly, h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([(poly[i], poly[i + 1]) for i in range(0, len(poly), 2)], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _box_polygon(rng, h: int, w: int) -> List[float]:
    """A quadrilateral inside the image, a fifth to a half of its size."""
    bh, bw = rng.randint(h // 5, h // 2), rng.randint(w // 5, w // 2)
    y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
    jitter = lambda: float(rng.randint(0, max(1, min(bh, bw) // 4)))
    return [x + jitter(), y + jitter(), x + bw - jitter(), y + jitter(), x + bw - jitter(), y + bh - jitter(),
            x + jitter(), y + bh - jitter()]


def write_coco_segmentation_tree(root: str, train: int = 8, val: int = 4, height: int = 512, width: int = 512,
                                 seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (256, 3)).astype(np.int16)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    ann_id = 1
    for split, count in (("train2017", train), ("val2017", val)):
        folder = os.path.join(root, "images", split)
        os.makedirs(folder, exist_ok=True)
        images, annotations = [], []
        for i in range(count):
            img_id = (1 if split == "train2017" else 100000) + i
            labels = np.zeros((height, width), np.uint8)
            anns = []

            def add(segmentation, mask, category, iscrowd=0):
                nonlocal ann_id
                anns.append({"id": ann_id, "image_id": img_id, "category_id": int(category), "iscrowd": iscrowd,
                             "segmentation": segmentation, "area": int(mask.sum()), "bbox": [0, 0, 1, 1]})
                ann_id += 1

            cats = rng.choice(COCO_RECIPE_CATEGORY_IDS[1:], 6, replace=False)
            for k, cat in enumerate(cats[:3]):  # polygons; the second overlaps the first
                poly = _box_polygon(rng, height, width)
                if k == 1:
                    poly = [v + 7.0 for v in anns[0]["segmentation"][0]]
                mask = _polygon_mask(poly, height, width)
                add([poly], mask, cat)
            rle_mask = _polygon_mask(_box_polygon(rng, height, width), height, width)
            add({"counts": encode_compressed_rle(rle_mask), "size": [height, width]}, rle_mask, cats[3])
            crowd_mask = _polygon_mask(_box_polygon(rng, height, width), height, width)
            add({"counts": uncompressed_rle(crowd_mask), "size": [height, width]}, crowd_mask, cats[4], iscrowd=1)
            crowd_poly = _box_polygon(rng, height, width)
            add([crowd_poly], _polygon_mask(crowd_poly, height, width), cats[5], iscrowd=1)
            other = _box_polygon(rng, height, width)
            add([other], _polygon_mask(other, height, width), COCO_OTHER_CATEGORY_ID)
            for a in anns:  # the image's colours: the first painted instance keeps a pixel
                if a["category_id"] == COCO_OTHER_CATEGORY_ID or (a["iscrowd"] and isinstance(a["segmentation"], list)):
                    continue
                seg = a["segmentation"]
                if isinstance(seg, dict):
                    inst = crowd_mask if a["iscrowd"] else rle_mask
                else:
                    inst = _polygon_mask(seg[0], height, width)
                idx = COCO_RECIPE_CATEGORY_IDS.index(a["category_id"])
                labels[(labels == 0) & (inst > 0)] = idx
            name = f"{img_id:012d}.jpg"
            Image.fromarray(_noisy_image(rng, labels, colours)).save(os.path.join(folder, name), quality=95)
            images.append({"id": img_id, "file_name": name, "height": height, "width": width})
            annotations += anns
        categories = [{"id": c, "name": str(c)} for c in COCO_RECIPE_CATEGORY_IDS[1:] + (COCO_OTHER_CATEGORY_ID,)]
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)


def _blob_labels(rng, h: int, w: int, classes: int, cells=(4, 4)) -> np.ndarray:
    grid = rng.randint(0, classes, cells)
    return grid.repeat(-(-h // cells[0]), axis=0).repeat(-(-w // cells[1]), axis=1)[:h, :w].astype(np.uint8)


def write_supervisely_tree(root: str, train: int = 8, val: int = 4, height: int = 480, width: int = 320,
                           seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (256, 3)).astype(np.int16)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    index = 0
    for csv_name, count in (("train.csv", train), ("val.csv", val)):
        rows = []
        for _ in range(count):
            person = _blob_labels(rng, height, width, 2)
            Image.fromarray(_noisy_image(rng, person, colours)).save(os.path.join(root, "images", f"{index}.jpg"),
                                                                     quality=95)
            Image.fromarray(person * 255).save(os.path.join(root, "masks", f"{index}.png"))
            rows.append(f"images/{index}.jpg,masks/{index}.png")
            index += 1
        rows.insert(1, "images/missing.png,masks/missing.png")
        with open(os.path.join(root, csv_name), "w") as f:
            f.write("\n".join(rows) + "\n")


VOC_PALETTE = [v for c in range(256) for v in ((c * 37) % 256, (c * 91) % 256, (c * 53) % 256)]


def write_voc_tree(root: str, train: int = 4, val: int = 2, height: int = 96, width: int = 128, seed: int = 0,
                   image_sets: bool = True) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (256, 3)).astype(np.int16)
    for sub in ("JPEGImages", "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for split, count in (("train", train), ("val", val)):
        names = [f"2007_{split}_{i:04d}" for i in range(count)]
        for name in names:
            labels = _blob_labels(rng, height, width, 21)
            labels[:2] = 255  # a void border
            Image.fromarray(_noisy_image(rng, labels, colours)).save(os.path.join(root, "JPEGImages", name + ".jpg"))
            mask = Image.frombytes("P", (width, height), np.ascontiguousarray(labels).tobytes())
            mask.putpalette(VOC_PALETTE)
            mask.save(os.path.join(root, "SegmentationClass", name + ".png"))
        if image_sets:
            with open(os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt"), "w") as f:
                f.write("\n".join(names) + "\n")


def write_mapillary_tree(root: str, train: int = 4, val: int = 2, height: int = 96, width: int = 128,
                         seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (256, 3)).astype(np.int16)
    labels_cfg = [{"readable": f"class {i}", "name": f"c{i}"} for i in range(65)] + [{"readable": "Unlabeled"}]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config_v1.2.json"), "w") as f:
        json.dump({"labels": labels_cfg}, f)
    for split, count in (("training", train), ("validation", val)):
        for sub in ("images", os.path.join("v1.2", "labels")):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(count):
            labels = _blob_labels(rng, height, width, 66)
            name = f"{split}_{i:04d}"
            Image.fromarray(_noisy_image(rng, labels, colours)).save(os.path.join(root, split, "images", name + ".jpg"))
            rgb = np.stack([labels, rng.randint(0, 256, labels.shape), rng.randint(0, 256, labels.shape)], -1)
            Image.fromarray(rgb.astype(np.uint8)).save(os.path.join(root, split, "v1.2", "labels", name + ".png"))


WRITERS = {"coco": write_coco_segmentation_tree, "supervisely": write_supervisely_tree, "voc": write_voc_tree,
           "mapillary": write_mapillary_tree}

# recipe: (its tree's folder, writer and seed, and the dataset parameter naming the tree's root)
RECIPE_TREES = {"coco_segmentation_shelfnet_lw": ("coco", write_coco_segmentation_tree, 3, "data_dir"),
                "supervisely_unet": ("supervisely", write_supervisely_tree, 4, "root_dir")}


def write_recipe_tree(recipe: str, root: str, train: int, val: int, height: int, width: int) -> str:
    """``recipe``'s tree under ``root`` from its own seed; returns the tree's root."""
    folder, writer, seed, _ = RECIPE_TREES[recipe]
    path = os.path.join(root, folder)
    writer(path, train=train, val=val, height=height, width=width, seed=seed)
    return path


def recipe_cuts(recipe: str, data_root: str, ckpt_root: str, batch: Optional[int] = None,
                image_size: Optional[Tuple[int, int]] = None, workers: int = 0,
                device: Optional[str] = None) -> List[str]:
    """The overrides that train ``recipe`` one epoch on ``data_root`` without TensorBoard:
    ``batch`` images a batch and ``image_size`` (the recipe's own where None), ``workers``
    loader workers, and ``device`` where given."""
    key = RECIPE_TREES[recipe][3]
    cuts = ["epochs=1", f"num_workers={workers}", f"ckpt_root_dir={ckpt_root}",
            "training_hyperparams.sg_logger_params.tensorboard=False"]
    if batch:
        cuts += [f"batch_size={batch}", f"val_batch_size={batch}"]
    for split in ("train", "val"):
        cuts.append(f"dataset_params.{split}_dataset_params.{key}={data_root}")
        if image_size:
            cuts.append(f"dataset_params.{split}_dataset_params.image_size=[{image_size[0]},{image_size[1]}]")
    return cuts + ([f"device={device}"] if device else [])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("layout", choices=sorted(WRITERS))
    parser.add_argument("root")
    parser.add_argument("--train", type=int, default=8)
    parser.add_argument("--val", type=int, default=4)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    WRITERS[args.layout](args.root, args.train, args.val, args.height, args.width, args.seed)


if __name__ == "__main__":
    main()
