#!/usr/bin/env python3
"""Write a Cityscapes-layout tree of PNGs from a seed:

    python tools/cityscapes_synthetic.py <root> [--train 16] [--val 8] [--height 1024] [--width 2048]

``<root>/leftImg8bit/<split>/<city>/<city>_<i>_leftImg8bit.png`` (RGB) and
``<root>/gtFine/<split>/<city>/<city>_<i>_gtFine_labelIds.png`` (8-bit labelIds), the
images spread over two cities. Each label map is a grid of 8 x 16 cells, each cell one
labelId; every image holds the 19 evaluated labelIds and two void ones (0 and 4), the
rest of its cells drawn at random. An image is its cells' colours (one colour a labelId,
drawn once from the seed) plus noise, so that a model can learn the labels from it.
"""

import argparse
import os

import numpy as np

# the labelIds of the 19 Cityscapes training classes, then two void ids
EVALUATED_LABEL_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)
LABEL_IDS = EVALUATED_LABEL_IDS + (0, 4)
GRID = (8, 16)
CITIES = ("aachen", "bochum")


def label_grid(rng) -> np.ndarray:
    """A ``GRID`` of labelIds that holds every id of ``LABEL_IDS`` once or more."""
    cells = GRID[0] * GRID[1]
    ids = np.concatenate([np.asarray(LABEL_IDS), rng.choice(LABEL_IDS, cells - len(LABEL_IDS))])
    rng.shuffle(ids)
    return ids.reshape(GRID).astype(np.uint8)


def write_cityscapes_tree(root: str, train: int = 16, val: int = 8, height: int = 1024, width: int = 2048,
                          seed: int = 0) -> None:
    """The tree under ``root``; ``height`` and ``width`` must be multiples of 8 and 16."""
    from PIL import Image

    if height % GRID[0] or width % GRID[1]:
        raise ValueError(f"height and width must be multiples of {GRID}, got {(height, width)}")
    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (256, 3)).astype(np.int16)
    cell_h, cell_w = height // GRID[0], width // GRID[1]
    for split, count in (("train", train), ("val", val)):
        for i in range(count):
            city = CITIES[i % len(CITIES)]
            labels = label_grid(rng).repeat(cell_h, axis=0).repeat(cell_w, axis=1)
            noise = rng.randint(-24, 25, (height, width, 3)).astype(np.int16)
            image = np.clip(colours[labels] + noise, 0, 255).astype(np.uint8)
            for kind, array, suffix in (("leftImg8bit", image, "leftImg8bit"), ("gtFine", labels, "gtFine_labelIds")):
                folder = os.path.join(root, kind, split, city)
                os.makedirs(folder, exist_ok=True)
                # zlib level 1: the same pixels as the default level, written several times faster
                Image.fromarray(array).save(os.path.join(folder, f"{city}_{i:06d}_000019_{suffix}.png"), compress_level=1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("--train", type=int, default=16)
    parser.add_argument("--val", type=int, default=8)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    write_cityscapes_tree(args.root, args.train, args.val, args.height, args.width, args.seed)


if __name__ == "__main__":
    main()
