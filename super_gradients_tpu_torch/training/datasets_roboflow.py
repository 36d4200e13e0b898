"""Roboflow-100 datasets (counterpart of ``super_gradients_tpu/training/datasets_roboflow.py``).

RF100 is 100 COCO-format detection datasets in 7 categories. A dataset lives in
``<data_dir>/<dataset_name>/<split>/_annotations.coco.json`` with its images beside
the json. The table below is the published RF100 inventory
(github.com/roboflow/roboflow-100-benchmark, ``datasets_stats.csv``):
``name -> (category, num_classes, train, valid, test)``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Union

from super_gradients_tpu_torch.training.datasets import COCOFormatDetectionDataset

logger = logging.getLogger(__name__)

DATASETS_CATEGORIES = (
    "electromagnetic", "videogames", "microscopic", "documents", "aerial", "underwater", "real world",
)

# name -> (category, num_classes, n_train, n_valid, n_test)
RF100_DATASETS: Dict[str, tuple] = {
    "4-fold-defect": ("microscopic", 1, 503, 134, 33),
    "abdomen-mri": ("electromagnetic", 1, 1887, 479, 238),
    "acl-x-ray": ("electromagnetic", 1, 2141, 612, 306),
    "activity-diagrams-qdobr": ("documents", 19, 259, 74, 45),
    "aerial-cows": ("aerial", 1, 1084, 340, 299),
    "aerial-pool": ("aerial", 7, 673, 177, 96),
    "aerial-spheres": ("aerial", 6, 318, 104, 51),
    "animals-ij5d2": ("real world", 10, 700, 200, 100),
    "apex-videogame": ("videogames", 2, 2583, 691, 415),
    "apples-fvpl5": ("real world", 2, 489, 178, 30),
    "aquarium-qlnqy": ("underwater", 7, 448, 127, 63),
    "asbestos": ("microscopic", 4, 932, 266, 133),
    "avatar-recognition-nuexe": ("videogames", 1, 225, 59, 30),
    "axial-mri": ("electromagnetic", 2, 253, 79, 39),
    "bacteria-ptywi": ("microscopic", 1, 30, 10, 10),
    "bccd-ouzjz": ("microscopic", 3, 255, 73, 36),
    "bees-jt5in": ("real world", 1, 5640, 1604, 836),
    "bone-fracture-7fylg": ("electromagnetic", 4, 326, 88, 44),
    "brain-tumor-m2pbp": ("electromagnetic", 3, 6930, 1980, 990),
    "cable-damage": ("real world", 2, 919, 265, 134),
    "cables-nl42k": ("real world", 11, 4816, 1220, 794),
    "cavity-rs0uf": ("real world", 2, 287, 93, 38),
    "cell-towers": ("real world", 2, 705, 202, 101),
    "cells-uyemf": ("microscopic", 1, 16, 4, 2),
    "chess-pieces-mjzgj": ("real world", 13, 202, 58, 29),
    "circuit-elements": ("real world", 46, 672, 64, 36),
    "circuit-voltages": ("real world", 6, 92, 25, 15),
    "cloud-types": ("aerial", 4, 3528, 1008, 504),
    "coins-1apki": ("real world", 4, 6121, 1599, 699),
    "construction-safety-gsnvb": ("real world", 5, 997, 119, 90),
    "coral-lwptl": ("underwater", 14, 427, 93, 74),
    "corrosion-bi3q3": ("real world", 3, 840, 304, 105),
    "cotton-20xz5": ("real world", 4, 367, 19, 20),
    "cotton-plant-disease": ("microscopic", 1, 724, 198, 102),
    "csgo-videogame": ("videogames", 2, 1774, 446, 207),
    "currency-v4f8j": ("real world", 10, 576, 155, 82),
    "digits-t2eg6": ("real world", 10, 2912, 824, 367),
    "document-parts": ("documents", 2, 906, 318, 150),
    "excavators-czvg9": ("real world", 3, 2244, 267, 144),
    "farcry6-videogame": ("videogames", 11, 82, 24, 14),
    "fish-market-ggjso": ("real world", 21, 14180, 3116, 1202),
    "flir-camera-objects": ("electromagnetic", 4, 9306, 2854, 1452),
    "furniture-ngpea": ("real world", 3, 454, 161, 74),
    "gauge-u2lwv": ("real world", 2, 158, 52, 25),
    "grass-weeds": ("real world", 1, 1661, 580, 245),
    "gynecology-mri": ("electromagnetic", 3, 2122, 526, 253),
    "halo-infinite-angel-videogame": ("videogames", 4, 462, 136, 71),
    "hand-gestures-jps7z": ("real world", 14, 642, 178, 94),
    "insects-mytwu": ("real world", 10, 696, 199, 100),
    "leaf-disease-nsdsr": ("real world", 3, 1589, 616, 296),
    "lettuce-pallets": ("real world", 5, 1060, 299, 151),
    "liver-disease": ("microscopic", 4, 2782, 794, 400),
    "marbles": ("real world", 2, 54, 19, 32),
    "mask-wearing-608pr": ("real world", 2, 105, 29, 15),
    "mitosis-gjs3g": ("microscopic", 1, 213, 61, 30),
    "number-ops": ("real world", 15, 4869, 1636, 623),
    "paper-parts": ("documents", 46, 8472, 2359, 1209),
    "paragraphs-co84b": ("documents", 7, 4209, 1221, 633),
    "parasites-1s07h": ("microscopic", 8, 1484, 411, 215),
    "peanuts-sd4kf": ("real world", 2, 268, 77, 42),
    "peixos-fish": ("underwater", 12, 821, 261, 118),
    "people-in-paintings": ("real world", 1, 634, 194, 81),
    "pests-2xlvx": ("real world", 28, 509, 153, 55),
    "phages": ("microscopic", 2, 1155, 164, 103),
    "pills-sxdht": ("real world", 8, 316, 90, 45),
    "poker-cards-cxcvz": ("real world", 53, 964, 193, 128),
    "printed-circuit-board": ("real world", 34, 548, 80, 44),
    "radio-signal": ("electromagnetic", 2, 1954, 566, 278),
    "road-signs-6ih4y": ("real world", 21, 1376, 488, 229),
    "road-traffic": ("real world", 12, 494, 187, 133),
    "robomasters-285km": ("videogames", 9, 1945, 556, 278),
    "secondary-chains": ("aerial", 1, 103, 43, 16),
    "sedimentary-features-9eosf": ("real world", 5, 156, 45, 21),
    "shark-teeth-5atku": ("real world", 4, 191, 53, 36),
    "sign-language-sokdr": ("real world", 26, 504, 144, 72),
    "signatures-xc8up": ("documents", 1, 257, 74, 37),
    "smoke-uvylj": ("real world", 1, 522, 148, 76),
    "soccer-players-5fuqs": ("aerial", 3, 114, 33, 16),
    "soda-bottles": ("real world", 6, 1547, 486, 216),
    "solar-panels-taxvb": ("electromagnetic", 5, 112, 30, 19),
    "stomata-cells": ("microscopic", 2, 1482, 414, 209),
    "street-work": ("real world", 11, 611, 175, 87),
    "tabular-data-wf9uh": ("documents", 12, 3251, 409, 206),
    "team-fight-tactics": ("videogames", 59, 1162, 307, 112),
    "thermal-cheetah-my4dp": ("electromagnetic", 2, 90, 25, 14),
    "thermal-dogs-and-people-x6ejw": ("electromagnetic", 2, 142, 41, 20),
    "trail-camera": ("real world", 2, 941, 239, 131),
    "truck-movement": ("real world", 7, 740, 215, 107),
    "tweeter-posts": ("documents", 2, 87, 21, 9),
    "tweeter-profile": ("documents", 1, 425, 121, 61),
    "underwater-objects-5v7p8": ("underwater", 5, 5320, 1520, 760),
    "underwater-pipes-4ng4t": ("underwater", 1, 5617, 1575, 779),
    "uno-deck": ("real world", 15, 6295, 1798, 899),
    "valentines-chocolate": ("real world", 22, 68, 13, 6),
    "vehicles-q0x2v": ("real world", 12, 2634, 966, 458),
    "wall-damage": ("real world", 3, 325, 96, 40),
    "washroom-rf1fa": ("real world", 10, 1885, 775, 318),
    "weed-crop-aerial": ("aerial", 2, 823, 235, 118),
    "wine-labels": ("real world", 12, 3172, 841, 630),
    "x-ray-rheumatology": ("electromagnetic", 12, 135, 34, 16),
}


def list_datasets(categories: Optional[List[str]] = None) -> List[str]:
    """All RF100 dataset names, optionally filtered by category."""
    cats = tuple(categories) if categories else DATASETS_CATEGORIES
    return [name for name, meta in RF100_DATASETS.items() if meta[0] in cats]


def get_dataset_metadata(dataset_name: str) -> Optional[Dict[str, Union[str, int]]]:
    """Metadata dict for one dataset, or None with a warning."""
    meta = RF100_DATASETS.get(dataset_name)
    if meta is None:
        logger.warning(f"No metadata found for roboflow dataset `{dataset_name}`")
        return None
    category, num_classes, n_train, n_valid, n_test = meta
    return {
        "category": category,
        "num_classes": num_classes,
        "train": n_train,
        "valid": n_valid,
        "test": n_test,
        "size": n_train + n_valid + n_test,
    }


def get_dataset_num_classes(dataset_name: str) -> int:
    """Class count for recipe interpolation."""
    meta = RF100_DATASETS.get(dataset_name)
    if meta is None:
        raise ValueError(f"Unknown roboflow dataset `{dataset_name}`; see list_datasets()")
    return meta[1]


class RoboflowDetectionDataset(COCOFormatDetectionDataset):
    """One RF100 dataset; ``split`` is train, valid or test."""

    def __init__(self, data_dir: str, dataset_name: str, split: str, **kwargs):
        if split not in ("train", "valid", "test"):
            raise ValueError(f"split must be one of ('train', 'valid', 'test'), got `{split}`")
        self.dataset_name = dataset_name
        split_dir = os.path.join(dataset_name, split)
        super().__init__(
            data_dir=data_dir,
            json_annotation_file=os.path.join(split_dir, "_annotations.coco.json"),
            images_dir=split_dir,
            **kwargs,
        )

    @staticmethod
    def list_datasets(categories: Optional[List[str]] = None) -> List[str]:
        return list_datasets(categories)

    @property
    def metadata(self) -> Optional[Dict[str, Union[str, int]]]:
        return get_dataset_metadata(self.dataset_name)
