"""A plain ``torch.utils.data.DataLoader`` over a port detection dataset, on the CPU.

The dataset ships uint8 images and its ``max_value``; torch's loader has no
``max_value`` of its own, so the trainer takes the dataset's. Trained and validated
from the same weights over the same sample order, the plain loader and the port's
``DataLoader`` must give the same losses and metrics, to the bit; a uint8 loader with
no ``max_value`` anywhere still raises.
"""

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401

# ``torch._dynamo`` is imported here, while the tests are collected: a torch optimizer
# imports it at its first construction, and by then the JAX parity tests' reference
# loader (``tests/ref_loader.py``) may have put module stubs such as ``onnx`` into this
# worker's ``sys.modules``, which break that import.

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.training import Trainer, dataloaders, datasets
from test_torch_detection_datasets import write_coco

torch.set_num_threads(2)

NUM_CLASSES, SIDE = 4, 64
PARAMS = dict(max_epochs=2, loss="PPYoloELoss", criterion_params={"num_classes": NUM_CLASSES}, initial_lr=1e-4,
              optimizer="AdamW", ema=True, ema_params={"decay": 0.9, "decay_type": "exp", "beta": 4},
              valid_metrics_list=[{"DetectionMetrics": {"num_cls": NUM_CLASSES}}], metric_to_watch="mAP@0.50:0.95",
              save_model=False, silent_mode=True, sg_logger_params={"tensorboard": False})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.RandomState(4)
    write_coco(str(root / "train"), str(root / "train.json"), 8, rng, sizes=((48, 70), (64, 64), (40, 56)))
    write_coco(str(root / "valid"), str(root / "valid.json"), 4, rng)
    return str(root)


def _datasets(root):
    """A train set through the mosaic chain (its own seeded generators) and a val set."""
    train = datasets.COCOFormatDetectionDataset(root, "train.json", "train", seed=5, max_boxes=30,
                                                transforms=dataloaders._yolo_nas_train_transforms((SIDE, SIDE)))
    valid = datasets.COCOFormatDetectionDataset(root, "valid.json", "valid", with_crowd=True, max_boxes=30,
                                                transforms=dataloaders._yolo_nas_val_transforms((SIDE, SIDE)))
    return train, valid


def _train(root, tmp_path, name, make_loader):
    train, valid = _datasets(root)
    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=SIDE, device="cpu", seed=2)
    for module_name, module in model.net.named_modules():
        if module_name.endswith("cls_pred"):
            module.bias.data.zero_()
    trainer = Trainer(name, ckpt_root_dir=str(tmp_path))
    train_loader, valid_loader = make_loader(train, True), make_loader(valid, False)
    trainer.train(model, PARAMS, train_loader, valid_loader)
    return trainer, trainer.evaluate(model, valid_loader, PARAMS)


def test_plain_torch_loader_trains_and_validates_as_the_port_loader(root, tmp_path):
    plain = lambda ds, train: torch.utils.data.DataLoader(ds, batch_size=4, shuffle=False, drop_last=train)  # noqa: E731
    port = lambda ds, train: dataloaders.DataLoader(ds, batch_size=4, shuffle=False, drop_last=train)  # noqa: E731
    sample = next(iter(plain(_datasets(root)[0], True)))
    assert sample[0].dtype == torch.uint8 and not hasattr(plain(_datasets(root)[0], True), "max_value")
    a, evaluated_a = _train(root, tmp_path, "plain", plain)
    b, evaluated_b = _train(root, tmp_path, "port", port)
    assert len(a.train_loss_history) == 2 and np.isfinite(a.train_loss_history).all()
    assert a.train_loss_history == b.train_loss_history
    assert a.valid_metrics_history == b.valid_metrics_history and "mAP@0.50:0.95" in a.valid_metrics_history[0]
    assert evaluated_a == evaluated_b and np.isfinite(list(evaluated_a.values())).all()
    for (ka, va), (kb, vb) in zip(a.train_state.net.state_dict().items(), b.train_state.net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_uint8_loader_without_max_value_raises(root, tmp_path):
    train, _ = _datasets(root)
    train.max_value = None  # neither the loader nor its dataset says how to standardize
    loader = torch.utils.data.DataLoader([(torch.zeros(3, SIDE, SIDE, dtype=torch.uint8), train[0][1])] * 4, batch_size=4)
    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=SIDE, device="cpu")
    with pytest.raises(ValueError, match="max_value"):
        Trainer("raise", ckpt_root_dir=str(tmp_path)).train(model, dict(PARAMS, max_epochs=1, valid_metrics_list=[]),
                                                           loader)
