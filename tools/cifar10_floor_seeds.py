#!/usr/bin/env python3
"""The cut of ``cifar10_resnet`` that the JAX package's ``test_cifar10_recipe_cli_accuracy_floor``
trains (5 epochs of b32 at LR 0.01 over 640 class-separable CIFAR images, validated on
128), from several model seeds, in the JAX package or in the PyTorch port:

    python tools/cifar10_floor_seeds.py --package jax --seeds 0-8              # on the CPU
    python tools/cifar10_floor_seeds.py --package torch --device cpu --seeds 0-4

Prints one line a seed: the epoch losses, the validation Accuracy after each epoch and the
best, beside the test's floor of 0.90. The data are the test's own, written to a temporary
directory from seed 0; only the model's initial weights change with ``--seeds``.
"""

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR = 0.90


def write_separable_cifar(root, n_per_batch=128, seed=0):
    """Class k is the grey level 25k + 10 plus noise in [-8, 8), as the JAX test writes it."""
    rng = np.random.RandomState(seed)
    sub = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(sub, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.randint(0, 10, n_per_batch)
        base = (np.arange(10)[:, None] * 25 + 10).repeat(3072, 1).astype(np.int32)
        data = base[labels] + rng.randint(-8, 8, (n_per_batch, 3072))
        with open(os.path.join(sub, name), "wb") as f:
            pickle.dump({b"data": np.clip(data, 0, 255).astype(np.uint8), b"labels": labels.tolist()}, f)


def seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--device", default="cuda", help="the port's device (torch only)")
    parser.add_argument("--seeds", type=seeds, default=seeds("0-4"), help="a seed or a range, e.g. 0-8")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from super_gradients_tpu import models
        from super_gradients_tpu.models import model_factory
        from super_gradients_tpu.train_from_recipe import main as train
    else:
        from super_gradients_tpu_torch import models
        from super_gradients_tpu_torch.models import model_factory
        from super_gradients_tpu_torch.train_from_recipe import main as train
    original_get = model_factory.get
    with tempfile.TemporaryDirectory() as root:
        write_separable_cifar(root)
        for seed in args.seeds:
            models.get = lambda *a, seed=seed, **k: original_get(*a, **dict(k, seed=seed))
            overrides = [f"ckpt_root_dir={root}/ckpt_{seed}", "epochs=5", "lr=0.01", "batch_size=32",
                         "val_batch_size=128", f"dataset_params.train_dataset_params.root={root}",
                         f"dataset_params.val_dataset_params.root={root}", "training_hyperparams.lr_warmup_epochs=0",
                         "training_hyperparams.average_best_models=False", "training_hyperparams.save_model=False"]
            if args.package == "torch":
                overrides += [f"device={args.device}", "training_hyperparams.sg_logger_params.tensorboard=False"]
            _, trainer = train(["--config-name", "cifar10_resnet", *overrides])
            accuracy = [v["Accuracy"] for v in trainer.valid_metrics_history]
            print(f"{args.package} seed {seed}: losses {[round(x, 3) for x in trainer.train_loss_history]}; Accuracy "
                  f"{[round(a, 4) for a in accuracy]}; best {max(accuracy):.4f} "
                  f"({'at or above' if max(accuracy) >= FLOOR else 'below'} the floor {FLOOR})", flush=True)
    models.get = original_get


if __name__ == "__main__":
    main()
