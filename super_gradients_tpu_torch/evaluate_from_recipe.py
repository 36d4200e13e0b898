"""Evaluate a recipe's model on its validation set:
``python -m super_gradients_tpu_torch.evaluate_from_recipe --config-name=<recipe> [--checkpoint-path=x.pth] [a.b=v ...]``
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate from a YAML recipe")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.common.config import load_recipe
    from super_gradients_tpu_torch.parallel.mesh import setup_device
    from super_gradients_tpu_torch.training import dataloaders
    from super_gradients_tpu_torch.training.trainer import Trainer

    cfg = load_recipe(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    setup_device(num_devices=cfg.get("num_devices"), device=cfg.get("device") or "cuda")
    model = models.get(
        cfg["architecture"],
        num_classes=cfg.get("num_classes"),
        arch_params=cfg.get("arch_params"),
        checkpoint_path=args.checkpoint_path or (cfg.get("checkpoint_params") or {}).get("checkpoint_path"),
        device=cfg.get("device") or "cuda",
    )
    valid_loader = dataloaders.get(
        cfg.get("val_dataloader"),
        dataset_params=(cfg.get("dataset_params") or {}).get("val_dataset_params"),
    )
    trainer = Trainer(cfg.get("experiment_name", "evaluation"), ckpt_root_dir=cfg.get("ckpt_root_dir"))
    results = trainer.evaluate(model, valid_loader, cfg.get("training_hyperparams") or {})
    print("Evaluation results:", results)
    return results


if __name__ == "__main__":
    main()
