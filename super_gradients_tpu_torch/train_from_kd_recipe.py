"""Knowledge-distillation training from a recipe:
``python -m super_gradients_tpu_torch.train_from_kd_recipe --config-name=<recipe> [a.b=v ...]``

Loads the recipe (``common/config.py::load_recipe``; the built-in KD recipes are
``imagenet_resnet50_kd`` and ``cityscapes_kd_base``), applies the dotted overrides and runs
``KDTrainer.train_from_config``. The student and the teacher train on the recipe's
``device``: the GPU, unless the recipe or an override says ``device=cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Knowledge-distillation training from a YAML recipe")
    parser.add_argument("--config-name", required=True, help="recipe name (builtin or in --config-dir)")
    parser.add_argument("--config-dir", default=None, help="directory with recipe YAMLs")
    parser.add_argument("overrides", nargs="*", help="dotted overrides like training_hyperparams.max_epochs=5")
    args = parser.parse_args(argv)

    from super_gradients_tpu_torch.common.config import load_recipe
    from super_gradients_tpu_torch.parallel.mesh import setup_device
    from super_gradients_tpu_torch.training.kd_trainer import KDTrainer

    cfg = load_recipe(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    setup_device(num_devices=cfg.get("num_devices"), device=cfg.get("device") or "cuda")
    student, trainer = KDTrainer.train_from_config(cfg)
    print(f"KD training complete. Best metric: {trainer.best_metric}")
    return student, trainer


if __name__ == "__main__":
    main()
