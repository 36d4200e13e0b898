"""Train from a recipe: ``python -m super_gradients_tpu_torch.train_from_recipe --config-name=<recipe> [a.b=v ...]``

Loads the recipe (``common/config.py::load_recipe``; the built-in ones are in
``super_gradients_tpu_torch/recipes/``), applies the dotted overrides and runs
``Trainer.train_from_config``. The model trains on the recipe's ``device``: the GPU,
unless the recipe or an override says ``device=cpu``.

Data-parallel on N GPUs (the recipe's ``batch_size`` is the global batch, as in the JAX
package; ``parallel/mesh.py``):

    python3 -m torch.distributed.run --nproc_per_node=N -m super_gradients_tpu_torch.train_from_recipe \
        --config-name=<recipe> num_devices=N [a.b=v ...]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train from a YAML recipe")
    parser.add_argument("--config-name", required=True, help="recipe name (builtin or in --config-dir)")
    parser.add_argument("--config-dir", default=None, help="directory with recipe YAMLs")
    parser.add_argument("overrides", nargs="*", help="dotted overrides like training_hyperparams.max_epochs=5")
    args = parser.parse_args(argv)

    from super_gradients_tpu_torch.common.config import load_recipe
    from super_gradients_tpu_torch.parallel.mesh import setup_device
    from super_gradients_tpu_torch.training.trainer import Trainer

    cfg = load_recipe(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    setup_device(num_devices=cfg.get("num_devices"), device=cfg.get("device") or "cuda")
    model, trainer = Trainer.train_from_config(cfg)
    print(f"Training complete. Best {cfg.get('training_hyperparams', {}).get('metric_to_watch')}: {trainer.best_metric}")
    return model, trainer


if __name__ == "__main__":
    main()
