"""Resume the latest (or a given) run of an experiment from its ``recipe.json``:
``python -m super_gradients_tpu_torch.resume_experiment --experiment_name=<name>``

Without a ``recipe.json`` in the run, ``--config-name`` names a recipe to compose
again with ``training_hyperparams.resume=True``. The run continues on the device its recipe
names (the GPU where it names none).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Resume an experiment")
    parser.add_argument("--experiment_name", required=True)
    parser.add_argument("--ckpt_root_dir", default=None)
    parser.add_argument("--run_id", default=None, help="specific RUN_<ts> id (default: latest)")
    parser.add_argument("--config-name", default=None, help="fallback recipe if the run has no persisted recipe.json")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from super_gradients_tpu_torch.parallel.mesh import setup_device
    from super_gradients_tpu_torch.training.trainer import Trainer

    try:
        return Trainer.resume_experiment(args.experiment_name, ckpt_root_dir=args.ckpt_root_dir, run_id=args.run_id)
    except (FileNotFoundError, ValueError):
        if args.config_name is None:
            raise
    from super_gradients_tpu_torch.common.config import load_recipe

    overrides = list(args.overrides) + ["training_hyperparams.resume=True"]
    cfg = load_recipe(args.config_name, config_dir=args.config_dir, overrides=overrides)
    cfg["experiment_name"] = args.experiment_name
    if args.ckpt_root_dir:
        cfg["ckpt_root_dir"] = args.ckpt_root_dir
    setup_device(device=cfg.get("device") or "cuda")
    return Trainer.train_from_config(cfg)


if __name__ == "__main__":
    main()
