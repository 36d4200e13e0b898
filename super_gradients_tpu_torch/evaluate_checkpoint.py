"""Evaluate a checkpoint of a recipe-launched run:
``python -m super_gradients_tpu_torch.evaluate_checkpoint --experiment_name=<name> [--ckpt_name=ckpt_best]``

Rebuilds the run's model and val loader from its ``recipe.json``, loads the named
checkpoint and validates (``Trainer.evaluate_checkpoint``), on the device the run's recipe
names (the GPU where it names none).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a saved checkpoint of a previous experiment")
    parser.add_argument("--experiment_name", "--experiment-name", dest="experiment_name", required=True)
    parser.add_argument("--ckpt_root_dir", "--ckpt-root-dir", dest="ckpt_root_dir", default=None)
    parser.add_argument("--ckpt_name", "--ckpt-name", dest="ckpt_name", default="ckpt_best")
    parser.add_argument("--run_id", "--run-id", dest="run_id", default=None)
    args = parser.parse_args(argv)

    from super_gradients_tpu_torch.training.trainer import Trainer

    results = Trainer.evaluate_checkpoint(
        experiment_name=args.experiment_name,
        ckpt_root_dir=args.ckpt_root_dir,
        ckpt_name=args.ckpt_name,
        run_id=args.run_id,
    )
    print({k: round(float(v), 5) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
