"""Knowledge-distillation trainer (counterpart of ``super_gradients_tpu/training/kd_trainer.py``).

``KDTrainer(...).train(student=, teacher=, training_params=, train_loader=, valid_loader=)``
wraps the two models' networks in a :class:`KDModule`, trains it as ``Trainer.train`` does
(the teacher frozen: no update, no weight decay, eval mode; the metrics read the student's
outputs) and hands the trained student's weights back into ``student``. The loss defaults
to :class:`KDLogitsLoss` built from the ``task_loss``, ``distillation_loss_coeff`` and
``temperature`` training parameters. ``KDTrainer.train_from_config(cfg)`` is the KD recipe
entry (``train_from_kd_recipe.py``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from super_gradients_tpu_torch.models.sg_model import SgModel
from super_gradients_tpu_torch.training.losses.kd_losses import KDLogitsLoss, KDModule, KDOutput  # noqa: F401
from super_gradients_tpu_torch.training.trainer import Trainer

logger = logging.getLogger(__name__)


def _first_metric_key(entry) -> str:
    """The results key the metric ``entry`` reports first (its ``compute`` output's first
    key), else its registry or class name."""
    from super_gradients_tpu_torch.training.metrics import get_metric

    try:
        m = get_metric(entry)
        keys = list(m.compute(m.init()).keys())
        if keys:
            return keys[0]
    except Exception:
        pass
    if isinstance(entry, str):
        return entry
    if isinstance(entry, dict):
        return next(iter(entry))
    return type(entry).__name__


class KDTrainer(Trainer):
    """A :class:`Trainer` that distills ``teacher`` into ``student``."""

    def train(self, model: Optional[SgModel] = None, training_params: Dict = None, train_loader=None,
              valid_loader=None, student: Optional[SgModel] = None, teacher: Optional[SgModel] = None, **kwargs):
        if student is None or teacher is None:
            raise ValueError("KDTrainer.train requires student= and teacher= SgModels")
        kd_model = SgModel(name=f"kd_{student.name}_{teacher.name}", net=KDModule(student.net, teacher.net),
                           num_classes=student.num_classes, device=student.device)

        tp = dict(training_params or {})
        tp.setdefault("loss", KDLogitsLoss(tp.pop("task_loss", None), tp.pop("distillation_loss_coeff", 0.5),
                                           tp.pop("temperature", 1.0)))
        # the teacher gets no update and no weight decay
        tp.setdefault("frozen_param_patterns", ["teacher"])
        user_metrics = tp.get("valid_metrics_list")
        tp.setdefault("valid_metrics_list", ["Accuracy"])
        if "metric_to_watch" not in tp:
            # a caller's metrics list may not hold Accuracy: watch the key its first metric reports
            tp["metric_to_watch"] = _first_metric_key(user_metrics[0]) if user_metrics else "Accuracy"

        trained = super().train(kd_model, tp, train_loader, valid_loader, **kwargs)
        prefix = "student."
        student.load_state_dict({k[len(prefix):]: v for k, v in trained.net.state_dict().items() if k.startswith(prefix)})
        return student

    @classmethod
    def train_from_config(cls, cfg: Dict):
        """The KD recipe entry: student and teacher from their own architecture, arch_params
        and checkpoint_params sections, then :meth:`train`. Both keyings are read: the
        original's (``student_architecture`` / ``teacher_architecture`` with
        ``student_arch_params``, ``student_checkpoint_params`` / ``teacher_checkpoint_params``)
        and the ``kd_module`` recipe's (``arch_params.student`` / ``teacher`` with
        ``checkpoint_params.teacher_pretrained_weights`` / ``teacher_checkpoint_path``). A
        teacher without a weights source raises ``ValueError``. Returns ``(student, trainer)``."""
        from super_gradients_tpu_torch import models

        cfg = cls._trigger_cfg_modifying_callbacks(dict(cfg))
        ap = cfg.get("arch_params") or {}
        student_name = cfg.get("student_architecture") or ap.get("student") or ap.get("student_architecture")
        teacher_name = cfg.get("teacher_architecture") or ap.get("teacher") or ap.get("teacher_architecture")
        if not student_name or not teacher_name:
            raise ValueError("KD recipe needs student_architecture and teacher_architecture "
                             "(or arch_params.student/teacher)")
        nc = cfg.get("num_classes") or ap.get("num_classes")
        cp = cfg.get("checkpoint_params") or {}
        scp = cfg.get("student_checkpoint_params") or {}
        tcp = dict(cfg.get("teacher_checkpoint_params") or {})
        tcp.setdefault("pretrained_weights", cp.get("teacher_pretrained_weights"))
        tcp.setdefault("checkpoint_path", cp.get("teacher_checkpoint_path"))
        if not tcp.get("pretrained_weights") and not tcp.get("checkpoint_path"):
            raise ValueError("KD teacher has no weights source (teacher_pretrained_weights / "
                             "teacher_checkpoint_path) — distilling from a random teacher "
                             "is almost certainly a recipe mistake (ref kd_trainer checks)")
        device = cfg.get("device") or "cuda"
        student = models.get(
            student_name, num_classes=nc,
            arch_params=cfg.get("student_arch_params") or ap.get("student_arch_params"),
            pretrained_weights=scp.get("pretrained_weights") or cp.get("pretrained_weights"),
            checkpoint_path=scp.get("checkpoint_path"),
            load_backbone=bool(scp.get("load_backbone")),
            strict_load=scp.get("strict_load"),
            device=device,
        )
        teacher = models.get(
            teacher_name, num_classes=nc,
            arch_params=cfg.get("teacher_arch_params") or ap.get("teacher_arch_params"),
            pretrained_weights=tcp.get("pretrained_weights"),
            checkpoint_path=tcp.get("checkpoint_path"),
            load_backbone=bool(tcp.get("load_backbone")),
            strict_load=tcp.get("strict_load"),
            device=device,
        )

        trainer = cls(experiment_name=cfg.get("experiment_name", "kd_experiment"), ckpt_root_dir=cfg.get("ckpt_root_dir"))
        trainer._recipe_cfg = cfg
        trained_student = trainer.train(
            training_params=cfg.get("training_hyperparams") or {},
            train_loader=cls._loader_from_cfg(cfg, "train"), valid_loader=cls._loader_from_cfg(cfg, "val"),
            student=student, teacher=teacher,
        )
        return trained_student, trainer
