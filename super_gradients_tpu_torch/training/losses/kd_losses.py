"""Knowledge distillation: the composite network and the logits loss (counterpart of
``super_gradients_tpu/training/losses/kd_losses.py``).

:class:`KDModule` runs a student and a frozen teacher on the same input and returns both
outputs as a :class:`KDOutput`. The teacher always runs in eval mode and without gradient
(JAX's ``stop_gradient``): ``KDModule.train()`` puts the student in train mode and leaves
the teacher in eval. :class:`KDLogitsLoss` mixes a task loss on the student's logits with
the temperature-scaled KL divergence from the teacher's softmax, ``task * (1 - c) + kd * c``.
The KL is averaged over the global batch under a process group
(``parallel/collectives.py::global_mean``), as the cross-entropy family is.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.common.registry import LOSSES, register_loss
from super_gradients_tpu_torch.parallel.collectives import global_mean


class KDOutput(NamedTuple):
    student_output: Any
    teacher_output: Any


class KDModule(nn.Module):
    """The student and the frozen teacher on the same input (``state_dict`` names
    ``student.*`` and ``teacher.*``, the JAX tree's ``student`` / ``teacher`` subtrees)."""

    def __init__(self, student: nn.Module, teacher: nn.Module):
        super().__init__()
        self.student = student
        self.teacher = teacher
        self.teacher.eval()

    def train(self, mode: bool = True) -> "KDModule":
        super().train(mode)
        self.teacher.eval()
        return self

    def reset_parameters(self, generator: torch.Generator) -> "KDModule":
        self.student.reset_parameters(generator)
        self.teacher.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor) -> KDOutput:
        student_output = self.student(x)
        with torch.no_grad():
            teacher_output = self.teacher(x)
        return KDOutput(student_output, teacher_output)


@register_loss("KDLogitsLoss")
class KDLogitsLoss:
    """The task loss (an object, a registry name built with its defaults, or
    ``CrossEntropyLoss()``) on the student's logits, mixed with
    ``KL(softmax(t / T) || softmax(s / T)) * T**2`` (JAX's ``+ 1e-12`` inside the log)."""

    def __init__(self, task_loss_fn=None, distillation_loss_coeff: float = 0.5, temperature: float = 1.0):
        from super_gradients_tpu_torch.training.losses.classification_losses import CrossEntropyLoss

        if isinstance(task_loss_fn, str):
            task_loss_fn = LOSSES[task_loss_fn]()
        self.task_loss = task_loss_fn or CrossEntropyLoss()
        self.coeff = distillation_loss_coeff
        self.temperature = temperature

    def __call__(self, outputs: KDOutput, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        s_logits, t_logits = outputs.student_output, outputs.teacher_output
        task, _ = self.task_loss(s_logits, targets)
        t = self.temperature
        s_logp = F.log_softmax(s_logits / t, dim=-1)
        t_p = F.softmax(t_logits / t, dim=-1)
        kd = global_mean(torch.sum(t_p * (torch.log(t_p + 1e-12) - s_logp), dim=-1)) * (t * t)
        loss = task * (1 - self.coeff) + kd * self.coeff
        return loss, {"task_loss": task, "distillation_loss": kd}
