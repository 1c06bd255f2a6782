"""Differentiable-mean-teacher trainer (counterpart of
contrastyou_tpu/trainers/dmt.py): ``semi`` training with the DMT hook,
evaluating and inferring on its teacher."""
from __future__ import annotations

from ..hooks.dmt import DifferentiableMeanTeacherTrainerHook
from .semi import SemiTrainer

__all__ = ["DMTTrainer"]


class DMTTrainer(SemiTrainer):
    #: not on W > 1 ranks yet: the teacher's forwards and the meta step
    #: take batch statistics of their own
    data_parallel = False

    def init(self) -> None:
        super().init()
        dmt = next((h for h in self._active_hooks
                    if isinstance(h, DifferentiableMeanTeacherTrainerHook)), None)
        if dmt is None:
            raise RuntimeError("DMTTrainer requires a DifferentiableMeanTeacher hook")
        self.set_model4inference(dmt)
