"""Mean-teacher trainer (counterpart of contrastyou_tpu/trainers/mt.py):
``semi`` training that evaluates and infers on the teacher of its
mean-teacher-family hook (MT, UAMT or ICT)."""
from __future__ import annotations

from ..hooks.mt import MeanTeacherTrainerHook
from .semi import SemiTrainer

__all__ = ["MTTrainer"]


class MTTrainer(SemiTrainer):
    #: on W > 1 ranks the teacher's forward runs inside the step's
    #: data-parallel context, so its BatchNorm sums are global too
    data_parallel = True

    def init(self) -> None:
        super().init()
        mt = next((h for h in self._active_hooks if isinstance(h, MeanTeacherTrainerHook)), None)
        if mt is None:
            raise RuntimeError("MTTrainer requires a MeanTeacher-family hook")
        # as JAX: the teacher, even over an EvalEMAParameters model the
        # hook factory chose
        self.set_model4inference(mt)
