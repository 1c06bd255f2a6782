"""Trainers of the port (counterpart of contrastyou_tpu/trainers):
``trainer_zoo`` maps ``Trainer.name`` to the ported epoch-loop trainers."""
from .semi import SemiTrainer

trainer_zoo = {"semi": SemiTrainer}

__all__ = ["SemiTrainer", "trainer_zoo"]
