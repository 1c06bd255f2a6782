"""Trainers of the port (counterpart of contrastyou_tpu/trainers):
``trainer_zoo`` maps ``Trainer.name`` to the ported epoch-loop trainers."""
from .ft import FineTuneTrainer
from .pretrain import PretrainDecoderTrainer, PretrainEncoderTrainer
from .semi import SemiTrainer

trainer_zoo = {"semi": SemiTrainer, "ft": FineTuneTrainer,
               "pretrain": PretrainEncoderTrainer, "pretrain_decoder": PretrainDecoderTrainer}

__all__ = ["SemiTrainer", "FineTuneTrainer", "PretrainEncoderTrainer",
           "PretrainDecoderTrainer", "trainer_zoo"]
