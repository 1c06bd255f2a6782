"""Trainers of the port (counterpart of contrastyou_tpu/trainers):
``trainer_zoo`` maps ``Trainer.name`` to the ported epoch-loop trainers."""
from .ft import FineTuneTrainer
from .mixup import MixUpTrainer
from .mt import MTTrainer
from .pretrain import PretrainDecoderTrainer, PretrainEncoderTrainer
from .semi import SemiTrainer

trainer_zoo = {"semi": SemiTrainer, "ft": FineTuneTrainer, "mt": MTTrainer,
               "mixup": MixUpTrainer, "pretrain": PretrainEncoderTrainer,
               "pretrain_decoder": PretrainDecoderTrainer}

__all__ = ["SemiTrainer", "FineTuneTrainer", "MTTrainer", "MixUpTrainer",
           "PretrainEncoderTrainer", "PretrainDecoderTrainer", "trainer_zoo"]
