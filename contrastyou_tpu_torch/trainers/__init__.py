"""Trainers of the port (counterpart of contrastyou_tpu/trainers):
``trainer_zoo`` maps ``Trainer.name`` to the ported epoch-loop trainers,
all nine of the JAX package's."""
from .adv import AdversarialTrainer
from .dmt import DMTTrainer
from .ft import FineTuneTrainer
from .mixup import MixUpTrainer
from .mt import MTTrainer
from .multicore import MulticoreTrainer
from .pretrain import PretrainDecoderTrainer, PretrainEncoderTrainer
from .semi import SemiTrainer

trainer_zoo = {"semi": SemiTrainer, "ft": FineTuneTrainer, "mt": MTTrainer,
               "dmt": DMTTrainer, "mixup": MixUpTrainer, "adv": AdversarialTrainer,
               "multicore": MulticoreTrainer, "pretrain": PretrainEncoderTrainer,
               "pretrain_decoder": PretrainDecoderTrainer}

__all__ = ["SemiTrainer", "FineTuneTrainer", "MTTrainer", "DMTTrainer", "MixUpTrainer",
           "AdversarialTrainer", "MulticoreTrainer", "PretrainEncoderTrainer",
           "PretrainDecoderTrainer", "trainer_zoo"]
