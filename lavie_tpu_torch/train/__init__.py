"""The fork's training layer (port of lavie_tpu.train): LoRA and mapper
fine-tuning (finetune.py), standalone mapper training (mapping_trainer.py),
the diffusion losses and full-parameter step (step.py), importance samplers
over timesteps (timestep_sampler.py) and the optax-equivalent optimizer
chain (optim.py)."""

from lavie_tpu_torch.train.step import (
    TrainState,
    conditioned_diffusion_loss,
    diffusion_loss,
    make_train_step,
)
from lavie_tpu_torch.train.timestep_sampler import (
    LossSecondMomentResampler,
    ScheduleSampler,
    UniformSampler,
    create_named_schedule_sampler,
)

__all__ = [
    "TrainState",
    "conditioned_diffusion_loss",
    "diffusion_loss",
    "make_train_step",
    "ScheduleSampler",
    "UniformSampler",
    "LossSecondMomentResampler",
    "create_named_schedule_sampler",
]
