"""Training substrate: optimizer, schedules, gradient utilities and the
loop (port of ``repro.train``)."""

from . import grad, loop, optimizer, schedule
from .loop import Trainer, TrainerConfig
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .schedule import ScheduleConfig, lr_at

__all__ = ["grad", "loop", "optimizer", "schedule", "Trainer", "TrainerConfig",
           "AdamWConfig", "adamw_update", "init_opt_state",
           "ScheduleConfig", "lr_at"]
