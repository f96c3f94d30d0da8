from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import ScheduleConfig, make_schedule
from repro_torch.optim.sct_optimizer import SCTOptimizer, TrainState, make_sct_optimizer

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
    "ScheduleConfig", "make_schedule", "SCTOptimizer", "TrainState", "make_sct_optimizer",
]
