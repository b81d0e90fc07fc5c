from .gae import compute_gae
from .ppo import PPOConfig, PPOLearner, PPOOptimizer, TrainingMetrics, pick_group_size
from .schedules import entropy_coef_at, make_lr_schedule

__all__ = [
    "compute_gae",
    "PPOConfig",
    "PPOLearner",
    "PPOOptimizer",
    "TrainingMetrics",
    "pick_group_size",
    "entropy_coef_at",
    "make_lr_schedule",
]
