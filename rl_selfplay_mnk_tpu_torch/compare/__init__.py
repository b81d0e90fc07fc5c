from .elo import ELOTracker
from .match_runner import GameConfig, MatchRunner, play_batch_games
from .model_loader import ModelInfo, ModelLoader

__all__ = [
    "ModelInfo",
    "ModelLoader",
    "GameConfig",
    "MatchRunner",
    "play_batch_games",
    "ELOTracker",
]
