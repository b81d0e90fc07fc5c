"""The port's benchmark: self-play PPO training throughput of
``rl_selfplay_mnk_tpu_torch`` on one H100. ``run.py`` runs one cell."""
