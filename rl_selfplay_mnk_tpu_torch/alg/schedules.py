"""Learning-rate and entropy-coefficient schedules (counterpart of the JAX
package's ``alg/schedules.py``).

Both advance once per training iteration. The lr schedule maps the
optimizer's update count to an lr that is constant within an iteration:
linear warmup 0.01x -> 1.0x over ``warmup_env_steps`` worth of iterations,
then constant, or a linear decay 1.0x -> 0.1x.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def make_lr_schedule(
    base_lr: float,
    warmup_env_steps: int,
    total_env_steps: int,
    num_envs: int,
    n_steps: int,
    updates_per_iteration: int,
    decay: bool = False,
):
    """update count -> lr (a Python float)."""
    steps_per_iteration = num_envs * n_steps
    total_iterations = max(1, total_env_steps // steps_per_iteration)
    warmup_iterations = (
        max(1, warmup_env_steps // steps_per_iteration) if warmup_env_steps > 0 else 0
    )
    decay_iterations = max(1, total_iterations - warmup_iterations)

    def schedule(count: int) -> float:
        it = float(count // updates_per_iteration)
        if it < warmup_iterations:
            wfrac = min(max(it / warmup_iterations, 0.0), 1.0)
            return base_lr * (0.01 + 0.99 * wfrac)
        if decay:
            dfrac = min(max((it - warmup_iterations) / decay_iterations, 0.0), 1.0)
            return base_lr * (1.0 - 0.9 * dfrac)
        return base_lr

    return schedule


def entropy_coef_at(
    initial_coef: float,
    schedule: Optional[Dict[str, Any]],
    iteration: int,
    num_envs: int,
    n_steps: int,
) -> float:
    """Entropy coefficient in effect during training iteration ``iteration``."""
    if schedule is None or iteration <= 0:
        return float(initial_coef)
    env_steps = iteration * num_envs * n_steps
    stype = schedule.get("type", "constant")
    params = schedule.get("params", {})
    if stype == "linear":
        final_coef = params.get("final_coef", 0.0)
        total_steps = params.get("total_steps", 10_000_000)
        if env_steps >= total_steps:
            return float(final_coef)
        progress = env_steps / total_steps
        return float(initial_coef * (1 - progress) + final_coef * progress)
    if stype == "exponential":
        decay_rate = params.get("decay_rate", 0.99)
        return float(initial_coef * (decay_rate ** (env_steps / 1000)))
    return float(initial_coef)
