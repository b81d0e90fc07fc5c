"""Learning-rate and entropy-coefficient schedules (counterpart of the JAX
package's ``alg/schedules.py``).

Both advance once per training iteration. The lr schedule maps the
optimizer's update count to an lr that is constant within an iteration:
linear warmup 0.01x -> 1.0x over ``warmup_env_steps`` worth of iterations,
then constant, or a linear decay 1.0x -> 0.1x.

The fused trainer (``alg/fused.py``) reads neither on the host: its twins
``make_lr_fn`` and ``make_entropy_coef_fn`` map a 0-d integer tensor on the
device to a 0-d float32 tensor, with the JAX package's float32 arithmetic
(its ``make_lr_schedule`` and ``make_entropy_coef_fn``), so a captured CUDA
graph computes them from its iteration counter.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


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


def make_lr_fn(
    base_lr: float,
    warmup_env_steps: int,
    total_env_steps: int,
    num_envs: int,
    n_steps: int,
    updates_per_iteration: int,
    decay: bool = False,
):
    """update count (a 0-d integer tensor) -> lr (a 0-d float32 tensor on
    its device), the JAX package's ``make_lr_schedule`` in float32."""
    steps_per_iteration = num_envs * n_steps
    total_iterations = max(1, total_env_steps // steps_per_iteration)
    warmup_iterations = (
        max(1, warmup_env_steps // steps_per_iteration) if warmup_env_steps > 0 else 0
    )
    decay_iterations = max(1, total_iterations - warmup_iterations)

    def fn(count: torch.Tensor) -> torch.Tensor:
        it = torch.div(count, updates_per_iteration, rounding_mode="floor").to(torch.float32)
        if warmup_iterations > 0:
            wfrac = torch.clamp(it / warmup_iterations, 0.0, 1.0)
        else:
            wfrac = torch.ones_like(it)
        warm = 0.01 + 0.99 * wfrac
        if decay:
            main = 1.0 - 0.9 * torch.clamp((it - warmup_iterations) / decay_iterations, 0.0, 1.0)
        else:
            main = torch.ones_like(it)
        return base_lr * torch.where(it < warmup_iterations, warm, main)

    return fn


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


def make_entropy_coef_fn(
    initial_coef: float,
    schedule: Optional[Dict[str, Any]],
    num_envs: int,
    n_steps: int,
):
    """iteration (a 0-d integer tensor) -> entropy coefficient (a 0-d
    float32 tensor on its device): ``entropy_coef_at`` with the JAX
    package's ``make_entropy_coef_fn`` float32 arithmetic."""
    initial = float(initial_coef)
    steps_per_iter = float(num_envs * n_steps)
    stype = (schedule or {}).get("type", "constant")
    params = (schedule or {}).get("params", {})

    if schedule is not None and stype == "linear":
        final = float(params.get("final_coef", 0.0))
        total = float(params.get("total_steps", 10_000_000))

        def fn(iteration: torch.Tensor) -> torch.Tensor:
            env_steps = iteration.to(torch.float32) * steps_per_iter
            progress = torch.clamp(env_steps / total, 0.0, 1.0)
            coef = initial * (1.0 - progress) + final * progress
            return torch.where(iteration <= 0, torch.full_like(coef, initial), coef)

        return fn

    if schedule is not None and stype == "exponential":
        decay_rate = float(params.get("decay_rate", 0.99))

        def fn(iteration: torch.Tensor) -> torch.Tensor:
            env_steps = iteration.to(torch.float32) * steps_per_iter
            coef = initial * torch.pow(decay_rate, env_steps / 1000.0)
            return torch.where(iteration <= 0, torch.full_like(coef, initial), coef)

        return fn

    def fn(iteration: torch.Tensor) -> torch.Tensor:
        return torch.full((), initial, dtype=torch.float32, device=iteration.device)

    return fn
