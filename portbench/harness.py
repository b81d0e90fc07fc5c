"""The program's own training loops, driven with the benchmark's hooks.

``loop``: ``train.train_mnk``, the host loop (``PPOLearner.learn`` an
iteration, the opponent schedule, pool inserts, validation and the
promotion rule, the metrics line). ``fused``: ``train_fused.
train_mnk_fused``, the device-resident blocks (``run_block`` up to each
validation). The benchmark calls each with a logger and an exporter that
write nothing, and reaches into it only through names the loop looks up
at run time:

  * ``train.init_network``: the benchmark's weights in place of the
    program's initialiser;
  * ``create_learner`` / ``create_fused_trainer``: the learner or trainer
    is kept, and CUDA events (``Spans``) and the ``Probe`` are put around
    its calls (``rollout``/``update``, or the fused pieces);
  * ``PPOLearner.learn`` (loop) and ``run_block`` (fused): the window's
    boundaries, each the start of a group of iterations that ends in a
    validation; ``StopLoop`` leaves the loop once ``seconds`` have passed;
  * ``validate``: a span, and the boards its forwards see (for ``mfu``).

Set-up is everything before the window: the trainer, iteration 0 (copied
by the probe) and, before the first group, one validation (the program's
own at iteration ``validation_interval`` in the fused loop, whose first
block runs to it; one of the benchmark's on the same shapes in the host
loop, whose window starts at iteration 1).
"""

from __future__ import annotations

import contextlib
import copy
import time
from collections import defaultdict

import torch


class StopLoop(BaseException):
    """Leaves the program's training loop from a hook (the loop logs and
    skips an ``Exception``, not this)."""


class Spans:
    """CUDA events around the program's calls, by label; read once at the
    end (``ms``)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs = defaultdict(list)

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.enabled:
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.pairs[label].append((start, end))

    def ms(self) -> dict:
        if not self.pairs:
            return {}
        torch.cuda.synchronize()
        return {label: sum(s.elapsed_time(e) for s, e in pairs)
                for label, pairs in self.pairs.items()}


class Probe:
    """Copies of iteration 0 as the program produced it: the rollout's
    record, the first three minibatches' rows and metrics, AdamW's first
    moments after the first update and the parameters after the third.
    ``on_complete`` is called once the third is copied."""

    UPDATES = 3

    def __init__(self, model, optimizer, on_complete=None):
        self.names = {id(p): name for name, p in model.named_parameters()}
        self.optimizer = optimizer
        self.record = {"rows": [], "metrics": []}
        self.active = True
        self.on_complete = on_complete

    def rollout_done(self, traj: dict, final_obs: torch.Tensor) -> None:
        rec = self.record
        for key in ("obs", "mask", "actions", "log_probs", "values", "rewards", "dones"):
            rec[key] = traj[key].detach().clone()
        rec["final_obs"] = final_obs.detach().clone()

    def update_done(self, k: int, rows: torch.Tensor, metrics: torch.Tensor) -> None:
        """After update ``k`` (1-based) on ``rows``, whose metrics row is
        ``metrics``."""
        rec = self.record
        rec["rows"].append(rows.detach().clone())
        rec["metrics"].append(metrics.detach().float().cpu())
        if k == 1:
            state = self.optimizer.adamw.state
            rec["exp_avg"] = {self.names[id(p)]: state[p]["exp_avg"].detach().clone()
                              for p in self.optimizer.params}
        if k == self.UPDATES:
            rec["params"] = {self.names[id(p)]: p.detach().clone()
                             for p in self.optimizer.params}
            self.active = False
            if self.on_complete is not None:
                self.on_complete()


class CountingPolicy:
    """A policy that counts the boards its forwards see."""

    def __init__(self, policy, counter: list):
        self.policy, self.counter = policy, counter

    def act(self, obs, deterministic: bool = False):
        self.counter[0] += obs["observation"].shape[0]
        return self.policy.act(obs, deterministic)


class NullExporter:
    """The exporter's surface, writing nothing."""

    export_dir = None

    def export_model(self, *args, **kwargs) -> None:
        return None


@contextlib.contextmanager
def patched(pairs):
    """Set each (object, attribute, value) while open; put the old back."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def program_config(cfg: dict, traffic: dict, seed: int) -> dict:
    """The program's config dict for a cell, every key from the files."""
    from rl_selfplay_mnk_tpu_torch.train import build_config

    config = build_config(cfg["architecture_name"], cfg["mnk"], traffic["batch_size"])
    for key in ("learning_rate", "lr_warmup_steps", "lr_decay", "total_environment_steps",
                "entropy_coef", "gamma", "clip_range"):
        config[key] = cfg[key]
    config["entropy_coef_schedule"] = copy.deepcopy(cfg["entropy_coef_schedule"])
    for key in ("num_envs", "n_steps", "ppo_epochs", "opponent_pool", "validation_interval",
                "validation_episodes", "benchmark_update_threshold_score", "watch_interval"):
        config[key] = traffic[key]
    config.update(seed=seed, checkpoint_interval=0, resume=False, matchmaking=None,
                  opponents_per_iteration=1, pool_weighted=False, pool_eviction="fifo")
    return config


def check_states_config(learner_cfg, cfg: dict) -> None:
    """Refuse to time a program that departs from what the configuration
    states where it exposes it."""
    stated = {"gamma": cfg["gamma"], "gae_lambda": cfg["gae_lambda"],
              "clip_range": cfg["clip_range"], "value_coef": cfg["value_coef"]}
    for key, want in stated.items():
        got = getattr(learner_cfg, key)
        if abs(got - want) > 1e-12:
            raise SystemExit(f"the program's {key} is {got}, the configuration states {want}")


class Session:
    """One run of the program's training loop for a cell.

    ``run(weights, seconds)`` drives the loop through set-up and the
    window and returns the window's record; with ``setup_only`` it leaves
    the loop once the probe has copied iteration 0. Afterwards the
    learner or trainer stays for ``profile_iteration`` and ``probe``.
    """

    def __init__(self, cfg, traffic, seed, device, spans: Spans, dispatch=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.spans = spans
        self.dispatch = dispatch or traffic.get("dispatch", "auto")
        self.vint = traffic["validation_interval"]
        self.val_boards = [0]
        self.on_open = None
        self.probe = None
        self.errors = []
        self.layout = None
        self.t0 = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the window -----------------------------------------------------------

    def group_start(self, it: int) -> None:
        """Called where the loop starts iteration ``it``, the first of a
        group: opens the window at the first one it may, and leaves the
        loop at the first one after ``seconds``."""
        if it < self.first_window_iteration:
            return
        self.sync()
        now = time.perf_counter()
        if self.t0 is None:
            self.before_window()
            self.sync()
            if self.on_open is not None:
                self.on_open()
            self.spans.pairs.clear()
            self.boards0, self.it0 = self.val_boards[0], it
            self.t0 = self.mark = time.perf_counter()
            self.groups = []
            return
        self.groups.append(now - self.mark)
        self.mark = now
        if now - self.t0 >= self.seconds:
            self.wall, self.next_it = now - self.t0, it
            raise StopLoop

    def before_window(self) -> None:
        """What set-up runs last, after the loop's own warm-up."""

    def window(self) -> dict:
        per_iter = self.traffic["num_envs"] * self.traffic["n_steps"]
        iters = self.next_it - self.it0
        return {"iterations": iters, "env_steps": iters * per_iter, "wall_s": self.wall,
                "validation_boards": self.val_boards[0] - self.boards0,
                "group_s": self.groups}

    def counted_errors(self, handle):
        """The loop's error handler, noting each iteration or block that
        raised: the loop logs it and goes on, and its env steps would
        otherwise count as done."""
        def run(logger, error, iteration, *args, **kwargs):
            self.errors.append(f"iteration {iteration}: {error!r}")
            return handle(logger, error, iteration, *args, **kwargs)
        return run

    def counted_validate(self, validate):
        def run(env_cfg, agent, bench, *args, **kwargs):
            with self.spans.span("validation"):
                return validate(env_cfg, CountingPolicy(agent, self.val_boards),
                                CountingPolicy(bench, self.val_boards), *args, **kwargs)
        return run

    def run(self, weights: dict, seconds: float, setup_only: bool = False):
        from rl_selfplay_mnk_tpu_torch import train as train_mod
        from rl_selfplay_mnk_tpu_torch.utils.metrics import NullMetricsLogger

        self.seconds, self.setup_only = seconds, setup_only
        config = program_config(self.cfg, self.traffic, self.seed)
        config["fused_dispatch"] = self.dispatch

        def load(module, generator=None):
            del generator
            module.load_state_dict({k: v.detach().to("cpu") for k, v in weights.items()},
                                   strict=True)
            return module

        pairs = [(train_mod, "init_network", load)] + self.patches()
        try:
            with patched(pairs):
                self.train(config, NullMetricsLogger(run_name="portbench", config=config),
                           str(self.device))
        except StopLoop:
            return None if setup_only else self.window()
        raise RuntimeError("the program's training loop ended before the window closed")

    def probe_done(self) -> None:
        if self.setup_only:
            raise StopLoop


class LoopSession(Session):
    """``train.train_mnk``."""

    first_window_iteration = 1

    def patches(self) -> list:
        from rl_selfplay_mnk_tpu_torch import train as train_mod

        self.train = train_mod.train_mnk
        self.create_original = train_mod.create_learner
        return [(train_mod, "create_learner", self.create_learner),
                (train_mod, "make_exporter", lambda *a, **k: NullExporter()),
                (train_mod, "validate", self.counted_validate(train_mod.validate)),
                (train_mod, "handle_training_error",
                 self.counted_errors(train_mod.handle_training_error))]

    def create_learner(self, config, hw, dp=None):
        from rl_selfplay_mnk_tpu_torch.alg import ppo

        out = self.create_original(config, hw, dp)
        learner, self.env_cfg = out[0], out[1]
        self.learner = learner
        check_states_config(learner.config, self.cfg)
        self.layout = (learner.config.shuffle, learner.config.group_size)
        spans = self.spans
        probe = self.probe = Probe(learner.model, learner.optimizer, self.probe_done)
        rollout, update, learn = learner.rollout, learner.update, learner.learn
        self.learn_original = learn
        calls = [0]

        def hooked_rollout(*a, **k):
            with spans.span("rollout"):
                traj, fin = rollout(*a, **k)
            if probe.active:
                probe.rollout_done(traj, learner._obs["observation"])
            return traj, fin

        def hooked_update(*a, **k):
            with spans.span("update"):
                return update(*a, **k)

        def hooked_learn(opponent, entropy_coef, *a, **k):
            it = calls[0]
            calls[0] += 1
            self.last_learn = (opponent, entropy_coef)
            if it >= 1 and (it - 1) % self.vint == 0:
                self.group_start(it)
            if it:
                return learn(opponent, entropy_coef, *a, **k)
            original = ppo.minibatch_update
            done = [0]

            def probed(model, ppo_cfg, optimizer, flats, rows, *pa, **pk):
                metrics = original(model, ppo_cfg, optimizer, flats, rows, *pa, **pk)
                if done[0] < Probe.UPDATES:
                    done[0] += 1
                    probe.update_done(done[0], rows, metrics)
                return metrics

            with patched([(ppo, "minibatch_update", probed)]):
                return learn(opponent, entropy_coef, *a, **k)

        learner.rollout, learner.update, learner.learn = hooked_rollout, hooked_update, \
            hooked_learn
        return out

    def before_window(self) -> None:
        """One validation on the window's shapes: the host loop's first
        comes at iteration ``validation_interval``, inside the window."""
        from rl_selfplay_mnk_tpu_torch.models.fold_bn import snapshot
        from rl_selfplay_mnk_tpu_torch.models.registry import eval_apply
        from rl_selfplay_mnk_tpu_torch.selfplay.policies import NNPolicy
        from rl_selfplay_mnk_tpu_torch.selfplay.validation import validate

        gen = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003)
        frozen = snapshot(self.learner.model)
        validate(self.env_cfg, NNPolicy(eval_apply, frozen, gen), NNPolicy(eval_apply, frozen, gen),
                 self.traffic["validation_episodes"], self.device, gen)

    def profile_iteration(self) -> None:
        """One more ``PPOLearner.learn`` with the last iteration's
        opponent and entropy coefficient."""
        self.learn_original(*self.last_learn)

    def free(self) -> None:
        del self.learner, self.learn_original, self.last_learn


class FusedSession(Session):
    """``train_fused.train_mnk_fused``."""

    def patches(self) -> list:
        from rl_selfplay_mnk_tpu_torch import train_fused

        self.train = train_fused.train_mnk_fused
        self.first_window_iteration = self.vint + 1  # the first block runs to the first validation
        self.run_block_original = train_fused.run_block
        self.create_original = train_fused.create_fused_trainer
        return [(train_fused, "create_fused_trainer", self.create_trainer),
                (train_fused, "make_exporter", lambda *a, **k: NullExporter()),
                (train_fused, "validate", self.counted_validate(train_fused.validate)),
                (train_fused, "handle_training_error",
                 self.counted_errors(train_fused.handle_training_error)),
                (train_fused, "run_block", self.run_block)]

    def run_block(self, trainer, dispatch, it0, block_len, insert_weight):
        self.group_start(it0)
        self.dispatch_taken = dispatch
        return self.run_block_original(trainer, dispatch, it0, block_len, insert_weight)

    def create_trainer(self, config, hw, max_block=1, dp=None):
        out = self.create_original(config, hw, max_block, dp)
        self.trainer = trainer = out[0]
        check_states_config(trainer.config, self.cfg)
        self.layout = (trainer.config.shuffle, trainer.config.group_size)
        self.probe = Probe(trainer.model, trainer.optimizer, self.probe_done)
        self._hook(trainer)
        return out

    def _hook(self, trainer) -> None:
        """Spans and the probe around the pieces: around the graph replays
        under scan, around the eager pieces otherwise (the capture's warm-up
        runs the eager pieces, never ``replay``)."""
        probe, spans = self.probe, self.spans
        n_steps = trainer.config.n_steps
        label = {"step": "rollout", "prepare": "update", "minibatch": "update"}

        def metrics_so_far():
            return trainer.sums.detach().clone()

        def probed_minibatch(run):
            before = metrics_so_far()
            k = len(probe.record["rows"]) + 1
            rows = trainer.perms[trainer.mb.item()].clone()
            run()
            probe.update_done(k, rows, metrics_so_far() - before)

        replay = trainer.replay

        def hooked_replay(name, times=1):
            with spans.span(label.get(name, name)):
                if name == "minibatch" and probe.active:
                    for _ in range(Probe.UPDATES):
                        probed_minibatch(lambda: replay(name, 1))
                    if times > Probe.UPDATES:
                        replay(name, times - Probe.UPDATES)
                else:
                    replay(name, times)
            if name == "step" and probe.active:
                probe.rollout_done(trainer.traj, trainer.obs["observation"])

        trainer.replay = hooked_replay
        step, prepare, minibatch = trainer.step, trainer.prepare, trainer.minibatch
        steps = [0]

        def hooked_step(*a, **k):
            with spans.span("rollout"):
                step(*a, **k)
            steps[0] += 1
            if probe.active and steps[0] == n_steps:
                probe.rollout_done(trainer.traj, trainer.obs["observation"])

        def hooked_prepare(*a, **k):
            with spans.span("update"):
                prepare(*a, **k)

        def hooked_minibatch():
            with spans.span("update"):
                if probe.active:
                    probed_minibatch(minibatch)
                else:
                    minibatch()

        if self.device.type != "cuda" or self.dispatch == "step":
            trainer.step, trainer.prepare, trainer.minibatch = hooked_step, hooked_prepare, \
                hooked_minibatch

    def profile_iteration(self) -> None:
        """One more iteration through ``run_block``."""
        self.run_block_original(self.trainer, self.dispatch_taken, self.next_it, 1, 1.0)
        self.next_it += 1

    def free(self) -> None:
        del self.trainer


SESSIONS = {"fused": FusedSession, "loop": LoopSession}
