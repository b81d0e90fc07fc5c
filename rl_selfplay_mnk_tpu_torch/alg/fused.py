"""Device-resident fused training (counterpart of the JAX package's
``alg/fused.py``).

The host loop (``train.py``) draws each opponent with a host
``random.Random``, snapshots it, and reads the iteration's metrics on the
host. Here the whole iteration stays on the device:

  * the opponent draw (``selfplay.opponent_pool.draw_opponent``): 15% a
    (weighted, or with ``matchmaking`` a PFSP) sample from the
    ``DevicePool``, 85% the live weights, chosen with a
    dense ``where`` on a 0-d device predicate and folded into a static
    opponent model in place (``models.fold_bn.fold_into``);
  * the entropy coefficient and the lr come from the iteration counter on
    the device (``schedules.make_entropy_coef_fn``, ``make_lr_fn``);
  * rollout and update write fixed buffers at device counters (the step
    row, the minibatch), so nothing is allocated per iteration that a graph
    would have to own;
  * the league record, then the masked pool insert every
    ``insert_interval`` iterations (the JAX order);
  * each iteration's metrics become a row of a stacked (block, 12) buffer
    that the host reads once per block.

An iteration is five pieces: ``draw``, ``step`` (``n_steps`` times),
``prepare`` (bootstrap value, GAE, normalisation, flatten, the epochs'
permutations), ``minibatch`` (``ppo_epochs * num_minibatches`` times) and
``finish``. Two dispatches run them, both with the masked insert:

  * ``FusedTrainer.iteration``: eagerly (JAX ``_iteration_impl``, and the
    step dispatch's ``train_step_iteration``);
  * ``train_block``: the JAX "scan". On the card each piece is captured
    once as a CUDA graph (``FusedTrainer.capture``) and a block of
    iterations is replays: ``1 + n_steps + 1 + updates + 1`` graph launches
    an iteration in place of one kernel launch per operation. Capture
    needs the card; it is preceded by one eager warm-up iteration on a side
    stream (kernel builds, ``cudaFuncSetAttribute``, first-use set-up),
    after which the whole train state is put back, so the warm-up changes
    nothing. The explicit generators are registered with every graph, so
    each replay draws fresh numbers, the numbers that the eager dispatch
    draws. A failed capture raises; nothing falls back to the eager path.

The piecewise graphs and the eager pieces are the same code on the same
buffers, so the two dispatches give the same bits wherever two eager runs
do. Both put the same spans (``utils/tracing.py``) around the pieces or
their replays, never inside a captured piece: ``iteration`` over
``rollout`` (``draw`` and the steps), ``update`` (``update.prepare``,
``update.epochs``) and ``finish``; the rollout and update of a block's
iteration ``j`` are measured into ``phase_times[j]`` for the metrics line.

Over the ranks of a data-parallel world (the learner's ``dp``) the pieces
run on the rank's envs with the learner's collectives (``alg/ppo.py``), the
replicated ``DeviceOptimizer`` or, as the JAX package allows it with its
step dispatch, the ZeRO-1 learner (``alg/zero_epochs.ZeroOptimizer`` with
its device lr); the finished-episode sums are all-reduced in ``finish``.
Only the eager dispatch runs there: ``capture`` refuses a world of more
than one rank (a gloo collective cannot be captured in a CUDA graph).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.fold_bn import fold_into, snapshot
from ..models.registry import eval_apply
from ..selfplay.opponent_pool import (
    DevicePool,
    draw_opponent,
    pool_add_if,
    pool_member,
    pool_record_result_if,
)
from ..selfplay.policies import NNPolicy
from ..selfplay.wrapper import SelfPlayState
from ..env.mnk_env import EnvState
from ..parallel.mesh import shard_batched
from ..utils.tracing import Interval, span
from .ppo import (
    _METRIC_KEYS,
    PPOLearner,
    _minibatch_indices,
    _update_prepare_impl,
    minibatch_update,
    rank_indices,
    rollout_buffers,
    rollout_step,
)

# The columns of a stacked metrics row.
METRIC_KEYS = _METRIC_KEYS + (
    "entropy_coef", "historical_opponent", "fin_reward", "fin_length", "fin_count",
)
PIECES = ("draw", "step", "prepare", "minibatch", "finish")


class FusedTrainer:
    """The fused trainer's state, on fixed device buffers, and the five
    pieces of an iteration.

    ``learner`` brings the model, the config, an optimizer with its lr on
    the device (``DeviceOptimizer``, or ``ZeroOptimizer`` over ranks), the
    generator (draws, the agent's sampling, side draws, permutations), its
    ``dp`` and its env state (``reset_envs`` done), which is copied into the
    trainer's own buffers.
    ``policy_generator`` draws the opponent's moves. ``entropy_fn(it)`` and
    ``lr_fn(count)`` map device integers to device float32 (``schedules``).
    ``max_block`` bounds the iterations of a block (the rows of ``stacked``).
    """

    def __init__(self, learner: PPOLearner, pool: DevicePool, policy_generator: torch.Generator,
                 entropy_fn: Callable, lr_fn: Callable, pool_prob: float = 0.15,
                 insert_interval: int = 20, matchmaking: Optional[str] = None,
                 pfsp_power: float = 2.0, league_ema: float = 0.3, eviction: str = "fifo",
                 max_block: int = 1):
        if not isinstance(getattr(learner.optimizer, "lr", None), torch.Tensor):
            raise ValueError("the fused trainer needs an optimizer with its lr on the device "
                             "(DeviceOptimizer or ZeroOptimizer(lr=...))")
        if learner.config.fin_blocks:
            raise ValueError("the fused trainer does not implement mixed-opponent batches")
        self.model = learner.model
        self.config = cfg = learner.config
        self.optimizer = learner.optimizer
        self.generator = learner.generator
        self.policy_generator = policy_generator
        self.device = dev = learner.device
        self.dp = dp = learner.dp
        self.shard = None if dp is None else dp.shard
        world, self.rank_of = (1, (1, 0)) if dp is None else (dp.world, (dp.world, dp.rank))
        self.pool = pool
        self.entropy_fn, self.lr_fn = entropy_fn, lr_fn
        self.pool_prob, self.insert_interval = pool_prob, insert_interval
        self.matchmaking, self.pfsp_power, self.league_ema = matchmaking, pfsp_power, league_ema
        self.eviction = eviction
        self.opponent = snapshot(self.model)
        self.opponent_policy = NNPolicy(eval_apply, self.opponent, policy_generator)
        self.opponent_policy.shard = self.shard

        sp = learner._sp_state
        self.sp = SelfPlayState(
            env=EnvState(*(t.clone() for t in sp.env)),
            agent_side=sp.agent_side.clone(), pending_resets=sp.pending_resets.clone())
        self.obs = {k: v.clone() for k, v in learner._obs.items()}
        self.ep_rew, self.ep_len = learner._ep_rew.clone(), learner._ep_len.clone()

        self.traj, self.fin = rollout_buffers(cfg, dev, learner.num_envs)
        m, n, a = cfg.env.m, cfg.env.n, cfg.env.num_actions
        rows = cfg.total_batch // world  # this rank's samples
        if cfg.shuffle == "grouped":
            lead = (rows // cfg.group_size, cfg.group_size)
            mb_groups = cfg.batch_size // cfg.group_size
            shards = cfg.shard_groups
            per_minibatch = ((shards // world, mb_groups // shards) if shards > 1
                             else (mb_groups,))
        else:
            lead, per_minibatch = (rows,), (cfg.batch_size // world,)
        self.flats = {
            "obs": torch.empty(lead + (2, m, n), dtype=torch.uint8, device=dev),
            "mask": torch.empty(lead + (a,), dtype=torch.bool, device=dev),
            "actions": torch.empty(lead, dtype=torch.int64, device=dev),
            "old_logp": torch.empty(lead, dtype=torch.float32, device=dev),
            "returns": torch.empty(lead, dtype=torch.float32, device=dev),
            "adv": torch.empty(lead, dtype=torch.float32, device=dev),
        }
        self.perms = torch.empty((cfg.ppo_epochs * cfg.num_minibatches,) + per_minibatch,
                                 dtype=torch.int64, device=dev)

        def counter(shape=(1,)):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        self.it, self.t, self.mb, self.row = counter(()), counter(), counter(), counter()
        self.hist = torch.zeros((), dtype=torch.bool, device=dev)
        self.slot = counter(())
        self.ent = torch.zeros((), dtype=torch.float32, device=dev)
        self.sums = torch.zeros((len(_METRIC_KEYS),), dtype=torch.float32, device=dev)
        self.insert_weight = torch.ones((), dtype=torch.float32, device=dev)
        self.stacked = torch.zeros((max_block, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.graph_replays = 0
        self.phase_times = [(Interval(dev), Interval(dev)) for _ in range(max_block)]
        self.block_interval = Interval()
        self._phase = 0  # the block's next iteration, for phase_times

    # -- the pieces of an iteration -------------------------------------

    @torch.no_grad()
    def draw(self, historical: Optional[bool] = None, slot: Optional[int] = None) -> None:
        """The opponent draw, the entropy coefficient and the lr of
        iteration ``it``, and the opponent staged. ``historical`` and
        ``slot`` inject the draw (tests)."""
        pool = self.pool
        u = torch.rand((1 + pool.max_size,), generator=self.generator, device=self.device)
        hist, slot = draw_opponent(pool, u, self.pool_prob, self.matchmaking, self.pfsp_power)
        self.hist.copy_(hist)
        self.slot.copy_(slot)
        if historical is not None:
            self.hist.fill_(historical)
        if slot is not None:
            self.slot.fill_(slot)
        self.ent.copy_(self.entropy_fn(self.it))
        self.optimizer.lr.copy_(self.lr_fn(self.it * self.config.updates_per_iteration))
        member = pool_member(pool, self.slot)
        fold_into(self.opponent, {k: torch.where(self.hist, member[k], v)
                                  for k, v in self.model.state_dict().items()})
        self.t.zero_()
        self.fin.zero_()

    @torch.no_grad()
    def step(self, noise: Optional[torch.Tensor] = None,
             sides: Optional[torch.Tensor] = None) -> None:
        """One self-play step into row ``t`` of the trajectory."""
        sp, obs, ep_rew, ep_len = rollout_step(
            self.model, self.config, self.opponent_policy, self.sp, self.obs, self.ep_rew,
            self.ep_len, self.traj, self.fin, self.t, self.generator, noise, sides, self.shard)
        for dst, src in zip((*self.sp.env, self.sp.agent_side, self.sp.pending_resets),
                            (*sp.env, sp.agent_side, sp.pending_resets)):
            dst.copy_(src)
        for k, v in obs.items():
            self.obs[k].copy_(v)
        self.ep_rew.copy_(ep_rew)
        self.ep_len.copy_(ep_len)
        self.t.add_(1)

    @torch.no_grad()
    def prepare(self, epoch_indices=None) -> None:
        """Bootstrap value, GAE, normalisation and flatten into the flat
        buffers, and every epoch's permutation (``epoch_indices`` injects
        them: one tensor an epoch over the whole batch, as
        ``_minibatch_indices`` draws it)."""
        for k, v in _update_prepare_impl(self.model, self.config, self.traj, self.obs,
                                         self.dp).items():
            self.flats[k].copy_(v)
        if epoch_indices is None:
            epoch_indices = [_minibatch_indices(self.config, self.generator, self.device,
                                                *self.rank_of)
                             for _ in range(self.config.ppo_epochs)]
        else:
            epoch_indices = [rank_indices(self.config, idx, *self.rank_of)
                             for idx in epoch_indices]
        self.perms.copy_(torch.cat(list(epoch_indices)))
        self.sums.zero_()
        self.mb.zero_()

    def minibatch(self) -> None:
        """The update on minibatch ``mb`` of the permutations."""
        rows = self.perms.index_select(0, self.mb)[0]
        metrics = minibatch_update(self.model, self.config, self.optimizer, self.flats, rows,
                                   self.ent, dp=self.dp)
        with torch.no_grad():
            self.sums += metrics
            self.mb.add_(1)

    @torch.no_grad()
    def finish(self) -> torch.Tensor:
        """The league record, the pool insert (masked at ``it %
        insert_interval == 0``) and the metrics row, written to row ``row``
        of ``stacked``. Returns the row."""
        pool, fin = self.pool, self.fin
        if self.dp is not None:
            self.dp.coll.all_reduce(fin)
        if self.matchmaking:
            mean_rew = torch.where(fin[2] > 0, fin[0] / torch.clamp(fin[2], min=1.0),
                                   torch.zeros_like(fin[0]))
            pool_record_result_if(pool, self.slot, (mean_rew + 1.0) / 2.0, self.hist,
                                  self.league_ema)
        pool_add_if(pool, self.model.state_dict(), self.insert_weight,
                    (self.it % self.insert_interval) == 0, self.eviction)
        row = torch.cat([self.sums / self.config.updates_per_iteration, self.ent[None],
                         self.hist.to(torch.float32)[None], fin])
        self.stacked.index_copy_(0, self.row, row[None])
        self.row.add_(1)
        self.it.add_(1)
        return row

    def iteration(self, draws: Optional[dict] = None) -> torch.Tensor:
        """The five pieces in order, eagerly; returns the metrics row
        (``METRIC_KEYS``) on the device, unread. ``draws`` injects the
        iteration's randomness: ``historical``, ``slot``, ``noise`` (T, E, A)
        and ``sides`` (T, E) as ``rollout_impl`` takes them (over the whole
        batch), and ``epoch_indices``."""
        d = draws or {}
        rows = (lambda x: x) if self.shard is None else self.shard.take
        rollout_t, update_t = self.next_phase_times()
        with span("iteration"):
            with span("rollout", rollout_t):
                self.draw(d.get("historical"), d.get("slot"))
                for t in range(self.config.n_steps):
                    self.step(rows(d["noise"][t]) if "noise" in d else None,
                              rows(d["sides"][t]) if "sides" in d else None)
            with span("update", update_t):
                with span("update.prepare"):
                    self.prepare(d.get("epoch_indices"))
                with span("update.epochs"):
                    for _ in range(self.config.updates_per_iteration):
                        self.minibatch()
            with span("finish"):
                return self.finish()

    def next_phase_times(self):
        """The (rollout, update) intervals of the block's next iteration."""
        pair = self.phase_times[self._phase % len(self.phase_times)]
        self._phase += 1
        return pair

    # -- blocks, graphs and state --------------------------------------

    def begin_block(self, it0: int, insert_weight: float, block_len: int) -> None:
        """Point the counters at iteration ``it0`` and row 0, and set the
        block's insert weight (a fill on the device, no copy from the host)."""
        if block_len > self.stacked.shape[0]:
            raise ValueError(f"a block of {block_len} iterations exceeds max_block "
                             f"{self.stacked.shape[0]}")
        self.it.fill_(it0)
        self.row.zero_()
        self._phase = 0
        self.insert_weight.fill_(insert_weight)

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor that carries over from one iteration to the next:
        the model's parameters and BatchNorm statistics, AdamW's state, the
        pool, the env state, the observation and the episode accumulators."""
        out = {f"model/{k}": v for k, v in self.model.state_dict().items()}
        out.update({f"optimizer/{k}": v for k, v in self.optimizer.state_tensors().items()})
        out.update({f"pool/{k}": v for k, v in self.pool.tensors().items()})
        out.update({f"env/{k}": v for k, v in self.sp.env._asdict().items()})
        out.update({"agent_side": self.sp.agent_side, "pending_resets": self.sp.pending_resets,
                    "ep_rew": self.ep_rew, "ep_len": self.ep_len})
        out.update({f"obs/{k}": v for k, v in self.obs.items()})
        return out

    _ENV_KEYS = ("agent_side", "pending_resets", "ep_rew", "ep_len")

    def _is_env(self, key: str) -> bool:
        return key.startswith(("env/", "obs/")) or key in self._ENV_KEYS

    def global_state(self) -> dict:
        """``save_state`` with the env rows of every rank and, for the ZeRO
        learner, the whole flat moments (every rank calls it): a checkpoint
        that any world size resumes (``load_global_state``)."""
        state = self.save_state()
        if self.dp is None:
            return state
        coll, tensors = self.dp.coll, state["tensors"]
        for k, v in tensors.items():
            if self._is_env(k):
                tensors[k] = self.dp.gather_rows(v.to(self.device))
            elif k in ("optimizer/zero/exp_avg", "optimizer/zero/exp_avg_sq"):
                full = coll.all_gather(v.to(self.device))
                tensors[k] = full[:self.optimizer.layout.total].cpu()
        return state

    def load_global_state(self, state: dict) -> None:
        """Put ``global_state``'s checkpoint back: this rank's env rows and
        ZeRO chunk of it."""
        if self.dp is None:
            return self.load_state(state)
        world, rank = self.rank_of
        tensors = {}
        for k, v in state["tensors"].items():
            if self._is_env(k):
                v = shard_batched(v, world, rank, batch_size=self.config.num_envs)
            elif k in ("optimizer/zero/exp_avg", "optimizer/zero/exp_avg_sq"):
                layout = self.optimizer.layout
                v = torch.nn.functional.pad(v, (0, layout.padded - layout.total))
                v = v[self.optimizer.lo:self.optimizer.hi]
            tensors[k] = v
        self.load_state({**state, "tensors": tensors})

    def save_state(self, device="cpu") -> dict:
        """A copy of the state (``state_tensors`` and both generators)."""
        return {"tensors": {k: v.detach().to(device, copy=True)
                            for k, v in self.state_tensors().items()},
                "generator": self.generator.get_state(),
                "policy_generator": self.policy_generator.get_state()}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Put ``save_state``'s copy back, into the same tensors (the
        captured graphs keep reading them)."""
        saved = state["tensors"]
        live = self.state_tensors()
        if set(saved) != set(live):
            raise ValueError(f"state mismatch: missing {sorted(set(live) - set(saved))[:4]}, "
                             f"unexpected {sorted(set(saved) - set(live))[:4]}")
        for k, v in live.items():
            v.copy_(saved[k])
        self.generator.set_state(state["generator"])
        self.policy_generator.set_state(state["policy_generator"])

    def capture(self) -> float:
        """Capture each piece as a CUDA graph. One eager warm-up iteration
        on a side stream runs first; the state is put back afterwards.
        Raises on the CPU and on any failure of the capture. Returns the
        host seconds of the ``capture`` span."""
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need the card: the scan dispatch does not run on "
                             f"{self.device}")
        if self.dp is not None:
            raise ValueError("the scan dispatch is not run over more than one rank (a gloo "
                             "collective cannot be captured); use fused_dispatch='step'")
        captured = Interval()
        with span("capture", captured):
            saved = self.save_state(self.device)
            self.row.zero_()  # the warm-up writes a metrics row
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side), span("capture.warmup"):
                self.iteration()
            current.wait_stream(side)
            with span("capture.graphs"):
                mempool = torch.cuda.graph_pool_handle()
                graphs = {}
                for name in PIECES:
                    graph = torch.cuda.CUDAGraph()
                    for generator in (self.generator, self.policy_generator):
                        graph.register_generator_state(generator)
                    with torch.cuda.graph(graph, pool=mempool):
                        getattr(self, name)()
                    graphs[name] = graph
            self.graphs = graphs
            self.load_state(saved)
            torch.cuda.synchronize(self.device)
        return captured.host_s

    def replay(self, name: str, times: int = 1) -> None:
        graph = self.graphs[name]
        for _ in range(times):
            graph.replay()
        self.graph_replays += times


def train_block(trainer: FusedTrainer, it0: int, block_len: int,
                insert_weight: float = 1.0) -> torch.Tensor:
    """Iterations [it0, it0 + block_len) as graph replays (captured at the
    first call). Returns the block's (block_len, len(METRIC_KEYS)) metrics
    on the device, unread."""
    if not trainer.graphs:
        trainer.capture()
    trainer.begin_block(it0, insert_weight, block_len)
    cfg = trainer.config
    for _ in range(block_len):
        rollout_t, update_t = trainer.next_phase_times()
        with span("iteration"):
            with span("rollout", rollout_t):
                trainer.replay("draw")
                trainer.replay("step", cfg.n_steps)
            with span("update", update_t):
                with span("update.prepare"):
                    trainer.replay("prepare")
                with span("update.epochs"):
                    trainer.replay("minibatch", cfg.updates_per_iteration)
            with span("finish"):
                trainer.replay("finish")
    return trainer.stacked[:block_len]
