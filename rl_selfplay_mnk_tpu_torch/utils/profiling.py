"""Where one training iteration's time goes, on the card.

Runs a training config (by default 9x9x5, ``resnet_b_s``, 384 envs,
n_steps 256, batch 8192, 4 epochs; ``--arch``, ``--mnk`` and ``--batch-size``
as in ``train.py``; ``--route`` forces a transformer's attention to one of
the routes ``tiny_head_attention`` lets a caller force, as chip_smoke.py's
path C does) for ``--warmup`` iterations, then traces one more
iteration with ``torch.profiler`` and prints: the wall time of the rollout
and the update, the device's busy time (sum of kernel times; one stream, so
no overlap) and idle share for each, the kernel launches (for the update
also a minibatch's share), the launches of the port's CUDA kernels, the
kernels that take the most device time and, from the program's spans
(``utils/tracing.py``, on while traced, so the Chrome traces carry them),
each layer's launches, idle share and idle seconds (``layer_report``; the
trace records host ops, which slow the eager launches). ``--watch``
traces a watch iteration's update, which also gathers the gradient
statistics. The last line is one JSON object with those numbers.

``--fused [--dispatch step|scan]`` traces instead one iteration of the
fused trainer (``alg/fused.py``) at the same config: its wall time untraced
(the mean over ``--iters`` iterations) and traced, the device's busy time
and idle share, the kernel launches in the trace, the CUDA graph replays,
the launches counted by the port's wrappers (under ``scan`` these count the
capture, not the replays) and the port's kernels found in the trace by
name. Without ``--fused`` the untraced iteration wall of the host loop is
reported the same way (``iteration_wall_s``).

``--tournament A B`` traces instead one half-pairing of a tournament
(``play_batch_games`` between the exports A and B, ``--games`` boards, after
one untraced half-pairing as warm-up) and prints the same numbers for it and
per turn: a turn is two dense policy forwards, the channel flip, one env
step and the bookkeeping, and ends in one host synchronisation.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.utils.profiling [--warmup 2] [--trace out.json] [--watch]
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --arch transformer_b_s
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --fused --dispatch scan [--arch transformer_b_s]
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --arch transformer_c_s --route infold
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --arch transformer_b_s_w --mnk 13 13 5 --batch-size 4096
    python -m rl_selfplay_mnk_tpu_torch.utils.profiling --mnk 9 9 5 --games 16 \\
        --tournament models/tpu_smoke30/model_00030.msgpack models/tpu_smoke30/model_00025.msgpack
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..alg.schedules import entropy_coef_at
from ..models import registry
from ..models.fold_bn import snapshot
from ..models.registry import eval_apply
from ..ops.attention import (
    attention_folded_bwd,
    attention_folded_fwd,
    attention_infold_bwd,
    attention_infold_fwd,
    attention_lane_slice_fwd,
    attention_packed_bwd,
    attention_packed_fwd,
    tiny_head_attention,
)
from ..ops.env_step import fused_step
from ..ops.layer_norm import layer_norm
from ..ops.resblock import fused_residual_block
from ..selfplay.policies import NNPolicy
from ..train import build_config, create_learner
from ..train_fused import create_fused_trainer, run_block
from . import tracing
from .hardware import detect_hardware_config


# The port's kernel wrappers, by the name their launch counts are reported under.
PORT_KERNELS = {
    "env_step": fused_step,
    "resblock": fused_residual_block,
    "attn_folded_fwd": attention_folded_fwd,
    "attn_folded_bwd": attention_folded_bwd,
    "attn_lane_slice_fwd": attention_lane_slice_fwd,
    "attn_infold_fwd": attention_infold_fwd,
    "attn_infold_bwd": attention_infold_bwd,
    "attn_packed_fwd": attention_packed_fwd,
    "attn_packed_bwd": attention_packed_bwd,
    "layer_norm": layer_norm,
}
# The kernel symbols of a wrapper whose symbols do not begin with its name
# (ATen's own LayerNorm kernels hold "layer_norm").
KERNEL_SYMBOLS = {"layer_norm": ("ln_rows_", "ln_cols_")}


def trace_launches(times) -> dict:
    """The port's kernels in a trace, by name: each kernel symbol begins
    with its wrapper's name (``env_step_kernel``, ``attn_folded_fwd_mma``...)
    or with one of its ``KERNEL_SYMBOLS``."""
    return {name: sum(c for kernel, (_, c) in times.items()
                      if any(s in kernel for s in KERNEL_SYMBOLS.get(name, (name,))))
            for name in PORT_KERNELS}


def reset_launches() -> None:
    for wrapper in PORT_KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in PORT_KERNELS.items()}


def kernel_times(prof) -> dict:
    """kernel name -> (total device microseconds, launches). User
    annotations (e.g. the optimizer step's range) are spans, not kernels."""
    out = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        annotation = getattr(evt, "is_user_annotation", False)
        if evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            rec = out[evt.name]
            rec[0] += evt.device_time_total
            rec[1] += 1
    return out


@contextlib.contextmanager
def spans_on():
    """The program's spans (``utils/tracing.py``) recorded while open, from
    none: a trace taken inside carries them as ranges."""
    tracing.clear()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


def trace_events(prof):
    """The card's work and the host's CUDA calls in a ``torch.profiler``
    trace, in nanoseconds on the profiler's clock: (kernels, launches),
    ``kernels`` [(start, end, correlation id, name)] by start (kernels,
    copies and sets; no annotation), ``launches`` {correlation id: host
    start} of the host's ``cuda*`` and ``cu*`` calls (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, whose id every node of the graph carries, ...)."""
    kernels, launches = [], {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            if not evt.is_user_annotation():
                kernels.append((evt.start_ns(), evt.end_ns(), evt.correlation_id(), evt.name()))
        elif evt.name().startswith("cu"):
            launches[evt.correlation_id()] = evt.start_ns()
    kernels.sort()
    return kernels, launches


def innermost_span(records):
    """host ns -> the index in ``records`` (``utils.tracing.records()``) of
    the innermost span open then, or None."""
    bounds = sorted({r[k] for r in records for k in ("start_ns", "end_ns")})
    owner = []
    for lo in bounds[:-1]:
        # spans nest, so the open span that began last is the innermost
        inside = [i for i, r in enumerate(records) if r["start_ns"] <= lo < r["end_ns"]]
        owner.append(max(inside) if inside else None)

    def at(t):
        i = bisect.bisect_right(bounds, t) - 1
        return owner[i] if 0 <= i < len(owner) else None
    return at


def layer_report(kernels, launches, records, layers=("rollout", "update"),
                 minibatches: int = 1) -> dict:
    """Each kernel given to the innermost span whose host interval holds
    its launch call (robust to the launch queue: a span may end long before
    its kernels run); ``unattributed`` counts the kernels whose launch call
    is not in the trace, ``unspanned`` those launched outside every span.
    Per layer in ``layers`` (the kernels of its spans and
    theirs): ``launches``, ``idle_share`` (1 - the union of their intervals
    over last end - first start) and ``idle_s``; each gap between busy
    intervals goes to the span that launched the kernel ending it
    (``idle_by_span``, by innermost name, "unspanned" outside every span).
    ``update_launches_per_minibatch``, by launch and by time (the kernels
    from the first to the last of the update's, by start)."""
    at = innermost_span(records)
    chains = []
    for r in records:
        names, p = {r["name"]}, r["parent"]
        while p is not None:
            names.add(records[p]["name"])
            p = records[p]["parent"]
        chains.append(names)
    found = [launches.get(corr) for _, _, corr, _ in kernels]
    owners = [None if t is None else at(t) for t in found]
    out = {"kernels": len(kernels), "unattributed": sum(t is None for t in found),
           "unspanned": sum(t is not None and o is None for t, o in zip(found, owners)),
           "layers": {}, "idle_by_span": defaultdict(float)}
    for layer in layers:
        mine = [k for k, o in zip(kernels, owners) if o is not None and layer in chains[o]]
        rec = {"launches": len(mine), "idle_share": None, "idle_s": 0.0}
        if mine:
            span_ns = max(k[1] for k in mine) - mine[0][0]
            busy = sum(end - start for start, end in merged_intervals(mine))
            rec["idle_share"] = 1.0 - busy / span_ns if span_ns else 0.0
        out["layers"][layer] = rec
    busy_end = None
    for k, o in zip(kernels, owners):
        if busy_end is not None and k[0] > busy_end:
            gap = (k[0] - busy_end) / 1e9
            out["idle_by_span"]["unspanned" if o is None else records[o]["name"]] += gap
            for layer in layers:
                if o is not None and layer in chains[o]:
                    out["layers"][layer]["idle_s"] += gap
        busy_end = k[1] if busy_end is None else max(busy_end, k[1])
    out["idle_by_span"] = dict(out["idle_by_span"])
    update = [i for i, o in enumerate(owners) if o is not None and "update" in chains[o]]
    if update:
        out["update_launches_per_minibatch"] = len(update) / minibatches
        out["update_launches_per_minibatch_by_time"] = (update[-1] - update[0] + 1) / minibatches
    return out


def merged_intervals(kernels) -> list:
    """The union of the kernels' intervals, as sorted disjoint [start, end]."""
    merged = []
    for start, end, *_ in kernels:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


@contextlib.contextmanager
def forced_route(arch: str, route: str | None):
    """While open, the registry builds ``arch`` with every attention forced
    to ``route`` (None: the dispatch decides)."""
    factory = registry.ARCHITECTURE_REGISTRY[arch]
    if route is not None:
        registry.ARCHITECTURE_REGISTRY[arch] = functools.partial(
            factory, attention_fn=functools.partial(tiny_head_attention, route=route))
    try:
        yield
    finally:
        registry.ARCHITECTURE_REGISTRY[arch] = factory


def profile_iteration(warmup: int = 2, trace: str | None = None, top: int = 15,
                      arch: str | None = None, mnk=None, batch_size: int | None = None,
                      route: str | None = None, watch: bool = False, iters: int = 2) -> dict:
    hw = detect_hardware_config("cuda")
    config = build_config(arch, mnk, batch_size)
    with forced_route(config["architecture_name"], route):
        learner, _, _, _ = create_learner(config, hw)
    generator = torch.Generator(device=hw.device).manual_seed(1)
    ent = entropy_coef_at(config["entropy_coef"], config["entropy_coef_schedule"], 0,
                          config["num_envs"], config["n_steps"])
    for _ in range(warmup):
        learner.learn(NNPolicy(eval_apply, snapshot(learner.model), generator), ent)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        learner.learn(NNPolicy(eval_apply, snapshot(learner.model), generator), ent)
    torch.cuda.synchronize()
    iteration_wall = (time.perf_counter() - t0) / iters
    print(f"host loop: {iteration_wall:.3f}s an iteration untraced (mean of {iters})")

    phases = {}
    kernels = {}
    launches = {}
    for phase in ("rollout", "update"):
        opponent = NNPolicy(eval_apply, snapshot(learner.model), generator)
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                spans_on():
            t0 = time.perf_counter()
            if phase == "rollout":
                traj, _ = learner.rollout(opponent)
            else:
                learner.update(traj, ent, watch=learner.grad_watch() if watch else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        layers = layer_report(*trace_events(prof), tracing.records(), (phase,),
                              learner.config.updates_per_iteration)
        if trace:
            prof.export_chrome_trace(trace.replace(".json", f".{phase}.json"))
        times = kernel_times(prof)
        busy = sum(t for t, _ in times.values()) / 1e6
        phases[phase] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
                         "kernel_launches": sum(c for _, c in times.values()),
                         "spans": layers}
        if phase == "update":
            phases[phase]["kernel_launches_per_minibatch"] = (
                phases[phase]["kernel_launches"] / learner.config.updates_per_iteration)
        launches[phase] = read_launches()
        kernels[phase] = sorted(
            ({"name": k[:90], "device_ms": t / 1e3, "count": c} for k, (t, c) in times.items()),
            key=lambda r: -r["device_ms"],
        )[:top]

    for phase, rec in phases.items():
        print(f"{phase}: wall {rec['wall_s']:.3f}s, device busy {rec['device_busy_s']:.3f}s, "
              f"idle share {rec['idle_share']:.3f}, {rec['kernel_launches']} kernel launches, "
              f"port kernels {json.dumps(launches[phase])}; idle by span "
              f"{json.dumps(rec['spans']['idle_by_span'])}")
        for r in kernels[phase]:
            print(f"  {r['device_ms']:9.3f} ms {r['count']:7d}x  {r['name']}")
    return {"device": torch.cuda.get_device_name(0), "architecture": config["architecture_name"],
            "route": route, "watch": watch, "mnk": list(config["mnk"]),
            "batch_size": config["batch_size"], "iteration_wall_s": iteration_wall,
            "phases": phases,
            "port_kernel_launches": launches, "top_kernels": kernels}


def profile_fused_iteration(dispatch: str = "scan", warmup: int = 1, iters: int = 2,
                            trace: str | None = None, top: int = 15, arch: str | None = None,
                            mnk=None, batch_size: int | None = None,
                            whole_graph: bool = False) -> dict:
    """One traced iteration of the fused trainer on the card, after
    ``warmup`` untraced ones (the first captures the graphs under
    ``scan``) and ``iters`` timed untraced ones; ``whole_graph`` then also
    times one whole iteration captured as a single graph
    (``time_whole_iteration_graph``)."""
    hw = detect_hardware_config("cuda")
    config = build_config(arch, mnk, batch_size)
    trainer = create_fused_trainer(config, hw, max_block=max(iters, 1))[0]
    it = 0
    t0 = time.perf_counter()
    for _ in range(warmup):
        run_block(trainer, dispatch, it, 1, 1.0)
        it += 1
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_block(trainer, dispatch, it, iters, 1.0)
    iteration_wall = (time.perf_counter() - t0) / iters
    it += iters
    reset_launches()
    replays = trainer.graph_replays
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, spans_on():
        t0 = time.perf_counter()
        run_block(trainer, dispatch, it, 1, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace.replace(".json", f".fused_{dispatch}.json"))
    spans = layer_report(*trace_events(prof), tracing.records(),
                         minibatches=trainer.config.updates_per_iteration)
    times = kernel_times(prof)
    busy = sum(t for t, _ in times.values()) / 1e6
    rec = {"device": torch.cuda.get_device_name(0), "architecture": config["architecture_name"],
           "mnk": list(config["mnk"]), "num_envs": config["num_envs"], "dispatch": dispatch,
           "warmup_s": setup, "iteration_wall_s": iteration_wall, "traced_wall_s": wall,
           "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
           "kernel_launches": sum(c for _, c in times.values()),
           "graph_replays": trainer.graph_replays - replays,
           "port_kernel_launches": read_launches(), "port_kernels_in_trace": trace_launches(times),
           "spans": spans,
           "top_kernels": sorted(({"name": k[:90], "device_ms": t / 1e3, "count": c}
                                  for k, (t, c) in times.items()),
                                 key=lambda r: -r["device_ms"])[:top]}
    print(f"fused {dispatch}: {iteration_wall:.3f}s an iteration untraced (mean of {iters}), "
          f"traced wall {wall:.3f}s, device busy {busy:.3f}s, idle share {rec['idle_share']:.3f}, "
          f"{rec['kernel_launches']} kernel launches, {rec['graph_replays']} graph replays, "
          f"port kernels in the trace {json.dumps(rec['port_kernels_in_trace'])}; idle by span "
          f"{json.dumps(spans['idle_by_span'])}")
    for r in rec["top_kernels"]:
        print(f"  {r['device_ms']:9.3f} ms {r['count']:7d}x  {r['name']}")
    if whole_graph:
        rec["whole_iteration_graph"] = time_whole_iteration_graph(trainer)
    return rec


def time_whole_iteration_graph(trainer) -> dict:
    """The alternative to the fused trainer's piecewise graphs: one whole
    iteration captured as a single CUDA graph, after the trainer's own
    capture (its warm-up). Times the capture (instantiation included) and
    two replays; counts the graph's nodes. The train state is put back
    afterwards."""
    saved = trainer.save_state(trainer.device)
    graph = torch.cuda.CUDAGraph()
    for generator in (trainer.generator, trainer.policy_generator):
        graph.register_generator_state(generator)
    trainer.begin_block(0, 1.0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        trainer.iteration()
    torch.cuda.synchronize()
    capture = time.perf_counter() - t0
    replays = []
    for _ in range(2):
        trainer.begin_block(0, 1.0, 1)  # the iteration writes metrics row 0
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(time.perf_counter() - t0)
    trainer.load_state(saved)
    rec = {"capture_s": capture, "replay_s": replays}
    print(f"whole-iteration graph: capture and instantiation {capture:.2f}s, replays "
          f"{', '.join(f'{r:.3f}s' for r in replays)}")
    return rec


def profile_half_pairing(paths, mnk=(9, 9, 5), games: int = 16, trace: str | None = None,
                         top: int = 15) -> dict:
    """One traced half-pairing between two exports on the card."""
    from ..compare.match_runner import play_batch_games
    from ..compare.model_loader import ModelLoader
    from ..env.mnk_env import EnvConfig

    device = detect_hardware_config("cuda").device
    models = ModelLoader(device).load_from_paths(list(paths))
    if len(models) != 2:
        raise ValueError(f"--tournament needs two exports, found {len(models)} in {list(paths)}")
    (params1, act1), (params2, act2) = (m.load_model() for m in models)
    cfg = EnvConfig(*mnk)
    generator = torch.Generator(device=device).manual_seed(0)
    play_batch_games(cfg, act1, act2, params1, params2, games, 0, generator, device)
    reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = play_batch_games(cfg, act1, act2, params1, params2, games, 0, generator, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace.replace(".json", ".tournament.json"))
    launches = read_launches()
    turns = launches["env_step"]  # one env step a turn
    times = kernel_times(prof)
    busy = sum(t for t, _ in times.values()) / 1e6
    total = sum(c for _, c in times.values())
    kernels = sorted(({"name": k[:90], "device_ms": t / 1e3, "count": c}
                      for k, (t, c) in times.items()), key=lambda r: -r["device_ms"])[:top]
    print(f"half-pairing {models[0].unique_id} vs {models[1].unique_id}, {games} games on "
          f"{'x'.join(map(str, mnk))}: result {result}, {turns} turns, wall {wall:.3f}s "
          f"({1e3 * wall / turns:.3f} ms a turn), device busy {busy:.4f}s, idle share "
          f"{1.0 - busy / wall:.3f}, {total} kernel launches ({total / turns:.1f} a turn), "
          f"port kernels {json.dumps(launches)}")
    for r in kernels:
        print(f"  {r['device_ms']:9.3f} ms {r['count']:7d}x  {r['name']}")
    return {"device": torch.cuda.get_device_name(0),
            "models": [m.unique_id for m in models],
            "architectures": [m.architecture_name for m in models], "mnk": list(mnk),
            "games": games, "turns": turns, "wall_s": wall, "wall_ms_per_turn": 1e3 * wall / turns,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall, "kernel_launches": total,
            "kernel_launches_per_turn": total / turns, "port_kernel_launches": launches,
            "top_kernels": kernels}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--trace", default=None, help="write Chrome traces next to this path")
    parser.add_argument("--arch", default=None, help="architecture registry name")
    parser.add_argument("--mnk", type=int, nargs=3, default=None, metavar=("M", "N", "K"))
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--route", choices=("folded", "infold"), default=None,
                        help="force every attention of a transformer to this route")
    parser.add_argument("--watch", action="store_true",
                        help="trace a watch iteration's update (gradient statistics gathered)")
    parser.add_argument("--tournament", nargs=2, default=None, metavar=("A", "B"),
                        help="trace one half-pairing between these two exports instead")
    parser.add_argument("--games", type=int, default=16, help="boards of the half-pairing")
    parser.add_argument("--fused", action="store_true",
                        help="trace an iteration of the fused trainer instead")
    parser.add_argument("--dispatch", choices=("step", "scan"), default="scan",
                        help="the fused trainer's dispatch (with --fused)")
    parser.add_argument("--iters", type=int, default=2,
                        help="untraced iterations timed before the traced one")
    parser.add_argument("--whole-graph", action="store_true",
                        help="with --fused --dispatch scan: also capture and time a whole "
                        "iteration as one graph")
    args = parser.parse_args(argv)
    if args.fused:
        print(json.dumps(profile_fused_iteration(args.dispatch, max(args.warmup, 1),
                                                 args.iters, args.trace, arch=args.arch,
                                                 mnk=args.mnk, batch_size=args.batch_size,
                                                 whole_graph=args.whole_graph)))
        return
    if args.tournament:
        print(json.dumps(profile_half_pairing(args.tournament, args.mnk or (9, 9, 5), args.games,
                                              args.trace)))
        return
    print(json.dumps(profile_iteration(args.warmup, args.trace, arch=args.arch, mnk=args.mnk,
                                       batch_size=args.batch_size, route=args.route,
                                       watch=args.watch, iters=args.iters)))


if __name__ == "__main__":
    main()
