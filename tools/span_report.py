"""One run of a benchmark cell (``portbench/``) with the port's spans on or
off, for what the benchmark's readers do not read yet.

    python3 tools/span_report.py --workload <cell> --seed <n> --seconds 30 --spans <0|1>

Drives the cell as ``portbench/run.py --trace 0`` does (the harness's
``Session``: set-up, then whole groups of iterations until ``--seconds``
have passed), with ``utils.tracing`` enabled before it (``--spans 1``)
or not, and skips the comparison that decides ``correct``. Prints one JSON
line: ``env_steps_per_s`` and ``setup_s`` as the benchmark reads them; with
``--spans 1`` also

  * ``coverage``: the share of the window's host wall under the spans
    ``iteration``, ``validation``, ``read`` and ``block``;
  * ``validation_ms``: the mean ``validation`` span of the window;
  * ``capture_s``, ``capture.warmup_s``, ``capture.graphs_s``: the
    ``capture`` span and its two children (fused cells);
  * ``layers_device_s``: the device seconds of the window's ``short_conv``
    and ``moe`` spans (LFM2's forwards; 0 for the other families), and
    ``counters``: each of ``utils.tracing``'s counters over the window and
    after (its count, mean and largest value: LFM2's
    ``moe.expert_load_max_over_mean`` and ``moe.not_held_share``);
  * ``card``: one more iteration after the window, traced for the card alone
    (as ``run.py``'s ``device_idle_share`` is): its wall, busy and idle
    seconds, and ``utils.profiling.layer_report`` of it: the launches, idle
    share and idle seconds of ``rollout`` and ``update``, the idle seconds
    by innermost span, the update's launches per minibatch by launch call
    and by time.

Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def covered(records, names, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) under the union of the spans named ``names``."""
    parts = sorted((max(r["start_ns"], lo), min(r["end_ns"], hi)) for r in records
                   if r["name"] in names and r["end_ns"] > lo and r["start_ns"] < hi)
    total, end = 0, lo
    for start, stop in parts:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def card_iteration(session, updates: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rl_selfplay_mnk_tpu_torch.utils import tracing
    from rl_selfplay_mnk_tpu_torch.utils.profiling import (
        layer_report,
        merged_intervals,
        trace_events,
    )

    session.sync()
    session.profile_iteration()
    session.sync()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.profile_iteration()
        session.sync()
        wall = time.perf_counter() - t0
    kernels, launches = trace_events(prof)
    busy = sum(stop - start for start, stop in merged_intervals(kernels))
    report = layer_report(kernels, launches, tracing.records(), minibatches=updates)
    idle = wall - busy / 1e9
    layered = sum(report["layers"][k]["idle_s"] for k in ("rollout", "update"))
    return {"wall_s": wall, "busy_s": busy / 1e9, "idle_s": idle, "idle_share": idle / wall,
            "layers_idle_within": layered <= idle + 1e-3, **report}


def main(argv=None, device: str = "cuda", traffic_overrides=None) -> int:
    """``device`` and ``traffic_overrides`` let a test drive a tiny cell on
    the CPU (no card-only iteration there)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    from portbench import harness, reference, spec
    from portbench import run as bench

    bench.cache_dirs()
    import torch

    torch.set_num_threads(bench.THREADS)
    if device == "cuda" and not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    from rl_selfplay_mnk_tpu_torch.utils import tracing

    shift = time.time_ns() - time.perf_counter_ns()
    if args.spans:
        tracing.enable()
    cfg, traffic = spec.cell(args.workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    seed = args.seed % (1 << 62)
    session = harness.SESSIONS[traffic["runner"]](
        cfg, traffic, seed, device, harness.Spans(False),
        "step" if device == "cpu" and traffic["runner"] == "fused" else None)
    weights = reference.make_weights(cfg, seed, device)
    opened = {}
    session.on_open = lambda: opened.setdefault("setup_s", bench.seconds_since_start())
    win = session.run(weights, args.seconds)
    out = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
           "card_name": bench.card_line() if device == "cuda" else "cpu",
           "iterations": win["iterations"],
           "env_steps_per_s": win["env_steps"] / win["wall_s"], "setup_s": opened["setup_s"]}
    if args.spans:
        records = tracing.records()
        lo = int(session.t0 * 1e9) + shift
        hi = lo + int(win["wall_s"] * 1e9)
        out["coverage"] = covered(records, {"iteration", "validation", "read", "block"},
                                  lo, hi) / (hi - lo)
        vals = [r["end_ns"] - r["start_ns"] for r in records
                if r["name"] == "validation" and lo <= r["start_ns"] < hi]
        out["validation_ms"] = sum(vals) / len(vals) / 1e6 if vals else None
        for name in ("capture", "capture.warmup", "capture.graphs"):
            found = [r["end_ns"] - r["start_ns"] for r in records if r["name"] == name]
            out[f"{name}_s"] = found[0] / 1e9 if found else None
        out["layers_device_s"] = {
            name: sum(r["device_s"] or 0.0 for r in records
                      if r["name"] == name and lo <= r["start_ns"] < hi)
            for name in ("short_conv", "moe")}
        out["counters"] = {name: {"count": len(v), "mean": sum(v) / len(v), "max": max(v)}
                           for name, v in tracing.counters().items() if v}
        if device == "cuda":
            learner = getattr(session, "trainer", None) or session.learner
            out["card"] = card_iteration(session, learner.config.updates_per_iteration)
        tracing.disable()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
