"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell (``cells/<cell>.json``), its configuration
(``configs/<name>.json``) and its traffic (``traffic/<name>.json``) by
name, makes the weights on the card from the seed and drives the
program's own training loop that the traffic names (``harness.py``):
set-up runs iteration 0, copied by the probe, and one validation; the
window times whole groups of iterations, each ending in its validation,
until ``--seconds`` have passed. It reads the peak memory, and with
``--trace 1`` the per-layer metrics (``metrics/<name>.py``, those that
``BENCHMARK.json`` lists for the cell) from the window's spans and from
iterations run after it under ``torch.profiler``. Last, with the
program's state freed, it holds iteration 0 against the plain reference
(``check.py``) and prints each compared number beside its limit on
standard error and, as its last line on standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last.

Exits 2 without a card (or with fewer than the cell asks for), 3 where the
program (``rl_selfplay_mnk_tpu_torch``) is not in the checkout, and 4 where
the process has loaded JAX, flax or the JAX package by the end; none of
these prints a result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
_HERE = Path(__file__).resolve().parent
REPO = _HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rl_selfplay_mnk_tpu")
THREADS = 2  # host threads for torch's CPU ops: the load of one process, kept small


def seconds_since_start() -> float:
    """Seconds since this process started (from /proc where it exists,
    else since this module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's, optax's,
    orbax's or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every cache that the card's toolchain may write, at a fixed path in
    the checkout (the program's nvcc builds go to its own ``_build/``)."""
    cache = REPO / ".portbench_cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None, device: str = "cuda", traffic_overrides=None, dispatch=None) -> dict:
    """The run; returns the result line's object, or {"exit": code} where
    it prints none. ``device``, ``traffic_overrides`` and ``dispatch`` let a
    test drive a tiny cell on the CPU."""
    args = parse_args(argv)
    cache_dirs()
    import torch

    torch.set_num_threads(THREADS)
    from portbench import spec

    chips = spec.chips(args.workload)
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return {"exit": 2}
    try:
        import rl_selfplay_mnk_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not in this checkout ({exc})", file=sys.stderr)
        return {"exit": 3}

    from portbench import check, harness, reference, yardstick

    cfg, traffic = spec.cell(args.workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    limits = check.load_limits(args.workload)
    seed = args.seed % (1 << 62)
    if device == "cuda":
        print(f"# card: {card_line()}", file=sys.stderr)
        torch.cuda.reset_peak_memory_stats()

    spans = harness.Spans(args.trace == 1 and device == "cuda")
    session = harness.SESSIONS[traffic["runner"]](cfg, traffic, seed, device, spans, dispatch)
    weights = reference.make_weights(cfg, seed, device)
    opened = {}

    def on_open():
        opened["setup_s"] = seconds_since_start()

    session.on_open = on_open
    win = session.run(weights, args.seconds)
    setup_s = opened["setup_s"]
    print(f"# set-up {setup_s:.3f} s", file=sys.stderr)
    print(f"# window: {win['iterations']} iterations, {win['env_steps']} env steps in "
          f"{win['wall_s']:.3f} s; groups {[round(g, 3) for g in win['group_s']]} s",
          file=sys.stderr)
    device_rec = {"platform": "gpu" if device == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                  "count": 1}
    out = {"correct": False, "attempted": win["iterations"], "failed": 0}
    if args.trace:
        ctx = {"cfg": cfg, "traffic": traffic, "window": win, "spans_ms": spans.ms(),
               "profile": None}
        spans.enabled = False
        if device == "cuda":
            ctx["profile"] = profile(session)
            device_rec["busy_s"] = ctx["profile"]["busy_s"]
            device_rec["window_s"] = ctx["profile"]["window_s"]
        metrics = {}
        for name in spec.metric_names(args.workload):
            reader = spec.load_metric(name)
            value = reader.read(ctx, yardstick)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        out["metrics"] = metrics
        if ctx["profile"] is not None:
            out["breakdown"] = {"device_ops": ctx["profile"]["device_ops"],
                                "idle_gaps": ctx["profile"]["idle_gaps"]}
    else:
        out["metrics"] = {
            "env_steps_per_s": {"value": win["env_steps"] / win["wall_s"], "unit": "env-steps/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    if device == "cuda":
        device_rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    out["device"] = device_rec

    errors = list(session.errors)
    for line in errors[:5]:
        print(f"portbench: the loop raised in {line}", file=sys.stderr)
    out["failed"] = len(errors)
    record, layout = session.probe.record, session.layout
    session.free()
    del session
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    verdict = check.judge(cfg, traffic, weights, record, layout, limits)
    out["correct"] = verdict["correct"] and not errors
    out["checks"] = {k: {"value": v, "limit": verdict["limits"].get(k)}
                     for k, v in verdict["numbers"].items()}
    out["checks"]["iteration_errors"] = {"value": len(errors), "limit": 0}

    found = forbidden_modules()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}; the port's run must not",
              file=sys.stderr)
        return {"exit": 4}
    return out


def profile(session) -> dict:
    """Three more iterations after the window: one untraced, one under
    ``torch.profiler`` recording the card's activity alone (the busy time,
    the kernels by name, the top device ops: no host op is recorded, so
    the eager launches run at their own pace), and one recording the host's
    ops too, for what the host was doing in the longest idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity

    from portbench import trace

    session.sync()
    t0 = time.perf_counter()
    session.profile_iteration()
    session.sync()
    plain = time.perf_counter() - t0
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.profile_iteration()
        session.sync()
        wall = time.perf_counter() - t0
    out = trace.summarise(prof, wall)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.profile_iteration()
        session.sync()
        host_wall = time.perf_counter() - t0
    out["idle_gaps"] = trace.idle_gaps(trace.busy_intervals(trace.device_kernels(prof)),
                                       trace.host_events(prof))
    print(f"# traced iteration: {out['busy_s']:.4f} s busy in {wall:.4f} s (card only); "
          f"untraced {plain:.4f} s; with the host's ops {host_wall:.4f} s", file=sys.stderr)
    return out


def main(argv=None) -> int:
    out = run(argv)
    if "exit" in out:
        return out["exit"]
    for name, rec in out["checks"].items():
        print(f"{name} {rec['value']!r} limit {rec['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
