"""Parameter accounting across the model zoo (counterpart of the JAX
package's ``count_params.py``): a per-group breakdown of one model and a
cross-architecture comparison table, under the JAX package's parameter paths.

Usage:
    python -m rl_selfplay_mnk_tpu_torch.count_params --arch resnet_b_s --m 9 --n 9
    python -m rl_selfplay_mnk_tpu_torch.count_params --all --m 9 --n 9
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from .models.convert import state_dict_to_flax
from .models.registry import ARCHITECTURE_REGISTRY, create_model_from_architecture


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def param_counts(name: str, m: int, n: int) -> Dict[str, int]:
    """Flat {path: count} for one architecture, paths as the JAX package
    names them (``Conv_0/kernel``). Needs no device: the module is built on
    the CPU and only its shapes are read."""
    module, _ = create_model_from_architecture(name, (2, m, n), m * n)
    with torch.no_grad():
        params = state_dict_to_flax(module.state_dict(), getattr(module, "num_heads", None))["params"]
    return {path: int(leaf.size) for path, leaf in _flatten(params)}


def print_model_breakdown(name: str, m: int, n: int) -> int:
    counts = param_counts(name, m, n)
    total = sum(counts.values())
    print(f"\n=== {name} @ {m}x{n}: {total:,} parameters ===")
    by_group: Dict[str, int] = {}
    for path, cnt in counts.items():
        group = path.split("/")[0]
        by_group[group] = by_group.get(group, 0) + cnt
    for group, cnt in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:<40} {cnt:>10,}  ({100 * cnt / total:5.1f}%)")
    return total


def print_comparison(m: int, n: int) -> None:
    print(f"\n=== Architecture comparison @ {m}x{n} ===")
    rows = [(name, sum(param_counts(name, m, n).values())) for name in sorted(ARCHITECTURE_REGISTRY)]
    width = max(len(r[0]) for r in rows)
    for name, total in sorted(rows, key=lambda r: r[1]):
        print(f"  {name:<{width}} {total:>12,}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Count model parameters")
    parser.add_argument("--arch", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--m", type=int, default=9)
    parser.add_argument("--n", type=int, default=9)
    args = parser.parse_args(argv)

    if args.all or args.arch is None:
        print_comparison(args.m, args.n)
    if args.arch:
        print_model_breakdown(args.arch, args.m, args.n)


if __name__ == "__main__":
    main()
