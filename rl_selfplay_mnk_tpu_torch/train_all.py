"""Batch experiment: the six budget-tier architectures at 9x9x5, one run
after another (counterpart of the JAX package's ``train_all.py``): the
default config with each family's learning rate and entropy schedule
(``train.apply_family_hparams``), runs ``run4_<arch>``.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.train_all [--device cpu]
"""

from __future__ import annotations

import argparse

from .train import apply_family_hparams, get_default_config, train_mnk
from .utils.metrics import MetricsLogger

ARCHITECTURES = [
    "transformer_b_l",
    "transformer_b_s",
    "resnet_b_l",
    "resnet_b_s",
    "cnn_b_l",
    "cnn_b_s",
]


def device_arg(description: str, argv=None, positional=()) -> argparse.Namespace:
    """The batch entries' command line: their positionals and ``--device``."""
    parser = argparse.ArgumentParser(description=description)
    for name in positional:
        parser.add_argument(name)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def run_all(configs, device: str) -> None:
    """``train_mnk`` on each (config, logger arguments) in turn."""
    for config, logger_args in configs:
        config["device"] = device
        with MetricsLogger(config=config, **logger_args) as logger:
            train_mnk(config, logger)


def configs_9x9():
    for arch in ARCHITECTURES:
        config = apply_family_hparams(get_default_config(), arch)
        config["architecture_name"] = arch
        yield config, {"project": "mnk_b", "run_name": f"run4_{arch}",
                       "group": "main_run2_small_board", "tags": [arch, "main_experiment"]}


def main(argv=None) -> None:
    args = device_arg(__doc__.splitlines()[0], argv)
    run_all(configs_9x9(), args.device)


if __name__ == "__main__":
    main()
