"""Batch experiment: the six budget-tier architectures on the 13x13x5
board (counterpart of the JAX package's ``train_all_13.py``): 700M env
steps, the entropy schedule over 300M, minibatch 4096, each family's
learning rate and entropy, runs ``run_<arch>_13x13``.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.train_all_13 [--device cpu]
"""

from __future__ import annotations

from .train import apply_family_hparams, get_default_config
from .train_all import ARCHITECTURES, device_arg, run_all


def configs_13x13():
    for arch in ARCHITECTURES:
        config = get_default_config()
        config["architecture_name"] = arch
        config["mnk"] = (13, 13, 5)
        config["total_environment_steps"] = 700_000_000
        config["entropy_coef_schedule"]["params"]["total_steps"] = 300_000_000
        config["batch_size"] = 4096
        apply_family_hparams(config, arch)
        yield config, {"project": "mnk_b", "run_name": f"run_{arch}_13x13",
                       "group": "main_run_13x13_board", "tags": [arch, "13x13"]}


def main(argv=None) -> None:
    args = device_arg(__doc__.splitlines()[0], argv)
    run_all(configs_13x13(), args.device)


if __name__ == "__main__":
    main()
