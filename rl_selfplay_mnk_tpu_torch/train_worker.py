"""One run of one architecture (counterpart of the JAX package's
``train_worker.py``): board "13x13" is the 13x13x5 recipe (600M env steps,
the entropy schedule over 300M, minibatch 4096), anything else the 9x9x5
default; the family's learning rate and entropy; run ``run_<arch>_<board>``.

Usage::

    python -m rl_selfplay_mnk_tpu_torch.train_worker <arch> <board> [--device cpu]
"""

from __future__ import annotations

from .train import apply_family_hparams, big_board_horizons, get_default_config
from .train_all import device_arg, run_all


def worker_config(arch: str, board_size: str):
    config = get_default_config()
    config["architecture_name"] = arch
    if board_size == "13x13":
        config["mnk"] = (13, 13, 5)
        big_board_horizons(config)
        config["batch_size"] = 4096
    apply_family_hparams(config, arch)
    return config, {"project": "mnk_b", "run_name": f"run_{arch}_{board_size}", "group": "final",
                    "tags": [arch, board_size, "final_final"]}


def run_training(arch: str, board_size: str, device: str = "cuda") -> None:
    run_all([worker_config(arch, board_size)], device)


def main(argv=None) -> None:
    args = device_arg(__doc__.splitlines()[0], argv, positional=("arch", "board_size"))
    run_training(args.arch, args.board_size, args.device)


if __name__ == "__main__":
    main()
