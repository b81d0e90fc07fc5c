"""PyTorch/CUDA port of the self-play PPO framework for MNK games.

The package mirrors ``rl_selfplay_mnk_tpu``'s layout (``env/``, ``ops/``,
``models/``, ``selfplay/``, ``alg/``, ``compare/``, ``utils/``, ``train.py``,
``compare_models.py``, ``play.py``, ``count_params.py``) and its public names. It imports ``torch`` and ``numpy`` only: the JAX package is
its reference, held against it by the tests, never imported from here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CUDA tensor the env step, the eval-mode residual block and the
attention are hand-written CUDA kernels (``csrc/``); on a CPU tensor the
same functions run their plain PyTorch versions.
"""

__version__ = "0.1.0"
