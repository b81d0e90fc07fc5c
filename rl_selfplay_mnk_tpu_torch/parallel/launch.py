"""Start the ranks of a data-parallel run on this host, one process each,
and collect what each returns.

``launch("package.module:function", world, kwargs)`` runs
``function(**kwargs)`` in ``world`` processes that have joined one process
group (``parallel.mesh.join_group``, a group of one included; rendezvous
through a file in a fresh temporary directory, so concurrent launches
never share a port) and returns the ranks' return values and outputs in
rank order (``RankGroup`` starts them and collects them later, so the
caller can work meanwhile). Every process is killed
when the group outlives ``timeout`` seconds or a rank fails, and the error
names the rank and ends with its output, so a deadlock fails one call
instead of hanging its caller.

The worker side is this module's ``__main__``::

    python -m rl_selfplay_mnk_tpu_torch.parallel.launch <spec dir> <rank>
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional, Tuple


class RankGroup:
    """``world`` processes running ``target(**kwargs)``, one a rank, started
    at construction; ``wait`` collects them."""

    def __init__(self, target: str, world: int, kwargs: Optional[dict] = None,
                 timeout: float = 120.0, device: Optional[str] = None,
                 env: Optional[dict] = None):
        self.target, self.world, self.timeout = target, world, timeout
        self.spec_dir = tempfile.mkdtemp(prefix="mnk_ranks_")
        with open(os.path.join(self.spec_dir, "spec.pkl"), "wb") as f:
            pickle.dump({"target": target, "kwargs": kwargs or {}, "world": world,
                         "device": device,
                         "init": "file://" + os.path.join(self.spec_dir, "store")}, f)
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        child_env.update(env or {})
        self.deadline = time.monotonic() + timeout
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(os.path.join(self.spec_dir, f"rank{rank}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "rl_selfplay_mnk_tpu_torch.parallel.launch",
                 self.spec_dir, str(rank)], stdout=log, stderr=subprocess.STDOUT,
                env=child_env))

    def close(self) -> None:
        """Kill every rank still running and remove the group's files (what
        ``wait`` does at its end; for a caller that gives up first)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.spec_dir, ignore_errors=True)

    def wait(self) -> Tuple[List[Any], List[str]]:
        """The ranks' results and outputs, in rank order. Kills every rank
        and raises when one fails or the group outlives its time limit."""
        try:
            procs, failed = self.procs, None
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > self.deadline:
                    failed = f"the ranks outlived the {self.timeout:.0f} s limit"
                    break
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outputs = []
            for log in self.logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
            if failed is not None:
                rank = int(failed.split()[1]) if failed.startswith("rank") else 0
                raise RuntimeError(f"{self.target} over {self.world} ranks: {failed}; rank "
                                   f"{rank}'s output:\n{outputs[rank][-6000:]}")
            results = []
            for rank in range(self.world):
                with open(os.path.join(self.spec_dir, f"result{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results, outputs
        finally:
            self.close()


def launch(target: str, world: int, kwargs: Optional[dict] = None, timeout: float = 120.0,
           device: Optional[str] = None, env: Optional[dict] = None
           ) -> Tuple[List[Any], List[str]]:
    """``target(**kwargs)`` on ranks 0 .. world-1 (``device`` each rank's
    device: None = its card, or as named); returns (results, outputs)."""
    return RankGroup(target, world, kwargs, timeout, device, env).wait()


def _worker(spec_dir: str, rank: int) -> None:
    with open(os.path.join(spec_dir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    import torch.distributed as dist

    from .mesh import join_group

    join_group(spec["init"], spec["world"], rank, spec["device"])
    module, name = spec["target"].split(":")
    result = getattr(importlib.import_module(module), name)(**spec["kwargs"])
    with open(os.path.join(spec_dir, f"result{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(spec_dir, f"result{rank}.pkl.tmp"),
               os.path.join(spec_dir, f"result{rank}.pkl"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _worker(sys.argv[1], int(sys.argv[2]))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
