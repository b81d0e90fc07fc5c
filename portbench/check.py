"""The comparison that decides ``correct``.

What the timed path produced in its first iteration (``harness.Probe``:
the rollout's record, the minibatches' rows, the first three updates'
losses, AdamW's state after the first and the parameters after the third)
is held against the plain reference (``reference.py``) run from the same
weights on the same inputs:

  env_mismatch  rollout rows that break the self-play rules (exact: 0);
  logp_gap      the widest gap of a recorded action's log-probability
                under the learner's rollout forward, nats;
  value_gap     the widest gap of a recorded value;
  opp_z         |z| of the opponent's moves under the reference's eval
                policy: the sum of log pi(move) + H(pi), over its standard
                deviation were the moves drawn from pi;
  loss_gap      the widest over the first three updates of the gap of
                the update's loss, over the sum of its terms' magnitudes
                in the reference;
  grad_gap      the median over the leaves of each leaf's gap of the
                norm of the first gradient as AdamW took it (its first
                moment / (1 - beta1)), over the larger of the reference
                leaf's norm and the median leaf's;
  change_gap    the same for each leaf's change over the three updates.

Both leaf numbers leave out the leaves whose first gradient in the
reference is under a thousandth of the median leaf's: their gradient is
nought but for rounding (a conv bias under BatchNorm, a key's bias under
softmax), so their norm and their move under AdamW are round-off alone.
They take the median leaf, not the worst (``worst`` keeps it): the worst
leaf is a small one whose gap under bf16 is rounding, as the look in
PERF.md shows (the program's own float32 path reads it 25-600x lower on
the same seeds, a bfloat16 reference as high as the program).

The reference takes the program's draws as given: the learner's and the
opponent's moves, the side draws behind the resets and the minibatches'
rows. Everything computed from them it computes itself: the rules'
rewards and dones, the forwards, GAE on its own rollout values, the
advantage normalisation, the losses, the gradients and AdamW; so a fault
in the program's rollout values reaches the update's numbers as well as
``value_gap``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from . import reference as ref

NUMBERS = ("env_mismatch", "logp_gap", "value_gap", "opp_z", "loss_gap", "grad_gap",
           "change_gap")
LIMITS_DIR = Path(__file__).resolve().parent / "limits"
_CHUNK = 8192


def load_limits(cell: str) -> dict:
    """number -> limit, from ``limits/<cell>.json``."""
    data = json.loads((LIMITS_DIR / f"{cell}.json").read_text())
    return {k: float(v["limit"]) for k, v in data.items() if k in NUMBERS}


def _flatten(x: torch.Tensor, layout) -> torch.Tensor:
    """(T, E, ...) -> (T * E, ...) in the program's minibatch layout:
    time-major for the grouped shuffle, env-major for the global one."""
    kind = layout[0]
    if kind == "grouped":
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def _rows(ids: torch.Tensor, layout) -> torch.Tensor:
    if layout[0] == "grouped":
        gs = layout[1]
        return (ids.long()[:, None] * gs + torch.arange(gs, device=ids.device)).reshape(-1)
    return ids.long().reshape(-1)


@torch.no_grad()
def rollout_forward(cfg: dict, weights: dict, rec: dict, prec) -> tuple:
    """The learner's train-mode forward at every step (BatchNorm over that
    step's envs; envs in blocks of ``ref.row_blocks``): (log-probabilities
    of the recorded actions (T, E), values (T, E), bootstrap values (E,))."""
    t_len, e = rec["actions"].shape
    logp = torch.empty((t_len, e), device=rec["actions"].device)
    values = torch.empty_like(logp)
    last = torch.empty((e,), device=logp.device)
    for rows in ref.row_blocks(cfg, e, train=True):
        for t in range(t_len):
            logits, v = ref.forward(cfg, weights, rec["obs"][t, rows].float(), True, prec)
            lp = ref.masked_log_softmax(logits, rec["mask"][t, rows])
            logp[t, rows] = lp.gather(1, rec["actions"][t, rows].long()[:, None])[:, 0]
            values[t, rows] = v
        last[rows] = ref.forward(cfg, weights, rec["final_obs"][rows].float(), True, prec)[1]
    return logp, values, last


@torch.no_grad()
def opponent_z(cfg: dict, weights: dict, env: dict) -> float:
    """|z| of the opponent's recorded moves under the reference's eval-mode
    policy (the opponent is the starting weights in the first iteration),
    in blocks of at most ``_CHUNK`` moves (``ref.row_blocks``)."""
    obs, mask, cell = env["opp_obs"], env["opp_mask"], env["opp_cell"]
    if obs.shape[0] == 0:
        return 0.0
    total, var = 0.0, 0.0
    for rows in ref.row_blocks(cfg, obs.shape[0], _CHUNK):
        logits, _ = ref.forward(cfg, weights, obs[rows], False)
        lp = ref.masked_log_softmax(logits, mask[rows])
        p = lp.exp()
        safe = torch.where(p > 0, lp, torch.zeros_like(lp))
        h = -(p * safe).sum(-1)
        total += float((lp.gather(1, cell[rows, None].long())[:, 0] + h).sum())
        var += float(((p * safe * safe).sum(-1) - h * h).clamp(min=0).sum())
    return abs(total) / math.sqrt(max(var, 1e-30))


def reference_side(cfg, traffic, weights, rec, env, layout, prec=ref.FP32) -> dict:
    """The reference's iteration from ``weights`` on the record's inputs:
    its own forwards, and its GAE on its own rollout values."""
    logp, values, last = rollout_forward(cfg, weights, rec, prec)
    adv, returns = ref.gae(env["rewards"], values, env["dones"], last, cfg["gamma"],
                           cfg["gae_lambda"])
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    batch = {"obs": _flatten(rec["obs"], layout).float(),
             "mask": _flatten(rec["mask"], layout),
             "actions": _flatten(rec["actions"], layout).long(),
             "old_logp": _flatten(logp, layout), "adv": _flatten(adv, layout),
             "returns": _flatten(returns, layout)}
    minibatches = [_rows(r, layout) for r in rec["rows"]]
    out = ref.ppo_steps(cfg, traffic, weights, batch, minibatches, prec)
    out.update(logp=logp, values=values)
    return out


def program_side(cfg: dict, rec: dict, ent_coef: float) -> dict:
    """The same quantities as the program produced them."""
    b1 = cfg["adam_betas"][0]
    losses = []
    for m in rec["metrics"]:  # actor, critic, entropy loss, ...
        actor, critic, ent = (float(x) for x in m[:3])
        losses.append([actor + cfg["value_coef"] * critic + ent_coef * ent, actor, critic, ent])
    return {"logp": rec["log_probs"], "values": rec["values"], "losses": losses,
            "first_grad": {k: v / (1 - b1) for k, v in rec["exp_avg"].items()},
            "params": rec["params"]}


def _leaf_gaps(side: dict, want: dict, keep) -> dict:
    """leaf -> |norm of side - norm of want| over the larger of want's norm
    and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(want[k].float())) for k in keep}
    floor = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(torch.linalg.vector_norm(side[k].float())) - norms[k])
            / max(norms[k], floor, 1e-30) for k in keep}


def _median(values) -> float:
    ordered = sorted(values)
    return ordered[len(ordered) // 2]


def compare(side: dict, want: dict, weights: dict, cfg: dict) -> dict:
    """The numbers of ``side`` against the reference ``want``, and (under
    ``worst``) the leaf behind each leaf number and its gap."""
    out = {
        "logp_gap": float((side["logp"] - want["logp"]).abs().max()),
        "value_gap": float((side["values"] - want["values"]).abs().max()),
    }
    gaps = []
    for got, exp in zip(side["losses"], want["losses"]):
        scale = abs(exp[1]) + cfg["value_coef"] * abs(exp[2]) + want["ent_coef"] * abs(exp[3])
        gaps.append(abs(got[0] - exp[0]) / max(scale, 1e-30))
    out["loss_gap"] = max(gaps) if len(gaps) == len(want["losses"]) else float("inf")
    names = list(want["first_grad"])
    gnorm = {k: float(torch.linalg.vector_norm(want["first_grad"][k])) for k in names}
    median = sorted(gnorm.values())[len(names) // 2]
    moving = [k for k in names if gnorm[k] >= 1e-3 * median]
    grad = _leaf_gaps(side["first_grad"], want["first_grad"], moving)
    change = _leaf_gaps({k: side["params"][k].float() - weights[k] for k in moving},
                        {k: want["params"][k] - weights[k] for k in moving}, moving)
    out["grad_gap"] = _median(grad.values())
    out["change_gap"] = _median(change.values())
    out["worst"] = {"grad": max(grad.values()), "grad_at": max(grad, key=grad.get),
                    "change": max(change.values()), "change_at": max(change, key=change.get)}
    out["left_out"] = sorted(set(names) - set(moving))
    return out


def _replay(cfg, rec) -> dict:
    ref.strict_float32()
    return ref.replay_env(cfg["mnk"], rec["obs"], rec["final_obs"], rec["mask"], rec["actions"],
                          rec["rewards"], rec["dones"])


def judge(cfg, traffic, weights, rec, layout, limits: dict) -> dict:
    """Every number of the program's first iteration, its limit, and
    ``correct``; under ``grad_norms`` the pre-clip global norm of each
    update's gradient on both sides."""
    env = _replay(cfg, rec)
    want = reference_side(cfg, traffic, weights, rec, env, layout)
    numbers = {"env_mismatch": float(env["mismatch"]),
               "opp_z": opponent_z(cfg, weights, env)}
    got = compare(program_side(cfg, rec, want["ent_coef"]), want, weights, cfg)
    left_out, worst = got.pop("left_out"), got.pop("worst")
    numbers.update(got)
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    norms = {"program": [float(m[3]) for m in rec["metrics"]], "reference": want["grad_norms"]}
    return {"numbers": {k: numbers[k] for k in NUMBERS}, "limits": limits, "correct": correct,
            "left_out": left_out, "worst": worst, "grad_norms": norms}


def control(cfg, traffic, weights, rec, layout, prec=ref.FP8) -> dict:
    """The numbers of the reference at ``prec`` (the float8 control; the
    bfloat16 witness) put in the program's place, on the same inputs,
    against the reference in float32."""
    env = _replay(cfg, rec)
    low = reference_side(cfg, traffic, weights, rec, env, layout, prec)
    want = reference_side(cfg, traffic, weights, rec, env, layout)
    got = compare(low, want, weights, cfg)
    got.pop("left_out")
    return got
