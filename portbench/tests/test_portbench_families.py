"""The network families as files of their own (``families/``): the ResNet and
the transformer give the same bits as before they were moved, an unknown
family is refused, and the reference's update in blocks of boards
(``reference.row_blocks``) and the check's forwards in blocks agree with the
single graph."""

import hashlib

import pytest
import torch

from portbench import check, reference, spec, yardstick

SEEDS = (1, 2_147_483_659)
BOARDS = 8
FORWARDS = [(train, prec) for prec in (reference.FP32, reference.BF16, reference.FP8)
            for train in (True, False)]


def configs() -> dict:
    res, tr = spec.load("configs", "resnet_b_s"), spec.load("configs", "transformer_b_s")
    return {
        "resnet_b_s": res,
        "transformer_b_s": tr,
        "tiny_resnet": {**res, "mnk": [4, 4, 3], "channels": 4, "num_blocks": 2,
                        "head_hidden": 8},
        "tiny_transformer": {**tr, "mnk": [4, 4, 3], "embed_dim": 8, "num_layers": 2,
                             "num_heads": 2, "head_dim": 4, "ffn_dim": 16, "head_hidden": 8},
    }


# Recorded from the reference and the yardstick before the families were moved
# into files of their own (torch 2.13.0 on the CPU, one thread): sha256 of the
# bytes, first 16 hex digits. Weights: every tensor's name, shape and bytes in
# ``param_shapes`` order; forwards: logits and values of ``BOARDS`` boards in
# train and eval mode under FP32, BF16 and FP8 (``FORWARDS`` order); ppo_steps:
# three updates on ``ppo_batch`` (losses, norms, first gradient, parameters).
PARENT = {
    "resnet_b_s": {
        "parameters": 118203, "forward_flops": 12136000.0,
        "kernel_work": {
            "fused384": {"K1": ("env_step", 8.257536e-05),
                         "K2": ("resblock", 0.0012283207068656717)},
            "loop8192": {"K1": ("env_step", 0.00022020096),
                         "K2": ("resblock", 0.003246682784477612)}},
        "seeds": {
            1: {"weights": "2f1a4245290755ff",
                "forward": ["2324078411c9e769", "4cddf25de7979392", "9337fa0d4f440b07",
                            "454f634ef9e28654", "b2ddd17ae8df20c4", "8bfd464930d9d829"]},
            2_147_483_659: {"weights": "7fff034078ebc429",
                            "forward": ["ae667c467183314d", "ad3ba333987b4a90",
                                        "d8d3a4e977a8e2a0", "80d711f304cf5b65",
                                        "50b94154b8a606aa", "03835fdd1a9bc467"]}}},
    "transformer_b_s": {
        "parameters": 124531, "forward_flops": 15260656.0,
        "kernel_work": {
            "fused384": {"K1": ("env_step", 8.257536e-05),
                         "K5": ("attn_lane_slice_fwd", 0.004267728773731344),
                         "K3": ("attn_folded_fwd", 0.008518819228656715),
                         "K4": ("attn_folded_bwd", 0.014907933650149254)},
            "loop8192": {"K1": ("env_step", 0.00022020096),
                         "K5": ("attn_lane_slice_fwd", 0.01153590103880597),
                         "K3": ("attn_folded_fwd", 0.02271685127641791),
                         "K4": ("attn_folded_bwd", 0.039754489733731344)}},
        "seeds": {
            1: {"weights": "56e138a4aa443180",
                "forward": ["ac0024ab3f2021e0", "ac0024ab3f2021e0", "89c603b37b8c21bd",
                            "89c603b37b8c21bd", "d02d0a25f7400f02", "d02d0a25f7400f02"]},
            2_147_483_659: {"weights": "ed781678eb7f44c1",
                            "forward": ["3a5bc478e6f51e50", "3a5bc478e6f51e50",
                                        "5d6ca5bb747b6bfd", "5d6ca5bb747b6bfd",
                                        "5c05411c658ec9f9", "5c05411c658ec9f9"]}}},
    "tiny_resnet": {
        "parameters": 1404, "forward_flops": 22160.0,
        "kernel_work": {
            "fused384": {"K1": ("env_step", 1.772406447761194e-05),
                         "K2": ("resblock", 1.5117296716417911e-05)},
            "loop8192": {"K1": ("env_step", 4.7264171940298506e-05),
                         "K2": ("resblock", 4.007660895522388e-05)}},
        "seeds": {
            1: {"weights": "402a363f04d7845a",
                "forward": ["187026c9a2ca0d02", "f8ee1c1d83a479c1", "49fb329dc6fd297c",
                            "1d8436948d56ad07", "7ff1c0fbdd0445b2", "bccaad240f42d7c4"],
                "ppo_steps": "48ed2effa331bc81"},
            2_147_483_659: {"weights": "3c274a03b8389b78",
                            "forward": ["879672266b935eb3", "bae6784016ee0b75",
                                        "452b28e8edcf54ca", "c458c188b33aedb6",
                                        "03cafb2957a9853d", "8889a889836dda5f"],
                            "ppo_steps": "b69e5d90fe3ebeca"}}},
    "tiny_transformer": {
        "parameters": 2060, "forward_flops": 51472.0,
        "kernel_work": {
            "fused384": {"K1": ("env_step", 1.772406447761194e-05),
                         "K5": ("attn_lane_slice_fwd", 0.00012042973611940298),
                         "K3": ("attn_folded_fwd", 0.00024038996059701491),
                         "K4": ("attn_folded_bwd", 0.0004206824310447761)},
            "loop8192": {"K1": ("env_step", 4.7264171940298506e-05),
                         "K5": ("attn_lane_slice_fwd", 0.00032552807164179103),
                         "K3": ("attn_folded_fwd", 0.0006410398949253731),
                         "K4": ("attn_folded_bwd", 0.001121819816119403)}},
        "seeds": {
            1: {"weights": "5be9449ea7b8ef2d",
                "forward": ["786dae53669278a0", "786dae53669278a0", "8602ab2a335977af",
                            "8602ab2a335977af", "c02ba860547292b5", "c02ba860547292b5"],
                "ppo_steps": "407076cbd5525c86"},
            2_147_483_659: {"weights": "dbc31553cd6251c3",
                            "forward": ["de5bb6f59e83ef82", "de5bb6f59e83ef82",
                                        "9da714e229f92228", "9da714e229f92228",
                                        "04ee8678586d1de3", "04ee8678586d1de3"],
                            "ppo_steps": "54fa065e218b222a"}}},
}


def blocks_of(monkeypatch, cfg: dict, boards: int):
    """Make the reference's blocks ``boards`` boards of ``cfg``."""
    m, n, _ = cfg["mnk"]
    width = spec.family(cfg).body_shapes(cfg)[1]
    monkeypatch.setattr(reference, "BLOCK_BYTES", boards * m * n * width * 4)


@pytest.fixture
def one_thread():
    """The recorded bits were taken on one thread: CPU reductions split
    over more threads sum in another order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def digest(parts) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else part.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def boards(mnk, rows: int, gen: torch.Generator):
    cells = torch.randint(0, 3, (rows, mnk[0], mnk[1]), generator=gen)
    return cells, torch.stack([cells == 1, cells == 2], 1).float()


def ppo_batch(cfg: dict, rows: int, seed: int):
    """``rows`` boards with legal actions, old log-probabilities, advantages
    and returns drawn from ``seed``, and three minibatches of a third each."""
    g = torch.Generator().manual_seed(seed)
    m, n, _ = cfg["mnk"]
    cells, obs = boards(cfg["mnk"], rows, g)
    mask = (cells == 0).reshape(rows, m * n)
    noise = torch.rand(mask.shape, generator=g)
    batch = {"obs": obs, "mask": mask, "actions": torch.where(mask, noise, -1.0).argmax(-1),
             "old_logp": torch.randn(rows, generator=g) * 0.1 - 2.0,
             "adv": torch.randn(rows, generator=g),
             "returns": torch.rand(rows, generator=g) * 2 - 1}
    return batch, list(torch.randperm(rows, generator=g).reshape(3, -1))


def run_ppo(cfg: dict, seed: int, dtype=torch.float32) -> dict:
    batch, minibatches = ppo_batch(cfg, 21, seed)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    weights = {k: v.to(dtype) for k, v in reference.make_weights(cfg, seed, "cpu").items()}
    return reference.ppo_steps(cfg, spec.load("traffic", "fused384"), weights, batch,
                               minibatches)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(PARENT))
def test_families_give_the_parents_bits(name, seed, one_thread):
    cfg, want = configs()[name], PARENT[name]
    assert reference.parameter_count(cfg) == want["parameters"]
    assert yardstick.forward_flops(cfg) == want["forward_flops"]
    for traffic, work in want["kernel_work"].items():
        assert yardstick.kernel_work(cfg, spec.load("traffic", traffic)) == work
    w = reference.make_weights(cfg, seed, "cpu")
    assert digest(p for k, v in w.items()
                  for p in (k.encode(), repr(tuple(v.shape)).encode(), v)) == \
        want["seeds"][seed]["weights"]
    _, obs = boards(cfg["mnk"], BOARDS, torch.Generator().manual_seed(seed))
    got = [digest(reference.forward(cfg, w, obs, train, prec)) for train, prec in FORWARDS]
    assert got == want["seeds"][seed]["forward"]
    if "ppo_steps" in want["seeds"][seed]:
        out = run_ppo(cfg, seed)
        assert digest([repr((out["losses"], out["grad_norms"], out["ent_coef"])).encode()]
                      + list(out["first_grad"].values()) + list(out["params"].values())) == \
            want["seeds"][seed]["ppo_steps"]


def test_an_unknown_family_is_refused_with_the_families_found():
    with pytest.raises(ValueError, match="resnet, transformer"):
        reference.param_shapes({**configs()["tiny_resnet"], "family": "no_such_family"})


@pytest.mark.parametrize("block", [1, 3, 7])
def test_blocks_of_boards_agree_with_the_single_graph(block, monkeypatch):
    """Blocks change only the order of the sums: rtol 1e-5. In float64 that
    holds for every number (blocks of 1 and 3 read under 1e-10 of any
    element on seeds 5-7), so a fault in the blocks' weights would show. In
    float32 it holds for the losses and gradient norms (under 1e-6), and a
    block of the whole minibatch is the single graph; AdamW turns the
    rounding of a gradient element near 0 into up to 1.5e-4 of a leaf's
    change, so float32 leaves are not compared across blocks. Leaves whose
    gradient is nought but for rounding (a key's bias under softmax: under a
    thousandth of the median leaf's, as ``check.compare`` leaves them out)
    move by the sign of that rounding, and are compared by their gradient
    alone."""
    cfg = configs()["tiny_transformer"]
    want, want32 = run_ppo(cfg, 5, torch.float64), run_ppo(cfg, 5)
    blocks_of(monkeypatch, cfg, block)
    assert len(reference.row_blocks(cfg, 7, train=True)) == -(-7 // block)
    got, got32 = run_ppo(cfg, 5, torch.float64), run_ppo(cfg, 5)
    for key in ("losses", "grad_norms"):
        torch.testing.assert_close(torch.tensor(got[key]), torch.tensor(want[key]), rtol=1e-5,
                                   atol=0)
    norms = {k: float(g.norm()) for k, g in want["first_grad"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, g in want["first_grad"].items():
        if norms[k] >= 1e-3 * median:
            torch.testing.assert_close(got["first_grad"][k], g, rtol=1e-5, atol=0)
            torch.testing.assert_close(got["params"][k], want["params"][k], rtol=1e-5, atol=0)
        else:
            torch.testing.assert_close(got["first_grad"][k], g, rtol=0, atol=1e-5 * median)
    for key in ("losses", "grad_norms"):
        torch.testing.assert_close(torch.tensor(got32[key]), torch.tensor(want32[key]),
                                   rtol=1e-5, atol=0)
    if block == 7:  # the whole minibatch
        assert got32["losses"] == want32["losses"] and got32["grad_norms"] == want32["grad_norms"]
        for key in ("first_grad", "params"):
            assert all(torch.equal(got32[key][k], v) for k, v in want32[key].items())


def test_blocks_are_refused_for_a_family_that_mixes_boards(monkeypatch):
    """Train-mode BatchNorm over a block is another function: the update and
    the rollout's forward refuse a ResNet that does not fit one block; the
    opponent's eval-mode forward, over the running statistics, may split."""
    cfg = configs()["tiny_resnet"]
    blocks_of(monkeypatch, cfg, 4)
    with pytest.raises(ValueError, match="BatchNorm"):
        run_ppo(cfg, 5)
    with pytest.raises(ValueError, match="BatchNorm"):
        reference.row_blocks(cfg, 5, train=True)
    assert reference.row_blocks(cfg, 4, train=True) == [slice(0, 4)]
    assert reference.row_blocks(cfg, 5) == [slice(0, 4), slice(4, 8)]


@pytest.mark.parametrize("name", ["resnet_b_s", "transformer_b_s"])
def test_row_blocks_follow_the_budget_and_the_cap(name):
    """The cells' configurations fit their largest train-mode batch (8192
    boards, the minibatch and the loop's envs) in one block, so the check
    reads the single graph's numbers there."""
    cfg = configs()[name]
    assert reference.row_blocks(cfg, 8192, train=True) == [slice(0, 8192)]
    assert reference.row_blocks(cfg, 20000, 8192) == [slice(0, 8192), slice(8192, 16384),
                                                      slice(16384, 24576)]
    assert reference.row_blocks(cfg, 5) == [slice(0, 5)]
    board = 81 * spec.family(cfg).body_shapes(cfg)[1] * 4
    size = reference.BLOCK_BYTES // board
    assert reference.row_blocks(cfg, size + 1) == [slice(0, size), slice(size, 2 * size)]


@pytest.mark.parametrize("block", [1, 3])
def test_the_checks_forwards_in_blocks_agree(block, monkeypatch):
    """The rollout's forwards and the opponent's |z| over blocks of envs
    and moves: the same rows through the same layers, rtol 1e-5."""
    cfg = configs()["tiny_transformer"]
    g = torch.Generator().manual_seed(9)
    t_len, e, mn = 3, 7, 16
    cells, obs = boards(cfg["mnk"], t_len * e, g)
    mask = (cells == 0).reshape(-1, mn)
    rec = {"obs": obs.reshape(t_len, e, 2, 4, 4), "mask": mask.reshape(t_len, e, mn),
           "actions": torch.where(mask, torch.rand(mask.shape, generator=g), -1.0)
           .argmax(-1).reshape(t_len, e), "final_obs": obs[:e]}
    env = {"opp_obs": obs, "opp_mask": mask, "opp_cell": rec["actions"].reshape(-1)}
    weights = reference.make_weights(cfg, 9, "cpu")
    want = check.rollout_forward(cfg, weights, rec, reference.FP32)
    want_z = check.opponent_z(cfg, weights, env)
    blocks_of(monkeypatch, cfg, block)
    assert len(reference.row_blocks(cfg, e, train=True)) == -(-e // block)
    for w, got in zip(want, check.rollout_forward(cfg, weights, rec, reference.FP32)):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)
    assert check.opponent_z(cfg, weights, env) == pytest.approx(want_z, rel=1e-5)
