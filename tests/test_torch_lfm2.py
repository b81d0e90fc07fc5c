"""LFM2-MoE in the port (``models/lfm2.py``) at a tiny size on the CPU,
held to the benchmark's plain float32 reference (``portbench/families/
lfm2.py``) on the same seeded weights, and its pieces to plain torch: the
RMSNorm, the gated short convolution, the expert layer (router, held
experts, combine) and its shares; snapshots, exports and
checkpoints; the registry's published-width model against the reference's
parameter count; one run of ``train_mnk``.

The ``cuda``-marked tests at the end hold the layer's pieces to plain torch
on the card at the benchmark cell's shapes, with no host synchronisation in
the expert layer or the short convolution, and skip without CUDA.
"""

import copy
import json

import pytest
import torch
import torch.nn.functional as F

from portbench import reference as ref
from rl_selfplay_mnk_tpu_torch.models import lfm2 as lfm2_model
from rl_selfplay_mnk_tpu_torch.models import registry
from rl_selfplay_mnk_tpu_torch.models.fold_bn import snapshot, snapshot_from_state_dict
from rl_selfplay_mnk_tpu_torch.ops import moe
from rl_selfplay_mnk_tpu_torch.ops.layer_norm import rms_norm, rms_norm_reference
from rl_selfplay_mnk_tpu_torch.ops.short_conv import short_conv, short_conv_reference
from rl_selfplay_mnk_tpu_torch.utils import tracing

torch.set_num_threads(1)

LAYER_TYPES = ["conv", "conv", "full_attention", "conv", "conv", "conv"]
# Width 64, 4 query and 2 KV heads of 16, 32 routed experts of width 32 (8
# held), a dense SwiGLU of 96, 81 cells.
TINY = dict(hidden_size=64, layer_types=tuple(LAYER_TYPES), num_dense_layers=2,
            intermediate_size=96, moe_intermediate_size=32, num_experts=32,
            experts_held=(0, 8), num_experts_per_tok=4, num_heads=4, num_kv_heads=2,
            head_dim=16, conv_L_cache=3, rope_theta=1e6, norm_eps=1e-5,
            routed_scaling_factor=1.0, head_hidden=16)


def tiny_cfg(first=0, held=8):
    """The benchmark's configuration file at the tiny size."""
    with open(ref.spec.ROOT / "configs" / "lfm2_8b_a1b_l6_e8.json") as f:
        cfg = json.load(f)
    cfg.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16, head_hidden=16,
               num_experts=held, experts_held_from=first)
    return cfg


def tiny_model(first=0, held=8, dtype=torch.float32):
    sizes = dict(TINY, experts_held=(first, held))
    return lfm2_model.Lfm2ActorCritic(81, (2, 9, 9), dtype=dtype, **sizes)


def seeded(first=0, held=8, seed=7, dtype=torch.float32):
    """(model, cfg, weights): the reference's weights from ``seed``, loaded."""
    cfg = tiny_cfg(first, held)
    weights = ref.make_weights(cfg, seed, "cpu")
    model = tiny_model(first, held, dtype)
    model.load_state_dict(weights, strict=True)
    return model, cfg, weights


def boards(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    cells = torch.randint(0, 3, (n, 81), generator=g)
    obs = torch.stack([(cells == 1), (cells == 2)], 1).float().view(n, 2, 9, 9)
    return obs, cells == 0


def ppo_like_loss(logits, value, mask, actions):
    """A loss over every output: the chosen actions' log-probabilities under
    the legal cells, the entropy and the values."""
    logp = ref.masked_log_softmax(logits, mask)
    chosen = logp.gather(1, actions[:, None])[:, 0]
    return -chosen.mean() - 0.1 * ref.entropy(logp).mean() + 0.5 * (value ** 2).mean()


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_model_matches_the_reference_logits_values_loss_and_every_gradient():
    """Both sides in float32 on the same weights; the only differences are
    the order of f32 sums (the grouped products' rows, the combine), so
    the limits are a few ulps of f32 over the largest magnitude: 1e-5
    relative to the largest of each output, 1e-4 of each gradient's; a leaf
    whose gradient is under a thousandth of the median leaf's is round-off
    alone (the heads' plane-projection biases, under the LayerNorm over the
    planes) and left out, as ``portbench/check.py`` leaves it out."""
    model, cfg, weights = seeded()
    obs, mask = boards()
    actions = torch.where(mask, torch.rand(mask.shape, generator=torch.Generator().manual_seed(1)),
                          torch.tensor(-1.0)).argmax(1)
    logits, value = model(obs, train=True)
    want_logits, want_value = ref.forward(cfg, weights, obs, True)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-5 * want_logits.abs().max())
    torch.testing.assert_close(value[:, 0], want_value, rtol=0, atol=1e-5)
    loss = ppo_like_loss(logits, value[:, 0], mask, actions)
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if ref.is_parameter(ref.param_shapes(cfg)[k][1])}
    want_loss = ppo_like_loss(*ref.forward(cfg, {**weights, **params}, obs, True), mask, actions)
    assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-5 * abs(float(want_loss.detach()))
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(params)
    want = dict(zip(params, torch.autograd.grad(want_loss, list(params.values()))))
    scales = {k: float(v.abs().max()) for k, v in want.items()}
    median = sorted(scales.values())[len(scales) // 2]
    left_out = {k for k, v in scales.items() if v < 1e-3 * median}
    assert left_out <= {"heads.value_head.plane_proj.bias", "heads.policy_head.plane_proj.bias"}
    for name, g in zip(names, grads):
        if name not in left_out:
            assert float((g - want[name]).abs().max()) <= 1e-4 * scales[name], name


def test_registry_model_has_the_reference_parameter_count():
    with open(ref.spec.ROOT / "configs" / "lfm2_8b_a1b_l6_e8.json") as f:
        cfg = json.load(f)
    with torch.device("meta"):
        model, _ = registry.create_model_from_architecture("lfm2_8b_a1b_l6_e8", (2, 9, 9), 81)
    shapes = ref.param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in shapes.items()}
    assert sum(p.numel() for p in model.parameters()) == ref.parameter_count(cfg) \
        == cfg["parameters"]
    assert "lfm2_8b_a1b_l6_e8" not in registry.ARCHITECTURE_REGISTRY  # the JAX package has not it


# ---------------------------------------------------------------------------
# the pieces against plain torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_is_the_plain_formula(dtype):
    x = torch.randn(7, 81, 64).to(dtype).requires_grad_(True)
    w = torch.rand(64) + 0.5
    y = rms_norm(x, w, 1e-5)
    xf = x.detach().to(torch.float32)
    want = (xf / torch.sqrt((xf * xf).mean(-1, keepdim=True) + 1e-5) * w).to(dtype)
    # f32: rsqrt against 1 / sqrt, an ulp or two; bf16: one rounding of y
    torch.testing.assert_close(y, want, rtol=2e-6 if dtype == torch.float32 else 2 ** -7, atol=0)
    assert y.dtype == dtype and torch.equal(y, rms_norm_reference(x, w, 1e-5))


def test_short_conv_is_a_causal_depthwise_conv1d_and_its_gradient():
    """The plain version against F.conv1d (depthwise, padded by K - 1 on the
    left, cut to L), forward and every gradient, in f64."""
    g = torch.Generator().manual_seed(3)
    bcx = torch.randn(5, 81, 3 * 16, generator=g, dtype=torch.float64).requires_grad_(True)
    w = torch.randn(16, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    y = short_conv(bcx, w)
    b, c, x = bcx.chunk(3, -1)
    z = F.conv1d((b * x).transpose(1, 2), w[:, None, :], padding=2, groups=16)[..., :81]
    want = c * z.transpose(1, 2)
    torch.testing.assert_close(y, want)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(y, (bcx, w), dy)
    exp = torch.autograd.grad(want, (bcx, w), dy)
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e)
    # causal: the first cell sees only its own B * x, through the last tap
    torch.testing.assert_close(y[:, 0], c[:, 0] * (b[:, 0] * x[:, 0] * w[:, 2]))


def test_short_conv_rounds_once_to_the_input_dtype():
    bcx = torch.randn(4, 81, 48).to(torch.bfloat16)
    w = torch.randn(16, 3)
    y = short_conv(bcx, w)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, short_conv_reference(bcx.float(), w).to(torch.bfloat16))


def expert_inputs(n=200, d=64, f=32, experts=32, held=8, seed=5, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).to(dtype)
    gate = torch.randn(experts, d, generator=g) / d ** 0.5
    bias = torch.zeros(experts)
    w1 = torch.randn(held, f, d, generator=g) / d ** 0.5
    w3 = torch.randn(held, f, d, generator=g) / d ** 0.5
    w2 = torch.randn(held, d, f, generator=g) / f ** 0.5
    return x, gate, bias, w1, w3, w2


@pytest.mark.parametrize("first", [0, 8, 24])
def test_held_experts_match_the_plain_loop_forward_and_backward(first):
    """The port's expert layer on the CPU against the benchmark reference's
    own loop over the held experts (``portbench/families/lfm2.py``), f32:
    the same products, summed in another order."""
    from portbench.families import lfm2 as fam

    inputs = [t.clone().requires_grad_(True) for t in expert_inputs()]
    x, gate, bias, w1, w3, w2 = inputs
    cfg = dict(tiny_cfg(first), experts_held_from=first)
    q = "layers.2.feed_forward"
    p = {f"{q}.gate.weight": gate, f"{q}.expert_bias": bias, f"{q}.w1": w1, f"{q}.w3": w3,
         f"{q}.w2": w2}
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    y = moe.held_experts(x, gate, bias, w1, w3, w2, first, 4, 1.0)
    want = fam._experts(cfg, p, q, x, ref.FP32)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(y, (x, gate, w1, w3, w2), dy)
    exp = torch.autograd.grad(want, (x, gate, w1, w3, w2), dy)
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)


def test_router_bias_moves_selection_and_not_the_weights():
    x, gate, bias, *_ = expert_inputs()
    w0, p0 = moe.route(x, gate, bias, 4, 1.0)
    torch.testing.assert_close(w0.sum(-1), torch.ones(x.shape[0]), rtol=0, atol=1e-5)
    scores = torch.sigmoid(x @ gate.t())
    torch.testing.assert_close(w0, scores.gather(1, p0) / (scores.gather(1, p0).sum(-1, True) + 1e-6))
    pushed = bias.clone()
    pushed[17] = 10.0  # expert 17 is picked by every token ...
    w1, p1 = moe.route(x, gate, pushed, 4, 1.0)
    assert bool((p1 == 17).any(-1).all())
    # ... with its own sigmoid score in the weights, not score + bias
    s = scores.gather(1, p1)
    torch.testing.assert_close(w1, s / (s.sum(-1, True) + 1e-6))
    assert float(w1.max()) < 1.0


def test_four_shares_sum_to_the_uncut_layer():
    """Experts 0-7, 8-15, 16-23 and 24-31 on four chips: their parts, summed,
    are the whole 32-expert layer (the uncut plain version)."""
    x, gate, bias, w1, w3, w2 = expert_inputs(held=32)
    whole = moe.held_experts_reference(x, gate, bias, w1, w3, w2, 0, 4, 1.0)
    parts = [moe.held_experts(x, gate, bias, w1[s:s + 8], w3[s:s + 8], w2[s:s + 8], s, 4, 1.0)
             for s in (0, 8, 16, 24)]
    torch.testing.assert_close(sum(parts), whole, rtol=1e-5, atol=1e-6)


def test_four_model_shares_sum_to_the_uncut_reference_layer():
    """The same through the benchmark's reference: the expert layer of the
    reference at 8 held experts from 0, 8, 16 and 24, summed, is the
    reference's layer at all 32."""
    from portbench.families import lfm2 as fam

    whole_cfg = tiny_cfg(0, 32)
    weights = ref.make_weights(whole_cfg, 11, "cpu")
    x = torch.randn(300, 64, generator=torch.Generator().manual_seed(2))
    q = "layers.2.feed_forward"
    whole = fam._experts(whole_cfg, weights, q, x, ref.FP32)
    total = torch.zeros_like(whole)
    for first in (0, 8, 16, 24):
        cfg = tiny_cfg(first, 8)
        p = dict(weights)
        for name in ("w1", "w3", "w2"):
            p[f"{q}.{name}"] = weights[f"{q}.{name}"][first:first + 8]
        total = total + fam._experts(cfg, p, q, x, ref.FP32)
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# snapshots, exports, checkpoints, tracing
# ---------------------------------------------------------------------------


def test_bf16_snapshot_holds_matrices_in_bf16_and_gives_the_same_bits():
    model, _, _ = seeded(dtype=torch.bfloat16)
    obs, _ = boards()
    frozen = snapshot(model)
    assert frozen.layers[3].feed_forward.w1.dtype == torch.bfloat16
    assert frozen.layers[0].conv.in_proj.weight.dtype == torch.bfloat16
    assert frozen.layers[3].feed_forward.gate.weight.dtype == torch.float32
    assert frozen.layers[0].conv.conv_weight.dtype == torch.float32
    assert frozen.final_norm.weight.dtype == torch.float32
    assert frozen.heads.policy_head.dense1.bias.dtype == torch.float32
    with torch.no_grad():
        want = copy.deepcopy(model)(obs)
        got = frozen(obs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rebuilt = snapshot_from_state_dict(tiny_model(dtype=torch.bfloat16), frozen.state_dict())
    with torch.no_grad():
        again = rebuilt(obs)
    assert torch.equal(again[0], want[0]) and rebuilt.layers[4].feed_forward.w2.dtype == \
        torch.bfloat16


def test_f32_snapshot_stays_f32():
    model, _, _ = seeded()
    frozen = snapshot(model)
    assert all(p.dtype == torch.float32 for p in frozen.parameters())
    assert not any(p.requires_grad for p in frozen.parameters())


def test_export_round_trip(tmp_path, monkeypatch):
    from rl_selfplay_mnk_tpu_torch.utils.model_export import ModelExporter, load_any_model

    monkeypatch.setitem(registry.PORT_REGISTRY, "lfm2_tiny", registry._lfm2(**TINY))
    model, _, _ = seeded()
    exporter = ModelExporter("run", base_dir=str(tmp_path))
    exporter.export_model(model, "lfm2_tiny", {"obs_shape": [2, 9, 9], "action_dim": 81}, 3)
    loaded, meta = load_any_model(str(tmp_path / "run"), "model_00003", device="cpu")
    assert meta.architecture_name == "lfm2_tiny"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    from rl_selfplay_mnk_tpu_torch.models.convert import flax_param_paths

    paths = flax_param_paths(n for n, _ in model.named_parameters())
    assert paths["layers.3.feed_forward.w1"] == "layers/3/feed_forward/w1"


def test_spans_and_counters_of_the_forward():
    model, _, _ = seeded()
    obs, _ = boards()
    tracing.clear()
    tracing.enable()
    try:
        with torch.no_grad():
            model(obs)
    finally:
        tracing.disable()
    names = [r["name"] for r in tracing.records()]
    assert names.count("short_conv") == 5 and names.count("moe") == 4
    counts = tracing.counters()
    assert len(counts["moe.expert_load_max_over_mean"]) == 4
    assert all(v >= 1.0 for v in counts["moe.expert_load_max_over_mean"])
    assert all(0.0 <= v <= 1.0 for v in counts["moe.not_held_share"])
    tracing.clear()
    with torch.no_grad():
        model(obs)  # off: nothing kept
    assert tracing.counters() == {} and tracing.records() == []


def test_train_mnk_runs_lfm2_with_validation_pool_export_and_checkpoints(tmp_path, monkeypatch):
    """``train_mnk``'s own loop on a tiny LFM2: validation and its export,
    pool inserts of compact snapshots, checkpoints, then a resume from the
    last checkpoint that rebuilds the benchmark and the pool."""
    from rl_selfplay_mnk_tpu_torch.train import get_default_config, train_mnk
    from rl_selfplay_mnk_tpu_torch.utils.checkpoint import restore_checkpoint
    from rl_selfplay_mnk_tpu_torch.utils.metrics import NullMetricsLogger

    monkeypatch.setitem(registry.PORT_REGISTRY, "lfm2_tiny", registry._lfm2(**TINY))
    config = get_default_config()
    config.update(mnk=(9, 9, 5), num_envs=4, n_steps=4, batch_size=8, ppo_epochs=1,
                  total_environment_steps=4 * 4 * 3, validation_interval=2, validation_episodes=4,
                  lr_warmup_steps=0, architecture_name="lfm2_tiny", opponent_pool=3,
                  checkpoint_interval=1, checkpoint_dir=str(tmp_path / "ckpt"), seed=5,
                  watch_interval=2, export_dir=str(tmp_path / "models"))
    summary = train_mnk(config, NullMetricsLogger(run_name="lfm2", config=config), device="cpu")
    assert summary["errors"] == [] and len(summary["iterations"]) == 3
    assert len(summary["validations"]) == 1
    state, step = restore_checkpoint(str(tmp_path / "ckpt"))
    assert step == 2 and len(state["pool"]) == 2
    config["resume"] = True
    config["total_environment_steps"] = 4 * 4 * 4
    resumed = train_mnk(config, NullMetricsLogger(run_name="lfm2", config=config), device="cpu")
    assert resumed["start_iteration"] == 3 and resumed["errors"] == []


# ---------------------------------------------------------------------------
# on the card (cell shapes)
# ---------------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_expert_inputs(n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    d, f, e, held = 2048, 1792, 32, 8
    x = torch.randn(n, d, device=device, generator=g).bfloat16()
    gate = torch.randn(e, d, device=device, generator=g) / d ** 0.5
    w1 = torch.randn(held, f, d, device=device, generator=g) / d ** 0.5
    w3 = torch.randn(held, f, d, device=device, generator=g) / d ** 0.5
    w2 = torch.randn(held, d, f, device=device, generator=g) / f ** 0.5
    return x, gate, torch.zeros(e, device=device), w1, w3, w2


def bf16_close(got, want, name, limit=2 ** -7):
    """Within ``limit`` of the largest magnitude: 2^-7 where both sides
    round the same products once to bf16 in f32 sums; 2^-6 for a gradient
    that passes three bf16 roundings on each side in another order (the
    plain loop sums a token's rows in bf16, the kernels in f32)."""
    scale = float(want.detach().abs().max())
    err = float((got.detach().float() - want.detach().float()).abs().max())
    assert err <= limit * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [10368, 41472])
def test_card_held_experts_match_the_plain_loop_without_host_sync(device, tokens):
    inputs = list(card_expert_inputs(tokens, device))
    for i in (0, 1, 3, 4, 5):
        inputs[i].requires_grad_(True)
    x, gate, bias, w1, w3, w2 = inputs
    dy = torch.randn(x.shape, device=device, generator=torch.Generator(device=device)
                     .manual_seed(1)).bfloat16()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.held_experts(x, gate, bias, w1, w3, w2, 0, 4, 1.0)
        got = torch.autograd.grad(y, (x, gate, w1, w3, w2), dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want_y = moe.held_experts_reference(x, gate, bias, w1, w3, w2, 0, 4, 1.0)
    exp = torch.autograd.grad(want_y, (x, gate, w1, w3, w2), dy)
    bf16_close(y, want_y, "y")
    for name, a, e in zip(("dx", "dgate", "dw1", "dw3", "dw2"), got, exp):
        bf16_close(a, e, name, 2 ** -6)


@pytest.mark.cuda
def test_card_short_conv_and_rms_norm_match_plain_without_host_sync(device):
    g = torch.Generator(device=device).manual_seed(2)
    bcx = torch.randn(512, 81, 3 * 2048, device=device, generator=g).bfloat16().requires_grad_()
    w = torch.randn(2048, 3, device=device, generator=g).requires_grad_()
    x = torch.randn(512, 81, 2048, device=device, generator=g).bfloat16().requires_grad_()
    nw = (torch.rand(2048, device=device, generator=g) + 0.5).requires_grad_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = short_conv(bcx, w)
        dy = torch.ones_like(y)
        got = torch.autograd.grad(y, (bcx, w), dy)
        r = rms_norm(x, nw, 1e-5)
        rgot = torch.autograd.grad(r, (x, nw), torch.ones_like(r))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = short_conv_reference(bcx, w)
    bf16_close(y, want, "short_conv")
    for name, a, e in zip(("dbcx", "dw"), got, torch.autograd.grad(want, (bcx, w), dy)):
        bf16_close(a, e, name)
    rwant = rms_norm_reference(x, nw, 1e-5)
    bf16_close(r, rwant, "rms_norm")
    for name, a, e in zip(("dx", "dweight"), rgot,
                          torch.autograd.grad(rwant, (x, nw), torch.ones_like(rwant))):
        bf16_close(a, e, name)


@pytest.mark.cuda
@pytest.mark.parametrize("width,rows", [(64, 41472 * 40), (2048, 41472), (2048, 10368),
                                        (56, 1000), (96, 333)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_rms_norm_kernels_match_plain(device, width, rows, dtype):
    """The RMS mode at the heads' 64 and the model's 2048 (and two widths
    of no model), forward and backward, twice for the same bits."""
    from rl_selfplay_mnk_tpu_torch.ops import layer_norm as ln

    g = torch.Generator(device=device).manual_seed(width)
    x = torch.randn(rows, width, device=device, generator=g).to(dtype).requires_grad_()
    w = (torch.rand(width, device=device, generator=g) + 0.5).requires_grad_()
    dy = torch.randn(rows, width, device=device, generator=g).to(dtype)
    before = ln.rms_norm.launches
    y = ln.rms_norm(x, w, 1e-5)
    got = torch.autograd.grad(y, (x, w), dy)
    assert ln.rms_norm.launches == before + 3
    again = torch.autograd.grad(ln.rms_norm(x, w, 1e-5), (x, w), dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ln.rms_norm_reference(x, w, 1e-5)
    exp = torch.autograd.grad(want, (x, w), dy)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, a, e in (("y", y, want), ("dx", got[0], exp[0]), ("dw", got[1], exp[1])):
        err = float((a.float() - e.float()).abs().max())
        assert err <= tol * float(e.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs,held", [(165888, 8), (41472, 8), (4097, 3), (100, 64)])
def test_card_moe_sort_is_the_stable_sort(device, pairs, held):
    g = torch.Generator(device=device).manual_seed(pairs)
    keys = torch.randint(0, held + 1, (pairs,), device=device, generator=g, dtype=torch.int32)
    order, inverse, ends = moe._sort(keys, held)
    want = torch.argsort(keys.long(), stable=True)
    assert torch.equal(order.long(), want)
    assert torch.equal(inverse.long()[want], torch.arange(pairs, device=device))
    counts = torch.bincount(keys.long(), minlength=held + 1)
    assert torch.equal(ends.long(), torch.cumsum(counts[:held], 0))


@pytest.mark.cuda
def test_card_tiny_lfm2_matches_the_cpu_in_f32_and_runs_bf16_without_host_sync(device):
    """The whole tiny model on the card in f32 (the kernels' f32 paths)
    against the CPU's plain f32 path on the same weights: logits, values
    and every gradient to f32 round-off; then in bf16, forward and backward
    with no host read, every gradient finite. (In bf16 the two sides pick
    different experts for some tokens, so no tight bound holds there.)"""
    obs, mask = boards(16)
    cpu, _, _ = seeded()
    card = seeded()[0].to(device)
    want = cpu(obs, train=True)
    got = card(obs.to(device), train=True)
    for a, e in zip(got, want):
        assert float((a.cpu() - e).abs().max()) <= 1e-4 * float(e.abs().max())
    gw = torch.autograd.grad(want[0].sum() + want[1].sum(), list(cpu.parameters()))
    gg = torch.autograd.grad(got[0].sum() + got[1].sum(), list(card.parameters()))
    # a leaf whose gradient is under a thousandth of the median leaf's is
    # round-off alone (the heads' plane-projection biases, under the
    # LayerNorm over the planes), left out as the CPU test leaves it out
    scales = {name: float(e.abs().max()) for (name, _), e in zip(cpu.named_parameters(), gw)}
    median = sorted(scales.values())[len(scales) // 2]
    left_out = {k for k, v in scales.items() if v < 1e-3 * median}
    assert left_out <= {"heads.value_head.plane_proj.bias", "heads.policy_head.plane_proj.bias"}
    for (name, _), a, e in zip(cpu.named_parameters(), gg, gw):
        if name not in left_out:
            assert float((a.cpu() - e).abs().max()) <= 1e-3 * scales[name] + 1e-7, name
    model = seeded(dtype=torch.bfloat16)[0].to(device)
    obs_card = obs.to(device)
    with torch.no_grad():
        model(obs_card)  # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, value = model(obs_card, train=True)
        (logits.sum() + value.sum()).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(value).all())
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
