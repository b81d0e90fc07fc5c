"""The port's exports against the JAX package's: the msgpack reader and writer
against ``flax.serialization`` and the committed weight files, the export
round trip in both directions for one name of each family, the JSON sidecar,
the committed exports' forwards, and the trainer's exports. Float32 on the
CPU."""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rl_selfplay_mnk_tpu.models import create_model_from_architecture as jax_create
from rl_selfplay_mnk_tpu.models import init_network as jax_init
from rl_selfplay_mnk_tpu.models import make_apply_fns as jax_apply_fns
from rl_selfplay_mnk_tpu.utils import model_export as jax_export
from rl_selfplay_mnk_tpu_torch.models import (
    create_model_from_architecture,
    eval_apply,
    init_network,
    state_dict_to_flax,
)
from rl_selfplay_mnk_tpu_torch.utils import flax_msgpack, model_export

# One intra-op thread: the tensors here are tiny, and several test processes
# with a thread pool each spend their time waiting on one another.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE30 = REPO / "models" / "tpu_smoke30"
FULL13 = REPO / "evidence" / "exports_full13_transformer_b_s_w"
# One name of each family: CNN, ResNet, plain transformer, the gated (SGR)
# transformer and the MLP. (The no-FFN speed tier is the committed 13x13 export.)
FAMILIES = ["cnn_b_s", "resnet_b_s", "transformer_b_s", "transformer_c_s", "mlp_tiny"]
# Forwards of the same weights in the two packages: f32 sums in another order.
FORWARD_TOL = dict(atol=1e-5, rtol=1e-5)


def boards(seed, b, m, n):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 3, size=(b, m, n))
    return np.stack([owner == 1, owner == 2], axis=1).astype(np.float32)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert sorted(la) == sorted(lb)
    for key, x in la.items():
        assert x.dtype == lb[key].dtype and x.shape == lb[key].shape, key
        np.testing.assert_array_equal(x, lb[key], err_msg=key)


def jax_template(module, obs_shape):
    template = dict(jax.eval_shape(
        lambda r: module.init(r, jnp.zeros((1,) + obs_shape, jnp.float32), train=False),
        jax.random.PRNGKey(0)))
    template.setdefault("batch_stats", {})
    return template


def port_model(name, seed, m):
    model, arch_params = create_model_from_architecture(name, (2, m, m), m * m)
    init_network(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # biases, norms, gates and running statistics off their init
        for key, t in model.state_dict().items():
            if key.endswith("running_var"):
                t.mul_(torch.from_numpy(rng.uniform(0.5, 2.0, tuple(t.shape)).astype(np.float32)))
            elif t.dtype == torch.float32:
                t.add_(torch.from_numpy((0.05 * rng.normal(size=tuple(t.shape))).astype(np.float32)))
    return model, arch_params


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [SMOKE30 / "model_00030.msgpack", FULL13 / "model_04365.msgpack"],
                         ids=lambda p: p.parent.name)
def test_reader_and_writer_reproduce_the_committed_files(path):
    """What the reader makes of a committed file is what flax restores from
    it, and the writer gives the file's bytes back."""
    raw = path.read_bytes()
    tree = flax_msgpack.unpackb(raw)
    assert_trees_equal(tree, serialization.msgpack_restore(raw))
    assert all(x.dtype == np.float32 for x in leaves(tree).values())
    assert flax_msgpack.packb(tree) == raw


def test_writer_gives_the_bytes_flax_writes():
    rng = np.random.default_rng(0)
    tree = {
        "params": {
            "Dense_0": {"kernel": rng.normal(size=(3, 70000)).astype(np.float32),  # ext 32
                        "bias": rng.normal(size=(300,)).astype(np.float32)},       # ext 16
            "tiny": {"scale": np.float32(2.5) * np.ones((1,), np.float32),         # ext 8
                     "steps": np.arange(4, dtype=np.int32),
                     "half": rng.normal(size=(2, 2)).astype(np.float16),
                     "flag": np.array([True, False]),
                     "empty": np.zeros((0, 3), np.float32)},
            **{f"layer_{i}": {"w": np.full((2,), i, np.float32)} for i in range(20)},  # map 16
        },
        "batch_stats": {},
        "scalars": {"count": 7, "negative": -40000, "big": 2**40, "rate": 0.25, "name": "x" * 40,
                    "none": None, "yes": True, "np": np.float32(1.5)},
    }
    want = serialization.msgpack_serialize(tree)
    got = flax_msgpack.packb(tree)
    assert got == want
    back = flax_msgpack.unpackb(got)
    assert_trees_equal(back["params"], tree["params"])
    assert back["scalars"] == {**tree["scalars"], "np": np.float32(1.5)}
    assert isinstance(back["scalars"]["np"], np.float32) and back["batch_stats"] == {}


@pytest.mark.parametrize("data,match", [
    (b"\x81\xa1a", "end inside"),
    (b"\xc0\xc0", "follow"),
    (b"\xc1", "unknown msgpack type"),
    (b"\xd4\x05\x00", "extension type 5"),
])
def test_reader_refuses_what_flax_does_not_write(data, match):
    with pytest.raises(flax_msgpack.MsgpackError, match=match):
        flax_msgpack.unpackb(data)
    with pytest.raises(flax_msgpack.MsgpackError, match="cannot pack"):
        flax_msgpack.packb({"a": object()})


# ---------------------------------------------------------------------------
# the round trip, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_port_export_is_restored_by_flax_bit_for_bit(name, tmp_path):
    """The port's file through ``flax.serialization.from_bytes`` and through
    the JAX package's loader: every leaf bitwise the port's weight, the
    forwards agree, and the port's own loader gives the model back."""
    m = 5
    model, arch_params = port_model(name, 3, m)
    exporter = model_export.ModelExporter("runP", base_dir=str(tmp_path))
    assert exporter.export_model(model, name, arch_params, 7, is_benchmark_breaker=True) == "model_00007"
    raw = (tmp_path / "runP" / "model_00007.msgpack").read_bytes()
    want = state_dict_to_flax(model.state_dict(), getattr(model, "num_heads", None))

    module, _ = jax_create(name, (2, m, m), m * m)
    restored = serialization.from_bytes(jax_template(module, (2, m, m)), raw)
    assert_trees_equal(restored, want)
    # The same bytes the JAX package's exporter writes for these variables.
    assert raw == serialization.to_bytes(jax.device_get(restored))

    module, variables, metadata = jax_export.load_any_model(str(tmp_path / "runP"), "model_00007")
    assert_trees_equal(variables, want)
    assert (metadata.architecture_name, metadata.iteration, metadata.run_name,
            metadata.is_benchmark_breaker) == (name, 7, "runP", True)
    obs = boards(4, 6, m, m)
    lj, vj = jax_apply_fns(module)[0](variables, jnp.asarray(obs))
    lt, vt = eval_apply(model, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), **FORWARD_TOL)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), **FORWARD_TOL)

    again, metadata = model_export.load_any_model(str(tmp_path / "runP"), "model_00007", device="cpu")
    assert metadata.to_dict()["architecture"] == {"name": name, "params": arch_params}
    for key, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], t), key


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_export_is_loaded_by_the_port(name, tmp_path):
    """A file written by the JAX package's ``ModelExporter``, loaded by the
    port: the same sidecar, the same forward."""
    m = 5
    module, arch_params = jax_create(name, (2, m, m), m * m)
    variables = jax_init(module, (2, m, m), jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) * rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        if p[-1].key == "var" else (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        variables)
    jax_export.ModelExporter("runJ", base_dir=str(tmp_path)).export_model(
        variables, name, arch_params, 12)

    model, metadata = model_export.load_any_model(str(tmp_path / "runJ"), "model_00012",
                                                  device="cpu")
    assert next(model.parameters()).device.type == "cpu" and model.dtype == torch.float32
    listing = model_export.get_models_from_directory(str(tmp_path / "runJ"))
    assert listing == jax_export.get_models_from_directory(str(tmp_path / "runJ"))
    assert listing == [metadata.to_dict()] and metadata.iteration == 12
    obs = boards(6, 6, m, m)
    lj, vj = jax_apply_fns(module)[0](variables, jnp.asarray(obs))
    lt, vt = eval_apply(model, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), **FORWARD_TOL)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), **FORWARD_TOL)


@pytest.mark.parametrize("model_dir,model_id,name,m", [
    (SMOKE30, "model_00030", "resnet_b_s", 9),
    (FULL13, "model_04365", "transformer_b_s_w", 13),
], ids=["tpu_smoke30", "full13"])
def test_committed_exports_load_with_the_jax_forward(model_dir, model_id, name, m):
    model, metadata = model_export.load_any_model(str(model_dir), model_id, device="cpu")
    module, variables, jax_metadata = jax_export.load_any_model(str(model_dir), model_id)
    assert metadata.to_dict() == jax_metadata.to_dict() and metadata.architecture_name == name
    obs = boards(7, 4, m, m)
    lj, vj = jax_apply_fns(module)[0](variables, jnp.asarray(obs))
    lt, vt = eval_apply(model, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), **FORWARD_TOL)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), **FORWARD_TOL)
    assert float(np.abs(lt.numpy()).max()) > 0.1  # trained weights, not an init


# ---------------------------------------------------------------------------
# the exporter's files and the trainer's exports
# ---------------------------------------------------------------------------


def test_sidecar_and_listing_are_the_jax_package_s(tmp_path):
    model, arch_params = port_model("mlp_tiny", 1, 3)
    exporter = model_export.ModelExporter("run", base_dir=str(tmp_path))
    for iteration in (30, 4):
        exporter.export_model(model, "mlp_tiny", arch_params, iteration)
    run_dir = tmp_path / "run"
    assert sorted(os.listdir(run_dir)) == ["model_00004.json", "model_00004.msgpack",
                                           "model_00030.json", "model_00030.msgpack"]
    sidecar = json.loads((run_dir / "model_00004.json").read_text())
    committed = json.loads((SMOKE30 / "model_00030.json").read_text())
    assert list(sidecar) == list(committed)
    assert list(sidecar["architecture"]) == list(committed["architecture"])
    assert sidecar["architecture"]["params"] == {"obs_shape": [2, 3, 3], "action_dim": 9}
    # Strays are skipped, the listing is sorted by iteration, as in the JAX package.
    (run_dir / "config.json").write_text(json.dumps({"lr": 3e-4}))
    (run_dir / "broken.json").write_text("{not json")
    listing = model_export.get_models_from_directory(str(run_dir))
    assert [entry["model_id"] for entry in listing] == ["model_00004", "model_00030"]
    assert listing == jax_export.get_models_from_directory(str(run_dir))
    assert model_export.get_models_from_directory(str(tmp_path / "nowhere")) == []
    with pytest.raises(FileNotFoundError, match="Metadata"):
        model_export.load_any_model(str(run_dir), "model_00001", device="cpu")
    (run_dir / "model_00030.msgpack").unlink()
    with pytest.raises(FileNotFoundError, match="weights"):
        model_export.load_any_model(str(run_dir), "model_00030", device="cpu")
    null = model_export.NullModelExporter("quiet", base_dir=str(tmp_path))
    assert null.export_model(model, "mlp_tiny", arch_params, 1) == ""
    assert not (tmp_path / "quiet").exists()


def test_trainer_exports_after_every_validation_and_at_the_end(tmp_path):
    """``train_mnk``: an export after each validation (marked when the learner
    was promoted) and one at the end, readable by both packages."""
    from rl_selfplay_mnk_tpu_torch.train import build_config, train_mnk
    from rl_selfplay_mnk_tpu_torch.utils.metrics import MetricsLogger

    config = build_config("cnn_b_s", (3, 3, 3), 32, 8 * 16 * 5)
    assert (config["learning_rate"], config["entropy_coef"]) == (6e-4, 0.04)
    config.update(num_envs=8, n_steps=16, validation_episodes=16, validation_interval=2,
                  export_dir=str(tmp_path / "models"))
    with MetricsLogger(run_name="cpu_cnn", config=config, out_dir=str(tmp_path)) as logger:
        summary = train_mnk(config, logger, device="cpu")
    assert summary["errors"] == [] and len(summary["validations"]) == 2
    assert summary["export_dir"] == str(tmp_path / "models" / "cpu_cnn")
    listing = model_export.get_models_from_directory(summary["export_dir"])
    assert [entry["iteration"] for entry in listing] == [2, 4, 5]
    assert all(entry["architecture"]["name"] == "cnn_b_s" and entry["run_name"] == "cpu_cnn"
               for entry in listing)
    promoted = [v["validation/vs_benchmark/score_rate"] > 0.6 for v in summary["validations"]]
    assert [entry["is_benchmark_breaker"] for entry in listing] == promoted + [False]
    last, _ = model_export.load_any_model(summary["export_dir"], "model_00005", device="cpu")
    for key, t in summary["model"].state_dict().items():
        assert torch.equal(last.state_dict()[key], t), key
    _, variables, _ = jax_export.load_any_model(summary["export_dir"], "model_00005")
    assert_trees_equal(variables, state_dict_to_flax(summary["model"].state_dict()))
