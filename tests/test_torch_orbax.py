"""The orbax backend of the port's ``save_checkpoint`` / ``load_checkpoint``
against JAX's, mirroring tests/test_train.py's orbax cases: a checkpoint
written by either package loads in the other (``{step}.orbax``, JAX's
layout), ``latest_checkpoint`` picks the highest step across both formats,
and the port's trainer writes orbax checkpoints that JAX's
``load_checkpoint`` restores into its own template and the port resumes
from. Values are compared exactly (bfloat16 leaves included)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

from isbfsar_tpu.utils import checkpoint as jck  # noqa: E402
from isbfsar_tpu_torch import configs as tc  # noqa: E402
from isbfsar_tpu_torch.train.dataloader import EpisodicSampler  # noqa: E402
from isbfsar_tpu_torch.train.synthetic import generate_dataset  # noqa: E402
from isbfsar_tpu_torch.train.trainer import Trainer  # noqa: E402
from isbfsar_tpu_torch.utils import checkpoint as tck  # noqa: E402

torch.set_num_threads(2)


def test_jax_orbax_loads_in_the_port(tmp_path, rng):
    tree = {
        "params": {"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
                   "h": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)},
        "step": jnp.int32(3),
    }
    path = jck.save_checkpoint(str(tmp_path), 2, tree, meta={"epoch": 2}, backend="orbax")
    assert path.endswith("2.orbax") and (tmp_path / "2.orbax").is_dir()
    loaded = tck.load_checkpoint(path, {"params": None, "step": None})
    assert isinstance(loaded["params"]["w"], torch.Tensor)
    np.testing.assert_array_equal(loaded["params"]["w"].numpy(), np.asarray(tree["params"]["w"]))
    assert loaded["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(loaded["params"]["h"].float(),
                       torch.from_numpy(np.asarray(tree["params"]["h"], np.float32)))
    assert int(loaded["step"]) == 3
    with pytest.raises(ValueError, match="checkpoint keys"):
        tck.load_checkpoint(path, {"params": None})


def test_port_orbax_loads_in_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(3, 4, generator=g),
                       "h": torch.randn(5, generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    path = tck.save_checkpoint(str(tmp_path), 4, tree, meta={"epoch": 4}, backend="orbax")
    assert path.endswith("4.orbax") and (tmp_path / "4.json").is_file()
    template = {"params": {"w": jnp.zeros((3, 4)), "h": jnp.zeros((5,), jnp.bfloat16)},
                "step": jnp.int32(0)}
    loaded = jck.load_checkpoint(path, template)
    np.testing.assert_array_equal(np.asarray(loaded["params"]["w"]), tree["params"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(loaded["params"]["h"], np.float32),
                                  tree["params"]["h"].float().numpy())
    assert int(loaded["step"]) == 7
    back = tck.load_checkpoint(path)  # and in the port itself
    assert torch.equal(back["params"]["h"], tree["params"]["h"])


def test_discovery_across_formats(tmp_path):
    tree = {"params": {"w": np.ones((2, 2), np.float32)}}
    tck.save_checkpoint(str(tmp_path), 2, tree, backend="orbax")
    tck.save_checkpoint(str(tmp_path), 1, tree)
    assert tck.latest_checkpoint(str(tmp_path)).endswith("2.orbax")
    jck.save_checkpoint(str(tmp_path), 5, tree)
    assert tck.latest_checkpoint(str(tmp_path)).endswith("5.msgpack")
    assert tck.latest_checkpoint(str(tmp_path)) == jck.latest_checkpoint(str(tmp_path))


def test_trainer_orbax_backend(tmp_path):
    """Trainer.fit with ckpt_backend='orbax' writes {epoch}.orbax, which JAX
    restores and the port resumes from."""
    generate_dataset(str(tmp_path / "tree"), n_classes=6, clips_per_class=2)
    cfg = dataclasses.replace(tc.ARConfig(), n_task=8, batch_size=4, eval_every_n_epoch=10_000,
                              checkpoint_dir=str(tmp_path / "ck"), ckpt_backend="orbax")
    sampler = EpisodicSampler(str(tmp_path / "tree"), n_task=8, l=16, seed=3)
    trainer = Trainer(cfg, sampler, log_dir=str(tmp_path / "r"), use_wandb=False, device="cpu")
    trainer.fit(n_epochs=1)
    latest = tck.latest_checkpoint(str(tmp_path / "ck"))
    assert latest is not None and latest.endswith("0.orbax")
    state = tck.load_checkpoint(latest, {"params": None, "batch_stats": None, "opt_state": None})
    saved = trainer.state()
    resumed = Trainer(cfg, log_dir=str(tmp_path / "r2"), use_wandb=False, device="cpu")
    resumed.load_state(state)
    for name, leaf in tck._flatten(saved["params"]).items():
        assert torch.equal(tck._flatten(resumed.state()["params"])[name], leaf), name
    jax_template = tck._map(saved, lambda t: jnp.zeros(tuple(t.shape), t.numpy().dtype)
                            if isinstance(t, torch.Tensor) else t)
    restored = jck.load_checkpoint(latest, jax_template)
    for name, leaf in tck._flatten(saved["params"]).items():
        np.testing.assert_array_equal(np.asarray(tck._flatten(restored["params"])[name]),
                                      leaf.numpy())
