"""The port's trained-parameter cache (``utils/cache.py``) and bundle
registry (``weights.available``/``verify``) against the JAX package's
(``isbfsar_tpu/utils/cache.py``, ``pretrained.py``): the seven digests, the
lookup order (mirrors of ``tests/test_pretrained.py``), the port's own
writable cache, and the fixtures served from the bundle."""

import os

import numpy as np
import pytest

from isbfsar_tpu import pretrained
from isbfsar_tpu.utils.cache import params_cache_digest as jax_digest
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.train import gazefocus as tgf
from isbfsar_tpu_torch.train import posestack as tps
from isbfsar_tpu_torch.utils import cache

NAMES = {"pose-ci-motions", "pose-ci-diverse", "pose-diverse-256", "focus-ci", "pose-prod-256",
         "pose-prod-256-calib", "pose-ci-calib"}


def test_verify_gives_jax_digests_and_the_manifest_files():
    got = weights.verify()
    assert set(got) == NAMES
    assert got == pretrained.verify()
    manifest = weights.manifest()
    for name, digest in got.items():
        assert manifest[name]["file"] == f"{digest}.msgpack"


@pytest.mark.parametrize("name", sorted(NAMES))
def test_each_key_builder_is_jax_string(name):
    """Each fixture's key, not only its digest, is the JAX package's."""
    port, jax_spec = weights._specs()[name], pretrained._specs()[name]
    assert port.key() == jax_spec.key()
    assert port.version == jax_spec.version


def test_focus_key_embeds_jax_focus_config_repr():
    from isbfsar_tpu.train import gazefocus as jgf

    assert tgf.focus_config_key_repr(tgf.CI_FOCUS_CFG) == repr(jgf.CI_FOCUS_CFG)


def test_digest_is_jax_and_stable():
    assert cache.params_cache_digest("k", "1") == jax_digest("k", "1")
    assert cache.params_cache_digest("k", "1") != cache.params_cache_digest("k", "2")
    assert len(cache.params_cache_digest("k", "1")) == 24


def test_available_matches_jax():
    assert weights.available() == pretrained.available()


def test_bundle_hit_skips_training(tmp_path, monkeypatch):
    monkeypatch.setenv("ISBFSAR_TORCH_PARAMS_CACHE", str(tmp_path))
    spec = weights._specs()["pose-ci-motions"]

    def bomb():
        raise RuntimeError("builder must not run: the bundle should hit")

    params = cache.cached_params(spec.key(), bomb, version=spec.version)
    assert "yolo" in params
    assert list(tmp_path.iterdir()) == []  # served read-only from the bundle


def test_moved_key_ignores_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("ISBFSAR_TORCH_PARAMS_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="fell through"):
        cache.cached_params("posestack:some-new-budget-tuple",
                            lambda: (_ for _ in ()).throw(RuntimeError("fell through")),
                            version="1")


def test_verify_flags_unbundled_spec(monkeypatch):
    real = weights._specs()

    def with_extra():
        return {**real, "pose-unbundled": weights.Spec(lambda: "posestack:not-in-any-bundle", "1",
                                                       lambda: None)}

    monkeypatch.setattr(weights, "_specs", with_extra)
    with pytest.raises(AssertionError, match="pose-unbundled"):
        weights.verify()


def test_verify_flags_a_stale_entry(monkeypatch):
    real = weights._specs()
    moved = real["focus-ci"]._replace(key=lambda: "gazefocus:moved")
    monkeypatch.setattr(weights, "_specs", lambda: {**real, "focus-ci": moved})
    with pytest.raises(AssertionError, match=r"stale entries \['focus-ci'\]"):
        weights.verify()


def test_pretrained_dir_override(tmp_path, monkeypatch):
    """``ISBFSAR_PRETRAINED_DIR`` moves the bundle for the cache lookup and
    for ``available`` alike: an empty directory has no entries and serves
    no hit."""
    monkeypatch.setenv("ISBFSAR_PRETRAINED_DIR", str(tmp_path / "bundle"))
    monkeypatch.setenv("ISBFSAR_TORCH_PARAMS_CACHE", str(tmp_path / "cache"))
    assert weights.available() == {}
    spec = weights._specs()["pose-ci-motions"]
    out = cache.cached_params(spec.key(), lambda: {"x": np.arange(3, dtype=np.float32)},
                              version=spec.version)
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(3, dtype=np.float32))


def test_miss_writes_the_port_cache_which_flax_reads(tmp_path, monkeypatch):
    """A miss trains, writes the port's own cache (never the JAX package's
    default directory) in Flax msgpack, and the next call hits it; a
    corrupt entry retrains."""
    from flax import serialization

    monkeypatch.setenv("ISBFSAR_TORCH_PARAMS_CACHE", str(tmp_path))
    calls = []

    def build():
        calls.append(1)
        return {"net": {"params": {"kernel": np.full((2, 3), 1.5, np.float32)}}}

    first = cache.cached_params("torch-test:key", build)
    second = cache.cached_params("torch-test:key", build)
    assert len(calls) == 1
    path = tmp_path / f"{cache.params_cache_digest('torch-test:key', '1')}.msgpack"
    with open(path, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    np.testing.assert_array_equal(restored["net"]["params"]["kernel"], np.full((2, 3), 1.5))
    np.testing.assert_array_equal(first["net"]["params"]["kernel"].numpy(),
                                  second["net"]["params"]["kernel"].numpy())
    path.write_bytes(b"\x00not msgpack")
    cache.cached_params("torch-test:key", build)
    assert len(calls) == 2
    assert os.path.dirname(cache.DEFAULT_PARAMS_CACHE_DIR) != "/tmp"


def _equal_trees(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and bool((a[k] == b[k]).all()), k


@pytest.mark.parametrize("name,fixture", [("pose-ci-motions", tps.ci_pose_params),
                                          ("focus-ci", tgf.ci_focus_params),
                                          ("pose-diverse-256", tps.diverse_pose_params_256)])
def test_fixtures_serve_the_bundle(tmp_path, monkeypatch, name, fixture):
    """The port's fixtures resolve to the bundle's trees (no training)."""
    monkeypatch.setenv("ISBFSAR_TORCH_PARAMS_CACHE", str(tmp_path))
    _equal_trees(fixture(device="cpu"), weights.load_bundle(name))
    assert list(tmp_path.iterdir()) == []


def test_storage_cast_matches_jax():
    """The bf16 trunk cast of a pose-stack tree: the same leaves cast."""
    import jax

    from isbfsar_tpu.train import posestack as jps

    tree = {"yolo": {"params": {"conv": {"kernel": np.ones((2, 2), np.float32)},
                                "head1_out": {"conv": {"bias": np.ones(2, np.float32)}}},
                     "batch_stats": {"bn": {"mean": np.ones(2, np.float32)}}},
            "bbone": {"params": {"stem_conv": {"kernel": np.ones(3, np.float32)}}},
            "head": {"params": {"conv_final": {"kernel": np.ones(4, np.float32)}}}}
    want = jps._storage_cast_trunks(tree)
    got = tps._storage_cast_trunks(tree)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
