"""The port's ActionRecognizer against the JAX one: ``inference`` over a
frame sequence (the window, the cached support features, an edit), the
modality check, and the support-set files, which either package must read
from the other.

Both recognizers hold the JAX-initialized TRX weights (carried across with
the weight bridge) and the same support data; float32 on the CPU. Scores
and the open-set decision are held to tests/test_torch_pipeline.py's
``TOL`` (probs 2e-5, is_true 2e-6); the class keys and the empty results
before the window fills must be equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer

torch.set_num_threads(2)

TOL = {"probs": 2e-5, "is_true": 2e-6}


def _item(name, seed, requires_focus=False):
    rng = np.random.default_rng(seed)
    return {"flag": name, "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
            "requires_focus": requires_focus}


@pytest.fixture
def pair():
    jar = JaxRecognizer(jc.ARConfig.for_input("skeleton"), seed=0)
    ar = ActionRecognizer(tc.ARConfig.for_input("skeleton"),
                          params=jax.tree.map(np.asarray, jar.params), device="cpu")
    for i, focus in ((0, False), (1, True)):
        jar.train(_item(f"a{i}", i, focus))
        ar.train(_item(f"a{i}", i, focus))
    return jar, ar


def _assert_same(ours, ref):
    (o_act, o_true, o_focus), (r_act, r_true, r_focus) = ours, ref
    assert o_act.keys() == r_act.keys() and o_focus == r_focus
    for name in r_act:
        np.testing.assert_allclose(o_act[name], r_act[name], atol=TOL["probs"], rtol=0)
    np.testing.assert_allclose(o_true, r_true, atol=TOL["is_true"], rtol=0)


def test_inference_matches_jax_across_an_edit(pair):
    jar, ar = pair
    frames = np.random.default_rng(5).normal(size=(40, 90)).astype(np.float32)
    for i, f in enumerate(frames[:20]):
        ours, ref = ar.inference({"sk": f}), jar.inference({"sk": f})
        _assert_same(ours, ref)
        assert (ours[0] == {}) == (i < 15)  # results once the window holds 16 frames
    assert set(ours[0]) == {"a0", "a1"} and ours[2] == {"a0": False, "a1": True}
    np.testing.assert_allclose(sum(ours[0].values()), 1.0, rtol=1e-5)

    # an edit clears the cached features; the window carries on
    for r in (jar, ar):
        assert r.remove("a0")
        r.train(_item("a2", 7))
    assert ar.support_features is None
    for f in frames[20:]:
        ours = ar.inference({"sk": f})
        _assert_same(ours, jar.inference({"sk": f}))
    assert set(ours[0]) == {"a1", "a2"} and len(ar.previous_frames) == 16


def test_empty_input_and_empty_support(pair):
    jar, ar = pair
    assert ar.inference(None) == jar.inference(None) == ({}, 0, {})
    assert ar.inference({}) == ({}, 0, {})
    empty = ActionRecognizer(tc.ARConfig.for_input("skeleton"), device="cpu")
    assert empty.inference({"sk": np.zeros(90, np.float32)}) == ({}, 0, {})
    assert empty.previous_frames == []


def test_missing_modality_raises_before_the_append(pair):
    jar, ar = pair
    ar.inference({"sk": np.zeros(90, np.float32)})
    for r in (jar, ar):
        with pytest.raises(ValueError, match="missing modalities"):
            r.inference({"rgb": np.zeros((224, 224, 3), np.float32)})
    assert len(ar.previous_frames) == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_support_set_files_cross_packages(pair, tmp_path, writer):
    """A set saved by one package loads in the other; the loader then scores
    a window as the writer's twin does."""
    jar, ar = pair
    if writer == "port":
        saver = ar
        loader = JaxRecognizer(jc.ARConfig.for_input("skeleton"), params=jar.params)
    else:
        saver = jar
        loader = ActionRecognizer(tc.ARConfig.for_input("skeleton"),
                                  params=jax.tree.map(np.asarray, jar.params), device="cpu")
    saver.save_support_set(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["support_set.json", "support_set.npz"]
    version = loader.support_version
    assert loader.load_support_set(str(tmp_path)) == 2
    assert loader.support_version == version + 1
    assert loader.class_order == saver.class_order
    assert loader.requires_focus == saver.requires_focus
    np.testing.assert_array_equal(loader.support_mask, saver.support_mask)
    np.testing.assert_array_equal(loader.support_data["sk"], saver.support_data["sk"])
    assert loader._live_classes() == ["a0", "a1"]
    # the port's result against the JAX package's, on the same window
    port, ref = (ar, loader) if writer == "port" else (loader, jar)
    for f in np.random.default_rng(9).normal(size=(16, 90)).astype(np.float32):
        ours, want = port.inference({"sk": f}), ref.inference({"sk": f})
    assert ours[0]
    _assert_same(ours, want)


def test_load_refuses_other_shapes_and_input_types(pair, tmp_path):
    _, ar = pair
    ar.save_support_set(str(tmp_path))
    wide = ActionRecognizer(tc.ARConfig(way=6), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        wide.load_support_set(str(tmp_path))
    meta = json.loads((tmp_path / "support_set.json").read_text())
    meta["input_type"] = "rgb"
    (tmp_path / "support_set.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="input_type"):
        ar.load_support_set(str(tmp_path))


def test_support_version_counts_edits(pair, tmp_path):
    _, ar = pair
    v = ar.support_version
    ar.train(_item("a2", 3))
    assert not ar.remove("nope")
    assert ar.remove("a2")
    ar.save_support_set(str(tmp_path))
    assert ar.support_version == v + 2
    ar.load_support_set(str(tmp_path))
    assert ar.support_version == v + 3
