"""Weight bridge of the PyTorch port: its numpy-only msgpack decoder against
``flax.serialization``, the calibration merge, and the conversion into the
port's modules (keys and shapes at full width, on the meta device)."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from isbfsar_tpu import pretrained
from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.models import effnetv2 as teff
from isbfsar_tpu_torch.models import yolov4 as tyolo


def _assert_bit_identical(ours, ref):
    flat_ours, flat_ref = weights._flatten(ours), weights._flatten(ref)
    assert flat_ours.keys() == flat_ref.keys()
    for key, want in flat_ref.items():
        got = flat_ours[key]
        assert tuple(got.shape) == want.shape, key
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16), err_msg=str(key))
        else:
            assert got.numpy().dtype == want.dtype, key
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(key))
    return flat_ref


@pytest.mark.parametrize("name", ["pose-ci-motions", "pose-prod-256-calib"])
def test_decoder_is_bit_identical_to_flax(name):
    flat = _assert_bit_identical(weights.load_bundle(name), pretrained.load(name))
    if name == "pose-prod-256-calib":  # the delta holds the YOLO branch, trunk in bf16
        assert {k[0] for k in flat} == {"yolo"}
        assert any(v.dtype.name == "bfloat16" for v in flat.values())


def test_decoder_round_trips_flax_encodings():
    tree = {
        "a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4), "bias": np.zeros((0,), np.float32)},
        "ints": np.arange(-3, 3, dtype=np.int64),
        "bf16": jnp.linspace(-2, 2, 7, dtype=jnp.bfloat16),
        "big": np.random.default_rng(0).normal(size=(300, 300)).astype(np.float32),  # bin32
        "scalar": np.float32(1.5),
        "meta": {"n": 7, "neg": -40, "huge": 2**40, "f": 0.25, "s": "x" * 40, "none": None,
                 "flags": [True, False], "empty": {}},
    }
    data = serialization.msgpack_serialize(tree)
    ours = weights.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert ours["meta"] == ref["meta"]
    assert float(ours["scalar"]) == 1.5 and ours["scalar"].shape == ()
    arrays = {k: v for k, v in ref.items() if k not in ("meta", "scalar")}
    _assert_bit_identical({k: ours[k] for k in arrays}, arrays)


def test_decoder_refuses_truncated_data():
    data = serialization.msgpack_serialize({"w": np.ones((4,), np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        weights.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        weights.msgpack_restore(data + b"\x00")


def test_load_calibrated_merges_the_delta_over_the_base(tmp_path):
    base = {"yolo": {"params": {"w": np.ones(2, np.float32)}},
            "bbone": {"params": {"w": np.zeros(3, np.float32)}}}
    delta = {"yolo": {"params": {"w": np.full(2, 5.0, np.float32)}}}
    for name, tree in (("base", base), ("delta", delta)):
        (tmp_path / f"{name}.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    (tmp_path / "MANIFEST.json").write_text(json.dumps(
        {"stack": {"file": "base.msgpack"}, "stack-calib": {"file": "delta.msgpack"}}))
    merged = weights.load_calibrated("stack", bundle_dir=str(tmp_path))
    assert merged["yolo"]["params"]["w"].tolist() == [5.0, 5.0]
    assert merged["bbone"]["params"]["w"].tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(KeyError):
        weights.load_bundle("absent", bundle_dir=str(tmp_path))


def _load_meta(net_fn, state_dict):
    with torch.device("meta"):
        net = net_fn()
    result = net.load_state_dict(state_dict, strict=True, assign=True)
    assert result.missing_keys == [] and result.unexpected_keys == []


def test_production_detector_delta_loads_into_full_width_yolo():
    sd = weights.convert_variables(weights.load_bundle("pose-prod-256-calib")["yolo"])
    assert sd["backbone.stem.conv.weight"].shape == (32, 3, 3, 3)
    _load_meta(lambda: tyolo.YOLOv4(width=1.0), sd)


@pytest.mark.slow
def test_production_base_decodes_and_loads_at_full_width():
    params = weights.load_calibrated("pose-prod-256")
    _assert_bit_identical(weights.load_bundle("pose-prod-256"), pretrained.load("pose-prod-256"))
    sd = weights.convert_pose_stack(params)
    _load_meta(lambda: tyolo.YOLOv4(width=1.0), sd["yolo"])
    _load_meta(lambda: teff.EfficientNetV2(teff.V2_L), sd["bbone"])
    _load_meta(teff.MetrabsHead, sd["head"])
