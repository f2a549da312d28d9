"""The port's reference-checkpoint importers (``utils/checkpoint.py``) against
JAX's, on the vendored upstream layouts of tests/fixtures_upstream.py
(Tianxiaomo YOLOv4 with 80 classes, the Keras-order and interleaved
EfficientNetV2-L variables, torchvision ResNet-18/50, the TRXOS
``DISC.pth`` key set), each tensor filled with a unique value.

Every case of tests/test_upstream_import.py is mirrored on the port:
coverage, spot positions, order independence, both neck spellings, the
census, layout invariance, and the loud failures. On top:

- the port's result equals ``convert_variables`` of JAX's importer output
  exactly, and loads into the port's own module with ``strict=True``;
- the same malformed inputs raise the same error types in both packages;
- the order-based importers (``import_ordered_convnet``,
  ``import_tf_vars``) are pinned: on each net they are documented for, the
  port's template (``template_variables``, the module's registration order)
  gives exactly what JAX's gives on its definition-order template, which is
  also what the name-mapped importer gives; the sorted template of
  ``to_flax_variables`` scrambles YOLOv4, in both packages alike.

Tolerance: none, every comparison is exact.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isbfsar_tpu.utils import checkpoint as jck
from isbfsar_tpu_torch.utils import checkpoint as pck
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables
from tests.fixtures_upstream import (
    effnetv2_l_tf_variables_spec,
    tianxiaomo_yolov4_state_dict_spec,
    torchvision_resnet_state_dict_spec,
    trxos_state_dict_spec,
)

torch.set_num_threads(2)


def _materialize(spec):
    """spec -> list of (key, array) where entry i is filled with i+1."""
    return [(key, np.full(shape, float(i + 1), np.float32)) for i, (key, shape) in enumerate(spec)]


def _fill_value(spec, key):
    for i, (k, _) in enumerate(spec):
        if k == key:
            return float(i + 1)
    raise KeyError(key)


def _flat(tree):
    return flax.traverse_util.flatten_dict(tree)


def _assert_all_filled(variables, collections=("params", "batch_stats")):
    for col in collections:
        flat = _flat(variables.get(col, {}))
        untouched = ["/".join(k) for k, v in flat.items() if not np.all(np.asarray(v) != 0)]
        assert not untouched, f"{col} leaves not overwritten by import: {untouched[:10]}"


def _assert_same(port, jax_out):
    """convert_variables of both: the same keys, bit-equal tensors."""
    a, b = convert_variables(port), convert_variables(jax_out)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:8]
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))]
    assert not bad, bad[:8]


def _definition_order(model, x):
    """JAX's variables in Flax's definition order, zero-filled: flattened
    inside the traced init (``eval_shape`` and ``jit`` rebuild dicts in
    sorted order on the way out)."""
    paths = []

    def init(key):
        flat = _flat(model.init(key, x))
        paths.extend(flat)
        return [flat[p] for p in paths]

    leaves = jax.eval_shape(init, jax.random.key(0))
    return flax.traverse_util.unflatten_dict(
        {p: np.zeros(s.shape, s.dtype) for p, s in zip(paths, leaves)})


def _loads_into(module, variables):
    module.load_state_dict(convert_variables(variables), strict=True)


def _same_error(fn_port, fn_jax, exc):
    with pytest.raises(exc) as ep:
        fn_port()
    with pytest.raises(exc) as ej:
        fn_jax()
    assert type(ep.value) is type(ej.value)


# ------------------------------------------------------------------ YOLOv4


class TestYolov4Tianxiaomo:
    @pytest.fixture(scope="class")
    def templates(self):
        from isbfsar_tpu.models.yolov4 import YOLOv4 as JaxYOLOv4
        from isbfsar_tpu_torch.models.yolov4 import YOLOv4

        port_model = YOLOv4(dtype=torch.float32)  # full-size reference architecture
        return (pck.template_variables(port_model),
                _definition_order(JaxYOLOv4(dtype=jnp.float32), jnp.zeros((1, 64, 64, 3))),
                port_model)

    @pytest.fixture(scope="class")
    def imported(self, templates):
        port_t, jax_t, _ = templates
        spec = tianxiaomo_yolov4_state_dict_spec()
        sd = dict(_materialize(spec))
        return spec, sd, pck.import_yolov4_tianxiaomo(sd, port_t), jck.import_yolov4_tianxiaomo(
            sd, jax_t)

    def test_equals_jax_and_loads(self, templates, imported):
        _, _, port, jax_out = imported
        _assert_same(port, jax_out)
        _loads_into(templates[2], port)

    def test_full_coverage(self, imported):
        _assert_all_filled(imported[2])

    def test_spot_positions(self, imported):
        spec, _, variables, _ = imported
        p, s = _flat(variables["params"]), _flat(variables["batch_stats"])

        def val(key):
            return _fill_value(spec, key)

        assert p[("backbone", "stem", "conv", "kernel")].flat[0] == val("down1.conv1.conv.0.weight")
        assert p[("backbone", "stage1", "res0", "conv1", "conv", "kernel")].flat[0] == val(
            "down1.conv5.conv.0.weight")
        assert p[("backbone", "stage1", "res0", "conv2", "conv", "kernel")].flat[0] == val(
            "down1.conv6.conv.0.weight")
        assert p[("backbone", "stage3", "route", "conv", "kernel")].flat[0] == val(
            "down3.conv2.conv.0.weight")
        assert p[("backbone", "stage3", "trunk_in", "conv", "kernel")].flat[0] == val(
            "down3.conv3.conv.0.weight")
        assert p[("neck", "p5_up", "conv", "kernel")].flat[0] == val("neek.conv7.conv.0.weight")
        assert p[("neck", "lat4", "conv", "kernel")].flat[0] == val("neek.conv8.conv.0.weight")
        assert p[("neck", "p4_up", "conv", "kernel")].flat[0] == val("neek.conv14.conv.0.weight")
        assert p[("neck", "lat3", "conv", "kernel")].flat[0] == val("neek.conv15.conv.0.weight")
        assert p[("head1_out", "conv", "kernel")].flat[0] == val("head.conv2.conv.0.weight")
        assert p[("head1_out", "conv", "bias")].flat[0] == val("head.conv2.conv.0.bias")
        assert p[("head2_out", "conv", "kernel")].flat[0] == val("head.conv10.conv.0.weight")
        assert p[("head3_out", "conv", "kernel")].flat[0] == val("head.conv18.conv.0.weight")
        assert s[("backbone", "stage5", "merge", "bn", "mean")].flat[0] == val(
            "down5.conv5.conv.1.running_mean")

    def test_order_independence(self, templates, imported):
        spec, _, variables, _ = imported
        again = pck.import_yolov4_tianxiaomo(dict(reversed(_materialize(spec))), templates[0])
        _assert_same(again, variables)

    @pytest.mark.parametrize("torch_tensors", [False, True])
    def test_neck_rename_accepted(self, templates, imported, torch_tensors):
        spec, _, variables, _ = imported
        sd = {k.replace("neek.", "neck."): (torch.from_numpy(v) if torch_tensors else v)
              for k, v in _materialize(spec)}
        _assert_same(pck.import_yolov4_tianxiaomo(sd, templates[0]), variables)

    def test_missing_layer_is_loud(self, templates):
        sd = dict(_materialize(tianxiaomo_yolov4_state_dict_spec()))
        del sd["neek.conv7.conv.0.weight"]
        _same_error(lambda: pck.import_yolov4_tianxiaomo(sd, templates[0]),
                    lambda: jck.import_yolov4_tianxiaomo(sd, templates[1]), KeyError)

    def test_extra_key_is_loud(self, templates):
        sd = dict(_materialize(tianxiaomo_yolov4_state_dict_spec()))
        sd["head.conv19.conv.0.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        _same_error(lambda: pck.import_yolov4_tianxiaomo(sd, templates[0]),
                    lambda: jck.import_yolov4_tianxiaomo(sd, templates[1]), ValueError)

    def test_shape_mismatch_is_loud(self, templates):
        sd = dict(_materialize(tianxiaomo_yolov4_state_dict_spec()))
        sd["head.conv3.conv.0.weight"] = np.zeros((256, 128, 1, 1), np.float32)
        _same_error(lambda: pck.import_yolov4_tianxiaomo(sd, templates[0]),
                    lambda: jck.import_yolov4_tianxiaomo(sd, templates[1]), ValueError)

    def test_ordered_import_pins_registration_order(self, templates, imported):
        """import_ordered_convnet zips the upstream registration order
        against the template's: the port's registration order gives JAX's
        definition-order result, which is the name-mapped import."""
        port_t, jax_t, _ = templates
        _, sd, named, _ = imported
        port = pck.import_ordered_convnet(sd, port_t)
        _assert_same(port, jck.import_ordered_convnet(sd, jax_t))
        _assert_same(port, named)

    def test_sorted_template_scrambles_in_both(self, templates, imported):
        sorted_t = jax.tree.map(lambda t: t.numpy(),
                                to_flax_variables(templates[2].state_dict()))
        sd = imported[1]
        _same_error(lambda: pck.import_ordered_convnet(sd, sorted_t),
                    lambda: jck.import_ordered_convnet(sd, sorted_t), ValueError)


# ------------------------------------------------------------ EffNetV2-L


class TestEffnetV2Metrabs:
    @pytest.fixture(scope="class")
    def templates(self):
        from isbfsar_tpu.models.effnetv2 import EfficientNetV2 as JaxEffNet
        from isbfsar_tpu_torch.models.effnetv2 import EfficientNetV2

        port_model = EfficientNetV2(dtype=torch.float32)  # V2-L
        return (pck.template_variables(port_model),
                _definition_order(JaxEffNet(dtype=jnp.float32), jnp.zeros((1, 64, 64, 3))),
                port_model)

    @pytest.fixture(scope="class")
    def imported(self, templates):
        spec = effnetv2_l_tf_variables_spec()
        tf_vars = _materialize(spec)
        return spec, tf_vars, pck.import_metrabs_effnetv2(tf_vars, templates[0])

    def test_equals_jax_and_loads(self, templates, imported):
        _, tf_vars, port = imported
        _assert_same(port, jck.import_metrabs_effnetv2(tf_vars, templates[1]))
        _loads_into(templates[2], port)

    def test_full_coverage(self, imported):
        _assert_all_filled(imported[2])

    def test_param_census(self, templates):
        fixture_n = sum(int(np.prod(shape)) for _, shape in effnetv2_l_tf_variables_spec())
        port_n = sum(t.numel() for t in templates[2].state_dict().values())
        assert fixture_n == port_n

    def test_spot_positions(self, imported):
        spec, _, variables = imported
        p, s = _flat(variables["params"]), _flat(variables["batch_stats"])

        def val(key):
            return _fill_value(spec, key)

        assert p[("stage0_block0", "project_conv", "kernel")].flat[0] == val(
            "efficientnetv2-l/blocks_0/conv2d/kernel:0")
        assert p[("stage3_block0", "expand_conv", "kernel")].flat[0] == val(
            "efficientnetv2-l/blocks_18/conv2d/kernel:0")
        assert p[("stage3_block0", "project_conv", "kernel")].flat[0] == val(
            "efficientnetv2-l/blocks_18/conv2d_1/kernel:0")
        k = p[("stage3_block0", "depthwise_conv", "kernel")]
        assert k.shape[2] == 1 and k.flat[0] == val(
            "efficientnetv2-l/blocks_18/depthwise_conv2d/depthwise_kernel:0")
        assert p[("stage3_block0", "se", "reduce", "bias")].flat[0] == val(
            "efficientnetv2-l/blocks_18/se/conv2d/bias:0")
        assert p[("stage6_block6", "project_conv", "kernel")].flat[0] == val(
            "efficientnetv2-l/blocks_78/conv2d_1/kernel:0")
        assert s[("stage6_block6", "project_bn", "var")].flat[0] == val(
            "efficientnetv2-l/blocks_78/tpu_batch_normalization_2/moving_variance:0")
        assert p[("head_conv", "kernel")].flat[0] == val("efficientnetv2-l/head/conv2d/kernel:0")
        assert s[("head_bn", "mean")].flat[0] == val(
            "efficientnetv2-l/head/tpu_batch_normalization/moving_mean:0")

    def test_layout_invariance(self, templates, imported):
        spec_tf = effnetv2_l_tf_variables_spec(interleaved=False)
        spec_il = effnetv2_l_tf_variables_spec(interleaved=True)
        assert [k for k, _ in spec_tf] != [k for k, _ in spec_il]
        values = {k: float(i + 1) for i, (k, _) in enumerate(spec_tf)}
        il = [(k, np.full(sh, values[k], np.float32)) for k, sh in spec_il]
        _assert_same(pck.import_metrabs_effnetv2(il, templates[0]), imported[2])

    def test_unknown_scope_is_loud(self, templates, imported):
        tf_vars = imported[1] + [("efficientnetv2-l/blocks_79/conv2d/kernel:0",
                                  np.zeros((1, 1, 1, 1), np.float32))]
        _same_error(lambda: pck.import_metrabs_effnetv2(tf_vars, templates[0]),
                    lambda: jck.import_metrabs_effnetv2(tf_vars, templates[1]), KeyError)

    def test_unknown_leaf_and_missing_scope_are_loud(self, templates, imported):
        bad_leaf = imported[1] + [("efficientnetv2-l/head/conv2d/weights:0",
                                   np.zeros((1,), np.float32))]
        _same_error(lambda: pck.import_metrabs_effnetv2(bad_leaf, templates[0]),
                    lambda: jck.import_metrabs_effnetv2(bad_leaf, templates[1]), ValueError)
        missing = [(k, v) for k, v in imported[1] if "/head/" not in k]
        _same_error(lambda: pck.import_metrabs_effnetv2(missing, templates[0]),
                    lambda: jck.import_metrabs_effnetv2(missing, templates[1]), ValueError)

    @pytest.mark.parametrize("interleaved", [False, True])
    def test_tf_vars_pins_registration_order(self, templates, imported, interleaved):
        """import_tf_vars zips layer groups against the template's conv,
        dense and bn order: the port's registration order gives JAX's
        definition-order result and the name-mapped import."""
        values = {k: float(i + 1) for i, (k, _) in enumerate(effnetv2_l_tf_variables_spec())}
        tf_vars = [(k, np.full(sh, values[k], np.float32))
                   for k, sh in effnetv2_l_tf_variables_spec(interleaved)]
        port = pck.import_tf_vars(tf_vars, templates[0])
        _assert_same(port, jck.import_tf_vars(tf_vars, templates[1]))
        _assert_same(port, imported[2])

    def test_tf_vars_duplicate_and_unconsumed_are_loud(self, templates, imported):
        dup = imported[1][:3] + [imported[1][0]]
        _same_error(lambda: pck.import_tf_vars(dup, templates[0]),
                    lambda: jck.import_tf_vars(dup, templates[1]), ValueError)
        extra = [("m/l1/kernel:0", np.zeros((3, 3, 3, 32), np.float32)),
                 ("m/l1/stray:0", np.zeros((1,), np.float32))]
        _same_error(lambda: pck.import_tf_vars(extra, templates[0]),
                    lambda: jck.import_tf_vars(extra, templates[1]), ValueError)


# ---------------------------------------------------------- torchvision


class TestTorchvisionResnets:
    @pytest.mark.parametrize("depth,stage_sizes,include_fc", [
        (18, (2, 2, 2, 2), True),   # ETH-XGaze trunk shape
        (50, (3, 4, 6, 3), False),  # TRXOS rgb branch (children()[:-1], no fc)
        (50, (3, 4, 6, 3), True),
    ])
    def test_structure_positions_and_order(self, depth, stage_sizes, include_fc):
        from isbfsar_tpu.models.resnet import resnet18 as jr18, resnet50 as jr50
        from isbfsar_tpu_torch.models.resnet import resnet18, resnet50

        spec = torchvision_resnet_state_dict_spec(depth, include_fc=include_fc)
        sd = dict(_materialize(spec))
        imported = pck.import_resnet_torch(sd, stage_sizes=stage_sizes)
        _assert_same(imported, jck.import_resnet_torch(sd, stage_sizes=stage_sizes))

        n_classes = 1000 if include_fc else 0
        model = (resnet18 if depth == 18 else resnet50)(torch.float32, num_classes=n_classes)
        _loads_into(model, imported)
        _assert_all_filled(imported)
        flat_got = _flat(imported["params"])
        assert flat_got[("conv1", "kernel")].flat[0] == _fill_value(spec, "conv1.weight")
        last = f"layer4_{stage_sizes[3] - 1}"
        assert flat_got[(last, "conv1", "kernel")].flat[0] == _fill_value(
            spec, f"layer4.{stage_sizes[3] - 1}.conv1.weight")
        assert flat_got[("layer2_0", "downsample_conv", "kernel")].flat[0] == _fill_value(
            spec, "layer2.0.downsample.0.weight")

        # the order-based fallback on the same net and upstream order
        jax_model = (jr18 if depth == 18 else jr50)(num_classes=n_classes, dtype=jnp.float32)
        port = pck.import_ordered_convnet(sd, pck.template_variables(model))
        _assert_same(port, jck.import_ordered_convnet(
            sd, _definition_order(jax_model, jnp.zeros((1, 64, 64, 3)))))
        _assert_same(port, imported)


# --------------------------------------------------------------- TRXOS


class TestTRXOSCheckpoint:
    @pytest.mark.parametrize("input_type", ["skeleton", "hybrid"])
    def test_full_tree(self, input_type):
        from isbfsar_tpu_torch.configs import ARConfig
        from isbfsar_tpu_torch.models.trx import TRXOS

        seq_len = 16 if input_type == "skeleton" else 8
        spec = trxos_state_dict_spec(input_type=input_type, seq_len=seq_len)
        # DataParallel '.module' segments on the rgb branch (ar.py:17-19)
        sd = {(k.replace("features_extractor.rgb", "features_extractor.rgb.module")
               if "rgb" in k else k): torch.from_numpy(v) for k, v in _materialize(spec)}
        imported = pck.import_trxos_full(sd, input_type=input_type)
        _assert_same(imported, jck.import_trxos_full(sd, input_type=input_type))
        _loads_into(TRXOS(ARConfig(input_type=input_type, seq_len=seq_len)), imported)

        flat_got = _flat(imported["params"])
        assert flat_got[("transformer", "k_linear", "kernel")].flat[0] == _fill_value(
            spec, "transformers.0.k_linear.weight")
        assert flat_got[("discriminator", "fc3", "bias")].flat[0] == _fill_value(
            spec, "discriminator.fc3.bias")
        if input_type == "hybrid":
            assert flat_got[("rgb_extractor", "post", "kernel")].flat[0] == _fill_value(
                spec, "post_resnet.l1.weight")
            assert flat_got[("rgb_extractor", "ResNet_0", "layer3_0", "conv2", "kernel")
                            ].flat[0] == _fill_value(spec, "features_extractor.rgb.6.0.conv2.weight")

    def test_rgb_without_branch_and_bad_child_are_loud(self):
        sd = dict(_materialize(trxos_state_dict_spec("skeleton")))
        _same_error(lambda: pck.import_trxos_full(sd, input_type="rgb"),
                    lambda: jck.import_trxos_full(sd, input_type="rgb"), KeyError)
        bad = {**sd, "features_extractor.rgb.3.weight": np.zeros(1, np.float32)}
        _same_error(lambda: pck.trxos_extract_rgb(bad), lambda: jck.trxos_extract_rgb(bad),
                    KeyError)
        assert pck.trxos_extract_rgb(sd) == jck.trxos_extract_rgb(sd) == {}

    def test_trxos_torch_random_equals_jax(self):
        """tests/test_train.py's random TRXOS state dict, with a DataParallel
        segment on one layer."""
        g = torch.Generator().manual_seed(0)
        shapes = {"features_extractor.sk.fc1": (180, 90), "features_extractor.sk.fc2": (256, 180),
                  "transformers.0.k_linear.module": (128, 512), "transformers.0.v_linear": (128, 512),
                  "discriminator.dimensionality_reduction": (16, 128),
                  "discriminator.fc1": (256, 1920), "discriminator.fc2": (64, 256),
                  "discriminator.fc3": (1, 64)}
        sd = {}
        for name, (o, i) in shapes.items():
            sd[f"{name}.weight"] = torch.randn(o, i, generator=g)
            sd[f"{name}.bias"] = torch.randn(o, generator=g)
        sd["transformers.0.norm_k.weight"] = torch.randn(128, generator=g)
        sd["transformers.0.norm_k.bias"] = torch.randn(128, generator=g)
        _assert_same(pck.import_trxos_torch(sd, "skeleton"), jck.import_trxos_torch(sd, "skeleton"))
        no_disc = {k: v for k, v in sd.items() if not k.startswith("discriminator")}
        out = pck.import_trxos_torch(no_disc, "skeleton")
        assert "discriminator" not in out["params"]
        _assert_same(out, jck.import_trxos_torch(no_disc, "skeleton"))


# -------------------------------------------------------------- helpers


def test_strip_dataparallel_equals_jax():
    sd = {"module.a.weight": 1, "down2.resblock.module_list.0.0.conv.0.weight": 2,
          "x.module.y": 3, "modules.z": 4}
    assert pck.strip_dataparallel(sd) == jck.strip_dataparallel(sd)
    assert "down2.resblock.module_list.0.0.conv.0.weight" in pck.strip_dataparallel(sd)


@pytest.mark.parametrize("renames", [
    {"old_name": "new_name"},
    {"fc1": "dense/fc1", "keep/b": "kept/c"},
    {"post_resnet": "rgb_extractor/post"},
])
def test_rename_params_equals_jax(renames):
    tree = {"old_name": {"fc1": {"kernel": np.ones(2)}, "fc10": {"bias": np.zeros(1)}},
            "keep": {"b": np.zeros(1), "myfc1": np.ones(3)},
            "post_resnet": {"kernel": np.ones((2, 2))}}
    got, want = pck.rename_params(tree, renames), jck.rename_params(tree, renames)
    assert _flat(got).keys() == _flat(want).keys()
    assert list(_flat(got)) == list(_flat(want))
