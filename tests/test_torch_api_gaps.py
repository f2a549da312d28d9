"""The small public names of the JAX package that the port now carries too:
the ops re-exports, ``ar.ActionRecognizer``, ``hpe.HumanPoseEstimator``,
``models.V2_S``, ``one_euro_init``, ``n_tuples``, ``SkeletonSpec.n_joints``,
``MainConfig.cam`` and ``HPEConfig.checkpoint_dir``, each against the JAX
name."""

import dataclasses

import numpy as np
import pytest
import torch

import isbfsar_tpu.ops as jops
from isbfsar_tpu import configs as jc
from isbfsar_tpu.models import effnetv2 as jeff
from isbfsar_tpu.ops import smooth as jsmooth
from isbfsar_tpu.ops import tuples as jtuples
from isbfsar_tpu.utils import skeleton as jskel
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.models import effnetv2 as teff
from isbfsar_tpu_torch.ops import smooth as tsmooth
from isbfsar_tpu_torch.ops import tuples as ttuples
from isbfsar_tpu_torch.utils import skeleton as tskel

JAX_OPS = sorted(n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n)))


def test_the_jax_ops_exports_are_26():
    assert len(JAX_OPS) == 26


@pytest.mark.parametrize("name", JAX_OPS)
def test_ops_reexports_the_jax_name(name):
    import isbfsar_tpu_torch.ops as tops

    fn = getattr(tops, name)
    assert callable(fn) and fn.__module__.startswith("isbfsar_tpu_torch.ops.")


def test_package_reexports():
    import isbfsar_tpu_torch.ar as tar
    import isbfsar_tpu_torch.hpe as thpe
    import isbfsar_tpu_torch.models as tmodels
    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator

    assert tar.ActionRecognizer is ActionRecognizer
    assert thpe.HumanPoseEstimator is HumanPoseEstimator
    assert tmodels.V2_S is teff.V2_S


def test_v2_s_is_jax_v2_s():
    assert [dataclasses.astuple(s) for s in teff.V2_S] == [dataclasses.astuple(s)
                                                          for s in jeff.V2_S]


def test_one_euro_init_is_jax():
    x0 = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float64)
    want = jsmooth.one_euro_init(x0)
    got = tsmooth.one_euro_init(x0)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the state steps like JAX's
    x1 = x0 + 0.1
    want_state, want_hat = jsmooth.one_euro_step(want, x1)
    got_state, got_hat = tsmooth.one_euro_step(got, torch.as_tensor(x1, dtype=torch.float32))
    np.testing.assert_allclose(got_hat.numpy(), np.asarray(want_hat), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seq_len,set_size", [(16, 2), (8, 2), (16, 3), (2, 2)])
def test_n_tuples_is_jax(seq_len, set_size):
    assert ttuples.n_tuples(seq_len, set_size) == jtuples.n_tuples(seq_len, set_size)


def test_skeleton_n_joints_is_jax():
    want = jskel.load_registry()
    got = tskel.load_registry()
    assert set(got) == set(want)
    for name in want:
        assert got[name].n_joints == want[name].n_joints == len(got[name].indices)


def test_config_fields_are_jax():
    """MainConfig and HPEConfig carry every JAX field, in order, with JAX's
    defaults for the two added ones."""
    for jcls, tcls in ((jc.MainConfig, tc.MainConfig), (jc.HPEConfig, tc.HPEConfig)):
        assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in
                                                            dataclasses.fields(jcls)]
    assert tc.MainConfig().cam == jc.MainConfig().cam == "synthetic"
    assert tc.HPEConfig().checkpoint_dir is jc.HPEConfig().checkpoint_dir is None
    assert tc.MainConfig.for_input("rgb").cam == "synthetic"
