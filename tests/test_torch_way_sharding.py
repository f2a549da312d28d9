"""The port's way-sharded matcher and multi-stream serving over a process
group of CPU ranks (gloo), against the JAX package's.

Each check starts its ranks with ``parallel/launch.py::run_ranks``; a rank
imports torch and the port only, so the JAX side runs here in the test
process on the same weights (the JAX init, carried to the ranks as numpy
trees) and the same inputs.

Tolerances: the port's 1-device skeleton recognizer against JAX's is held
to probs 2e-5 and is_true 2e-6 (``tests/test_torch_serving.py``'s
``TOL_JAX``, the pose 1e-4 m); the way-sharded and dp-sharded paths read
0.0 against the port's own 1-device results on this CPU (the same
arithmetic on a slice of the classes or streams), so the limits against
JAX stay those. The ranks of one run agree exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.parallel.mesh import make_mesh, make_mesh_2d
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.runtime.source import SyntheticSource
from isbfsar_tpu.serving import MultiStreamPipeline as JaxMultiStream
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.parallel import parity

torch.set_num_threads(2)

TOL = {"probs": 2e-5, "is_true": 2e-6, "pose": 1e-4}
FRAME_SHAPE = (120, 160)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------- the matcher


def _script(seed: int):
    """Train 11 classes, match, add the query as a class, match, remove
    one, match: (script, query window)."""
    rng = np.random.default_rng(seed)
    clip = lambda: rng.normal(size=(16, 90)).astype(np.float32)  # noqa: E731
    window = clip()
    script = [("train", f"class_{i}", clip()) for i in range(11)]
    script += [("match", window), ("train", "exact_match", window.copy()), ("match", window),
               ("remove", "class_0"), ("match", window)]
    return script


def _jax_matches(script, way, params):
    """JAX's recognizer's own frame-by-frame ``inference`` over each match's
    window, after the script's edits."""
    cfg = dataclasses.replace(jc.ARConfig.for_input("skeleton"), way=way)
    ar = JaxRecognizer(cfg, params=params)
    out = []
    for op, *arg in script:
        if op == "train":
            ar.train({"flag": arg[0], "data": {"poses": arg[1]}, "requires_focus": False})
        elif op == "remove":
            ar.remove(arg[0])
        else:
            ar.previous_frames = []
            for frame in arg[0]:
                probs, is_true, _ = ar.inference({"sk": frame})
            out.append((probs, float(is_true)))
    return out


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_way_sharded_matcher_matches_jax(n_ranks):
    """A way=16 support set split over 2 and 4 ranks, through support edits
    (a class added after a match, one removed): every rank's probabilities
    and open-set score equal JAX's recognizer's own ``inference`` on the
    window; each rank embeds way/n classes."""
    way = 16
    params = _numpy(JaxRecognizer(dataclasses.replace(jc.ARConfig.for_input("skeleton"),
                                                      way=way)).params)
    script = _script(n_ranks)
    want = _jax_matches(script, way, params)
    ranks = parity.matcher_over_ranks(script, way, n_ranks, params=params)
    for r in ranks:
        assert r["classes_per_rank"] == way // n_ranks
        assert r["matches"] == ranks[0]["matches"]
        for (probs, ist), (jprobs, jist) in zip(r["matches"], want, strict=True):
            assert set(probs) == set(jprobs)
            for k in jprobs:
                assert abs(probs[k] - jprobs[k]) <= TOL["probs"], (k, probs[k], jprobs[k])
            assert abs(ist - jist) <= TOL["is_true"], (ist, jist)
    (_, _), (probs, _), (last, _) = ranks[0]["matches"]
    assert probs["exact_match"] == max(probs.values())  # the new class is its own query
    assert "class_0" not in last and "exact_match" in last


def test_way_sharding_parity_check():
    """The certificate: a 2n-class support set over n ranks equals the
    recognizer's own frame-by-frame inference (1e-5)."""
    report = parity.way_sharding_parity_check(2)
    assert report["classes_per_device"] == 2
    assert report["max_prob_diff"] <= 1e-5 and report["is_true_diff"] <= 1e-5


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def stream_spec():
    """The JAX CI skeleton pipeline and the spec that builds the port's twin
    in each rank (the JAX init's weights, way 16, five support actions)."""
    hpe_kw = dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.0, compute_dtype="float32")
    jintr = jc.CameraIntrinsics(width=FRAME_SHAPE[1], height=FRAME_SHAPE[0])
    jhpe = JaxEstimator(jc.HPEConfig(**hpe_kw), jintr, backbone_stages=JAX_V2_TINY,
                        frame_shape=FRAME_SHAPE, yolo_width=0.25)
    ar_kw = dict(way=16)
    jar = JaxRecognizer(dataclasses.replace(jc.ARConfig.for_input("skeleton"), **ar_kw))
    rng = np.random.default_rng(0)
    support = [{"flag": f"a{i}", "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
                "requires_focus": False} for i in range(5)]
    for item in support:
        jar.train(item)
    jcfg = jc.PipelineConfig(main=jc.MainConfig(cam_width=160, cam_height=120), intrinsics=jintr,
                             hpe=jc.HPEConfig(**hpe_kw), ar=jar.config, param_dtype="float32")
    jpipe = JaxPipeline(jcfg, hpe=jhpe, ar=jar, with_focus=False)
    spec = {"hpe": _numpy(jhpe.params), "ar": _numpy(jar.params), "support": support,
            "ar_config": dataclasses.replace(tc.ARConfig.for_input("skeleton"), **ar_kw)}
    return jpipe, spec


def _ticks(n_streams, n):
    sources = [SyntheticSource(FRAME_SHAPE[1], FRAME_SHAPE[0]) for _ in range(n_streams)]
    for i, src in enumerate(sources):  # the streams see different phases
        for _ in range(5 * i):
            src.read()
    return [np.stack([src.read()[1] for src in sources]) for _ in range(n)]


def _close(got, want, where):
    for key in ("pose", "probs", "is_true", "pose_ok", "ar_ready", "bbox"):
        tol = TOL.get(key, 0.0)
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=f"{where} {key}")


@pytest.mark.parametrize("layout", ["dp2", "dp2xway2"])
def test_multistream_over_ranks_matches_jax(stream_spec, layout):
    """``MultiStreamPipeline`` with 4 streams over 2 ranks (2 streams each)
    and over a 2x2 mesh whose second axis splits the 16-way support set,
    through the static-buffer step of the graphs: every rank returns all 4
    streams' outputs, equal on every rank, to an eager twin's exactly, and
    to JAX's ``MultiStreamPipeline`` (its flat mesh, and its composed 2x2
    way mesh on virtual devices) for ``step`` and ``stream_batched``."""
    jpipe, spec = stream_spec
    n_streams = 4
    ticks = _ticks(n_streams, 17)
    if layout == "dp2":
        jm = JaxMultiStream(n_streams=n_streams, mesh=make_mesh(2), pipe=jpipe)
        ranks = parity.streams_over_ranks(spec, n_streams, ticks, 2, cuda_graphs=True)
    else:
        jm = JaxMultiStream(n_streams=n_streams, mesh=make_mesh_2d((2, 2)), pipe=jpipe,
                            way_axis="way")
        ranks = parity.streams_over_ranks(spec, n_streams, ticks, 4, mesh_shape=(2, 2),
                                          axes=("dp", "way"), way_axis="way", cuda_graphs=True)
    jm.start()
    want = [jm.step(t) for t in ticks]
    jm.start()
    want_batched = list(jm.stream_batched(iter(ticks), batch_size=2))
    for r, got in enumerate(ranks):
        assert got["streams"][1] - got["streams"][0] == 2
        assert got["support_rows"] == (16 if layout == "dp2" else 8)
        # under the way axis no rank builds the whole set's K/V
        assert got["pipe_support_kv"] == (layout == "dp2")
        for name, ref in (("steps", want), ("batched", want_batched)):
            assert len(got[name]) == len(ref)
            for i, (tick, jtick) in enumerate(zip(got[name], ref)):
                assert len(tick) == n_streams
                for s in range(n_streams):
                    _close(tick[s], jtick[s], f"rank {r} {name} tick {i} stream {s}")
                    for k, v in tick[s].items():
                        np.testing.assert_array_equal(v, ranks[0][name][i][s][k])
        for tick, eager in zip(got["steps"], got["eager_steps"], strict=True):
            for s in range(n_streams):
                for k, v in tick[s].items():
                    np.testing.assert_array_equal(v, eager[s][k], err_msg=f"graphs vs eager {k}")
    assert all(o["ar_ready"] == 1 for o in ranks[0]["steps"][-1])
