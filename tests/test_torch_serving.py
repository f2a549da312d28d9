"""The port's MultiStreamPipeline: twins of tests/test_serving.py's
TestMultiStream, and the JAX MultiStreamPipeline on the same inputs.

On one GPU the stream axis is a batch axis of one step, not a mesh: the
first twin checks that every net sees the S*B frames as one batch and the
state carries a leading S. 120x160 frames, random JAX-initialized weights
at gate 0.0, focus off, float32 on the CPU. Single-stream and multi-stream
steps differ only in the convolutions' batch size (the CPU reads about
1e-6 in pose): held to 1e-5, as tests/test_torch_pipeline.py holds batched
against sequential. Against JAX: tests/test_torch_pipeline.py's ``TOL``
for the random CI sizes (pose 1e-4 m, probs 2e-5).
"""

import jax
import numpy as np
import pytest
import torch

from isbfsar_tpu import configs as jc
from isbfsar_tpu.ar.recognizer import ActionRecognizer as JaxRecognizer
from isbfsar_tpu.hpe.estimator import HumanPoseEstimator as JaxEstimator
from isbfsar_tpu.models.effnetv2 import V2_TINY as JAX_V2_TINY
from isbfsar_tpu.parallel.mesh import make_mesh
from isbfsar_tpu.pipeline import FusedPipeline as JaxPipeline
from isbfsar_tpu.runtime.source import SyntheticSource
from isbfsar_tpu.serving import MultiStreamPipeline as JaxMultiStream
from isbfsar_tpu_torch import configs as tc
from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
from isbfsar_tpu_torch.pipeline import FusedPipeline
from isbfsar_tpu_torch.serving import MultiStreamPipeline

torch.set_num_threads(2)

FRAME_SHAPE = (120, 160)
S = 4
TOL_BATCH = 1e-5
TOL_JAX = {"pose": 1e-4, "probs": 2e-5, "is_true": 2e-6}
FIELDS = ("pose", "probs", "is_true", "pose_ok", "ar_ready", "bbox")


def _close(got, want, atol, where=""):
    for key in FIELDS:
        tol = atol.get(key, 0.0) if isinstance(atol, dict) else atol
        if key in ("pose_ok", "ar_ready", "bbox"):
            tol = 0.0
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=f"{where} {key}")


@pytest.fixture(scope="module")
def stacks():
    """The JAX and the port pipelines on the same random weights, two
    support actions each."""
    hpe_kw = dict(yolo_input_size=128, crop_size=256, yolo_thresh=0.0, compute_dtype="float32")
    jintr = jc.CameraIntrinsics(width=FRAME_SHAPE[1], height=FRAME_SHAPE[0])
    jhpe = JaxEstimator(jc.HPEConfig(**hpe_kw), jintr, backbone_stages=JAX_V2_TINY,
                        frame_shape=FRAME_SHAPE, yolo_width=0.25)
    jar = JaxRecognizer(jc.ARConfig.for_input("skeleton"))
    jcfg = jc.PipelineConfig(main=jc.MainConfig(cam_width=160, cam_height=120), intrinsics=jintr,
                             hpe=jc.HPEConfig(**hpe_kw), param_dtype="float32")
    jpipe = JaxPipeline(jcfg, hpe=jhpe, ar=jar, with_focus=False)

    intr = tc.CameraIntrinsics(width=FRAME_SHAPE[1], height=FRAME_SHAPE[0])
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    hpe = HumanPoseEstimator(tc.HPEConfig(**hpe_kw), intr, params=np_tree(jhpe.params),
                             backbone_stages=V2_TINY, frame_shape=FRAME_SHAPE, yolo_width=0.25,
                             device="cpu")
    ar = ActionRecognizer(tc.ARConfig.for_input("skeleton"), params=np_tree(jar.params),
                          device="cpu")
    cfg = tc.PipelineConfig(main=tc.MainConfig(cam_width=160, cam_height=120), intrinsics=intr,
                            hpe=tc.HPEConfig(**hpe_kw), param_dtype="float32")
    pipe = FusedPipeline(cfg, hpe=hpe, ar=ar, with_focus=False, input_format="bgr", device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        item = {"flag": f"a{i}", "data": {"poses": rng.normal(size=(16, 90)).astype(np.float32)},
                "requires_focus": False}
        jar.train(item)
        ar.train(item)
    return jpipe, pipe


@pytest.fixture(scope="module")
def multi(stacks):
    m = MultiStreamPipeline(n_streams=S, pipe=stacks[1])
    m.start()
    return m


def _ticks(n, seed=0):
    sources = [SyntheticSource(FRAME_SHAPE[1], FRAME_SHAPE[0]) for _ in range(S)]
    for i, src in enumerate(sources):  # the streams see different phases
        for _ in range(5 * i + seed):
            src.read()
    return [np.stack([src.read()[1] for src in sources]) for _ in range(n)]


class TestMultiStream:
    def test_stream_axis_is_one_batch(self, multi):
        """Each (S, B) block is one step: every net runs once on S*B frames,
        and the state has a leading stream axis."""
        assert multi._state.window.shape[0] == S and multi._state.n_valid.shape == (S,)
        assert multi._state.smooth["init"].shape == (S,)
        seen = []
        hooks = [net.register_forward_hook(lambda mod, inp, out: seen.append(inp[0].shape[0]))
                 for net in multi.pipe.hpe.nets.values()]
        try:
            multi.dispatch_batch(np.stack(_ticks(2), axis=1)).numpy()
        finally:
            for h in hooks:
                h.remove()
        assert seen == [2 * S] * 3

    def test_streams_are_independent(self, multi):
        """Stream 0 sees moving frames, the others a constant frame: the
        others agree with one another and differ from stream 0."""
        multi.start()
        src = SyntheticSource(FRAME_SHAPE[1], FRAME_SHAPE[0])
        const = np.zeros(FRAME_SHAPE + (3,), np.uint8)
        for _ in range(3):
            outs = multi.step(np.stack([src.read()[1]] + [const] * (S - 1)))
        assert len(outs) == S
        for i in range(2, S):
            np.testing.assert_array_equal(outs[i]["pose"], outs[1]["pose"])
        assert np.abs(outs[0]["pose"] - outs[1]["pose"]).max() > 1e-4

    def test_matches_single_stream_pipelines(self, multi):
        """Each stream equals a lone FusedPipeline fed that stream's frames."""
        ticks = _ticks(18)
        multi.start()
        outs = [multi.step(t) for t in ticks]
        pipe = multi.pipe
        for s in range(S):
            pipe.start()
            ref = [pipe.step(t[s]) for t in ticks]
            for i, (tick, want) in enumerate(zip(outs, ref)):
                _close(tick[s], want, TOL_BATCH, f"stream {s} tick {i}")
        assert outs[-1][0]["ar_ready"] == 1

    def test_decode_contract(self, multi):
        multi.start()
        outs = multi.step(_ticks(1)[0])
        assert "actions" in multi.decode(outs[0])

    def test_stream_double_buffered_parity(self, multi):
        ticks = _ticks(4)
        multi.start()
        ref = [multi.step(t) for t in ticks]
        multi.start()
        got = list(multi.stream(iter(ticks)))
        assert len(got) == len(ref)
        for g_tick, r_tick in zip(got, ref):
            for g, r in zip(g_tick, r_tick):
                _close(g, r, 0.0)

    def test_stream_batched_parity(self, multi):
        """Two blocks of 2 and a tail tick, against per-tick steps."""
        ticks = _ticks(5)
        multi.start()
        ref = [multi.step(t) for t in ticks]
        multi.start()
        got = list(multi.stream_batched(iter(ticks), batch_size=2))
        assert len(got) == len(ref)
        for g_tick, r_tick in zip(got, ref):
            for g, r in zip(g_tick, r_tick):
                _close(g, r, TOL_BATCH)

    def test_refresh_support_keeps_the_state(self, multi):
        """An edit reaches the streams only through refresh_support(), which
        changes the match target and leaves every stream's state alone."""
        multi.start()
        for t in _ticks(3):
            multi.step(t)
        states = [t.clone() for t in (multi._state.window, multi._state.n_valid,
                                      multi._state.smooth["x"])]
        kv = multi._support_kv[0].clone()
        mask = multi._support_mask.clone()
        multi.pipe.ar.train({"flag": "late", "data": {"poses": np.full((16, 90), 0.3, np.float32)}})
        torch.testing.assert_close(multi._support_kv[0], kv, rtol=0, atol=0)
        multi.refresh_support()
        assert int(multi._support_mask.sum()) == int(mask.sum()) + 1
        assert (multi._support_kv[0] - kv).abs().max() > 1e-6
        for now, before in zip((multi._state.window, multi._state.n_valid,
                                multi._state.smooth["x"]), states):
            torch.testing.assert_close(now, before, rtol=0, atol=0)
        assert len(multi.step(_ticks(1)[0])) == S
        assert multi.pipe.ar.remove("late")
        multi.refresh_support()

    def test_static_buffer_steps_equal_eager(self, stacks):
        """The steps the CUDA graphs replay, run eagerly on the CPU over the
        static buffers, against the plain steps: bit-equal, across a support
        refresh."""
        pipe = stacks[1]
        static_pipe = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, with_focus=False,
                                    input_format="bgr", device="cpu", cuda_graphs=True)
        ticks = _ticks(6)
        runs = []
        for p in (pipe, static_pipe):
            m = MultiStreamPipeline(n_streams=S, pipe=p)
            m.start()
            buffers = [id(m._state.window), id(m._support_kv[0])]
            out = [m.step(t) for t in ticks[:2]]
            out += list(m.stream_batched(iter(ticks[2:6]), batch_size=2))
            m.refresh_support()
            out.append(m.step(ticks[0]))
            runs.append(out)
            assert ([id(m._state.window), id(m._support_kv[0])] == buffers) == p.cuda_graphs
        assert sorted(m._graphs) == [(S, 1), (S, 2)]
        for a, b in zip(*runs):
            for x, y in zip(a, b):
                _close(y, x, 0.0)


def test_pipelines_and_their_graphs_free_without_the_collector(stacks):
    """A pipeline and its multi-stream twin hold their step graphs with no
    reference cycle: they go when their last reference does, graphs and
    static buffers with them (live graphs piling up until a collection
    broke a later capture on the card)."""
    import gc
    import weakref

    pipe = stacks[1]
    static = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, with_focus=False,
                           input_format="bgr", device="cpu", cuda_graphs=True)
    multi = MultiStreamPipeline(n_streams=S, pipe=static)
    multi.start()
    multi.step(_ticks(1)[0])
    static.step(_ticks(1)[0][0])
    refs = [weakref.ref(x) for x in (static, multi, *static._graphs.values(),
                                     *multi._graphs.values())]
    assert len(refs) == 4
    gc.disable()
    try:
        del static, multi
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_matches_the_jax_multistream_pipeline(stacks):
    jpipe, pipe = stacks
    jm = JaxMultiStream(n_streams=S, mesh=make_mesh(S), pipe=jpipe)
    m = MultiStreamPipeline(n_streams=S, pipe=pipe)
    ticks = _ticks(17, seed=2)
    for x in (jm, m):
        x.start()
    for i, t in enumerate(ticks):
        ref, got = jm.step(t), m.step(t)
        for s in range(S):
            _close(got[s], ref[s], TOL_JAX, f"tick {i} stream {s}")
    assert all(o["ar_ready"] == 1 for o in got)
    jm.start()
    m.start()
    ref = list(jm.stream_batched(iter(ticks[:8]), batch_size=4))
    got = list(m.stream_batched(iter(ticks[:8]), batch_size=4))
    for i, (g_tick, r_tick) in enumerate(zip(got, ref, strict=True)):
        for s in range(S):
            _close(g_tick[s], r_tick[s], TOL_JAX, f"batched tick {i} stream {s}")
