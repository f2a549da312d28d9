"""The port's runtime visualizers (``runtime/visualizer.py``) against JAX's on
the same elements: ``ConsoleVisualizer`` output string-equal, the
``ElementsRecorder`` trace value-equal, ``GUIVisualizer.render`` pixel-equal
under Agg on the cases of tests/test_gui.py (with and without a person, the
focus colours, a calibrated threshold), the keyboard's command stream
equal, and ``get_color`` / ``score_bar`` equal. Tolerance: none, every
comparison is exact. Also: the elements the port's ``Orchestrator`` emits
reach the visualizers as numpy arrays and Python values, never tensors."""

import io

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

from isbfsar_tpu.runtime import visualizer as jv  # noqa: E402
from isbfsar_tpu_torch.runtime import visualizer as tv  # noqa: E402

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
ELEMENTS = {
    "fps": 22.1,
    "distance": 1.5,
    "focus": True,
    "actions": {"wave": 0.8, "point": 0.2},
    "is_true": 0.7,
    "requires_focus": {"wave": True, "point": False},
    "img": RNG.integers(0, 255, (480, 640, 3)).astype(np.uint8),
    "bbox": (100, 300, 50, 400),
    "face_bbox": np.asarray([150, 80, 250, 200]),
    "pose": np.random.default_rng(1).normal(0, 0.2, (30, 3)),
    "edges": np.stack([np.arange(29), np.arange(1, 30)], 1),
    "log": "Action wave learned successfully!",
}
NO_PERSON = {"fps": 1.0, "img": ELEMENTS["img"], "actions": {}}
FOCUS_OFF = dict(fps=1.0, img=np.zeros((480, 640, 3), np.uint8), actions={},
                 bbox=(60, 560, 40, 440), face_bbox=np.asarray([200, 100, 400, 300]),
                 focus=False)
STREAM = [
    ELEMENTS,
    NO_PERSON,
    FOCUS_OFF,
    dict(FOCUS_OFF, focus=True),
    dict(ELEMENTS, actions={"wave": 0.1, "point": 0.9}, distance=2.9, focus=False,
         pose=ELEMENTS["pose"] + 0.4, log="Classes saved!"),
    dict(ELEMENTS, is_true=0.5),
    dict(ELEMENTS, is_true=0.9, requires_focus={}),
    {"fps": 3.0, "actions": {"a": 0.5}, "is_true": 0.3},
]


class _Key:
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("value", [-0.5, 0.0, 0.1, 0.329, 0.33, 0.5, 0.66, 0.9, 1.0, 1.7])
def test_get_color_and_score_bar(value):
    assert tv.get_color(value) == jv.get_color(value)
    for width in (10, 20):
        assert tv.score_bar(value, width) == jv.score_bar(value, width)


def test_console_output_string_equal():
    out_t, out_j = io.StringIO(), io.StringIO()
    con_t, con_j = tv.ConsoleVisualizer(out_t), jv.ConsoleVisualizer(out_j)
    for el in STREAM:
        con_t.show(el)
        con_j.show(el)
    assert out_t.getvalue() == out_j.getvalue()
    assert "  log: Classes saved!" in out_t.getvalue()


def test_recorder_npz_value_equal(tmp_path):
    rec_t = tv.ElementsRecorder(str(tmp_path / "t.npz"))
    rec_j = jv.ElementsRecorder(str(tmp_path / "j.npz"))
    for el in STREAM:
        rec_t.show(el)
        rec_j.show(el)
    rec_t.flush()
    rec_j.flush()
    a = np.load(tmp_path / "t.npz", allow_pickle=True)["frames"]
    b = np.load(tmp_path / "j.npz", allow_pickle=True)["frames"]
    assert len(a) == len(b) == len(STREAM)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            if isinstance(fb[k], dict):
                assert fa[k] == fb[k]
            else:
                np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]))


@pytest.mark.parametrize("threshold", [0.66, 0.26])
def test_gui_render_pixel_equal(threshold):
    """The whole stream through one panel of each package: every frame's
    pixels equal (the blit background is re-captured on the same frames)."""
    gui_t = tv.GUIVisualizer(backend="Agg", os_threshold=threshold)
    gui_j = jv.GUIVisualizer(backend="Agg", os_threshold=threshold)
    for i, el in enumerate(STREAM):
        a, b = gui_t.render(el), gui_j.render(el)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.array_equal(a, b), f"frame {i}: {np.abs(a.astype(int) - b.astype(int)).max()}"
    labels = {r["label"].get_text(): r["label"].get_color() for r in gui_t._art["rows"]}
    assert labels == {r["label"].get_text(): r["label"].get_color() for r in gui_j._art["rows"]}


def test_gui_calibrated_threshold_changes_accept():
    """As tests/test_gui.py: is_true 0.4 is rejected at 0.66, accepted at 0.26."""
    def best_label_color(vis):
        vis.render(dict(ELEMENTS, is_true=0.4))
        labels = {r["label"].get_text(): r["label"] for r in vis._art["rows"]}
        return labels["wave"].get_color()

    assert best_label_color(tv.GUIVisualizer(backend="Agg")) == "white"
    assert best_label_color(tv.GUIVisualizer(backend="Agg", os_threshold=0.26)) != "white"


def test_gui_key_commands_equal():
    keys = list("add") + ["space", "x", "backspace", "w", "enter", "\\", "`", "shift",
                          "enter", "escape"] + list("save") + ["enter"]
    gui_t = tv.GUIVisualizer(backend="Agg")
    gui_j = jv.GUIVisualizer(backend="Agg")
    states = []
    for gui in (gui_t, gui_j):
        trace = []
        for k in keys:
            gui._on_key(_Key(k))
            trace.append((gui.input_text, gui.show_enabled, gui.show_os))
        cmds = gui.commands()
        trace.append([next(cmds) for _ in range(5)])
        trace.append(gui.poll())
        states.append(trace)
    assert states[0] == states[1]
    assert states[0][-2] == ["add w", "", "quit", "save", ""]


def _host_values(x, where="elements"):
    if isinstance(x, torch.Tensor):
        raise AssertionError(f"{where} is a torch tensor")
    if isinstance(x, dict):
        for k, v in x.items():
            _host_values(v, f"{where}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _host_values(v, f"{where}[{i}]")
    else:
        assert x is None or isinstance(x, (np.ndarray, np.generic, int, float, bool, str)), (
            f"{where}: {type(x)}")


def test_orchestrator_elements_reach_visualizers_as_host_values():
    """The port's fused orchestrator (CI operating point, focus on, a learned
    action) emits numpy and Python values, which the console, the recorder
    and the GUI take."""
    from isbfsar_tpu_torch.profile_slice import build_ci, ci_frames
    from isbfsar_tpu_torch.ops.image import i420_to_bgr
    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

    pipe = build_ci("cpu")
    orch = Orchestrator(pipe.config, fused=pipe, fused_overlap=False)
    frames = [torch.round(i420_to_bgr(torch.from_numpy(f), 240)).to(torch.uint8).numpy()
              for f in ci_frames(18, faces=True)]
    shown = [orch.get_frame(img=f, log="x" if i == 0 else None) for i, f in enumerate(frames)]
    assert any(e.get("actions") for e in shown) and any("pose" in e for e in shown)
    assert any("face_bbox" in e for e in shown)
    out = io.StringIO()
    con, gui = tv.ConsoleVisualizer(out), tv.GUIVisualizer(backend="Agg")
    for el in shown:
        _host_values(el)
        con.show(el)
    assert gui.render(shown[-1]).shape[2] == 3
    assert out.getvalue().count("fps") == len(shown)
