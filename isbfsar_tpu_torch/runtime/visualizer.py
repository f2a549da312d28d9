"""Runtime observability frontends for the per-frame ``elements`` stream
(port of ``isbfsar_tpu/runtime/visualizer.py``).

The reference renders a VisPy 2x2 GUI — 3D skeleton, action score bars with
few-shot coloring, open-set bar, focus "eye", FPS, distance, camera image +
bboxes, keyboard console (reference utils/output.py:8-280) — plus a
matplotlib 3D pose debugger (utils/matplotlib_visualizer.py:5-58). This
module provides the headless equivalents:

- :class:`ConsoleVisualizer` — renders each elements dict as a status line
  + score bars on the terminal (the observability contract: actions,
  open-set score, focus flag, FPS, distance, log).
- :class:`MPLPosePrinter` — matplotlib 3D skeleton viewer with the
  reference's print_pose/clear/sleep/save API.
- :class:`ElementsRecorder` — appends the stream to disk (npz) for offline
  inspection and benches.
- :class:`GUIVisualizer` — the interactive 2x2 panel.

The elements come from the port's ``Orchestrator`` as numpy arrays and
Python numbers (``FusedPipeline.decode`` copies them to the host), so
nothing here touches torch. ``ConsoleVisualizer``, ``ElementsRecorder``,
``score_bar`` and ``get_color`` need numpy only; ``MPLPosePrinter`` and
``GUIVisualizer`` import matplotlib when built (the card machine has none:
there they raise ``ImportError``), and ``GUIVisualizer.render`` uses cv2
where it is installed, as the reference does.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np


def score_bar(value: float, width: int = 20) -> str:
    filled = int(max(0.0, min(1.0, value)) * width)
    return "#" * filled + "-" * (width - filled)


class ConsoleVisualizer:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def show(self, elements: Dict[str, Any]) -> None:
        lines: List[str] = []
        fps = elements.get("fps", 0.0)
        dist = elements.get("distance")
        focus = elements.get("focus")
        head = f"fps {fps:5.1f}"
        if dist is not None:
            head += f" | dist {dist:4.2f}m"
        if focus is not None:
            head += f" | focus {'YES' if focus else 'no '}"
        if "is_true" in elements:
            head += f" | open-set [{score_bar(float(elements['is_true']), 10)}]"
        lines.append(head)
        for name, score in (elements.get("actions") or {}).items():
            req = (elements.get("requires_focus") or {}).get(name, False)
            lines.append(f"  {name:<16} [{score_bar(score)}] {score:4.2f}{' (focus)' if req else ''}")
        if elements.get("log"):
            lines.append(f"  log: {elements['log']}")
        print("\n".join(lines), file=self.stream, flush=True)


class MPLPosePrinter:
    """3D skeleton viewer (reference utils/matplotlib_visualizer.py API)."""

    def __init__(self, interactive: bool = True):
        import matplotlib

        if not os.environ.get("DISPLAY"):
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig = plt.figure()
        self.ax = self.fig.add_subplot(projection="3d")
        if interactive and os.environ.get("DISPLAY"):
            plt.ion()
            plt.show()

    def print_pose(self, pose: np.ndarray, edges: Optional[np.ndarray], color: str = "b") -> None:
        pose = np.asarray(pose).reshape(-1, 3)
        self.ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], c=color, s=8)
        if edges is not None:
            for a, b in np.asarray(edges):
                self.ax.plot(
                    [pose[a, 0], pose[b, 0]],
                    [pose[a, 1], pose[b, 1]],
                    [pose[a, 2], pose[b, 2]],
                    c=color,
                )
        lim = np.abs(pose).max() + 1e-3
        self.ax.set_xlim(-lim, lim)
        self.ax.set_ylim(-lim, lim)
        self.ax.set_zlim(-lim, lim)

    def clear(self) -> None:
        self.ax.cla()

    def sleep(self, t: float) -> None:
        self.plt.pause(t) if os.environ.get("DISPLAY") else time.sleep(t)

    def save(self, path: str) -> None:
        self.fig.savefig(path)


class ElementsRecorder:
    """Append the elements stream to an .npz trace for offline analysis."""

    def __init__(self, path: str):
        self.path = path
        self.frames: List[Dict[str, Any]] = []

    def show(self, elements: Dict[str, Any]) -> None:
        keep = {
            k: v
            for k, v in elements.items()
            if k in ("pose", "bbox", "actions", "is_true", "focus", "fps", "distance", "log")
        }
        self.frames.append(keep)

    def flush(self) -> None:
        np.savez_compressed(self.path, frames=np.asarray(self.frames, dtype=object))


def get_color(value: float) -> str:
    """Score -> traffic-light color (reference utils/output.py:8-15)."""
    if value < 0.33:
        return "red"
    if value < 0.66:
        return "orange"
    return "green"


class GUIVisualizer:
    """Interactive 2x2 GUI panel (reference VISPYVisualizer, utils/output.py:8-280).

    Matplotlib-backed (vispy is not a dependency of this rebuild):

    - top-left: 3D skeleton, drawn as a fixed oblique projection through
      ONE LineCollection (the reference's vispy scene is likewise a fixed
      GL camera over a line batch, utils/output.py:153-179; mplot3d's
      per-frame projection machinery keeps a panel under frame rate)
    - top-right: info — distance, FOCUS flag, FPS, per-action score bars
      with traffic-light coloring, the focus "eye" marker for actions that
      require focus, and the open-set bar next to the winning action
    - bottom-left: camera image + person bbox (blue) + face bbox
      (green when in focus, red otherwise)
    - bottom-right: command help + typed input line + log line

    Frame-rate design: every animated artist is
    created ONCE (``animated=True``) and updated in place; the static
    chrome (axes, headers, help text) is drawn once into a cached Agg
    background, and each frame restores the background, draws only the
    animated artists and blits.

    Keyboard console semantics match the reference printer
    (utils/output.py:20-34): printable keys append, backspace deletes,
    Enter submits the command (exposed via :meth:`commands` for
    ``run_source(..., command_stream=gui.commands())``), '\\' toggles
    rendering, '`' toggles the open-set bar.

    Headless tests use ``backend="Agg"`` + :meth:`render` (offscreen RGB).
    """

    MAX_ACTION_ROWS = 8  # visible score-bar slots (reference panel scale)

    HELP = [
        "ADD ACTION: add action_name [-focus]",
        "SAVE: save",
        "LOAD: load",
        "DEBUG: debug",
        "REMOVE ACTION: remove action_name",
    ]

    def __init__(self, backend: Optional[str] = None, figsize=(12, 6),
                 os_threshold: float = 0.66):
        import matplotlib

        if backend:
            matplotlib.use(backend, force=True)
        import matplotlib.pyplot as plt

        # open-set accept gate for the green action label (reference
        # utils/output.py:252-258 value 0.66; ARConfig.os_threshold /
        # calibrate_os_threshold supply a calibrated one)
        self.os_threshold = float(os_threshold)
        self._plt = plt
        self.show_enabled = True
        self.show_os = True
        self.input_text = ">"
        self.log_text = ""
        self._pending: List[str] = []

        self.fig = plt.figure(figsize=figsize)
        self.fig.patch.set_facecolor("black")
        # 2x2 panel; the skeleton panel is a plain axes fed a fixed oblique
        # projection (see class docstring)
        self.ax3d = self.fig.add_subplot(2, 2, 1)
        self.ax_info = self.fig.add_subplot(2, 2, 2)
        self.ax_img = self.fig.add_subplot(2, 2, 3)
        self.ax_cmd = self.fig.add_subplot(2, 2, 4)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._interactive = backend is None or "agg" not in str(backend).lower()
        if self._interactive:
            # map the window NOW: modern backends create figure windows
            # hidden until manager.show(), and the per-frame pump below is
            # flush_events (which only services an already-shown window) —
            # without this the GUI never appears
            try:
                self.fig.show()
            except Exception:
                self._interactive = False  # no display after all
        self._art: Optional[Dict[str, Any]] = None  # persistent animated artists
        self._bg = None  # cached static background (blit base)
        self._bg_size = None
        self._bg_content = None  # _bg_key() of the cached background

    # ------------------------------------------------------------ keyboard

    def _on_key(self, event) -> None:
        """Reference printer() contract (utils/output.py:20-34)."""
        key = event.key
        if key == "backspace":
            if len(self.input_text) > 1:
                self.input_text = self.input_text[:-1]
            self.log_text = ""
        elif key == "enter":
            self._pending.append(self.input_text[1:])  # do not send '>'
            self.input_text = ">"
            self.log_text = ""
        elif key == "\\":
            self.show_enabled = not self.show_enabled
        elif key == "`":
            self.show_os = not self.show_os
        elif key == "escape":
            self._pending.append("quit")
        elif key is not None and len(key) == 1:
            self.input_text += key
        elif key == "space":
            self.input_text += " "

    def poll(self) -> Optional[str]:
        """Pop one pending typed command, or None. The non-generator
        surface for consumers with their own loop."""
        return self._pending.pop(0) if self._pending else None

    def commands(self):
        """Per-frame poll generator for ``run_source(command_stream=...)``:
        yields one pending typed command per ``next()``, '' when none.

        CONTRACT: this is an infinite generator paced by its CONSUMER —
        ``run_source`` draws exactly one item per captured frame. Do not
        iterate it in a bare ``for`` loop (it never terminates and spins);
        use :meth:`poll` for event-style consumption.
        """
        while True:
            cmd = self.poll()
            yield cmd if cmd is not None else ""

    # ------------------------------------------------------------ rendering

    def show(self, elements: Dict[str, Any]) -> None:
        if self.show_enabled:
            self._render_frame(elements)
        if self._interactive:
            # ALWAYS pump the GUI event loop — this is the only pump in the
            # run_source loop, so skipping it while rendering is toggled
            # off ('\\') would freeze the window and eat every later
            # keystroke, including the one to re-enable.
            # flush_events, NOT plt.pause: pause draw_idles the stale
            # figure, and that full redraw EXCLUDES animated artists —
            # wiping the blit we just painted. The
            # interactive backends (TkAgg/QtAgg/macosx) all implement
            # flush_events; the FigureCanvasBase fallback is a silent
            # no-op, acceptable for exotic canvases (the window was mapped
            # by fig.show() in __init__ either way).
            self.fig.canvas.flush_events()

    def render(self, elements: Dict[str, Any]) -> np.ndarray:
        """Offscreen render -> (h, w, 3) uint8 RGB (for tests / recording)."""
        self._render_frame(elements)
        buf = np.asarray(self.fig.canvas.buffer_rgba())
        try:
            import cv2

            return cv2.cvtColor(buf, cv2.COLOR_RGBA2RGB)  # SIMD strided copy
        except ImportError:
            return buf[..., :3].copy()

    def _style_axis(self, ax) -> None:
        ax.set_facecolor("black")
        ax.set_xticks([])
        ax.set_yticks([])
        for s in ax.spines.values():
            s.set_color("gray")

    # --------------------------------------------------- persistent artists

    def _build_artists(self) -> Dict[str, Any]:
        """Create every animated artist ONCE; static chrome stays on the
        axes and lands in the cached blit background."""
        from matplotlib.collections import LineCollection
        from matplotlib.patches import Rectangle as _Rect

        art: Dict[str, Any] = {}
        anim = dict(animated=True)

        # --- skeleton panel (static frame + one animated line batch)
        ax = self.ax3d
        self._style_axis(ax)
        ax.set_xlim(-1.2, 1.2)
        ax.set_ylim(-1.4, 1.0)
        art["bones"] = ax.add_collection(
            LineCollection([], colors="purple", linewidths=2, **anim)
        )
        (art["joints"],) = ax.plot([], [], "o", color="violet", markersize=3, **anim)

        # --- info panel
        ax = self.ax_info
        self._style_axis(ax)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        # static column headers
        ax.text(7 / 16, 0.78, "rf", color="white", ha="center", fontsize=8)
        ax.text(5 / 8, 0.78, "fs score", color="white", ha="center", fontsize=8)
        ax.text(7 / 8, 0.78, "os score", color="white", ha="center", fontsize=8)
        art["dist"] = ax.text(0.25, 0.9, "DIST:", color="white", ha="center", **anim)
        art["focus"] = ax.text(0.5, 0.9, "NOT FOC.", color="red", ha="center", **anim)
        art["fps"] = ax.text(0.75, 0.9, "FPS:", color="white", ha="center", **anim)
        rows = []
        for i in range(self.MAX_ACTION_ROWS):
            y = 0.6 - 0.1 * i
            # labels are ANIMATED (redrawn per blit): their color is the
            # accept-state cue, which can legitimately flip every frame as
            # is_true hovers around the threshold — keying the cached
            # background on it would force a full canvas.draw() on every
            # flicker, exactly when actions are displayed. Drawing ≤5 short
            # texts per frame is far cheaper than one background recapture.
            label = ax.text(3 / 16, y, "", color="white", ha="center",
                            va="center", **anim)
            rf = _Rect((7 / 16 - 0.025, y - 0.03), 0.05, 0.06, color="red", **anim)
            fs = _Rect((0.5, y - 0.03), 0.0, 0.06, color="red", **anim)
            osb = _Rect((0.75, y - 0.03), 0.0, 0.06, color="red", **anim)
            for p in (rf, fs, osb):
                ax.add_patch(p)
                p.set_visible(False)
            rows.append({"label": label, "rf": rf, "fs": fs, "os": osb})
        art["rows"] = rows

        # --- camera panel (image artist created on first frame: needs shape)
        self._style_axis(self.ax_img)
        art["image"] = None

        # --- command console
        ax = self.ax_cmd
        self._style_axis(ax)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        for i, line in enumerate(self.HELP):
            ax.text(0.05, 0.9 - 0.1 * i, line, color="white", fontsize=9, ha="left")
        # input/log are background-dynamic too (change on keystrokes/events,
        # not per frame)
        art["input"] = ax.text(0.05, 0.3, self.input_text, color="violet",
                               fontsize=11, ha="left")
        art["log"] = ax.text(0.05, 0.2, "", color="orange", fontsize=11,
                             ha="left")
        return art

    @staticmethod
    def _project(pose: np.ndarray) -> np.ndarray:
        """Fixed oblique projection, camera frame -> panel coords:
        x right, -y up, depth (z) foreshortened onto both axes (the
        reference's fixed vispy camera, output.py:172-177)."""
        z = pose[:, 2] - np.median(pose[:, 2])
        return np.stack([pose[:, 0] + 0.35 * z, -pose[:, 1] - 0.18 * z], axis=1)

    def _update_artists(self, elements: Dict[str, Any]) -> None:
        if "log" in elements:
            self.log_text = str(elements["log"])
        art = self._art

        # skeleton
        pose = elements.get("pose")
        edges = elements.get("edges")
        if pose is not None and edges is not None:
            p2 = self._project(np.asarray(pose, np.float32))
            e = np.asarray(edges, int)
            art["bones"].set_segments(p2[e])
            art["joints"].set_data(p2[:, 0], p2[:, 1])
        else:
            art["bones"].set_segments([])
            art["joints"].set_data([], [])

        # info
        dist = elements.get("distance")
        focus = elements.get("focus")
        art["dist"].set_text(f"DIST: {dist:.2f}m" if dist is not None else "DIST:")
        art["focus"].set_text("FOCUS" if focus else "NOT FOC.")
        art["focus"].set_color("green" if focus else "red")
        art["fps"].set_text(f"FPS: {elements.get('fps', 0.0):.2f}")

        actions = elements.get("actions") or {}
        requires_focus = elements.get("requires_focus") or {}
        is_true = float(elements.get("is_true", 0.0))
        best = max(actions.values()) if actions else None
        items = list(actions.items())[: self.MAX_ACTION_ROWS]
        for i, row in enumerate(art["rows"]):
            if i >= len(items):
                row["label"].set_text("")
                for p in (row["rf"], row["fs"], row["os"]):
                    p.set_visible(False)
                continue
            name, score = items[i]
            # action label: green when accepted by the open-set head (and
            # focus, if required) — reference output.py:252-258
            label_color = "white"
            if score == best and is_true > self.os_threshold:
                if requires_focus.get(name, False):
                    label_color = "green" if focus else "orange"
                else:
                    label_color = "green"
            row["label"].set_text(name)
            row["label"].set_color(label_color)
            row["rf"].set_visible(bool(requires_focus.get(name, False)))
            row["rf"].set_color("green" if focus else "red")
            row["fs"].set_visible(True)
            row["fs"].set_width(max(0.0, min(1.0, score)) * 0.25)
            row["fs"].set_color(get_color(score))
            show_os = score == best and self.show_os
            row["os"].set_visible(show_os)
            if show_os:
                row["os"].set_width(max(0.0, min(1.0, is_true)) * 0.25)
                row["os"].set_color(get_color(is_true))

        # camera image + bboxes (rects burned into the pixel array — cheap,
        # and keeps the animated-artist set fixed)
        img = elements.get("img")
        if img is not None:
            img = np.asarray(img)
            try:
                import cv2

                # Downscale to the PANEL's pixel budget first: Agg's
                # image resample is the single most expensive artist —
                # shrinking with cv2 (SIMD) before the draw cuts the
                # panel's cost ~4x at 480p with no visible difference.
                bb = self.ax_img.get_window_extent()
                pw, ph = max(int(bb.width), 16), max(int(bb.height), 16)
                sx = sy = 1.0
                if img.shape[1] > pw or img.shape[0] > ph:
                    # ONE scale factor (fit-inside): stretching to the
                    # panel box would distort the aspect ratio imshow's
                    # equal-aspect letterboxing previously preserved
                    s = min(pw / img.shape[1], ph / img.shape[0])
                    sx = sy = s
                    img = cv2.resize(
                        img,
                        (max(int(img.shape[1] * s), 1), max(int(img.shape[0] * s), 1)),
                        interpolation=cv2.INTER_AREA,
                    )
                else:
                    img = img.copy()
                # colors are BGR here — the display conversion below swaps
                # channels, so "red" must be written (0, 0, 255)
                if elements.get("bbox") is not None:
                    x1, x2, y1, y2 = (int(v) for v in elements["bbox"])
                    cv2.rectangle(img, (int(x1 * sx), int(y1 * sy)),
                                  (int(x2 * sx), int(y2 * sy)), (255, 0, 0), 2)
                if elements.get("face_bbox") is not None:
                    x1, y1, x2, y2 = (int(v) for v in np.asarray(elements["face_bbox"]).reshape(-1))
                    color = (0, 255, 0) if focus else (0, 0, 255)
                    cv2.rectangle(img, (int(x1 * sx), int(y1 * sy)),
                                  (int(x2 * sx), int(y2 * sy)), color, 2)
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            except ImportError:
                img = np.ascontiguousarray(img[..., ::-1])
            if art["image"] is None or art["image"].get_array().shape != img.shape:
                if art["image"] is not None:
                    art["image"].remove()
                art["image"] = self.ax_img.imshow(
                    img, animated=True, interpolation="nearest"
                )
            else:
                art["image"].set_data(img)

        art["input"].set_text(self.input_text)
        art["log"].set_text(self.log_text)

    def _dynamic_artists(self):
        """Foreground (animated=True) artists redrawn every frame. Input /
        log texts are background-dynamic — see _render_frame."""
        art = self._art
        out = [art["bones"], art["joints"], art["dist"], art["focus"], art["fps"]]
        for row in art["rows"]:
            out += [row["label"], row["rf"], row["fs"], row["os"]]
        if art["image"] is not None:
            out.append(art["image"])
        return out

    def _bg_key(self):
        """Content signature of the background-dynamic artists: when it
        moves, the cached background is re-captured (one full draw).
        Action-row labels are NOT here — they are animated artists (their
        accept-state color can flip per frame)."""
        return (self.input_text, self.log_text)

    def _render_frame(self, elements: Dict[str, Any]) -> None:
        """Update artists; restore the cached background (static chrome +
        rarely-changing texts), draw only the per-frame artists, blit.
        Falls back to a full draw on canvases without Agg blit support."""
        canvas = self.fig.canvas
        if self._art is None:
            self._art = self._build_artists()
        self._update_artists(elements)

        blit_ok = hasattr(canvas, "copy_from_bbox") and hasattr(canvas, "restore_region")
        if not blit_ok:
            for a in self._dynamic_artists():
                a.set_animated(False)
            canvas.draw()
            return
        size = canvas.get_width_height()
        key = self._bg_key()
        if self._bg is None or self._bg_size != size or self._bg_content != key:
            canvas.draw()  # static chrome + bg-dynamic (animated excluded)
            self._bg = canvas.copy_from_bbox(self.fig.bbox)
            self._bg_size = size
            self._bg_content = key
        canvas.restore_region(self._bg)
        for a in self._dynamic_artists():
            # empty Text artists still pay full layout in draw — skip them
            if a.get_visible() and getattr(a, "get_text", lambda: "x")() != "":
                a.axes.draw_artist(a)
        canvas.blit(self.fig.bbox)
