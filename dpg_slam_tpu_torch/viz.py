"""Visualization export — replaces the reference's amrl/rviz plumbing.

The port's copy of dpg_slam_tpu/viz.py, drawing the port's engine
(its host-array queries: map_points, trajectory, odom_trajectory,
map_layers). matplotlib is imported only inside the render calls; where
it is not installed they raise ImportError naming it.

The reference publishes VisualizationMsg point/line layers with fixed
colors and ±25 m offsets for the active/dynamic maps
(src/visualization/visualization.cc, dpg_slam_main.cc:117-159). Here
visualization is an EXPORT, not a middleware layer: matplotlib figures
(PNG) and plain dict/npz dumps a notebook or viewer can consume.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "render_session",
    "export_layers",
    "Color4f",
    "Canvas",
    "trajectory_ticks",
    "draw_session",
]

# Layer colors follow the reference's scheme (dpg_slam_main.cc:139-156):
# grey full map; active static blue-ish; added green; removed red.
_COLORS = {
    "map": "#888888",
    "trajectory": "#1f77b4",
    "odometry": "#ff7f0e",
    "active_static": "#17becf",
    "active_added": "#2ca02c",
    "dynamic_added": "#98df8a",
    "dynamic_removed": "#d62728",
}


@dataclasses.dataclass(frozen=True)
class Color4f:
    """RGBA color in [0, 1] (gui_helpers.h:38-54 analog), with the same
    named constants the reference exposes."""

    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 1.0

    def to_hex(self) -> str:
        return "#%02x%02x%02x%02x" % tuple(
            int(round(255 * max(0.0, min(1.0, c)))) for c in (self.r, self.g, self.b, self.a)
        )

    @classmethod
    def from_hex(cls, h: str, alpha: float = 1.0) -> "Color4f":
        h = h.lstrip("#")
        r, g, b = (int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4))
        a = int(h[6:8], 16) / 255.0 if len(h) >= 8 else alpha
        return cls(r, g, b, a)


# gui_helpers.h kColor* constants.
Color4f.WHITE = Color4f(1, 1, 1, 1)
Color4f.BLACK = Color4f(0, 0, 0, 1)
Color4f.RED = Color4f(1, 0, 0, 1)
Color4f.GREEN = Color4f(0, 1, 0, 1)
Color4f.BLUE = Color4f(0, 0, 1, 1)
Color4f.YELLOW = Color4f(1, 1, 0, 1)
Color4f.CYAN = Color4f(0, 1, 1, 1)
Color4f.MAGENTA = Color4f(1, 0, 1, 1)


class Canvas:
    """Accumulating drawing surface — the VisualizationMsg analog.

    Replaces the amrl visualization helpers (visualization.cc:65-140:
    NewVisualizationMessage / DrawPoint / DrawLine / DrawCross / DrawArc /
    DrawParticle / DrawPathOption) with a host-side primitive buffer that
    renders to matplotlib or serializes to plain arrays. The reference
    publishes these as ROS messages; here the "publish" is a PNG or an
    npz-able dict.
    """

    def __init__(self, frame: str = "map"):
        self.frame = frame
        self.clear()

    # -- message lifecycle (NewVisualizationMessage / ClearVisualizationMsg)
    def clear(self) -> None:
        self._points: list[tuple[float, float, Color4f, float]] = []
        self._lines: list[tuple[float, float, float, float, Color4f, float]] = []
        self._arcs: list[tuple] = []
        self._texts: list[tuple[float, float, str, Color4f]] = []

    # -- primitives ---------------------------------------------------------
    def draw_point(self, p, color: Color4f = Color4f.BLUE, size: float = 2.0) -> None:
        """DrawPoint (visualization.cc:74-79)."""
        self._points.append((float(p[0]), float(p[1]), color, size))

    def draw_points(self, pts, color: Color4f = Color4f.BLUE, size: float = 2.0) -> None:
        for p in np.asarray(pts).reshape(-1, 2):
            self._points.append((float(p[0]), float(p[1]), color, size))

    def draw_line(self, p0, p1, color: Color4f = Color4f.BLACK, width: float = 1.0) -> None:
        """DrawLine (visualization.cc:81-90)."""
        self._lines.append(
            (float(p0[0]), float(p0[1]), float(p1[0]), float(p1[1]), color, width)
        )

    def draw_cross(self, p, size: float, color: Color4f = Color4f.RED) -> None:
        """DrawCross (visualization.cc:92-99): two diagonal strokes."""
        x, y = float(p[0]), float(p[1])
        self.draw_line((x - size, y - size), (x + size, y + size), color)
        self.draw_line((x + size, y - size), (x - size, y + size), color)

    def draw_arc(
        self,
        center,
        radius: float,
        start_angle: float,
        end_angle: float,
        color: Color4f = Color4f.BLACK,
        width: float = 1.0,
    ) -> None:
        """DrawArc (visualization.cc:101-115)."""
        self._arcs.append(
            (
                float(center[0]),
                float(center[1]),
                float(radius),
                float(start_angle),
                float(end_angle),
                color,
                width,
            )
        )

    def draw_particle(self, loc, angle: float, color: Color4f = Color4f.GREEN) -> None:
        """DrawParticle (visualization.cc:117-126): a point plus a short
        heading stroke."""
        x, y = float(loc[0]), float(loc[1])
        self.draw_point((x, y), color, size=3.0)
        self.draw_line((x, y), (x + 0.3 * math.cos(angle), y + 0.3 * math.sin(angle)), color)

    def draw_path_option(
        self, curvature: float, distance: float, clearance: float,
        color: Color4f = Color4f.BLUE,
    ) -> None:
        """DrawPathOption (visualization.cc:128-140): a constant-curvature
        arc (or straight segment) from the robot origin, plus the clearance
        envelope arc."""
        if abs(curvature) < 1e-6:
            self.draw_line((0.0, 0.0), (distance, 0.0), color)
            if clearance > 0:
                self.draw_line((0.0, clearance), (distance, clearance), color)
                self.draw_line((0.0, -clearance), (distance, -clearance), color)
            return
        r = 1.0 / curvature
        sweep = distance * curvature
        c = (0.0, r)
        a0 = -math.pi / 2 if r > 0 else math.pi / 2
        a1 = a0 + sweep
        lo, hi = (a0, a1) if a1 >= a0 else (a1, a0)
        self.draw_arc(c, abs(r), lo, hi, color)
        if clearance > 0:
            self.draw_arc(c, max(abs(r) - clearance, 0.0), lo, hi, color)
            self.draw_arc(c, abs(r) + clearance, lo, hi, color)

    def draw_text(self, p, text: str, color: Color4f = Color4f.BLACK) -> None:
        self._texts.append((float(p[0]), float(p[1]), text, color))

    # -- export ------------------------------------------------------------
    def to_dict(self) -> dict[str, np.ndarray]:
        """Flat array form (the serialized-message analog)."""
        pts = np.array([(x, y) for x, y, _, _ in self._points], np.float32).reshape(-1, 2)
        lines = np.array(
            [(x0, y0, x1, y1) for x0, y0, x1, y1, _, _ in self._lines], np.float32
        ).reshape(-1, 4)
        arcs = np.array(
            [(x, y, r, a0, a1) for x, y, r, a0, a1, _, _ in self._arcs], np.float32
        ).reshape(-1, 5)
        return {"points": pts, "lines": lines, "arcs": arcs, "frame": self.frame}

    def render(self, ax=None, out_path: str | None = None, dpi: int = 120):
        """Draw onto a matplotlib axis (created if needed); optionally save
        (to the caller's figure when `ax` is provided)."""
        if ax is None:
            # Only force the headless backend for figures we create;
            # switching backends closes a caller's existing figures.
            import matplotlib

            matplotlib.use("Agg")
        from matplotlib.patches import Arc

        fig = None
        if ax is None:
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 7))
        if self._points:
            xs = [p[0] for p in self._points]
            ys = [p[1] for p in self._points]
            cs = [p[2].to_hex() for p in self._points]
            ss = [p[3] for p in self._points]
            ax.scatter(xs, ys, s=ss, c=cs)
        for x0, y0, x1, y1, color, width in self._lines:
            ax.plot([x0, x1], [y0, y1], c=color.to_hex(), lw=width)
        for x, y, r, a0, a1, color, width in self._arcs:
            ax.add_patch(
                Arc(
                    (x, y), 2 * r, 2 * r,
                    theta1=math.degrees(a0), theta2=math.degrees(a1),
                    edgecolor=color.to_hex(), lw=width,
                )
            )
        for x, y, text, color in self._texts:
            ax.text(x, y, text, color=color.to_hex(), fontsize=8)
        ax.set_aspect("equal")
        if out_path is not None:
            target = fig if fig is not None else ax.figure
            target.savefig(out_path, dpi=dpi)
            if fig is not None:
                import matplotlib.pyplot as plt

                plt.close(fig)
        return ax


def trajectory_ticks(poses: np.ndarray, tick_len: float = 0.2) -> np.ndarray:
    """Pose tick-line segments for a trajectory — publishTrajectory
    (dpg_slam.cc:142-158) draws each pose as a short heading stroke.
    Returns (N, 4) [x0, y0, x1, y1]."""
    poses = np.asarray(poses).reshape(-1, 3)
    x0 = poses[:, 0]
    y0 = poses[:, 1]
    x1 = x0 + tick_len * np.cos(poses[:, 2])
    y1 = y0 + tick_len * np.sin(poses[:, 2])
    return np.stack([x0, y0, x1, y1], axis=1).astype(np.float32)


def draw_session(engine, canvas: Canvas | None = None) -> Canvas:
    """Populate a Canvas the way PublishMap + publishTrajectory do
    (dpg_slam_main.cc:117-159): grey full map, colored DPG layers,
    SLAM + odometry pose ticks."""
    canvas = canvas or Canvas()
    layers = export_layers(engine)
    for name in ("map", "active_static", "active_added", "dynamic_added", "dynamic_removed"):
        pts = layers.get(name)
        if pts is not None and len(pts):
            canvas.draw_points(pts, Color4f.from_hex(_COLORS[name]), size=1.5)
    for name in ("trajectory", "odometry"):
        tr = layers.get(name)
        if tr is not None and len(tr):
            color = Color4f.from_hex(_COLORS[name])
            for seg in trajectory_ticks(tr):
                canvas.draw_line(seg[:2], seg[2:], color)
    return canvas


def export_layers(engine) -> dict[str, np.ndarray]:
    """All drawable layers as host arrays (points (P, 2) / poses (N, 3))."""
    layers = {
        "map": engine.map_points(),
        "trajectory": engine.trajectory(),
        "odometry": engine.odom_trajectory(),
    }
    layers.update(engine.map_layers())
    return layers


def render_session(
    engine,
    out_path: str,
    *,
    show_dynamic: bool = True,
    dpi: int = 120,
) -> str:
    """Render the session to a PNG: full map + trajectories, and (if DPG
    ran) the active/dynamic layers side by side like the reference's
    offset displays — but as subplots, not coordinate offsets."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    layers = export_layers(engine)
    n_panels = 2 if show_dynamic else 1
    fig, axes = plt.subplots(1, n_panels, figsize=(8 * n_panels, 7), squeeze=False)
    axes = axes[0]

    ax = axes[0]
    m = layers["map"]
    if len(m):
        ax.scatter(m[:, 0], m[:, 1], s=1, c=_COLORS["map"], label="map")
    tr = layers["trajectory"]
    if len(tr):
        ax.plot(tr[:, 0], tr[:, 1], "-", c=_COLORS["trajectory"], lw=1.5, label="slam")
    od = layers["odometry"]
    if len(od):
        ax.plot(od[:, 0], od[:, 1], ":", c=_COLORS["odometry"], lw=1, label="odometry")
    ax.set_title("map + trajectory")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)

    if show_dynamic:
        ax = axes[1]
        for name in ("active_static", "active_added", "dynamic_added", "dynamic_removed"):
            pts = layers.get(name)
            if pts is not None and len(pts):
                ax.scatter(pts[:, 0], pts[:, 1], s=2, c=_COLORS[name], label=name)
        ax.set_title("DPG layers")
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)

    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path
