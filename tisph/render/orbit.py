"""Interactive orbit-camera 3D viewer (first-party perspective pipeline).

Full parity with the reference's GGUI workflow (main_3d.py:8-16 camera
position/lookat/up/fov, :34-46 per-frame track_user_inputs + scene.particles
+ scene.lines draw loop): an orbit/track camera the user drives with the
mouse and keyboard while the simulation streams frames.  The reference
delegates to Taichi's GGUI window; here the camera model, the perspective
projection, depth sorting, and distance/depth shading are all first-party
(numpy), rasterised through a plain 2D matplotlib canvas — so the viewer
works over any matplotlib backend (interactive or Agg-headless), needs no
GPU windowing stack, and stays entirely OUT of the device hot path (positions
arrive as host snapshots, SURVEY.md §2.9.7).

Controls (matching GGUI's track_user_inputs semantics):
  left-drag   orbit (azimuth / elevation around the target)
  right-drag  pan the target in the view plane
  scroll      dolly (distance to target)
  w/s a/d q/e move the target forward/back, left/right, down/up
  r           reset to the initial pose

Headless use: ``OrbitViewer(scene, interactive=False)`` renders through Agg;
``project()`` / ``render_frame()`` are pure functions of camera + points and
are unit-tested without a display (tests/test_aux.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tisph.config import SceneConfig
from tisph.models.state import SimState, state_to_host
from tisph.utils.lines import domain_wireframe


def _normalize(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclasses.dataclass
class OrbitCamera:
    """Perspective orbit camera: a pose (target, distance, azimuth,
    elevation) plus a vertical-FOV pinhole projection.

    The orbit parameterisation is y-up spherical (the reference's
    camera.up(0, 1, 0), main_3d.py:13): ``azimuth`` rotates around +y,
    ``elevation`` tilts toward +y, both in degrees.
    """

    target: np.ndarray
    distance: float
    azimuth: float = 45.0
    elevation: float = 20.0
    fov: float = 70.0            # vertical FOV, degrees (main_3d.py:15)
    near: float = 1e-3

    def __post_init__(self):
        self.target = np.asarray(self.target, np.float64)
        self._initial = (self.target.copy(), float(self.distance),
                         float(self.azimuth), float(self.elevation))

    # -- pose ---------------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        az = np.deg2rad(self.azimuth)
        el = np.deg2rad(np.clip(self.elevation, -89.9, 89.9))
        d = max(self.distance, 1e-6)
        offs = np.array([
            np.cos(el) * np.cos(az),
            np.sin(el),
            np.cos(el) * np.sin(az),
        ])
        return self.target + d * offs

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(forward, right, up) orthonormal view basis (y-up world)."""
        fwd = _normalize(self.target - self.position)
        right = _normalize(np.cross(fwd, np.array([0.0, 1.0, 0.0])))
        if not np.isfinite(right).all() or np.linalg.norm(right) < 1e-9:
            right = np.array([1.0, 0.0, 0.0])  # looking straight up/down
        up = np.cross(right, fwd)
        return fwd, right, up

    @classmethod
    def from_lookat(cls, position, lookat, fov: float = 70.0) -> "OrbitCamera":
        """Build the orbit pose from the reference's position/lookat pair
        (main_3d.py:12-14: position(5.5, 2.5, 4.0), lookat(-1, 0, 0))."""
        position = np.asarray(position, np.float64)
        lookat = np.asarray(lookat, np.float64)
        off = position - lookat
        d = float(np.linalg.norm(off))
        el = float(np.rad2deg(np.arcsin(np.clip(off[1] / max(d, 1e-9), -1, 1))))
        az = float(np.rad2deg(np.arctan2(off[2], off[0])))
        return cls(target=lookat, distance=d, azimuth=az, elevation=el, fov=fov)

    def reset(self) -> None:
        t, d, az, el = self._initial
        self.target = t.copy()
        self.distance, self.azimuth, self.elevation = d, az, el

    # -- interaction (GGUI track_user_inputs parity) -------------------
    def orbit(self, d_azimuth: float, d_elevation: float) -> None:
        self.azimuth = (self.azimuth + d_azimuth) % 360.0
        self.elevation = float(np.clip(self.elevation + d_elevation, -89.0, 89.0))

    def pan(self, dx: float, dy: float) -> None:
        """Translate the target in the view plane; dx/dy in units of the
        view height at the target distance (so a full-window drag moves
        the scene by about one window)."""
        _, right, up = self.basis()
        scale = 2.0 * self.distance * np.tan(np.deg2rad(self.fov) / 2.0)
        self.target = self.target + (-dx * right + dy * up) * scale

    def dolly(self, steps: float) -> None:
        self.distance = float(np.clip(self.distance * (0.88 ** steps),
                                      1e-3, 1e6))

    def move(self, key: str, speed: float = 0.03) -> bool:
        """WASD/QE target motion (GGUI movement_speed, main_3d.py:34).
        Returns True when the key was handled."""
        fwd, right, up = self.basis()
        step = {
            "w": fwd, "s": -fwd, "a": -right, "d": right,
            "e": up, "q": -up,
        }.get(key)
        if step is None:
            return False
        self.target = self.target + speed * self.distance * step
        return True

    # -- projection ----------------------------------------------------
    def project(self, pts: np.ndarray, aspect: float = 1.0):
        """Perspective-project world points.

        Returns ``(xy, depth, vis)``: normalised screen coords (x in
        [-1, 1] maps to the horizontal extent, y scaled by 1/aspect),
        view-space depth (distance along forward), and the in-front-of-
        near-plane mask.  Pure numpy — unit-testable headless."""
        pts = np.asarray(pts, np.float64)
        fwd, right, up = self.basis()
        rel = pts - self.position
        z = rel @ fwd
        vis = z > self.near
        zs = np.where(vis, z, 1.0)
        f = 1.0 / np.tan(np.deg2rad(self.fov) / 2.0)
        x = (rel @ right) * f / (zs * aspect)
        y = (rel @ up) * f / zs
        return np.stack([x, y], axis=-1), z, vis


class OrbitViewer:
    """Live orbit-camera particle viewer (GGUI main_3d.py parity).

    Call ``show(state)`` once per rendered frame; between frames the mouse
    and keyboard retarget the camera.  The domain wireframe (utils/lines,
    reference scene.lines main_3d.py:43) is re-projected every draw."""

    #: reference GGUI fluid color (main_3d.py:41)
    PARTICLE_COLOR = (0.68, 0.26, 0.19)

    def __init__(self, scene: SceneConfig, interactive: bool = True,
                 point_size: float = 2.0, camera: OrbitCamera | None = None,
                 max_points: int = 400_000, color_by: str = "color"):
        import matplotlib

        if not interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.scene = scene
        self.point_size = point_size
        self.max_points = max_points
        self.color_by = color_by
        s = np.asarray(scene.domain_start, np.float64)
        e = np.asarray(scene.domain_end, np.float64)
        if camera is None:
            # the reference's fixed pose scaled to THIS scene's domain:
            # look at the domain center from the same diagonal direction
            center = (s + e) / 2.0
            diag = float(np.linalg.norm(e - s))
            ref = OrbitCamera.from_lookat((5.5, 2.5, 4.0), (-1.0, 0.0, 0.0))
            camera = OrbitCamera(target=center, distance=1.2 * diag,
                                 azimuth=ref.azimuth, elevation=ref.elevation,
                                 fov=70.0)
        self.camera = camera
        self._wire_pts, self._wire_edges = domain_wireframe(
            scene.domain_start, scene.domain_end
        )

        self.fig, self.ax = plt.subplots(figsize=(8, 8))
        mgr = getattr(self.fig.canvas, "manager", None)
        if mgr is not None:
            try:
                mgr.set_window_title("tisph — orbit view")
            except Exception:
                pass
        self.aspect = 1.0
        self.ax.set_xlim(-1, 1)
        self.ax.set_ylim(-1, 1)
        self.ax.set_aspect("equal")
        self.ax.set_axis_off()
        self.fig.subplots_adjust(left=0, right=1, bottom=0, top=1)
        self._scatter = None
        self._wires = []
        self._last = None  # (x, colors) for input-driven redraw

        self._drag = None  # (button, x, y)
        if interactive:
            c = self.fig.canvas
            c.mpl_connect("button_press_event", self._on_press)
            c.mpl_connect("button_release_event", self._on_release)
            c.mpl_connect("motion_notify_event", self._on_motion)
            c.mpl_connect("scroll_event", self._on_scroll)
            c.mpl_connect("key_press_event", self._on_key)
            plt.ion()
            plt.show(block=False)

    # -- event handlers (exercised directly in tests) ------------------
    def _on_press(self, ev):
        if ev.x is not None:
            self._drag = (ev.button, ev.x, ev.y)

    def _on_release(self, ev):
        self._drag = None

    def _on_motion(self, ev):
        if self._drag is None or ev.x is None:
            return
        button, x0, y0 = self._drag
        w = max(self.fig.bbox.width, 1)
        h = max(self.fig.bbox.height, 1)
        dx, dy = (ev.x - x0) / w, (ev.y - y0) / h
        self._drag = (button, ev.x, ev.y)
        if (button == 1 and ev.key == "shift") or button == 3:
            self.camera.pan(dx, dy)
        elif button == 1:
            self.camera.orbit(-dx * 180.0, -dy * 180.0)
        else:
            return
        self._redraw()

    def _on_scroll(self, ev):
        self.camera.dolly(ev.step)
        self._redraw()

    def _on_key(self, ev):
        if ev.key == "r":
            self.camera.reset()
        elif not self.camera.move(ev.key or ""):
            return
        self._redraw()

    # -- rendering ------------------------------------------------------
    def render_frame(self, x: np.ndarray, colors: np.ndarray | None = None):
        """Project + depth-sort + shade one frame of points; returns the
        plotted (xy, rgba, sizes) for testing."""
        cam = self.camera
        if len(x) > self.max_points:
            stride = int(np.ceil(len(x) / self.max_points))
            x = x[::stride]
            colors = colors[::stride] if colors is not None else None
        xy, z, vis = cam.project(x, self.aspect)
        xy, z = xy[vis], z[vis]
        if colors is None:
            rgb = np.broadcast_to(np.asarray(self.PARTICLE_COLOR), (len(z), 3))
        else:
            rgb = np.clip(np.asarray(colors, np.float64)[vis][:, :3], 0, 1)
        # painter's order: far -> near
        order = np.argsort(-z)
        xy, z, rgb = xy[order], z[order], rgb[order]
        # depth shading: dim distant particles toward 55% (cheap stand-in
        # for the reference's point light, main_3d.py:37)
        if len(z):
            z0, z1 = float(z.min()), float(z.max())
            shade = 1.0 - 0.45 * (z - z0) / max(z1 - z0, 1e-9)
        else:
            shade = z
        rgba = np.concatenate([rgb * shade[:, None],
                               np.ones((len(z), 1))], axis=1)
        # perspective size attenuation ~ 1/z^2 around the target distance
        sizes = self.point_size * np.clip(cam.distance / np.maximum(z, 1e-6),
                                          0.1, 8.0) ** 2

        if self._scatter is not None:
            self._scatter.remove()
        self._scatter = self.ax.scatter(xy[:, 0], xy[:, 1], s=sizes, c=rgba,
                                        lw=0, rasterized=True)
        self._draw_wireframe()
        return xy, rgba, sizes

    def _draw_wireframe(self):
        for ln in self._wires:
            ln.remove()
        self._wires = []
        xy, z, vis = self.camera.project(self._wire_pts, self.aspect)
        for a, b in self._wire_edges:
            if vis[a] and vis[b]:
                (ln,) = self.ax.plot(xy[[a, b], 0], xy[[a, b], 1],
                                     c="#fcae47", lw=1.0)  # main_3d.py:43
                self._wires.append(ln)

    def show(self, state: SimState, title: str | None = None) -> None:
        host = state_to_host(state)
        x = host["position"] if "position" in host else host["x"]
        colors = host.get("color") if self.color_by == "color" else None
        self._last = (np.asarray(x), colors)
        self._redraw(title)

    def _redraw(self, title: str | None = None) -> None:
        if self._last is None:
            return
        x, colors = self._last
        self.render_frame(x, colors)
        if title:
            self.ax.set_title(title)
        self.fig.canvas.draw_idle()
        try:
            self.fig.canvas.flush_events()
        except Exception:
            pass

    def savefig(self, path: str) -> None:
        self.fig.savefig(path, dpi=110, facecolor="black")

    def close(self) -> None:
        self._plt.close(self.fig)
