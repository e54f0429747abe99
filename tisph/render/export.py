"""Headless frame export with asynchronous device->host streaming.

The reference's ``dump()`` is a synchronous device->host copy every frame
that stalls the device pipeline (partice_systemv4.py:279-296, SURVEY.md
§3.5).  Here the transfer is double-buffered: ``save`` enqueues a
non-blocking ``jax.device_get``-style copy (``jax.copy_to_host_async``
semantics via ``.copy_to_host_async()``) and the actual file write happens
on a worker thread one frame behind, so the device keeps simulating.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any

import numpy as np
import jax

from tisph.config import SceneConfig
from tisph.models.state import SimState


class FrameExporter:
    """Writes per-frame particle snapshots as .npz (full state) or .png
    (scatter render via matplotlib, 2D/3D)."""

    def __init__(self, out_dir: str, fmt: str = "npz", scene: SceneConfig | None = None):
        self.out_dir = out_dir
        self.fmt = fmt
        self.scene = scene
        os.makedirs(out_dir, exist_ok=True)
        self._q: "queue.Queue[tuple[int, Any] | None]" = queue.Queue(maxsize=4)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._error: BaseException | None = None
        self._worker.start()

    def save(self, state: SimState, frame: int) -> None:
        if self._error is not None:
            raise self._error
        # Start async device->host copies; resolution happens on the worker.
        arrays = {
            "position": state.x,
            "velocity": state.v,
            "density": state.density,
            "pressure": state.pressure,
            "material": state.material,
            "color": state.color,
            "num_active": state.num_active,
        }
        for a in arrays.values():
            try:
                a.copy_to_host_async()
            except AttributeError:  # plain numpy under some test setups
                pass
        self._q.put((frame, arrays))

    def _drain(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                frame, arrays = item
                host = {k: np.asarray(jax.device_get(v)) for k, v in arrays.items()}
                n = int(host.pop("num_active"))
                host = {k: v[:n] for k, v in host.items()}
                if self.fmt == "npz":
                    np.savez_compressed(
                        os.path.join(self.out_dir, f"frame_{frame:06d}.npz"), **host
                    )
                else:
                    self._write_png(host, frame)
        except BaseException as e:  # surfaced on next save()/close()
            self._error = e

    def _write_png(self, host: dict[str, np.ndarray], frame: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = host["position"]
        mat = host["material"]
        fig, ax = plt.subplots(figsize=(8, 6))
        if x.shape[1] == 3:
            # orthographic xy projection, z as shade
            order = np.argsort(x[:, 2])
            x2, mat2 = x[order][:, :2], mat[order]
        else:
            x2, mat2 = x, mat
        ax.scatter(x2[mat2 == 1, 0], x2[mat2 == 1, 1], s=1.0, c="#3070c0", lw=0)
        ax.scatter(x2[mat2 == 0, 0], x2[mat2 == 0, 1], s=1.0, c="#909090", lw=0)
        if self.scene is not None:
            ax.set_xlim(self.scene.domain_start[0], self.scene.domain_end[0])
            ax.set_ylim(self.scene.domain_start[1], self.scene.domain_end[1])
        ax.set_aspect("equal")
        ax.set_title(f"frame {frame}")
        fig.savefig(os.path.join(self.out_dir, f"frame_{frame:06d}.png"), dpi=100)
        plt.close(fig)

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=60)
        if self._error is not None:
            raise self._error


def load_frame(path: str) -> dict[str, np.ndarray]:
    """Read back one exported .npz frame."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
