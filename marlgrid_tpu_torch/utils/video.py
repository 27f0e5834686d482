"""Episode video recording (``marlgrid/utils/video.py — §GridRecorder``),
the PyTorch port's copy of ``marlgrid_tpu/utils/video.py``.

Wraps the host env, keeps ``render(mode='rgb_array')`` frames of every
step while ``recording`` is on, and exports mp4 or gif through imageio
(imported inside the export, so the port imports without it). Off the
training path; for looking at episodes.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np


class GridRecorder:
    """Pass-through env wrapper with a frame buffer (SURVEY §3.5)."""

    def __init__(self, env, tile_size: int = 16, render_kwargs: dict = None):
        self.env = env
        self.tile_size = tile_size
        self.render_kwargs = render_kwargs or {}
        self.recording = True
        self.frames: List[np.ndarray] = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _capture(self):
        if self.recording:
            self.frames.append(
                self.env.render(mode="rgb_array", tile_size=self.tile_size,
                                **self.render_kwargs))

    def reset(self, **kw):
        obs = self.env.reset(**kw)
        self.frames = []
        self._capture()
        return obs

    def step(self, actions):
        out = self.env.step(actions)
        self._capture()
        return out

    def export_video(self, path: str, fps: int = 8):
        """Write the buffered frames to mp4/gif (imageio backend)."""
        assert self.frames, "no frames recorded"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        import imageio.v2 as imageio

        if path.endswith(".gif"):
            imageio.mimsave(path, self.frames, duration=1.0 / fps)
        else:
            with imageio.get_writer(path, fps=fps,
                                    macro_block_size=None) as w:
                for f in self.frames:
                    w.append_data(f)
        return path


def export_frames(frames, path: str, fps: int = 8):
    """Standalone frame-list export (for VectorEnv-sourced renders)."""
    rec = GridRecorder.__new__(GridRecorder)
    rec.frames = list(frames)
    return GridRecorder.export_video(rec, path, fps)
