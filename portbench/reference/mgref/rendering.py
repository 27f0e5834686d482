"""Sprite rasterization (host side), frozen from the port's
``rendering.py``: the pixel-geometry predicates, ``fill_coords``,
``downsample``, the base and agent sprites and the sprite tables
``base_lut``/``agent_lut`` that the image observations index
(``ops/sprite.py``). The port's board rendering and viewer window are not
part of this copy.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from .core import constants as C
from .core.obs import NS, N_AGENT_APPEAR, N_BASE_APPEAR

# --------------------------------------------------------------------------
# Geometry predicates. Each returns fn(xf, yf) -> bool mask, where xf/yf are
# float arrays of pixel-center coordinates in [0, 1).
# --------------------------------------------------------------------------


def point_in_rect(xmin, xmax, ymin, ymax):
    return lambda x, y: (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)


def point_in_circle(cx, cy, r):
    return lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= r ** 2


def point_in_line(x0, y0, x1, y1, r):
    def fn(x, y):
        dx, dy = x1 - x0, y1 - y0
        denom = dx * dx + dy * dy + 1e-12
        t = np.clip(((x - x0) * dx + (y - y0) * dy) / denom, 0.0, 1.0)
        px, py = x0 + t * dx, y0 + t * dy
        return (x - px) ** 2 + (y - py) ** 2 <= r ** 2
    return fn


def point_in_triangle(a, b, c):
    ax, ay = a
    bx, by = b
    cx, cy = c

    def fn(x, y):
        v0x, v0y = cx - ax, cy - ay
        v1x, v1y = bx - ax, by - ay
        v2x, v2y = x - ax, y - ay
        d00 = v0x * v0x + v0y * v0y
        d01 = v0x * v1x + v0y * v1y
        d11 = v1x * v1x + v1y * v1y
        d20 = v2x * v0x + v2y * v0y
        d21 = v2x * v1x + v2y * v1y
        denom = d00 * d11 - d01 * d01 + 1e-12
        u = (d11 * d20 - d01 * d21) / denom
        v = (d00 * d21 - d01 * d20) / denom
        return (u >= 0) & (v >= 0) & (u + v <= 1)
    return fn


def rotate_fn(fin, cx, cy, theta):
    """Rotate a predicate's input frame by theta around (cx, cy)."""
    def fn(x, y):
        xr = cx + (x - cx) * math.cos(theta) - (y - cy) * math.sin(theta)
        yr = cy + (y - cy) * math.cos(theta) + (x - cx) * math.sin(theta)
        return fin(xr, yr)
    return fn


def fill_coords(img, fn, color):
    """Rasterize a predicate into an image in place; returns the mask."""
    h, w = img.shape[:2]
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    xg, yg = np.meshgrid(xs, ys)          # row y, col x
    mask = fn(xg, yg)
    img[mask] = np.asarray(color, img.dtype)
    return mask


def downsample(img, factor):
    """Box-downsample by an integer factor (supersampling average)."""
    h, w = img.shape[:2]
    out = img.reshape(h // factor, factor, w // factor, factor, -1)
    return out.mean(axis=(1, 3)).astype(img.dtype)


SUBDIVS = 3
_GREY = np.array([100, 100, 100], np.uint8)
_BLACK = np.array([0, 0, 0], np.uint8)


def _canvas(tile_size):
    s = tile_size * SUBDIVS
    return np.zeros((s, s, 3), np.uint8)


def render_base_tile(otype, color_idx, state, tile_size):
    """(T, T, 3) uint8 sprite for a non-agent cell."""
    img = _canvas(tile_size)
    col = C.COLORS[color_idx].astype(np.uint8)
    dim = (col.astype(np.int32) * 45 // 100).astype(np.uint8)
    if otype == C.WALL:
        fill_coords(img, point_in_rect(0, 1, 0, 1), _GREY)
    elif otype == C.FLOOR:
        fill_coords(img, point_in_rect(0.031, 1, 0.031, 1), dim)
    elif otype == C.GOAL:
        fill_coords(img, point_in_rect(0, 1, 0, 1), col)
    elif otype == C.LAVA:
        orange = np.array([255, 128, 0], np.uint8)
        fill_coords(img, point_in_rect(0, 1, 0, 1), orange)
        for k in range(3):
            ylo = 0.3 + 0.2 * k
            fill_coords(img, point_in_line(0.1, ylo, 0.9, ylo, 0.03), _BLACK)
    elif otype == C.DOOR:
        if state == C.DOOR_OPEN:
            fill_coords(img, point_in_rect(0.88, 1.0, 0.0, 1.0), col)
            fill_coords(img, point_in_rect(0.92, 0.96, 0.04, 0.96), _BLACK)
        else:
            fill_coords(img, point_in_rect(0.0, 1.0, 0.0, 1.0), col)
            fill_coords(img, point_in_rect(0.04, 0.96, 0.04, 0.96), _BLACK)
            if state == C.DOOR_LOCKED:
                fill_coords(img, point_in_rect(0.08, 0.92, 0.08, 0.92), dim)
                fill_coords(img, point_in_rect(0.52, 0.75, 0.50, 0.56), col)
            else:
                fill_coords(img, point_in_rect(0.08, 0.92, 0.08, 0.92),
                            _BLACK)
                fill_coords(img, point_in_circle(0.75, 0.50, 0.08), col)
    elif otype == C.KEY:
        fill_coords(img, point_in_circle(0.56, 0.28, 0.19), col)   # bow
        fill_coords(img, point_in_circle(0.56, 0.28, 0.064), _BLACK)
        fill_coords(img, point_in_rect(0.50, 0.62, 0.31, 0.88), col)  # stem
        fill_coords(img, point_in_rect(0.62, 0.79, 0.70, 0.77), col)  # teeth
        fill_coords(img, point_in_rect(0.62, 0.79, 0.81, 0.88), col)
    elif otype == C.BALL:
        fill_coords(img, point_in_circle(0.5, 0.5, 0.31), col)
    elif otype == C.BOX:
        fill_coords(img, point_in_rect(0.12, 0.88, 0.12, 0.88), col)
        fill_coords(img, point_in_rect(0.18, 0.82, 0.18, 0.82), _BLACK)
        fill_coords(img, point_in_rect(0.16, 0.84, 0.47, 0.53), col)  # lid
    elif otype == C.BONUS:
        diamond = rotate_fn(point_in_rect(0.28, 0.72, 0.28, 0.72),
                            0.5, 0.5, math.pi / 4)
        fill_coords(img, diamond, col)
    # EMPTY / unknown: stays black
    return downsample(img, SUBDIVS)


def render_agent_tile(color_idx, rel_dir, tile_size):
    """(T, T, 4) uint8 RGBA sprite: the agent triangle (SPEC §8)."""
    img = _canvas(tile_size)
    tri = point_in_triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
    # rel_dir 0=east (triangle's native heading), rotate by 90° per dir
    tri = rotate_fn(tri, 0.5, 0.5, 0.5 * math.pi * rel_dir)
    mask = fill_coords(img, tri, C.COLORS[color_idx])
    alpha = np.zeros(img.shape[:2] + (1,), np.uint8)
    alpha[mask] = 255
    rgba = np.concatenate([img, alpha], axis=-1)
    return downsample(rgba, SUBDIVS)


@functools.lru_cache(maxsize=None)
def base_lut(tile_size: int) -> np.ndarray:
    """(N_BASE_APPEAR, T, T, 3) uint8 — all base-cell appearances, row
    ``(type * N_COLORS + color) * NS + door_state``. Shared; do not write."""
    out = np.zeros((N_BASE_APPEAR, tile_size, tile_size, 3), np.uint8)
    for t in range(C.N_TYPES):
        for c in range(C.N_COLORS):
            for s in range(NS):
                out[(t * C.N_COLORS + c) * NS + s] = render_base_tile(
                    t, c, s, tile_size)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def agent_lut(tile_size: int) -> np.ndarray:
    """(N_AGENT_APPEAR, T, T, 4) uint8 — agent overlays, row ``1 + color * 4
    + rel_dir``; row 0 (no agent) is transparent. Shared; do not write."""
    out = np.zeros((N_AGENT_APPEAR, tile_size, tile_size, 4), np.uint8)
    for c in range(C.N_COLORS):
        for d in range(4):
            out[1 + c * 4 + d] = render_agent_tile(c, d, tile_size)
    out.flags.writeable = False
    return out
