"""Training observability: log parsing and a loss-curve PNG. Port of
flowmirror_hydravox_tpu/runtime/training_plots.py (reference
user_interface/tabs/training_tab.py:427-824).

`parse_training_logs` and its two patterns are JAX's (:14-39). They read
the port's log line (`step N loss X acc Y grad_norm Z (s/it)`, metrics at
%.5g, train/steps.py `train_loop`) and JAX's (`... gnorm Z`) alike: only
step, loss, acc and the eval lines are taken. A HiFT log line has no `loss`
field, so its plot is empty, in both packages.

`generate_training_plot` writes `<output_dir>/figure/training_plot.png`
without matplotlib (the GPU machine has none): an RGB raster at JAX's size
(9 x 5 in at 110 dpi, 990 x 550 pixels) with the train-loss polyline, the
eval-loss points joined by a line, the accuracy curve on a scale of its own
(right axis; only when every step has an accuracy, as in JAX), axes, ticks
and a grid, encoded as PNG chunks with zlib and struct. No text is drawn;
the axis extents go in a `tEXt` chunk (keyword `extents`).
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib
from typing import Dict, List

import numpy as np

_STEP_RE = re.compile(
    r"step (\d+) loss ([\d.eE+-]+)(?: acc ([\d.eE+-]+))?(?:.*?gnorm ([\d.naif]+))?"
)
_EVAL_RE = re.compile(r"eval step (\d+) loss ([\d.eE+-]+)")

WIDTH, HEIGHT = 990, 550  # JAX's figsize (9, 5) at dpi 110
_LEFT, _RIGHT, _TOP, _BOTTOM = 80, 80, 30, 60  # plot-area margins, pixels
_LOSS_RGB, _EVAL_RGB, _ACC_RGB = (0x23, 0x74, 0xab), (0xab, 0x3b, 0x23), (0x3f, 0xa3, 0x4d)
_AXIS_RGB, _GRID_RGB = (0, 0, 0), (0xdd, 0xdd, 0xdd)
_TICKS = 5


def parse_training_logs(log_text: str) -> Dict[str, List]:
    """Extract step/loss/acc + eval curves from a trainer log."""
    steps, losses, accs = [], [], []
    eval_steps, eval_losses = [], []
    for line in log_text.splitlines():
        m = _EVAL_RE.search(line)
        if m:
            eval_steps.append(int(m.group(1)))
            eval_losses.append(float(m.group(2)))
            continue
        m = _STEP_RE.search(line)
        if m:
            steps.append(int(m.group(1)))
            losses.append(float(m.group(2)))
            if m.group(3):
                accs.append(float(m.group(3)))
    return {
        "steps": steps, "losses": losses, "accs": accs,
        "eval_steps": eval_steps, "eval_losses": eval_losses,
    }


def _extent(values) -> tuple:
    """(lo, hi) of the finite values with 5% margins (a unit span around a
    single value; (0, 1) for none)."""
    v = np.asarray([x for x in values if np.isfinite(x)], np.float64)
    if v.size == 0:
        return 0.0, 1.0
    lo, hi = float(v.min()), float(v.max())
    if hi - lo < 1e-12:
        return lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


class _Canvas:
    def __init__(self):
        self.img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
        self.x0, self.x1 = _LEFT, WIDTH - _RIGHT
        self.y0, self.y1 = _TOP, HEIGHT - _BOTTOM

    def line(self, xa, ya, xb, yb, rgb, width: int = 1):
        n = int(max(abs(xb - xa), abs(yb - ya))) + 1
        xs = np.rint(np.linspace(xa, xb, n)).astype(int)
        ys = np.rint(np.linspace(ya, yb, n)).astype(int)
        for d in range(width):
            yy = np.clip(ys + d - width // 2, 0, HEIGHT - 1)
            self.img[yy, np.clip(xs, 0, WIDTH - 1)] = rgb

    def box(self, x, y, half: int, rgb):
        x, y = int(round(x)), int(round(y))
        self.img[max(y - half, 0):y + half + 1, max(x - half, 0):x + half + 1] = rgb

    def to_px(self, xs, ys, xext, yext):
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        px = self.x0 + (xs - xext[0]) / (xext[1] - xext[0]) * (self.x1 - self.x0)
        py = self.y1 - (ys - yext[0]) / (yext[1] - yext[0]) * (self.y1 - self.y0)
        return px, py

    def polyline(self, px, py, rgb, width: int = 2):
        keep = np.isfinite(px) & np.isfinite(py)
        px, py = px[keep], py[keep]
        for i in range(len(px) - 1):
            self.line(px[i], py[i], px[i + 1], py[i + 1], rgb, width)
        if len(px) == 1:
            self.box(px[0], py[0], 1, rgb)


def _png(img: np.ndarray, text: Dict[str, str]) -> bytes:
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    for key, value in text.items():
        out += chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    return out + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b"")


def render_plot(data: Dict[str, List]) -> bytes:
    """The PNG bytes of the curves `parse_training_logs` returns."""
    c = _Canvas()
    xext = _extent(data["steps"] + data["eval_steps"])
    yext = _extent(data["losses"] + data["eval_losses"])
    with_acc = bool(data["accs"]) and len(data["accs"]) == len(data["steps"])
    aext = _extent(data["accs"]) if with_acc else None
    for i in range(_TICKS + 1):
        fx = c.x0 + i * (c.x1 - c.x0) / _TICKS
        fy = c.y0 + i * (c.y1 - c.y0) / _TICKS
        c.line(fx, c.y0, fx, c.y1, _GRID_RGB)
        c.line(c.x0, fy, c.x1, fy, _GRID_RGB)
        c.line(fx, c.y1, fx, c.y1 + 6, _AXIS_RGB)
        c.line(c.x0 - 6, fy, c.x0, fy, _AXIS_RGB)
        if with_acc:
            c.line(c.x1, fy, c.x1 + 6, fy, _ACC_RGB)
    c.line(c.x0, c.y0, c.x0, c.y1, _AXIS_RGB)
    c.line(c.x0, c.y1, c.x1, c.y1, _AXIS_RGB)
    c.line(c.x0, c.y0, c.x1, c.y0, _AXIS_RGB)
    c.line(c.x1, c.y0, c.x1, c.y1, _ACC_RGB if with_acc else _AXIS_RGB)
    if with_acc:
        c.polyline(*c.to_px(data["steps"], data["accs"], xext, aext), _ACC_RGB, width=1)
    if data["steps"]:
        c.polyline(*c.to_px(data["steps"], data["losses"], xext, yext), _LOSS_RGB)
    if data["eval_steps"]:
        px, py = c.to_px(data["eval_steps"], data["eval_losses"], xext, yext)
        c.polyline(px, py, _EVAL_RGB, width=1)
        for x, y in zip(px, py):
            if np.isfinite(x) and np.isfinite(y):
                c.box(x, y, 3, _EVAL_RGB)
    extents = {"step": xext, "loss": yext, "acc": aext,
               "points": {k: len(v) for k, v in data.items()}}
    return _png(c.img, {"Title": "training curves", "extents": json.dumps(extents)})


def generate_training_plot(log_path: str, output_dir: str) -> str:
    """Render the log's curves to <output_dir>/figure/training_plot.png
    (training_tab.py:594-824 equivalent). Returns the png path."""
    with open(log_path) as f:
        data = parse_training_logs(f.read())
    fig_dir = os.path.join(output_dir, "figure")
    os.makedirs(fig_dir, exist_ok=True)
    path = os.path.join(fig_dir, "training_plot.png")
    with open(path, "wb") as f:
        f.write(render_plot(data))
    return path
