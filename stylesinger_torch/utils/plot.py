"""Validation figures: spectrograms, F0 curves, durations, attention maps
(port of ``stylesinger_tpu/utils/plot.py``, the reference's
``utils/plot.py``).  matplotlib is imported when a figure is drawn, with
the Agg backend; without it a figure raises ``ImportError``."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def spec_to_figure(spec: np.ndarray, vmin: Optional[float] = None,
                   vmax: Optional[float] = None, title: str = ""):
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    plt.title(title)
    return fig


def f0_to_figure(f0_gt: np.ndarray, f0_cwt: Optional[np.ndarray] = None,
                 f0_pred: Optional[np.ndarray] = None):
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.asarray(f0_gt), color="r", label="gt")
    if f0_cwt is not None:
        plt.plot(np.asarray(f0_cwt), color="b", label="cwt")
    if f0_pred is not None:
        plt.plot(np.asarray(f0_pred), color="green", label="pred")
    plt.legend()
    return fig


def dur_to_figure(dur_gt: np.ndarray, dur_pred: np.ndarray, txt: str = ""):
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.asarray(dur_gt), color="r", label="gt")
    plt.plot(np.asarray(dur_pred), color="green", label="pred")
    plt.legend()
    plt.title(txt)
    return fig


def attn_to_figure(attn: np.ndarray, title: str = ""):
    plt = _plt()
    fig = plt.figure(figsize=(8, 8))
    plt.imshow(np.asarray(attn), aspect="auto", origin="lower")
    plt.title(title)
    return fig


def figure_to_image(fig) -> np.ndarray:
    """A figure rendered to an HWC uint8 array (for image summaries); the
    figure is closed."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    import matplotlib.pyplot as plt
    plt.close(fig)
    return buf
