"""Review-screen spectrogram: window planning + PNG rendering (headless).

A copy of the JAX package's ``ui/spectrogram.py`` (numpy; matplotlib is
imported only inside ``render_review_png``).

Behavior parity with ``review_detections.py:800-968``:
  * window sizing — seconds-per-inch zoom (powers of two), detection
    centered, clamped at file start/end, zero-padded to the full window
  * display STFT — |STFT| with n_fft=512, win=512, hop=256 (the reference
    calls librosa.stft with defaults: periodic Hann, center=True, zero
    padding) — ``display_spec``
  * rendering — dB of spec², ref=max, abs-flipped grayscale, origin lower,
    extent [start, end] × [0, 11025] Hz, red span = current detection, blue
    spans = other detections in window, optional 0.5 s dotted gridlines

The renderer returns PNG bytes (matplotlib Agg), so any frontend can show
or save it.  Where matplotlib is not installed (the card's machine) it
draws the same image without axes or labels — the grayscale spectrogram,
the red and blue spans and the dotted gridlines over the plot area — and
writes the PNG itself (``_plain_png``).
"""

from __future__ import annotations

import io
import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from ..config import Config, DEFAULT_CONFIG
from ..io import get_audio_data, load_audio_startstop


def display_spec(data: np.ndarray, trim_edges: bool = True) -> np.ndarray:
    """|STFT| magnitude for display (voice_activity.py:148-154 semantics:
    librosa.stft defaults — n_fft=512, periodic Hann, center zero-pad)."""
    n_fft, hop = 512, 256
    x = np.asarray(data, np.float32)
    pad = n_fft // 2
    xp = np.pad(x, pad, mode="constant")
    n_frames = 1 + (len(xp) - n_fft) // hop
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = xp[idx] * w
    mag = np.abs(np.fft.rfft(frames, axis=1)).T.astype(np.float32)  # (257, T)
    if trim_edges:
        mag = mag[0:256, 0:256]
    return mag


def amplitude_to_db(s: np.ndarray, ref: Optional[float] = None, amin=1e-5,
                    top_db=80.0):
    """Exact librosa.amplitude_to_db semantics: 20*log10, amin=1e-5.

    The reference feeds it the POWER spectrogram
    (review_detections.py:880 ``amplitude_to_db(spectrogram**2, ref=np.max)``)
    so the displayed scale is effectively 40*log10(|STFT|) — reproduce that,
    not a 'corrected' power_to_db (a 10*log10 here halves the dB range and
    visibly changes the rendered contrast/floor vs the reference)."""
    mag = np.asarray(s, np.float64)
    ref_value = np.max(mag) if ref is None else ref
    db = 20.0 * np.log10(np.maximum(amin, mag))
    db -= 20.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db.astype(np.float32)


def plan_view_window(
    full_path: str,
    detection_start: float,
    detection_end: float,
    widget_width_px: int = 1200,
    dpi: float = 96.0,
    zoom_level: float = 1.0,
) -> Tuple[float, float, float]:
    """(audio_start, audio_end, total_duration) — the visible clip range,
    detection centered, clamped to the file (review_detections.py:826-852)."""
    detection_len = detection_end - detection_start
    window_width_in = widget_width_px / dpi
    audio_duration, _sr = get_audio_data(full_path)
    total_duration = math.ceil(window_width_in * zoom_level)
    load_duration = min(audio_duration, total_duration)
    gap = (load_duration - detection_len) / 2
    adjust = max(0.0, (detection_end + gap) - audio_duration)
    audio_start = math.floor(max(0, detection_start - gap - adjust))
    return audio_start, audio_start + load_duration, total_duration


def render_review_png(
    full_path: str,
    detection_start: float,
    detection_end: float,
    other_detections=(),
    widget_width_px: int = 1200,
    widget_height_px: int = 500,
    dpi: float = 96.0,
    zoom_level: float = 1.0,
    show_gridlines: bool = True,
    config: Config = DEFAULT_CONFIG,
) -> bytes:
    """Produce the review-screen spectrogram PNG for one detection."""
    try:
        import matplotlib
    except ImportError:
        matplotlib = None

    sr = config.dsp.sample_rate
    audio_start, audio_end, total_duration = plan_view_window(
        full_path, detection_start, detection_end, widget_width_px, dpi, zoom_level
    )
    data, got_sr = load_audio_startstop(full_path, (audio_start, audio_end), target_sr=sr)
    if data is None:
        raise IOError(f"failed to load {full_path}")
    if len(data) / got_sr != total_duration:  # zero-pad to the full window
        temp = np.zeros(int(total_duration * got_sr), np.float32)
        temp[: len(data)] = data
        data = temp

    spec = display_spec(data, trim_edges=False)
    db = amplitude_to_db(spec.astype(np.float64) ** 2)
    flipped = np.abs(db)
    view_end = audio_start + total_duration
    spacing = _tick_spacing(total_duration, widget_width_px)
    ticks = np.arange(np.floor(audio_start), np.ceil(view_end) + spacing,
                      spacing)
    others = [(s, e) for s, e in other_detections
              if e >= audio_start and s <= view_end
              and not (s == detection_start and e == detection_end)]
    if matplotlib is None:
        return _plain_png(flipped, (audio_start, view_end), (detection_start, detection_end),
                          others, ticks if show_gridlines else (),
                          int(widget_width_px), int(widget_height_px / 2))

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(
        figsize=(widget_width_px / dpi, widget_height_px / dpi / 2), dpi=dpi
    )
    ax.imshow(
        flipped,
        origin="lower",
        aspect="auto",
        cmap="gray",
        vmin=flipped.min(),
        vmax=flipped.max(),
        extent=[audio_start, view_end, 0, sr / 2],
    )
    # current detection red, overlapping others blue (:907-926)
    ax.axvspan(detection_start, detection_end, color="red", alpha=0.3)
    for s, e in others:
        ax.axvspan(s, e, color="blue", alpha=0.3)

    if show_gridlines:
        for t in ticks:
            ax.axvline(x=t, color="b", linestyle=":", alpha=0.3)
    ax.set_xticks(ticks)
    ax.set_xticklabels([f"{t:.1f}" for t in ticks])
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    ax.set_xlim(audio_start, view_end)
    ax.set_ylim(0, sr / 2)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Frequency [Hz]")
    plt.tight_layout()

    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return buf.getvalue()


def _tick_spacing(total_duration: float, widget_width_px: int) -> float:
    """0.5 s grid at review zoom (reference look), doubled until the tick
    count is capped: a zoomed-out multi-minute view at fixed 0.5 s spacing
    drew thousands of axvlines/labels per render on the UI thread."""
    spacing = 0.5
    max_ticks = max(8.0, widget_width_px / 40.0)
    while total_duration / spacing > max_ticks:
        spacing *= 2.0
    return spacing


def _plain_png(flipped: np.ndarray, view: Tuple[float, float],
               detection: Tuple[float, float], others, ticks,
               width: int, height: int) -> bytes:
    """The review image without matplotlib: ``flipped`` (freq × time) as
    grayscale from its min (black) to its max (white), origin lower, scaled
    to ``width`` × ``height`` by nearest sample; the current detection
    blended 30% red, the others 30% blue, dotted blue gridlines at
    ``ticks``; written as an 8-bit RGB PNG."""
    lo, hi = float(flipped.min()), float(flipped.max())
    gray = (flipped - lo) / (hi - lo) if hi > lo else np.zeros_like(flipped)
    rows = np.minimum((np.arange(height)[::-1] + 0.5) * flipped.shape[0] / height,
                      flipped.shape[0] - 1).astype(np.int64)
    cols = np.minimum((np.arange(width) + 0.5) * flipped.shape[1] / width,
                      flipped.shape[1] - 1).astype(np.int64)
    img = np.repeat(gray[rows][:, cols, None], 3, axis=2)
    t0, t1 = view
    x_of = (np.arange(width) + 0.5) / width * (t1 - t0) + t0  # each column's time
    red, blue = np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])
    span = (x_of >= detection[0]) & (x_of <= detection[1])
    img[:, span] = 0.7 * img[:, span] + 0.3 * red
    for s, e in others:
        span = (x_of >= s) & (x_of <= e)
        img[:, span] = 0.7 * img[:, span] + 0.3 * blue
    for t in ticks:
        col = int((t - t0) / (t1 - t0) * width)
        if 0 <= col < width:
            img[::4, col] = 0.7 * img[::4, col] + 0.3 * blue  # dotted
    pixels = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + pixels[r].tobytes() for r in range(height))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
