"""Terminal loopback demo — the reference Qt GUI's terminal analog.

The reference demo (app/QFDemoWindow.cpp:201-266) runs a timer loop:
take 4 payload bytes from a cyclic text, map to 16-QAM, OFDM-modulate
with CP, feed TX straight into RX, demap, and render three views —
time-domain Re/Im, the constellation scatter, and the decoded text —
with a 512-sample sliding plot history and a 50-char decoded ring
(QFDemoWindow.cpp:19-27).

This demo reproduces that frame loop with the whole PHY chain inside
ONE jitted program (bytes in → bytes + plot samples out, as real/int
arrays — the planar host boundary), renders the three views as
terminal ASCII panels, and optionally replaces the reference's identity
channel with AWGN so the constellation actually scatters.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.modulation import from_constl, to_constl
from sdr_tpu.ops.channel import awgn, ebno_db_to_noise_var, time_noise_var
from sdr_tpu.ops.ofdm import ofdm_rx, ofdm_tx
from sdr_tpu.utils import SlidingBuffer

# Our own cyclic payload (the reference cycles a fixed greeting string,
# QFDemoWindow.cpp:23-27).
PAYLOAD = (
    b"Hello from sdr_tpu! A JAX-native software-defined-radio stack: "
    b"bits -> QAM -> OFDM -> channel -> OFDM' -> QAM' -> bits. "
)


@dataclasses.dataclass
class DemoConfig:
    n_fft: int = 8          # reference: 8 subcarriers/frame (QFDemoWindow.cpp:210-213)
    cp_len: int = 8         # reference: CP == symbol length (cp=8)
    modulation: Modulation = Modulation.QAM16
    ebno_db: Optional[float] = None  # None → identity loopback like the reference
    history: int = 512      # plot ring size (QFDemoWindow.cpp:20)
    text_ring: int = 50     # decoded text ring (QFDemoWindow.cpp:21)


def make_frame_fn(cfg: DemoConfig):
    """One jitted frame: payload bytes → (decoded bytes, tx re, tx im, points)."""
    bytes_per_frame = cfg.n_fft * cfg.modulation.bits_per_symbol // 8
    if bytes_per_frame < 1:
        raise ValueError("frame smaller than one byte; increase n_fft")

    @jax.jit
    def frame(data: jnp.ndarray, key: jax.Array):
        points = to_constl(data, cfg.modulation)  # (n_fft,)
        tx = ofdm_tx(points, cfg.cp_len)
        if cfg.ebno_db is not None:
            nv = ebno_db_to_noise_var(cfg.ebno_db, cfg.modulation.bits_per_symbol)
            rx = awgn(key, tx, time_noise_var(nv, cfg.n_fft))
        else:
            rx = tx  # the reference's identity "channel" (QFDemoWindow.cpp:213-218)
        rx_points = ofdm_rx(rx, cfg.cp_len)
        decoded = from_constl(rx_points, cfg.modulation)
        return decoded, jnp.real(tx), jnp.imag(tx), jnp.real(rx_points), jnp.imag(rx_points)

    return frame, bytes_per_frame


# --- ASCII rendering -------------------------------------------------------


def render_wave(samples: np.ndarray, width: int = 64, height: int = 7) -> list:
    """Time-domain Re trace as an ASCII panel (newest right)."""
    s = samples[-width:] if len(samples) >= width else samples
    grid = [[" "] * width for _ in range(height)]
    if len(s):
        lim = max(float(np.max(np.abs(s))), 1e-9)
        for x, v in enumerate(s):
            y = int((1.0 - (float(v) / lim + 1.0) / 2.0) * (height - 1) + 0.5)
            grid[min(max(y, 0), height - 1)][x + width - len(s)] = "*"
    return ["".join(row) for row in grid]


def render_constellation(pts: np.ndarray, size: int = 17) -> list:
    """I/Q scatter on a size×size grid spanning ±1.2 (unit-Es points)."""
    grid = [[" "] * size for _ in range(size)]
    mid = size // 2
    for i in range(size):
        grid[i][mid] = "|"
        grid[mid][i] = "-"
    grid[mid][mid] = "+"
    lim = 1.2
    for p in pts:
        x = int((np.real(p) / lim + 1.0) / 2.0 * (size - 1) + 0.5)
        y = int((1.0 - (np.imag(p) / lim + 1.0) / 2.0) * (size - 1) + 0.5)
        if 0 <= x < size and 0 <= y < size:
            grid[y][x] = "o"
    return ["".join(row) for row in grid]


def render_frame_panel(wave_ring, const_pts, text: str) -> str:
    wave = render_wave(np.array(wave_ring.tolist(), dtype=np.float64))
    const = render_constellation(const_pts)
    lines = ["  TX time (Re)" + " " * 52 + "RX constellation"]
    for i in range(max(len(wave), len(const))):
        left = wave[i] if i < len(wave) else " " * 64
        right = const[i] if i < len(const) else ""
        lines.append(f"  {left}  {right}")
    lines.append(f"  decoded: {text!r}")
    return "\n".join(lines)


# --- frame loop ------------------------------------------------------------


class _KeyPoller:
    """Non-blocking single-key reader for an interactive terminal.

    The live-control analog of the reference's speed slider
    (QFDemoWindow.cpp:119-162, 1–200 ms on the running timer): on a
    POSIX tty, '+'/'-' retune the frame interval WHILE the demo runs
    and 'q' quits. On non-tty stdin (tests, pipes, CI) every poll
    returns None and the demo behaves exactly as before.
    """

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdin
        self._active = False
        self._old = None
        try:
            self._fd = self._stream.fileno()
            self._isatty = self._stream.isatty()
        except (AttributeError, OSError, ValueError):
            self._fd = None
            self._isatty = False

    def __enter__(self):
        if self._isatty:
            try:
                import termios
                import tty

                self._old = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                self._active = True
            except Exception:
                self._active = False
        return self

    def __exit__(self, *exc):
        if self._active and self._old is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)
        return False

    def poll(self):
        if not self._active:
            return None
        import select

        r, _, _ = select.select([self._fd], [], [], 0)
        if not r:
            return None
        ch = self._stream.read(1)
        return ch or None


def run_demo(
    cfg: DemoConfig | None = None,
    frames: int = 100,
    interval_ms: float = 50.0,   # the reference's default timer (QFDemoWindow.cpp:152)
    render: bool = True,
    out=sys.stdout,
    snapshot: str | None = None,
    keys=None,
) -> str:
    """Run the loopback frame loop; returns the final decoded text ring.

    ``snapshot``: optional path — after the last frame, render the two
    graphical views the reference's Qt window shows (time-domain Re/Im
    of the sliding plot history, RX constellation scatter) into one
    figure, with the decoded text as the caption.

    Live controls on an interactive terminal (the reference slider's
    analog, clamped to its same 1–200 ms range): '+' speeds the frame
    timer up, '-' slows it down, 'q' stops. ``keys``: optional iterable
    of key events consumed one per frame (the testable injection form
    of the tty poller).
    """
    cfg = cfg or DemoConfig()
    frame, bpf = make_frame_fn(cfg)
    plot_ring = SlidingBuffer(cfg.history)
    text_ring = SlidingBuffer(cfg.text_ring)
    text_ring.push_back(list(b" " * cfg.text_ring))
    key = jax.random.PRNGKey(0)

    pos = 0
    im_ring = SlidingBuffer(cfg.history)
    pts = np.zeros(0, np.complex64)
    key_iter = iter(keys) if keys is not None else None
    with _KeyPoller() as poller:
        for fi in range(frames):
            chunk = bytes(
                PAYLOAD[(pos + i) % len(PAYLOAD)] for i in range(bpf)
            )
            pos = (pos + bpf) % len(PAYLOAD)
            decoded, tx_re, tx_im, rx_re, rx_im = frame(
                jnp.asarray(np.frombuffer(chunk, np.uint8)), jax.random.fold_in(key, fi)
            )
            plot_ring.push_back([float(v) for v in np.asarray(tx_re)])
            im_ring.push_back([float(v) for v in np.asarray(tx_im)])
            text_ring.push_back(list(bytes(np.asarray(decoded))))
            pts = np.asarray(rx_re) + 1j * np.asarray(rx_im)
            if render:
                txt = bytes(b & 0x7F for b in text_ring.tolist()).decode("ascii", "replace")
                out.write("\x1b[2J\x1b[H" if out.isatty() else "")
                out.write(render_frame_panel(plot_ring, pts, txt) + "\n")
                out.write(
                    f"[frame {fi + 1}/{frames}  interval "
                    f"{interval_ms:.0f} ms   +/- speed, q quit]\n"
                )
                out.flush()
            # Live speed control: injected key events first (testable),
            # then the tty poller; clamped to the reference slider's
            # 1-200 ms range (QFDemoWindow.cpp:119-125).
            ch = None
            if key_iter is not None:
                ch = next(key_iter, None)
            if ch is None:
                ch = poller.poll()
            if ch == "+":
                interval_ms = max(1.0, interval_ms / 1.25)
            elif ch == "-":
                interval_ms = min(200.0, max(1.0, interval_ms) * 1.25)
            elif ch == "q":
                break
            if interval_ms and render:
                time.sleep(interval_ms / 1000.0)

    text = bytes(b & 0x7F for b in text_ring.tolist()).decode("ascii", "replace")
    if snapshot:
        snapshot_views(
            np.asarray(plot_ring.tolist(), np.float32),
            np.asarray(im_ring.tolist(), np.float32),
            pts,
            text,
            snapshot,
            cfg.modulation,
        )
    return text


def snapshot_views(
    re_hist: np.ndarray,
    im_hist: np.ndarray,
    const_pts: np.ndarray,
    decoded_text: str,
    path: str,
    mod: Modulation,
) -> str:
    """Figure twin of the reference's three Qt views (QFDemoWindow.cpp:
    29-163): sliding time plot (Re/Im), RX constellation scatter, and
    the decoded text as the caption."""
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("demo --snapshot needs matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_t, ax_c) = plt.subplots(
        1, 2, figsize=(10, 4), dpi=140, width_ratios=[2, 1]
    )
    n = len(re_hist)
    ax_t.plot(np.arange(n), re_hist, lw=1.4, color="#2a78d6", label="Re")
    ax_t.plot(np.arange(n), im_hist, lw=1.4, color="#eb6834", label="Im")
    ax_t.set_title("TX time signal (sliding history)", fontsize=10, loc="left")
    ax_t.legend(frameon=False, fontsize=8)
    ax_c.scatter(
        np.real(const_pts), np.imag(const_pts), s=14, color="#2a78d6",
        alpha=0.8, edgecolors="none",
    )
    ax_c.set_title(f"RX constellation ({mod.value})", fontsize=10, loc="left")
    ax_c.set_aspect("equal")
    for ax in (ax_t, ax_c):
        ax.grid(True, color="#e5e4dd", lw=0.6)
        for sp in ("top", "right"):
            ax.spines[sp].set_visible(False)
        ax.tick_params(colors="#6b6a63", labelsize=8)
    fig.suptitle(f"decoded: “{decoded_text.strip()}”", fontsize=9, y=0.02,
                 va="bottom", color="#1a1a19")
    fig.tight_layout(rect=(0, 0.06, 1, 1))
    fig.savefig(path, facecolor="white")
    plt.close(fig)
    return path
