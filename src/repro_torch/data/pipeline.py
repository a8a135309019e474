"""Deterministic raw-frame stream (the readout half of the JAX package's
data/pipeline.py; the LM ``TokenPipeline`` is not ported).

``FrameStream`` carries RAW smart-pixel charge frames per sensor — what
the fused frontend ingests (the server's ``submit_frames``).
``batch_at(step, sensor)`` is a pure function of (seed, step, sensor), so
any host can regenerate any sensor's block.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.data.smartpixel import SmartPixelConfig, generate_batch


# --------------------------------------------------------------------------
# Raw-frame stream (the PGPv4 data-plane analogue, frames-first)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrameStreamConfig:
    n_sensors: int = 4
    batch: int = 256            # events per (step, sensor) block
    seed: int = 700
    sensor: SmartPixelConfig = SmartPixelConfig()  # physics knobs only


class FrameStream:
    """Deterministic raw-frame stream for N sensors.

    The readout server ingests RAW frames (B, T, Y, X) + y0 — the fused
    frontend featurizes on device — so the stream carries frames, not
    host-computed features. ``batch_at(step, sensor)`` is a pure function
    of (seed, step, sensor): any host can regenerate any sensor's block,
    the recompute-anywhere contract TokenPipeline makes for tokens.
    (``features``/``label``/``pt`` ride along for calibration and trigger
    -efficiency accounting; the server never sees them.)
    """

    def __init__(self, cfg: FrameStreamConfig = FrameStreamConfig()):
        self.cfg = cfg

    def batch_at(self, step: int, sensor: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert 0 <= sensor < cfg.n_sensors, sensor
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, sensor])
        )
        out = generate_batch(rng, cfg.sensor, cfg.batch, return_frames=True)
        out["y0"] = out["features"][:, -1]
        return out

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Round-robin over sensors: yields (sensor, block) forever."""
        step = 0
        while True:
            for s in range(self.cfg.n_sensors):
                yield s, self.batch_at(step, s)
            step += 1
