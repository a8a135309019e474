"""Deterministic, shard-recomputable data pipelines, LM tokens and raw
frames (the port of the JAX package's data/pipeline.py).

Every (step, shard) batch is a pure function of (seed, step, shard): no
pipeline state to checkpoint, any host can recompute any other host's
shard after a failure, and changing the shard count is re-indexing.

``TokenPipeline`` gives the LM trainer its token batches, numpy arrays
bit for bit the reference's. Two synthetic corpora:
  * "markov": a fixed random Markov chain over the vocab (learnable: the
    loss can fall to log(branching) nats);
  * "uniform": i.i.d. tokens (for shape and throughput tests).

``FrameStream`` carries RAW smart-pixel charge frames per sensor — what
the fused frontend ingests (the server's ``submit_frames``).
``batch_at(step, sensor)`` has the same (seed, step, shard)-pure
contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.smartpixel import SmartPixelConfig, generate_batch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "markov"       # markov | uniform
    branching: int = 4         # out-degree of the markov chain


def _chain(vocab: int, branching: int, seed: int) -> np.ndarray:
    """Fixed successor table: (vocab, branching) int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (vocab, branching), dtype=np.int32)


class TokenPipeline:
    """Token batches {"tokens", "labels"} (b_local, seq_len) int32 numpy
    arrays, labels the next tokens; ``global_batch`` splits evenly over
    ``n_shards``."""

    def __init__(self, cfg: DataConfig, n_shards: int = 1, shard: int = 0):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_shards} shards")
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard = shard
        self._succ = (_chain(cfg.vocab, cfg.branching, cfg.seed)
                      if cfg.kind == "markov" else None)

    def batch_at(self, step: int, shard: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """The batch for (step, shard) — pure function, recomputable
        anywhere."""
        cfg = self.cfg
        shard = self.shard if shard is None else shard
        b_local = cfg.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab, (b_local, cfg.seq_len + 1),
                                dtype=np.int32)
        else:
            toks = np.empty((b_local, cfg.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, cfg.vocab, b_local)
            choices = rng.integers(0, cfg.branching, (b_local, cfg.seq_len))
            for t in range(cfg.seq_len):
                toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def entropy_bound_nats(self) -> float:
        """Lower bound on achievable loss (log branching for markov)."""
        if self.cfg.kind == "uniform":
            return float(np.log(self.cfg.vocab))
        return float(np.log(self.cfg.branching))


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
