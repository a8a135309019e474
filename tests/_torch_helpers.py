"""Shared fixtures-in-functions for the PyTorch-port conformance tests.

Every helper builds the SAME object twice — once with the JAX package
(``repro``), once with the port (``repro_torch``) — from the same seeds,
so a test can hold the two against each other on identical inputs.
"""
import functools

import numpy as np
import torch

import chip_smoke

import repro.core.tmr  # noqa: F401  (registers efpga_28nm_xl)
import repro_torch.core.tmr  # noqa: F401
from repro.core.bdt import GradientBoostedClassifier as JaxGBC
from repro.core.quantize import FixedSpec as JaxSpec
from repro.core.readout import ReadoutChip as JaxChip
from repro.data.smartpixel import SmartPixelConfig as JaxSPC
from repro.data.smartpixel import generate as jax_generate
from repro.data.smartpixel import train_test_split as jax_split
from repro_torch.core.bdt import GradientBoostedClassifier as PortGBC
from repro_torch.core.quantize import FixedSpec as PortSpec
from repro_torch.core.quantize import quantize_raw
from repro_torch.core.readout import ReadoutChip as PortChip
from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
from repro_torch.data.smartpixel import SmartPixelConfig as PortSPC
from repro_torch.data.smartpixel import generate as port_generate
from repro_torch.data.smartpixel import train_test_split as port_split

# The suite runs under several xdist workers: one intra-op thread each
# keeps the port's small CPU tensors from oversubscribing the cores the
# JAX tests share.
torch.set_num_threads(1)

# One small chip recipe per registered fabric (the JAX package's
# tests/test_frontend.py farm): (depth, leaves, n_estimators, spec).
FABRIC_RECIPES = {
    "efpga_130nm": (3, 5, 1, None),
    "efpga_28nm": (4, 8, 1, None),
    "efpga_28nm_xl": (3, 6, 2, (16, 8)),
}


def _train(gbc, chip_cls, spec_cls, spc, generate, split, fabric, depth,
           leaves, n_estimators, spec, seed):
    tr, _ = split(generate(spc(n_events=12_000, seed=seed)))
    clf = gbc(n_estimators=n_estimators, max_depth=depth,
              max_leaf_nodes=leaves, min_samples_leaf=200,
              ).fit(tr["features"], tr["label"])
    kw = {} if spec is None else {"spec": spec_cls(*spec)}
    chip = chip_cls.build(clf, fabric=fabric, **kw)
    chip.calibrate(tr["features"], tr["label"], target_sig_eff=0.95)
    return chip


@functools.lru_cache(maxsize=None)
def chip_pair(fabric: str, seed: int = 5, depth=None, leaves=None):
    """(JAX ReadoutChip, port ReadoutChip) trained identically."""
    d, lv, n_est, spec = FABRIC_RECIPES[fabric]
    d = d if depth is None else depth
    lv = lv if leaves is None else leaves
    jax_chip = _train(JaxGBC, JaxChip, JaxSpec, JaxSPC, jax_generate,
                      jax_split, fabric, d, lv, n_est, spec, seed)
    port_chip = _train(PortGBC, PortChip, PortSpec, PortSPC, port_generate,
                       port_split, fabric, d, lv, n_est, spec, seed)
    return jax_chip, port_chip


@functools.lru_cache(maxsize=None)
def frames(n_events: int = 256, seed: int = 9):
    """Real smart-pixel frames + y0: (n, 8, 13, 21) f32, (n,) f32."""
    dd = jax_generate(JaxSPC(n_events=n_events, seed=seed),
                      return_frames=True)
    return (dd["frames"].astype(np.float32),
            dd["features"][:, 13].astype(np.float32))


def as_int32(words) -> np.ndarray:
    """JAX uint32 words -> the port's int32 bit patterns."""
    return np.asarray(words).astype(np.uint32).view(np.int32)


BDT_ARRAYS = ("featsel", "thr", "root_onehot", "left", "right", "value_hi",
              "value_lo")
BDT_RECIPES = chip_smoke.BDT_RECIPES


def broken_one_hot(packed, x, recipe: str):
    """The arrays of a packed BDT ensemble (JAX's or the port's
    PackedEnsemble on the CPU) as numpy, and raw features ``x``, broken out of the
    one-hot form as ``recipe`` of BDT_RECIPES says (the recipes of
    chip_smoke.synthetic_ensemble, which the card checks too). Returns
    (dict of arrays, x)."""
    arrays = {k: np.asarray(getattr(packed, k)) for k in BDT_ARRAYS}
    return chip_smoke.synthetic_ensemble(np, arrays, np.asarray(x), recipe)


# The served stream of the server tests: 2 chips (a 28 nm and a 130 nm
# one) x 3 FrameStream batches x 64 events, chip 0 hot-swapped for a
# second 130 nm chip before the second batch.
N_BATCHES, N_EVENTS, SWAP_AT = 3, 64, 1


@functools.lru_cache(maxsize=None)
def served_stream():
    """(chip pairs, swap pair, blocks[step][sensor] of frames + y0)."""
    pairs = [chip_pair(f) for f in ("efpga_28nm", "efpga_130nm")]
    swap = chip_pair("efpga_130nm", seed=6)
    fs = FrameStream(FrameStreamConfig(n_sensors=2, batch=N_EVENTS, seed=3))
    blocks = [[fs.batch_at(step, s) for s in range(2)]
              for step in range(N_BATCHES)]
    return pairs, swap, blocks


def jax_features(frames, y0):
    """The JAX featurizer's (n, 14) features of raw frames."""
    from repro.kernels.yprofile import ops as jax_yp

    return np.asarray(jax_yp.yprofile(frames, y0, batch_tile=128))


@functools.lru_cache(maxsize=None)
def served_features():
    """features[step][sensor]: the JAX featurizer's features of the
    served stream's frames, float64 — identical host features for both
    packages' features path."""
    blocks = served_stream()[2]
    return [[jax_features(b["frames"], b["y0"]).astype(np.float64)
             for b in per_sensor] for per_sensor in blocks]


def drive(server, chip_after_swap, blocks, features=None, frames=True):
    """Serve the stream with a frozen clock (batches form only at
    max_batch, reconfigure and flush — identical in both packages): per
    step and sensor the frames block (``frames``) and then the features
    block (``features``), so a micro-batch can mix both kinds. Returns
    ({seq: (chip, score, keep)}, report)."""
    out = []
    for step, per_sensor in enumerate(blocks):
        if step == SWAP_AT:
            out += server.reconfigure(0, chip_after_swap)
        for s, blk in enumerate(per_sensor):
            if frames:
                server.submit_frames(s, blk["frames"], blk["y0"])
            if features is not None:
                server.submit_batch(s, features[step][s])
            out += server.poll()
    out += server.flush()
    return {r.seq: (r.chip, r.score_raw, r.keep) for r in out}, server.report()


def flip_seqs(pairs, swap, blocks, with_features=False):
    """seqs of frame events whose quantized used features differ between
    the two featurizers (summation-order flips, test_torch_yprofile.py),
    numbered as ``drive`` submits them."""
    from repro_torch.kernels.yprofile import ops as port_yp

    flips, seq = set(), 0
    for step, per_sensor in enumerate(blocks):
        for s, blk in enumerate(per_sensor):
            chip = swap if (s == 0 and step >= SWAP_AT) else pairs[s][1]
            used = list(chip.synth.used_features)
            a = port_yp.yprofile(blk["frames"], blk["y0"],
                                 device="cpu").numpy()[:, used]
            b = jax_features(blk["frames"], blk["y0"])[:, used]
            d = (quantize_raw(a, chip.golden.spec)
                 != quantize_raw(b, chip.golden.spec)).any(-1)
            flips |= {seq + i for i in np.flatnonzero(d)}
            seq += len(d) + (N_EVENTS if with_features else 0)
    return flips
