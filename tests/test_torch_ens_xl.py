"""A boosted ensemble on the larger 28 nm fabric (``efpga_28nm_xl``), on
the CPU.

The fabric registers where fabrics live (``core.fabric.FABRICS``), so a
chip builds on it in an interpreter that has imported nothing but
``repro_torch.core.readout`` (``core.tmr``, its former home, blocked).
K2's walk takes the first of its three forms whose block fits in shared
memory: the staged walk on the served 4-chip TMR stack, the split walk
where one replica's block still fits, the streamed walk where only a
word's net buffer does (the benchmark's 5-tree ensemble: 33 levels x 640
LUTs, a 384-word input segment), and a refusal past it. Small boosted
ensembles on the fabric, built identically by both packages, are served
under TMR with sparse egress by the port's server on the CPU twins and
by the JAX package's, on the same frames and features: the kept events,
their scores and the report's counters agree.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.lut_eval import bitsliced as bs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fabric_registers_without_core_tmr():
    code = (
        "import importlib.abc, json, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name == 'repro_torch.core.tmr':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.core.readout import ReadoutChip\n"
        "from repro_torch.core.fabric import FABRICS\n"
        "from repro_torch.core.bdt import GradientBoostedClassifier\n"
        "from repro_torch.data.smartpixel import SmartPixelConfig, generate\n"
        "d = generate(SmartPixelConfig(n_events=3000, seed=7))\n"
        "clf = GradientBoostedClassifier(n_estimators=2, max_depth=3,\n"
        "    max_leaf_nodes=6, min_samples_leaf=200).fit(d['features'],\n"
        "                                                d['label'])\n"
        "chip = ReadoutChip.build(clf, fabric='efpga_28nm_xl')\n"
        "X = d['features'][:64]\n"
        "print(json.dumps(['efpga_28nm_xl' in FABRICS,\n"
        "    chip.config.fabric_name, chip.config.n_luts,\n"
        "    chip.verify_vs_golden(X)['accuracy'] == 1.0,\n"
        "    'repro_torch.core.tmr' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    registered, name, n_luts, exact, tmr_loaded = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert registered and name == "efpga_28nm_xl" and n_luts > 0
    assert exact and not tmr_loaded


def test_core_tmr_still_names_the_fabric():
    from repro_torch.core import fabric, tmr

    assert tmr.FABRIC_28NM_XL is fabric.FABRICS["efpga_28nm_xl"]
    assert tmr.FABRIC_28NM_XL.n_logic_cells == 1792


# (replicas, in_seg, levels, m_pad) -> (form, words a block) at 64 words
# a chip (2,048 events), 4 chips, 132 SMs; None: refused
ENVELOPES = {
    "tmr28_stream": ((3, 256, 13, 128), ("staged", 2)),
    "ens4_28x512": ((3, 384, 28, 512), ("split", 1)),
    "ens5xl_plain": ((1, 384, 33, 640), ("streamed", 2)),
    "ens5xl_tmr": ((3, 384, 33, 640), ("streamed", 2)),
    "streamed_last": ((3, 384, 80, 640), ("streamed", 1)),
    "past_streamed_tmr": ((3, 384, 81, 640), None),
    "past_streamed_plain": ((1, 384, 81, 640), None),
}


@pytest.mark.parametrize("case", sorted(ENVELOPES))
def test_walk_form_tile_and_shared_memory(case):
    (R, in_seg, L, M), want = ENVELOPES[case]
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            bs.walk_path(R, in_seg, L, M)
        with pytest.raises(ValueError, match="shared memory"):
            bs.word_tile(R, in_seg, L, M, 64, n_chips=4, n_sms=132)
        return
    form, tile = want
    assert bs.walk_path(R, in_seg, L, M) == form
    assert bs.word_tile(R, in_seg, L, M, 64, n_chips=4, n_sms=132) == tile
    smem = bs.smem_bytes(R, in_seg, L, M, tile)
    assert smem <= build.SMEM_LIMIT_BYTES
    if form == "streamed":
        # a ring of RING levels' descriptors (10 B a LUT slot) and the
        # net buffer of the tile's words, nothing of the other levels
        assert smem == bs.RING * M * 10 + tile * (in_seg + L * M) * 4
        assert bs.smem_bytes(R, in_seg, L, M, tile + 1) \
            > build.SMEM_LIMIT_BYTES
        # neither other form holds one word of this envelope
        assert bs._block_bytes(1, in_seg, L, M, 1) > build.SMEM_LIMIT_BYTES


def test_ens5xl_block_and_scratch_bytes():
    args = (384, 33, 640)
    # the split walk's one-replica block for one word: all 33 levels'
    # descriptors (211,200 B) and the word's net buffer (86,016 B)
    assert bs._chip_desc_bytes(1, 33, 640) == 211_200
    assert bs._block_bytes(1, *args, 1) == 297_220
    assert bs.smem_bytes(3, *args, 2) == 25_600 + 2 * 86_016
    # every replica row's descriptors, a level at a stride of 640 slots
    assert bs.scratch_bytes(4, 3, 33, 640) == 12 * 211_200
    # a level stride that is not a whole number of 16-byte mask pieces
    # is rounded up in the streamed layout only
    assert bs._level_stride(641) == 648
    assert bs.scratch_bytes(1, 1, 33, 641) == 33 * 648 * 10


# the served stream: 2 sensors x 3 FrameStream batches x 128 events
XL_STEPS, XL_EVENTS = 3, 128


@pytest.fixture(scope="module")
def xl_served():
    """Two boosted ensembles on efpga_28nm_xl (3 rounds, depth 4, 8
    leaves, ap_fixed<28,19>) built identically by both packages, the
    stream's blocks and the JAX featurizer's features of them, and the
    JAX server's run of each ingest: host backend (its oracle, which
    the JAX package holds bit-identical to its kernel backend), TMR,
    sparse egress, steered scrub every 2 dispatches, a frozen clock."""
    pytest.importorskip("jax")
    from repro.launch.readout_server import ReadoutServer as JaxServer
    from repro.launch.readout_server import ServerConfig as JaxConfig
    from repro_torch.data.pipeline import FrameStream, FrameStreamConfig
    from tests import _torch_helpers as th

    pairs = [th._train(th.JaxGBC, th.JaxChip, th.JaxSpec, th.JaxSPC,
                       th.jax_generate, th.jax_split, "efpga_28nm_xl", 4, 8,
                       3, None, seed)
             for seed in (31, 32)]
    port = [th._train(th.PortGBC, th.PortChip, th.PortSpec, th.PortSPC,
                      th.port_generate, th.port_split, "efpga_28nm_xl", 4,
                      8, 3, None, seed)
            for seed in (31, 32)]
    fs = FrameStream(FrameStreamConfig(n_sensors=2, batch=XL_EVENTS,
                                       seed=3))
    blocks = [[fs.batch_at(step, s) for s in range(2)]
              for step in range(XL_STEPS)]
    feats = [[th.jax_features(b["frames"], b["y0"]).astype(np.float64)
              for b in per] for per in blocks]
    runs = {ingest: _serve_xl(JaxServer(pairs, _xl_cfg(JaxConfig,
                                                       backend="host"),
                                        clock=lambda: 0.0),
                              blocks, feats, ingest)
            for ingest in ("frames", "features")}
    return port, blocks, feats, runs


def _xl_cfg(cls, **kw):
    return cls(redundancy="tmr", sparse=True, scrub_interval=2,
               max_batch=256, **kw)


def _serve_xl(server, blocks, feats, ingest):
    """Every step's sensor blocks (raw frames, or their JAX features
    through submit_batch), a poll after each, then a flush: ({seq:
    (chip, score, keep)}, report)."""
    out = []
    for step, per in enumerate(blocks):
        for s, blk in enumerate(per):
            if ingest == "frames":
                server.submit_frames(s, blk["frames"], blk["y0"])
            else:
                server.submit_batch(s, feats[step][s])
            out += server.poll()
    out += server.flush()
    return {r.seq: (r.chip, r.score_raw, r.keep) for r in out}, \
        server.report()


def _xl_flips(chips, blocks):
    """seqs of frame events whose quantized used features differ between
    the port's and the JAX featurizer (summation order), numbered as
    ``_serve_xl`` submits them."""
    from repro_torch.core.quantize import quantize_raw
    from repro_torch.kernels.yprofile import ops as yp_ops
    from tests._torch_helpers import jax_features

    out, seq = set(), 0
    for per in blocks:
        for s, blk in enumerate(per):
            used = list(chips[s].synth.used_features)
            a = yp_ops.yprofile(blk["frames"], blk["y0"],
                                device="cpu").numpy()[:, used]
            b = jax_features(blk["frames"], blk["y0"])[:, used]
            d = (quantize_raw(a, chips[s].golden.spec)
                 != quantize_raw(b, chips[s].golden.spec)).any(-1)
            out |= {seq + i for i in np.flatnonzero(d)}
            seq += len(d)
    return out


@pytest.mark.parametrize("ingest", ["frames", "features"])
def test_served_xl_ensemble_under_tmr_with_sparse_egress(xl_served, ingest):
    """The port's server on the CPU twins against the JAX server on the
    same ensembles and stream: the kept events, their scores and the
    report's counters (events in and kept a chip, disagreements, scrub
    steps and detections, link bytes) equal, exactly on features and up
    to featurizer flips on frames."""
    from repro_torch.launch.readout_server import (ReadoutServer,
                                                   ServerConfig)

    chips, blocks, feats, runs = xl_served
    want, jrep = runs[ingest]
    server = ReadoutServer(chips, _xl_cfg(ServerConfig), clock=lambda: 0.0,
                           device="cpu")
    stack = server._path.stack
    assert stack.n_levels > 13 and stack.n_replicas == 3
    got, rep = _serve_xl(server, blocks, feats, ingest)
    n_all = XL_STEPS * 2 * XL_EVENTS
    assert all(v[2] for v in got.values()) and 0 < len(got) < n_all
    diff = {q for q in set(got) | set(want) if got.get(q) != want.get(q)}
    if ingest == "features":
        assert not diff
    else:
        flips = _xl_flips(chips, blocks)
        assert diff <= flips and len(flips) <= 0.01 * n_all
    for c, (pc, jc) in enumerate(zip(rep["per_chip"], jrep["per_chip"])):
        assert pc["n_in"] == jc["n_in"] == XL_STEPS * XL_EVENTS
        assert pc["seu_disagreements"] == jc["seu_disagreements"]
        moved = (sum(1 for q in diff if q in got and got[q][0] == c)
                 - sum(1 for q in diff if q in want and want[q][0] == c))
        assert pc["n_kept"] - jc["n_kept"] == moved
    assert rep["seu_disagreement_total"] == jrep["seu_disagreement_total"]
    assert rep["seu_disagreement_total"] == 0
    for k in ("steps", "detections"):
        assert rep["scrub"][k] == jrep["scrub"][k], k
    assert rep["scrub"]["steps"] > 0 and rep["scrub"]["detections"] == 0
    if not diff:
        assert rep["link_bytes"] == jrep["link_bytes"]
