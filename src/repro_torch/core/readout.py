"""End-to-end at-source readout pipeline (paper §5), PyTorch port.

    sensor frames / features  ->  quantize (ap_fixed)  ->  offset-binary bits
    ->  configured eFPGA fabric (bitstream)  ->  score  ->  keep/drop

``ReadoutChip``, ``ScoringBackend`` and ``HostBackend`` are copies of the
JAX package's core/readout.py (numpy; the staged frames path featurizes
with this port's yprofile). ``KernelBackend`` runs the fabric kernels
(selection matmul by default, or bit-sliced) and the fused frontend on a
torch device (CUDA by default); its §5 check (``ReadoutChip.infer_raw``)
also quantizes, encodes and decodes there, where the reference does it on
the host.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.bdt import GradientBoostedClassifier, QuantizedEnsemble
from repro_torch.core.bitstream import decode, encode
from repro_torch.core.fabric import FABRICS, FabricConfig, FabricSim, place_and_route
from repro_torch.core.quantize import AP_FIXED_28_19, FixedSpec
from repro_torch.core.synth import SynthResult, synth_ensemble
from repro_torch.stages import SPANS


# --------------------------------------------------------------------------
# Scoring backends
# --------------------------------------------------------------------------


class ScoringBackend(abc.ABC):
    """Evaluates input bits on a configured fabric.

    The interface point where host-oracle and device execution are
    interchangeable: ReadoutChip and launch/readout_server.py accept either
    a backend name ("host" / "kernel") or an instance, per call. Backends
    cache derived per-config structures (simulators, packed device arrays)
    keyed by config identity, so repeated calls don't re-pack.

    Two entry points, one per ingestion stage:
      * ``score_bits``   — pre-packed fabric input bits (the classic path);
      * ``score_frames`` — RAW charge frames. The base implementation is
        the STAGED pipeline (featurize -> quantize+pack -> score_bits),
        every stage materialized on the host between steps — the oracle
        the fused path is compared against. KernelBackend overrides it
        with the fused single-dispatch frontend (kernels/frontend.py).

    ``ReadoutChip.infer_raw`` (feature rows in, scores out) runs
    ``encode_features`` -> ``score_bits`` -> ``decode_outputs``; the base
    encode and decode are the chip's host ones, and KernelBackend moves
    both to the device.
    """

    name: str = "?"

    @abc.abstractmethod
    def score_bits(self, config: FabricConfig, bits: np.ndarray) -> np.ndarray:
        """(B, n_inputs) 0/1 -> (B, n_outputs) uint8 output bits."""

    def encode_features(self, chip: "ReadoutChip", X: np.ndarray):
        """features (n, 14) float -> the input bits ``score_bits`` takes:
        the chip's host encode."""
        return chip.encode_features(X)

    def decode_outputs(self, chip: "ReadoutChip", outs) -> np.ndarray:
        """``score_bits``'s output bits -> (n,) raw int64 scores: the
        chip's host decode."""
        return chip.synth.decode_outputs(outs)

    # torch device of the featurizer (None = CUDA), resolved on first use
    device = None

    def score_frames(
        self,
        chip: "ReadoutChip",
        frames: np.ndarray,
        y0: np.ndarray,
        threshold_electrons: float = 800.0,
    ) -> np.ndarray:
        """(B, T, Y, X) charge + (B,) y0 -> (B,) raw integer scores.

        Staged path: the featurizer runs on ``self.device`` (the one float
        stage: the same kernel or plain twin as the fused path, and the
        same per-event sum order), then numpy quantize + offset-binary
        packing + the backend's own bit scorer.
        """
        from repro_torch.kernels.yprofile import ops as yp_ops

        feats = yp_ops.yprofile(
            frames, y0, threshold_electrons=threshold_electrons,
            device=self.device).cpu().numpy()
        bits = chip.encode_features(feats)
        outs = self.score_bits(chip.config, bits)
        return chip.synth.decode_outputs(outs)


class _ConfigCache:
    """Small LRU of per-config derived structures.

    Keyed by id() but each entry pins the config object, so entries can't
    go stale through id reuse; bounded so a long-running service that
    keeps reconfiguring doesn't pin every packed fabric it ever saw.
    """

    def __init__(self, build, max_entries: int = 8):
        self._build = build
        self._max = max_entries
        self._entries: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )

    def get(self, config: FabricConfig, build=None):
        """``build`` overrides the default builder for this miss — used
        when the derived structure needs more context than the config
        (e.g. a chip's encode plan for the fused frontend)."""
        entry = self._entries.get(id(config))
        if entry is not None and entry[0] is config:
            self._entries.move_to_end(id(config))
            return entry[1]
        derived = (build or self._build)(config)
        self._entries[id(config)] = (config, derived)
        self._entries.move_to_end(id(config))
        while len(self._entries) > self._max:
            self._entries.popitem(last=False)
        return derived


class HostBackend(ScoringBackend):
    """numpy FabricSim — the bit-exact oracle."""

    name = "host"

    def __init__(self, device=None):
        self.device = device
        self._sims = _ConfigCache(FabricSim)

    def score_bits(self, config: FabricConfig, bits: np.ndarray) -> np.ndarray:
        outs, _ = self._sims.get(config).run(bits)
        return np.asarray(outs)


class KernelBackend(ScoringBackend):
    """The fabric kernels and the fused frontend on a torch device (None =
    CUDA).

    ``layout="matmul"`` (default, as in the reference) evaluates through
    the selection-matmul kernels; ``band`` picks their routing layout when
    packing: None bands it whenever the config's fan-in reach makes that
    cheaper, True/False force it. ``layout="bitsliced"`` runs the
    32-events-per-word evaluator, where the band is a reach envelope.
    """

    name = "kernel"

    def __init__(self, batch_tile: int = 128, band: Optional[bool] = None,
                 layout: str = "matmul", device=None):
        from repro_torch.kernels.lut_eval import ops as lut_ops

        lut_ops._check_layout(layout)
        self.batch_tile = batch_tile
        self.band = band
        self.layout = layout
        self.device = device

        def build(config):
            return lut_ops.pack_fabric(config, band=self.band,
                                       layout=self.layout,
                                       device=self.device)

        self._packed = _ConfigCache(build)
        self._frontends = _ConfigCache(None)
        self._check_plans = _ConfigCache(None)

    def score_bits(self, config: FabricConfig, bits):
        """(B, n_inputs) 0/1 -> (B, n_outputs) uint8 output bits: a host
        array for host bits (the copy back is the span
        ``readout.check.d2h``), a tensor left on the device for bits that
        are a device tensor (``encode_features``'s)."""
        from repro_torch.kernels.lut_eval import ops as lut_ops

        out = lut_ops.fabric_eval(
            self._packed.get(config), bits, batch_tile=self.batch_tile)
        if isinstance(bits, torch.Tensor):
            return out
        with SPANS.time("check.d2h"):
            return out.cpu().numpy()

    def _check_plan(self, chip: "ReadoutChip") -> "_CheckPlan":
        def build(_config):
            dev = self._packed.get(chip.config).device
            W = chip.synth.spec.width
            return _CheckPlan(
                used=torch.as_tensor(chip.synth.used_features,
                                     dtype=torch.int32, device=dev),
                weights=torch.as_tensor(np.int64(1) << np.arange(W),
                                        device=dev))

        return self._check_plans.get(chip.config, build=build)

    def encode_features(self, chip: "ReadoutChip",
                        X: np.ndarray) -> torch.Tensor:
        """features (n, 14) -> (n, n_inputs) int32 input bits on the
        device: the rows cross as they are (float32 or float64; another
        type widened to float64 first), in the span
        ``readout.check.h2d``, and kernels/feature_encode.py quantizes and
        encodes them there, into the plan's bits buffer (the bits of the
        chip's last chunk; a longer chunk grows it)."""
        from repro_torch.kernels import feature_encode

        plan = self._check_plan(chip)
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        dev = plan.used.device
        with SPANS.time("check.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
        n, cols = len(X), plan.used.numel() * chip.synth.spec.width
        if plan.bits is None or plan.bits.shape[0] < n:
            plan.bits = torch.empty((n, cols), dtype=torch.int32, device=dev)
        return feature_encode.encode_rows(x, plan.used, chip.synth.spec,
                                          out=plan.bits[:n])

    def decode_outputs(self, chip: "ReadoutChip", outs) -> np.ndarray:
        """(n, W) output bits, a device tensor or a host array -> (n,) raw
        int64 scores, decoded on the device exactly as
        ``SynthResult.decode_outputs`` does and copied back in one copy
        (the span ``readout.check.d2h``)."""
        plan = self._check_plan(chip)
        o = torch.as_tensor(outs, device=plan.used.device).to(torch.int64)
        u = (o * plan.weights).sum(-1)
        sign = 1 << (chip.synth.spec.width - 1)
        score = torch.where(u >= sign, u - (sign << 1), u)
        with SPANS.time("check.d2h"):
            return score.cpu().numpy()

    def score_frames(
        self,
        chip: "ReadoutChip",
        frames: np.ndarray,
        y0: np.ndarray,
        threshold_electrons: float = 800.0,
    ) -> np.ndarray:
        """FUSED path: frames -> features -> bits -> score in one device
        pass (kernels/frontend.py), no host materialization between
        stages."""
        from repro_torch.kernels import frontend as fe

        # cached per (config identity, featurizer threshold)
        by_thr = self._frontends.get(chip.config, build=lambda _cfg: {})
        front = by_thr.get(float(threshold_electrons))
        if front is None:
            front = fe.pack_frontend(
                [chip.config], [chip.frontend_spec()], band=self.band,
                layout=self.layout, batch_tile=self.batch_tile,
                threshold_electrons=threshold_electrons, device=self.device)
            by_thr[float(threshold_electrons)] = front
        score, _keep = front.score_frames(
            np.asarray(frames)[None], np.asarray(y0)[None])
        return score[0].cpu().numpy().astype(np.int64)


@dataclasses.dataclass
class _CheckPlan:
    """A chip's §5 check on KernelBackend's device: the used feature
    columns (int32), the decode's bit weights 2**w (int64) and the
    encode's (rows, n_inputs) int32 bits buffer, reused chunk after chunk
    (stream order keeps a chunk's bits until its fabric pass has read
    them)."""

    used: torch.Tensor
    weights: torch.Tensor
    bits: Optional[torch.Tensor] = None


_BACKENDS: Dict[str, ScoringBackend] = {}


def get_backend(backend: Union[str, ScoringBackend]) -> ScoringBackend:
    """Resolve "host"/"kernel" to a shared cached instance; pass instances
    through unchanged."""
    if isinstance(backend, ScoringBackend):
        return backend
    if backend not in ("host", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend not in _BACKENDS:
        _BACKENDS[backend] = (
            HostBackend() if backend == "host" else KernelBackend()
        )
    return _BACKENDS[backend]


@dataclasses.dataclass
class ReadoutChip:
    """A configured eFPGA acting as the front-end classifier ASIC."""

    synth: SynthResult
    golden: QuantizedEnsemble
    config: FabricConfig
    bitstream: bytes
    score_threshold_raw: int  # reject if score_raw > threshold_raw

    @classmethod
    def build(
        cls,
        clf: GradientBoostedClassifier,
        fabric: str = "efpga_28nm",
        spec: FixedSpec = AP_FIXED_28_19,
        score_threshold: float = 0.5,
        adder: str = "tree",
    ) -> "ReadoutChip":
        """``adder`` is the ensemble summation structure: "tree" (default,
        shallow carry-select reduction — faster to evaluate, ~2.5x the
        adder LUTs) or "ripple" (minimal area, for near-capacity designs).
        Single trees have no adders, so the paper's chip is unaffected."""
        golden = clf.quantized(spec)
        synth = synth_ensemble(golden, adder=adder)
        config = place_and_route(synth.netlist, FABRICS[fabric])
        bs = encode(config)
        # thresholding happens in logit space on the integer grid
        logit = float(np.log(score_threshold / (1 - score_threshold)))
        thr_raw = int(np.floor(logit * spec.scale))
        # reload through the bitstream (the "program the chip" step)
        return cls(
            synth=synth,
            golden=golden,
            config=decode(bs),
            bitstream=bs,
            score_threshold_raw=thr_raw,
        )

    # ---------------------------------------------------------------- run
    def encode_features(self, X: np.ndarray) -> np.ndarray:
        """features (n, 14) float -> fabric input bits (host featurization)."""
        return self.synth.encode_inputs(self.golden.quantize_features(X))

    def infer_raw(
        self, X: np.ndarray, backend: Union[str, ScoringBackend] = "host"
    ) -> np.ndarray:
        """features (n, 14) float -> raw integer scores, via the fabric:
        the backend's encode, ``score_bits`` and decode (on
        KernelBackend, all three on the device). While a profiler
        records, the encode and decode are the spans
        ``readout.check.encode`` and ``readout.check.decode``."""
        be = get_backend(backend)
        with SPANS.time("check.encode"):
            bits = be.encode_features(self, X)
        outs = be.score_bits(self.config, bits)
        with SPANS.time("check.decode"):
            return be.decode_outputs(self, outs)

    def frontend_spec(self):
        """This chip's fused-frontend encode/decode contract
        (kernels.frontend.ChipFrontendSpec): which features feed the
        fabric, on which ap_fixed grid, with which trigger cut."""
        from repro_torch.kernels.frontend import ChipFrontendSpec

        return ChipFrontendSpec(
            used_features=tuple(self.synth.used_features),
            spec=self.golden.spec,
            threshold_raw=int(self.score_threshold_raw),
        )

    def infer_from_frames(self, frames: np.ndarray, y0: np.ndarray,
                          backend: Union[str, ScoringBackend] = "kernel") -> np.ndarray:
        """Full front end: raw charge frames -> raw integer scores.

        Routed through the backend's ``score_frames`` pipeline: the
        kernel backend runs the FUSED single-dispatch frontend
        (frames -> features -> bits -> score with no host round-trip);
        the host backend runs the same pipeline staged, each stage
        materialized — the bit-exact comparison oracle.
        """
        return get_backend(backend).score_frames(self, frames, y0)

    def infer_proba(self, X: np.ndarray,
                    backend: Union[str, ScoringBackend] = "host") -> np.ndarray:
        raw = self.infer_raw(X, backend)
        return 1.0 / (1.0 + np.exp(-raw / self.golden.spec.scale))

    def keep_mask(self, X: np.ndarray,
                  backend: Union[str, ScoringBackend] = "host") -> np.ndarray:
        """True = retain (not classified as pileup)."""
        return self.infer_raw(X, backend) <= self.score_threshold_raw

    # ----------------------------------------------------------- accounting
    def data_reduction_report(
        self,
        X: np.ndarray,
        is_pileup: np.ndarray,
        bits_per_hit: int = 256,
        hit_rate_hz: float = 40e6,
        backend: Union[str, ScoringBackend] = "host",
    ) -> Dict[str, float]:
        keep = self.keep_mask(X, backend)
        is_pu = is_pileup.astype(bool)
        frac_kept = float(keep.mean())
        return {
            "n": float(len(X)),
            "fraction_kept": frac_kept,
            "signal_efficiency": float(keep[~is_pu].mean()) if (~is_pu).any() else 1.0,
            "background_rejection": float((~keep)[is_pu].mean()) if is_pu.any() else 0.0,
            "link_rate_in_gbps": hit_rate_hz * bits_per_hit / 1e9,
            "link_rate_out_gbps": hit_rate_hz * bits_per_hit * frac_kept / 1e9,
            "data_reduction_factor": 1.0 / max(frac_kept, 1e-9),
        }

    def calibrate(self, X_val: np.ndarray, is_pileup_val: np.ndarray,
                  target_sig_eff: float = 0.975) -> Dict[str, float]:
        """Pick the reject threshold achieving ~target signal efficiency on
        a validation set (integer-domain, so the deployed cut is exact)."""
        from repro_torch.core.bdt import operating_point_at_signal_eff

        raw = self.golden.decision_function_raw(
            self.golden.quantize_features(X_val))
        thr, se, br = operating_point_at_signal_eff(
            raw.astype(np.float64), is_pileup_val, target_sig_eff)
        self.score_threshold_raw = int(thr)
        return {"threshold_raw": int(thr), "signal_efficiency": se,
                "background_rejection": br}

    def verify_vs_golden(self, X: np.ndarray,
                         backend: Union[str, ScoringBackend] = "host") -> Dict[str, float]:
        """The 100%-accuracy check of §5, through bitstream + fabric."""
        X_raw = self.golden.quantize_features(X)
        got = self.infer_raw(X, backend)
        want = self.golden.decision_function_raw(X_raw)
        return {
            "n": float(len(X)),
            "n_match": float((got == want).sum()),
            "accuracy": float((got == want).mean()),
        }
