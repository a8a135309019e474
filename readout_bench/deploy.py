"""A deployment from its configuration file.

``configs/<name>.json`` states the deployment: the fabric, the ap_fixed
grid, the sensors, each chip's classifier recipe (the seed of its
training tracks, their number and split, tree limits, signal-efficiency
target) and the server's settings. The trees are the configuration's,
the same in every run: a run's seed makes only the inputs it serves (so
every seed gives the same sizes). The benchmark fits the trees and sets
the cuts with its own copies (``bdt_fit``, ``reference``) and hands them
to the program through its public classes
(``GradientBoostedClassifier``, ``Tree``, ``ReadoutChip``); the netlist,
placement and bitstream are the program's own.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

from readout_bench import bdt_fit, reference, smartpixel

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> Dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one purpose of a run's seed (the frame pool of a
    sensor, the check's feature rows)."""
    ss = np.random.SeedSequence([int(seed), *path])
    return int(ss.generate_state(1, np.uint32)[0])


@dataclasses.dataclass
class Deployment:
    config: Dict
    models: List[reference.Model]      # one a sensor
    cuts: List[int]                    # one a sensor
    chips: List                        # the program's ReadoutChip, a sensor

    @property
    def n_sensors(self) -> int:
        return int(self.config["sensors"])

    def sizes(self) -> List[Dict]:
        """Per sensor, the sizes the yardstick counts from."""
        srv = self.config["server"]
        replicas = 3 if srv["redundancy"] == "tmr" else 1
        out = []
        for m, chip in zip(self.models, self.chips):
            out.append({
                "n_luts": int(chip.config.n_luts),
                "n_inputs": int(chip.config.n_inputs),
                "n_outputs": int(len(chip.config.output_nets)),
                "n_used_features": len(m.used_features()),
                "replicas": replicas,
            })
        return out

    def server_config(self, **over):
        """The program's ServerConfig for this deployment."""
        from repro_torch.launch.readout_server import ServerConfig

        srv = dict(self.config["server"])
        srv.update(over)
        return ServerConfig(
            max_batch=int(srv["max_batch"]),
            max_latency_s=float(srv["max_latency_s"]),
            pipeline_depth=int(srv["pipeline_depth"]),
            layout=srv["layout"], redundancy=srv["redundancy"],
            sparse=bool(srv["sparse"]),
            scrub_interval=srv["scrub_interval"],
            scrub_mode=srv["scrub_mode"],
            threshold_electrons=float(self.config["threshold_electrons"]))


def fit_chip(recipe: Dict, fixed: Dict):
    """One chip's classifier from its recipe: (reference model, cut,
    the fitted trees, f0)."""
    data = smartpixel.generate(smartpixel.SmartPixelConfig(
        n_events=int(recipe["events"]), seed=int(recipe["train_seed"])))
    tr, _ = smartpixel.train_test_split(
        data, test_fraction=float(recipe["test_fraction"]))
    trees, f0 = bdt_fit.fit(
        tr["features"], tr["label"],
        n_estimators=int(recipe["n_estimators"]),
        max_depth=int(recipe["max_depth"]),
        learning_rate=float(recipe["learning_rate"]),
        min_samples_leaf=int(recipe["min_samples_leaf"]),
        n_bins=int(recipe["n_bins"]),
        max_leaf_nodes=recipe["max_leaf_nodes"])
    model = reference.Model(trees, f0, float(recipe["learning_rate"]),
                            int(fixed["width"]), int(fixed["int_bits"]))
    cut = reference.calibrate(model, tr["features"], tr["label"],
                              float(recipe["target_sig_eff"]))
    return model, cut, trees, f0


def program_chip(recipe: Dict, config: Dict, trees, f0: float, cut: int):
    """The program's ReadoutChip for fitted trees and a cut."""
    from repro_torch.core.bdt import GradientBoostedClassifier, Tree
    from repro_torch.core.quantize import FixedSpec
    from repro_torch.core.readout import ReadoutChip

    clf = GradientBoostedClassifier(
        n_estimators=int(recipe["n_estimators"]),
        max_depth=int(recipe["max_depth"]),
        learning_rate=float(recipe["learning_rate"]),
        min_samples_leaf=int(recipe["min_samples_leaf"]),
        n_bins=int(recipe["n_bins"]),
        max_leaf_nodes=recipe["max_leaf_nodes"],
        trees=[Tree(feature=t.feature.copy(), threshold=t.threshold.copy(),
                    children_left=t.children_left.copy(),
                    children_right=t.children_right.copy(),
                    value=t.value.copy()) for t in trees],
        f0=float(f0))
    fx = config["fixed"]
    chip = ReadoutChip.build(clf, fabric=config["fabric"],
                             spec=FixedSpec(width=int(fx["width"]),
                                            int_bits=int(fx["int_bits"])))
    chip.score_threshold_raw = int(cut)
    return chip


def build(config: Dict) -> Deployment:
    """Fit each distinct chip of the configuration and map the chips
    onto the sensors (sensor i runs chip i mod len(chips))."""
    fitted = []
    for recipe in config["chips"]:
        model, cut, trees, f0 = fit_chip(recipe, config["fixed"])
        fitted.append((model, cut,
                       program_chip(recipe, config, trees, f0, cut)))
    per = [fitted[s % len(fitted)] for s in range(int(config["sensors"]))]
    return Deployment(config=config, models=[p[0] for p in per],
                      cuts=[p[1] for p in per], chips=[p[2] for p in per])
