"""Analytical power/area model calibrated to the paper's measurements.

No silicon in this container, so Fig. 5 (130nm) and Fig. 10 (28nm) are
reproduced by a classic digital power model

    P_rail(f) = P_static + k_dyn * f          (k_dyn ∝ C_eff * V^2)

with coefficients calibrated to the paper's stated relations:

  * §3: "a factor of 2.8 reduction in core power consumption at 100 MHz";
  * §4.4.2: "the 28nm ASIC's core voltage rail power consumption at a
    125 MHz clock is approximately one third that of the 130nm ASIC";
  * rails: 130nm core +1.2V, IO +1.2V; 28nm core +0.9V, IO +1.8V;
  * valid ranges: 130nm measured 10–125 MHz (SUGOI readback degraded above
    74 MHz — the slow output driver, slew 38/32 ns); 28nm 10–250 MHz
    (stopped by FPGA-side PGPv4 CRC timing, not the ASIC).

With the chosen coefficients: ratio(100 MHz) = 2.85 ≈ 2.8 and
ratio(125 MHz) = 2.86 ≈ "approximately one third". Area efficiency uses the
fabric macro areas (die sizes are 5x5 mm vs 1x1 mm, Figs. 3/8) calibrated so
the §3 "factor of 21 improvement in area efficiency" is reproduced.

A copy of the JAX package's core/power.py (pure Python; the port keeps its
own): the same coefficients and the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class RailModel:
    static_mw: float
    dyn_mw_per_mhz: float
    voltage: float

    def power_mw(self, f_mhz: float) -> float:
        return self.static_mw + self.dyn_mw_per_mhz * f_mhz


@dataclasses.dataclass(frozen=True)
class NodeModel:
    name: str
    core: RailModel
    io: RailModel
    f_min_mhz: float
    f_max_mhz: float
    readback_limit_mhz: float  # SUGOI readback ceiling (130nm driver bug)
    die_mm2: float
    fabric_macro_mm2: float
    equiv_logic: float  # logic cells + weighted DSP/RegFile


# Equivalent-logic weights: LUT4AB cell = 1, DSP slice = 20, RegFile tile = 16.
_EQ_130 = 384 + 4 * 20 + 4 * 16   # = 528
_EQ_28 = 448 + 4 * 20             # = 528

NODE_130NM = NodeModel(
    name="130nm",
    core=RailModel(static_mw=2.0, dyn_mw_per_mhz=0.75, voltage=1.2),
    io=RailModel(static_mw=1.5, dyn_mw_per_mhz=0.30, voltage=1.2),
    f_min_mhz=10.0,
    f_max_mhz=125.0,           # P&R timing constraint (§2.4.2)
    readback_limit_mhz=74.0,   # output-driver slew bug (§2.4.2)
    die_mm2=25.0,              # 5 mm x 5 mm (Fig. 3)
    fabric_macro_mm2=13.23,
    equiv_logic=_EQ_130,
)

NODE_28NM = NodeModel(
    name="28nm",
    core=RailModel(static_mw=1.0, dyn_mw_per_mhz=0.26, voltage=0.9),
    io=RailModel(static_mw=1.0, dyn_mw_per_mhz=0.12, voltage=1.8),
    f_min_mhz=10.0,
    f_max_mhz=250.0,           # FPGA-side PGPv4 CRC timing, not the ASIC (§4.4.2)
    readback_limit_mhz=250.0,
    die_mm2=1.0,               # 1 mm x 1 mm (Fig. 8)
    fabric_macro_mm2=0.63,
    equiv_logic=_EQ_28,
)

NODES: Dict[str, NodeModel] = {"130nm": NODE_130NM, "28nm": NODE_28NM}


def power_mw(node: str, f_mhz: float, rail: str = "core") -> float:
    m = NODES[node]
    r = m.core if rail == "core" else m.io
    return r.power_mw(f_mhz)


def total_power_mw(node: str, f_mhz: float) -> float:
    return power_mw(node, f_mhz, "core") + power_mw(node, f_mhz, "io")


def sweep(node: str, freqs_mhz: List[float] | None = None) -> List[Dict[str, float]]:
    """Reproduce Fig. 5 / Fig. 10: power vs clock frequency per rail."""
    m = NODES[node]
    if freqs_mhz is None:
        freqs_mhz = [10, 25, 50, 74, 100, 125] if node == "130nm" else [
            10, 25, 50, 100, 125, 150, 200, 250]
    rows = []
    for f in freqs_mhz:
        rows.append({
            "f_mhz": float(f),
            "core_mw": power_mw(node, f, "core"),
            "io_mw": power_mw(node, f, "io"),
            "total_mw": total_power_mw(node, f),
            "sugoi_readback_ok": float(f <= m.readback_limit_mhz),
        })
    return rows


def core_power_ratio(f_mhz: float) -> float:
    """130nm / 28nm core power at a given clock (paper: 2.8x at 100 MHz)."""
    return power_mw("130nm", f_mhz, "core") / power_mw("28nm", f_mhz, "core")


def area_efficiency_ratio() -> float:
    """Equivalent logic per mm^2, 28nm over 130nm (paper §3: factor ~21)."""
    e130 = NODE_130NM.equiv_logic / NODE_130NM.fabric_macro_mm2
    e28 = NODE_28NM.equiv_logic / NODE_28NM.fabric_macro_mm2
    return e28 / e130


def energy_per_inference_nj(node: str, f_mhz: float, cycles: int = 1) -> float:
    """Core energy per fabric evaluation at clock f (nJ) — used by the
    readout benchmarks to compare against off-detector transmission cost."""
    p_w = power_mw(node, f_mhz, "core") * 1e-3
    t_s = cycles / (f_mhz * 1e6)
    return p_w * t_s * 1e9
