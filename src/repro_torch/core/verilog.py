"""Structural Verilog export of a synthesized netlist.

The paper's flow ends in "synthesis from C to Verilog firmware"; this
module closes that loop for ours: any Netlist exports to a structural
Verilog module of LUT4/FF primitives, suitable for the FABulous/yosys
toolchain (each LUT4 instance carries its 16-bit INIT parameter, exactly
the configuration frame the bitstream encodes).

The export is also a useful audit artifact: a reader can diff the emitted
module against the resource report (tests assert instance counts match).

A copy of the JAX package's core/verilog.py with its import rewritten (the
port keeps its own pure-Python modules); the emitted text is the same.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.netlist import CONST0, CONST1, Netlist


def _net(n: int) -> str:
    if n == CONST0:
        return "1'b0"
    if n == CONST1:
        return "1'b1"
    return f"n{n}"


def to_verilog(nl: Netlist, module_name: str = "readout_module") -> str:
    lines: List[str] = []
    in_ports = [f"input wire in_{i}" for i in range(len(nl.inputs))]
    out_ports = [f"output wire out_{i}" for i in range(len(nl.outputs))]
    clk = ["input wire clk"] if nl.ffs else []
    lines.append(f"module {module_name} (")
    lines.append("  " + ",\n  ".join(clk + in_ports + out_ports))
    lines.append(");")

    nets = sorted({l.out for l in nl.luts} | {f.q for f in nl.ffs})
    if nets:
        lines.append("  wire " + ", ".join(_net(n) for n in nets) + ";")
    for i, net in enumerate(nl.inputs):
        lines.append(f"  // primary input {i}")
    for i, net in enumerate(nl.inputs):
        lines.append(f"  wire n{net}; assign n{net} = in_{i};")

    for k, l in enumerate(nl.luts):
        ins = ", ".join(f".I{j}({_net(l.inputs[j])})" for j in range(4))
        lines.append(
            f"  LUT4 #(.INIT(16'h{l.table:04X})) lut_{k} "
            f"({ins}, .O({_net(l.out)}));"
        )
    for k, f in enumerate(nl.ffs):
        lines.append(
            f"  FDRE #(.INIT(1'b{f.init})) ff_{k} "
            f"(.C(clk), .D({_net(f.d)}), .Q({_net(f.q)}));"
        )
    for i, net in enumerate(nl.outputs):
        lines.append(f"  assign out_{i} = {_net(net)};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"
