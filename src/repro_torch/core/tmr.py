# Copy of repro/core/tmr.py with imports rewritten: the PyTorch port keeps its own
# numpy modules and imports nothing of the JAX package.
"""Triple modular redundancy (paper §5 future work).

"Additionally, any readout ASIC in a collider inner system will need to be
insensitive to radiation-induced issues such as single-event effects. The
implementation of triple modular redundancy (TMR) in FABulous could open up
the broad usage of eFPGAs in collider readout scenarios."

``triplicate`` transforms any netlist into its TMR form: three independent
replicas of all logic + per-output majority voters (vote = ab|ac|bc, one
LUT3 per output bit). FFs are triplicated too, so a single-event upset
(SEU) in ONE replica's configuration or state cannot corrupt any output.

Cost: 3x logic + one voter LUT per output — which is exactly why the paper
calls for a larger next-generation fabric: the 294-LUT BDT needs ~900 LUTs
under TMR, far beyond the 448-cell 28nm chip. ``FABRIC_28NM_XL`` models
that next-generation part (4x the logic columns of the fabricated 28nm
chip, same tile library) so the TMR readout chip is buildable end-to-end.

SEU injection (``inject_seu``) flips one configuration bit (a LUT truth
table entry) in a decoded bitstream — the standard fault model for
configuration-memory upsets.

Two TMR granularities live here:

  * ``triplicate`` — netlist-level TMR (3x logic + voter LUTs inside ONE
    fabric), the paper's on-chip form. Costs 3x the cells of a single
    fabric, hence ``FABRIC_28NM_XL``.
  * ``replicate_config`` — serving-level TMR: three independently-encoded
    decoded bitstreams of the SAME design, each with a distinct placement
    (LUT order rotated within every level), evaluated as three chip slots
    of a ``PackedFabricStack`` and reduced by a device majority vote
    (kernels/lut_eval/ops.py, ``redundancy="tmr"``). Distinct placements
    mean one configuration-memory address maps to different logical LUTs
    in each replica, so a common-mode flip at a shared address cannot
    produce three identically-wrong replicas. Levels narrower than 3
    cells cannot give all replicas distinct slots (pigeonhole); single
    faults are still voted out regardless.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# FABRIC_28NM_XL lives in core.fabric, registered there; imported here too
# so ``from repro_torch.core.tmr import FABRIC_28NM_XL`` keeps working
from repro_torch.core.fabric import (  # noqa: F401
    FABRIC_28NM_XL, FabricConfig, packed_table_image,
)
from repro_torch.core.netlist import (
    CONST0, CONST1, FF, LUT, Netlist, table_from_fn,
)

TBL_VOTE = table_from_fn(lambda a, b, c: (a & b) | (a & c) | (b & c), 3)

# Serving-level TMR replica count (the only redundancy the majority vote
# supports; 2-of-3 voting needs exactly three replicas).
N_REPLICAS = 3


def majority_vote(a, b, c):
    """Elementwise 2-of-3 majority on 0/1 bit tensors.

    Pure bitwise expression — the SAME function is the host oracle (numpy
    arrays) and the device voter (jax arrays inside the scoring dispatch),
    so the vote has a single source of truth.
    """
    return (a & b) | (a & c) | (b & c)


def majority_vote_words(a, b, c):
    """Word-parallel 2-of-3 majority for bit-sliced 32-event words.

    The same bitwise identity as ``majority_vote`` — (a&b)|(a&c)|(b&c)
    is per-bit, so applied to uint32 words of the bit-sliced layout
    (kernels.lut_eval.bitsliced: bit ``e`` of a word = event ``e``'s net
    value) it votes all 32 event lanes of a net at once. One definition
    shared by the device evaluator and the host oracle
    (core.fabric.BitslicedSim), so the folded-in TMR vote cannot fork
    from the per-bit vote the rest of the stack uses.
    """
    return majority_vote(a, b, c)


def replicate_config(config: FabricConfig, replica: int) -> FabricConfig:
    """Re-encode a decoded bitstream as TMR replica ``replica`` (0..2).

    Replica 0 is the original encoding. Replicas 1 and 2 rotate the LUT
    order within every level by ``replica`` slots — a different placement
    (and therefore a different configuration-memory image) computing the
    identical function: net ids, truth-table rows and physical cells all
    move together. Functional identity holds because levelized evaluation
    is order-independent within a level; fan-in *levels* are untouched, so
    the banded-routing reach is replica-invariant and all replicas share
    one stack envelope.
    """
    if not 0 <= replica < N_REPLICAS:
        raise ValueError(f"replica must be in [0, {N_REPLICAS}), got {replica!r}")
    if replica == 0:
        return config
    c = config
    n_luts = c.n_luts
    sizes = np.asarray(c.level_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    # order[new_slot] = old_slot: rotate within each level
    order = np.arange(n_luts, dtype=np.int64)
    for l, size in enumerate(sizes):
        if size > 1:
            lo = int(starts[l])
            order[lo : lo + size] = lo + (np.arange(size) + replica) % size
    inv = np.empty_like(order)
    inv[order] = np.arange(n_luts)

    base = 2 + c.n_inputs + c.n_ffs
    remap = np.arange(c.n_nets, dtype=np.int64)
    remap[base : base + n_luts] = base + inv
    return dataclasses.replace(
        c,
        lut_inputs=remap[c.lut_inputs[order]].astype(np.int32),
        lut_tables=c.lut_tables[order].copy(),
        output_nets=remap[c.output_nets].astype(np.int32),
        ff_d_nets=(
            remap[c.ff_d_nets].astype(np.int32) if c.n_ffs else c.ff_d_nets.copy()
        ),
        cell_of_lut=c.cell_of_lut[order].copy(),
    )


def triplicate(nl: Netlist) -> Netlist:
    """Return the TMR form of a netlist (shared inputs, voted outputs)."""
    n_copies = 3

    def remap_for(copy: int):
        # nets: consts + inputs shared; everything else per-copy
        shared = {CONST0: CONST0, CONST1: CONST1}
        for net in nl.inputs:
            shared[net] = net
        return shared

    next_net = nl.n_nets
    per_copy_map = []
    for c in range(n_copies):
        m = remap_for(c)
        for net in range(nl.n_nets):
            if net in m:
                continue
            if c == 0:
                m[net] = net  # copy 0 keeps original ids
            else:
                m[net] = next_net
                next_net += 1
        per_copy_map.append(m)

    luts = []
    ffs = []
    for c in range(n_copies):
        m = per_copy_map[c]
        for l in nl.luts:
            luts.append(LUT(
                inputs=tuple(m[i] for i in l.inputs),
                table=l.table,
                out=m[l.out],
            ))
        for f in nl.ffs:
            ffs.append(FF(d=m[f.d], q=m[f.q], init=f.init))

    # majority voters on each output
    outputs = []
    names = dict(nl.names)
    for out in nl.outputs:
        voted = next_net
        next_net += 1
        luts.append(LUT(
            inputs=(per_copy_map[0][out], per_copy_map[1][out],
                    per_copy_map[2][out], CONST0),
            table=TBL_VOTE,
            out=voted,
        ))
        names[voted] = f"vote({nl.names.get(out, out)})"
        outputs.append(voted)

    return Netlist(
        n_nets=next_net,
        inputs=list(nl.inputs),
        outputs=outputs,
        luts=luts,
        ffs=ffs,
        names=names,
    )


def replica_lut_index(config: FabricConfig, replica: int,
                      lut_index: int) -> int:
    """Slot of base-encoding LUT ``lut_index`` in ``replica``'s encoding.

    The coordinate translation for injecting the SAME logical fault into
    several replicas (the double-fault campaign): replica r's within-level
    rotation moves base slot j to ``lo + ((j - lo - r) % size)``.
    """
    if not 0 <= lut_index < config.n_luts:
        raise ValueError(
            f"lut_index must be in [0, {config.n_luts}), got {lut_index!r}")
    if not 0 <= replica < N_REPLICAS:
        raise ValueError(f"replica must be in [0, {N_REPLICAS}), got {replica!r}")
    if replica == 0:
        return int(lut_index)
    lo = 0
    for size in config.level_sizes:
        if lut_index < lo + size:
            if size <= 1:
                return int(lut_index)
            return int(lo + ((lut_index - lo - replica) % size))
        lo += size
    raise AssertionError("unreachable: lut_index inside n_luts")


def replica_table_images(
    config: FabricConfig, n_levels: int, m_pad: int,
    n_replicas: int = N_REPLICAS,
) -> List[np.ndarray]:
    """Golden configuration-memory truth-table images, one per served
    replica encoding, in the padded scrub-loop layout.

    Each replica's image is ``packed_table_image`` of its placement-
    rotated encoding — the exact bytes a clean readback of that replica
    slot returns (device stack or host-oracle twin), so the scrubbing
    subsystem's golden CRC digests (core.bitstream.GoldenImageStore) are
    computed here once at (re)configuration time. ``n_replicas=1`` is the
    non-redundant, CRC-only-detection case (the base encoding alone).
    """
    return [
        packed_table_image(replicate_config(config, r), n_levels, m_pad)
        for r in range(n_replicas)
    ]


def inject_seu(config: FabricConfig, lut_index: int, bit: int) -> FabricConfig:
    """Flip one truth-table configuration bit (SEU in config memory).

    ``lut_index``/``bit`` are bounds-checked with a named error: numpy's
    fancy indexing would otherwise silently wrap negative indices to the
    other end of the config memory, making a fault-injection campaign
    sweep the wrong addresses without noticing.
    """
    n = config.n_luts
    if not isinstance(lut_index, (int, np.integer)) or not 0 <= lut_index < n:
        raise ValueError(
            f"lut_index must be an int in [0, {n}) for this config, "
            f"got {lut_index!r}"
        )
    if not isinstance(bit, (int, np.integer)) or not 0 <= bit < 16:
        raise ValueError(
            f"bit must be an int in [0, 16) (LUT4 truth table), got {bit!r}"
        )
    tables = config.lut_tables.copy()
    tables[lut_index, bit] ^= 1
    return dataclasses.replace(config, lut_tables=tables)

