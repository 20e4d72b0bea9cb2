"""Device regex matching: one Glushkov state mask per row, advanced a byte
at a time over every row at once — the counterpart of
spark_rapids_tpu/regex/kernel.py, whose `lax.while_loop` runs on the
device with a trip count it computes there (the longest row).

Here the loop is a Python loop of torch ops over byte positions. Its trip
count is the longest row's byte length, taken by one host read per
evaluation (ROADMAP C.6 lists it beside the string hashes' reads). The
anchored-start find keeps the JAX package's early exit: it checks
whether every row is decided after 1, 2, 4, 8, ... steps, one more host
read each, so a batch whose rows all die early stops after about twice
the steps they needed. Both kinds of read are counted (`counters()`).

The state masks are int64 lanes holding the uint32 bit patterns (bit 31
is a live position; torch's uint32 has few CPU ops). The follow set of a
state is the OR of its positions' follow rows; a step reads it from four
256-entry tables, one per byte of the state, instead of testing the up
to 32 positions one by one.

A CUDA kernel for this loop would be a new kernel, not a port of one:
the JAX package has no Pallas kernel here. It is a later speed item if
PERF.md's numbers call for it (ROADMAP B).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..columnar.column import Column, StringColumn
from ..types import BOOLEAN
from .program import RegexProgram

_COUNTS: Dict[str, int] = {"evaluations": 0, "steps": 0, "host_reads": 0}


def counters() -> Dict[str, int]:
    """Evaluations, loop steps and host reads of `regex_find` since the
    last reset."""
    return dict(_COUNTS)


def reset_counters() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _read(t: torch.Tensor):
    _COUNTS["host_reads"] += 1
    return t.item()


def follow_tables(prog: RegexProgram) -> np.ndarray:
    """(4, 256) int64: table k maps byte k of a state mask to the OR of the
    follow rows of the positions that byte holds."""
    tables = np.zeros((4, 256), dtype=np.int64)
    rows = prog.follow_rows.astype(np.int64)
    for k in range(4):
        for v in range(1, 256):
            m = 0
            for bit in range(8):
                s = 8 * k + bit
                if v >> bit & 1 and s < prog.n_pos:
                    m |= int(rows[s])
            tables[k, v] = m
    return tables


def regex_find(col: StringColumn, prog: RegexProgram) -> Column:
    """Java Matcher.find()/matches() over every row.

    anchored_start/anchored_end False (RLike): true iff some substring
    matches. Both anchored (LIKE): true iff the whole row matches."""
    from ..ops.strings import device_constant, string_lengths

    cap = col.capacity
    dev = col.device
    lens = string_lengths(col)
    valid = col.validity
    _COUNTS["evaluations"] += 1

    # a nullable pattern matches the empty string; under find() an empty
    # match exists somewhere unless BOTH ends are anchored
    if prog.nullable and not (prog.anchored_start and prog.anchored_end):
        return Column(torch.ones(cap, dtype=torch.bool, device=dev), valid,
                      BOOLEAN)
    if prog.n_pos == 0:
        # an empty anchored pattern matches only the empty string
        return Column(lens == 0, valid, BOOLEAN)

    byte_table = device_constant(prog.byte_table.astype(np.int64), dev)
    tables = device_constant(follow_tables(prog), dev)
    first, last = int(prog.first_mask), int(prog.last_mask)
    starts = col.offsets[:-1]
    byte_cap = col.byte_capacity
    max_t = int(_read(lens.max())) if cap else 0
    early_exit = prog.anchored_start and not prog.anchored_end

    state = torch.zeros(cap, dtype=torch.int64, device=dev)
    matched = torch.zeros(cap, dtype=torch.bool, device=dev)
    for t in range(max_t):
        p = torch.clamp(starts + t, 0, byte_cap - 1).long()
        cmask = byte_table[col.data[p].long()]
        fol = tables[0][state & 0xFF] | tables[1][(state >> 8) & 0xFF] \
            | tables[2][(state >> 16) & 0xFF] | tables[3][(state >> 24) & 0xFF]
        inject = first if (t == 0 or not prog.anchored_start) else 0
        new_state = (fol | inject) & cmask
        active = t < lens
        state = torch.where(active, new_state, state)
        if not prog.anchored_end:
            matched = matched | (active & ((state & last) != 0))
        _COUNTS["steps"] += 1
        done = t + 1
        if early_exit and done < max_t and done & (done - 1) == 0:
            # every row matched, dead (no injection after the first
            # byte) or past its end: nothing can change
            if _read(torch.all(matched | (state == 0) | (done >= lens))):
                break

    if prog.anchored_end:
        # accept iff a last position is live at the row's end (the state
        # freezes after its final byte); the empty row is the nullable case
        matched = (state & last) != 0
        matched = torch.where(lens == 0, prog.nullable, matched)
    return Column(matched, valid, BOOLEAN)
