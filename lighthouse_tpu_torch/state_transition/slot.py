"""Slot-level helpers of the state transition.

The port's state_transition/slot.py holds only `types_for_slot` (the
reference's lighthouse_tpu/state_transition/slot.py:19-20), which the
synthetic-state fixture needs. per_slot_processing, the fork upgrades and
the block-driven state_transition come with the port's block processing.
"""

from __future__ import annotations

from ..types.containers import spec_types
from ..types.spec import ChainSpec


def types_for_slot(spec: ChainSpec, slot: int):
    return spec_types(spec.preset, spec.fork_name_at_slot(slot))
