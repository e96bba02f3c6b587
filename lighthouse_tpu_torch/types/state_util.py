"""State cloning — consensus-critical structural sharing.

Lives with the type layer (not the test harness) because its semantics are
load-bearing for production: the chain clones states on every block import
and production, and the memoized container roots
(ssz/core.py MEMOIZED_ROOT_TYPES) only carry across clones because
unchanged element instances are SHARED."""

from __future__ import annotations

from ..ssz.core import List as _SSZList


def clone_state(state, spec=None):
    """Copy-on-write state clone with structural sharing (the milhouse
    idea, lighthouse/consensus/types/src/beacon_state.rs:34, done the
    Python way): the clone gets fresh LIST objects (so appends and element
    assignment stay private) but SHARES every element and non-list field.
    Sound because the codebase's mutation discipline is copy-on-write for
    all container values — every Validator/header/etc. update goes through
    copy_with — and ints/bytes are immutable.

    The big per-validator fields ride `ssz/cow.py`'s chunked CowList: a
    CowList field clones in O(#chunks) sharing every chunk, and a plain
    list field long enough (cow_min_len, env LIGHTHOUSE_TPU_COW_MIN) is
    adopted into a CowList on the way into the clone — so chain states
    converge onto chunk sharing after their first clone without touching
    genesis/deserialize construction. Small lists stay plain lists.

    `spec` is accepted for call-site compatibility and unused."""
    from ..ssz.cow import CowList, maybe_adopt

    cls = state.__class__
    vals = {}
    for f in cls.ssz_type.fields:
        v = getattr(state, f.name)
        if isinstance(v, CowList):
            vals[f.name] = v.clone()
        elif isinstance(v, list):
            if isinstance(f.type, _SSZList):
                adopted = maybe_adopt(f.type, v, f.name)
                vals[f.name] = (
                    adopted if isinstance(adopted, CowList) else list(v)
                )
            else:
                vals[f.name] = list(v)
        else:
            vals[f.name] = v
    return cls(**vals)
