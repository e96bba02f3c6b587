"""SSZ merkle proofs: single-leaf branches over container/vector trees.

Parity surface: lighthouse/consensus/merkle_proof (branch verification)
plus the generalized-index proof production the light-client server needs
(consensus/types light-client types + beacon_chain light_client_server
cache). Only field-level proofs over containers (possibly nested) are
needed by the light-client protocol; that is what this provides.
"""

from __future__ import annotations

import hashlib

from .core import Container, SSZType, ZERO_HASHES, next_pow2


def hash_pair(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def build_tree(chunks: list[bytes], limit: int | None = None) -> list[list[bytes]]:
    """Full padded tree, layers[0] = leaves (padded), layers[-1] = [root]."""
    width = next_pow2(limit if limit is not None else max(1, len(chunks)))
    depth = width.bit_length() - 1
    leaves = list(chunks) + [ZERO_HASHES[0]] * (width - len(chunks))
    layers = [leaves]
    for d in range(depth):
        prev = layers[-1]
        layers.append([hash_pair(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])
    return layers


def branch_for(layers: list[list[bytes]], index: int) -> list[bytes]:
    """Sibling branch for leaf `index`, bottom-up."""
    branch = []
    for layer in layers[:-1]:
        branch.append(layer[index ^ 1])
        index //= 2
    return branch


def verify_branch(leaf: bytes, branch: list[bytes], index: int, root: bytes) -> bool:
    value = leaf
    for sib in branch:
        if index & 1:
            value = hash_pair(sib, value)
        else:
            value = hash_pair(value, sib)
        index //= 2
    return value == root


def container_field_proof(ctype: Container, value, field_path: list[str]):
    """Branch proving `value.<path>`'s hash_tree_root within ctype's root.

    Returns (leaf_root, branch, gindex_pos, depth): the concatenated branch
    is ordered bottom-up (innermost container first), matching the spec's
    fixed-depth light-client branches."""
    branch: list[bytes] = []
    pos = 0
    depth = 0
    current_type: Container = ctype
    current_value = value
    # walk from the OUTERMOST to innermost, but branches concatenate
    # bottom-up, so collect per-level then reverse.
    steps = []
    for name in field_path:
        idx = None
        ftype = None
        for i, f in enumerate(current_type.fields):
            if f.name == name:
                idx, ftype = i, f.type
                break
        if idx is None:
            raise KeyError(f"{current_type}: no field {name}")
        steps.append((current_type, current_value, idx))
        current_type = ftype
        current_value = getattr(current_value, name)
    leaf = (
        current_type.hash_tree_root(current_value)
        if isinstance(current_type, SSZType)
        else current_type.hash_tree_root(current_value)
    )
    for ctype_i, cval_i, idx in reversed(steps):
        chunks = [f.type.hash_tree_root(getattr(cval_i, f.name)) for f in ctype_i.fields]
        layers = build_tree(chunks, len(ctype_i.fields))
        sub_branch = branch_for(layers, idx)
        level_depth = len(sub_branch)
        branch = branch + sub_branch
        pos = pos + (idx << depth)
        depth += level_depth
    return leaf, branch, pos, depth
