"""Carrying consensus objects and keys into the port.

The port's containers and the JAX package's are both SSZ, so a state or a
signed block crosses as its bytes: `types.BeaconState.deserialize` of the
other side's `serialize`. Keypairs cross as secret-key ints and affine
points, so no test pays twice for the pure-Python key generation (~0.17 s
a key); the public keys are interned in the port's pubkey cache, as a
node's ValidatorPubkeyCache would hold them. Nothing here imports the
other package: each function reads the objects it is given.
"""

from __future__ import annotations

from ..crypto import bls


def carry_ssz(value, from_type, to_type):
    """`value` of SSZ type `from_type` as a value of the port's `to_type`."""
    return to_type.deserialize(from_type.serialize(value))


def carry_state(state, from_types, types):
    return carry_ssz(state, from_types.BeaconState, types.BeaconState)


def carry_signed_block(signed_block, from_types, types):
    return carry_ssz(signed_block, from_types.SignedBeaconBlock, types.SignedBeaconBlock)


def carry_keypairs(keypairs) -> list:
    """The port's Keypairs for objects with `.sk.scalar` and `.pk.point`."""
    out = []
    for kp in keypairs:
        pk = bls.PublicKey(kp.pk.point)
        pk.serialize()
        out.append(bls.Keypair(bls.SecretKey(kp.sk.scalar), pk))
    return out
