"""SignatureSets and the KZG setup from the repo's committed fixture archives.

bench_fixtures.npz (and its small twin bench_fixtures_smoke.npz) hold real
BLS signature sets as big-endian 48-byte field elements: att_* are
aggregate attestations (n_att sets of up to 128 keys), sync_* one Altair
sync-committee aggregate of 512 keys; kzg_* a dev KZG setup (uncompressed
affine Lagrange points, 4096 in bench_fixtures.npz) with blobs and their
compressed commitments and proofs. Decoding only: no device work.
"""

from __future__ import annotations

import json

import numpy as np

from ..crypto import bls


def _fq(a) -> int:
    return int.from_bytes(bytes(a), "big")


def _g1(a):
    return (_fq(a[0]), _fq(a[1]))


def _g2(a):
    return ((_fq(a[0, 0]), _fq(a[0, 1])), (_fq(a[1, 0]), _fq(a[1, 1])))


def signature_set(keys, sig, msg) -> bls.SignatureSet:
    return bls.SignatureSet(
        bls.Signature(_g2(sig)), [bls.PublicKey(_g1(k)) for k in keys], bytes(msg)
    )


def load_groups(path, n_att: int | None = None) -> dict:
    """{"att": first n_att attestation sets (all by default), "sync": [the
    sync aggregate], "meta": the archive's metadata}."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]))
    count = meta["n_att"] if n_att is None else min(n_att, meta["n_att"])
    att = [signature_set(z["att_keys"][i], z["att_sigs"][i], z["att_msgs"][i])
           for i in range(count)]
    sync = [signature_set(z["sync_keys"], z["sync_sigs"][0], z["sync_msgs"][0])]
    return {"att": att, "sync": sync, "meta": meta}


def load_kzg(path) -> dict:
    """The archive's KZG fixture: {"g1_lagrange": host affine G1 points,
    "g2_monomial": [H, tau H] as host affine G2 points, "blobs",
    "commitments", "proofs": bytes}."""
    z = np.load(path)
    return {
        "g1_lagrange": [_g1(p) for p in z["kzg_setup_g1"]],
        "g2_monomial": [_g2(p) for p in z["kzg_g2_monomial"]],
        "blobs": [bytes(b) for b in z["kzg_blobs"]],
        "commitments": [bytes(c) for c in z["kzg_commitments"]],
        "proofs": [bytes(p) for p in z["kzg_proofs"]],
    }
