"""Generic BLS interface of the port: the plugin boundary.

Mirrors lighthouse_tpu.crypto.bls with the backends of this package:
`set_backend("torch")` loads the batched CUDA backend
(lighthouse_tpu_torch.crypto.torchbls) at first use; "fake" is the
always-valid plumbing stub. The interchange record is SignatureSet:
signature + signing keys + 32-byte message.
"""

from .keys import SecretKey, PublicKey, Keypair, interop_keypairs, interop_keypair
from .signature import Signature, AggregateSignature, INFINITY_SIGNATURE_BYTES
from .signature_set import SignatureSet
from .api import (
    get_backend,
    set_backend,
    available_backends,
    sign,
    verify,
    aggregate_verify,
    fast_aggregate_verify,
    eth_fast_aggregate_verify,
    verify_signature_sets,
    verify_signature_sets_async,
)

__all__ = [
    "SecretKey",
    "PublicKey",
    "Keypair",
    "Signature",
    "AggregateSignature",
    "SignatureSet",
    "INFINITY_SIGNATURE_BYTES",
    "interop_keypairs",
    "interop_keypair",
    "get_backend",
    "set_backend",
    "available_backends",
    "sign",
    "verify",
    "aggregate_verify",
    "fast_aggregate_verify",
    "eth_fast_aggregate_verify",
    "verify_signature_sets",
    "verify_signature_sets_async",
]
