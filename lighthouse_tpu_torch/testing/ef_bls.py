"""The Ethereum consensus spec's BLS test vectors through the port's BLS API.

The handlers are the port's own copy of the JAX package's BLS handlers
(lighthouse_tpu/testing/ef_runner.py `_run_bls`): sign, verify, aggregate,
fast_aggregate_verify, aggregate_verify, eth_fast_aggregate_verify and
batch_verify, each run through `lighthouse_tpu_torch.crypto.bls` with
whatever backend is active. The vectors are the flat `data.yaml` files
under tests/ef/vectors/general/phase0/bls/<handler>/bls_tests/<case>/;
`read_data_yaml` reads that subset of YAML (mappings, lists, quoted
strings, true/false/null) without PyYAML.
"""

from __future__ import annotations

from pathlib import Path

from ..crypto import bls

HANDLERS = ("sign", "verify", "aggregate", "fast_aggregate_verify", "aggregate_verify",
            "eth_fast_aggregate_verify", "batch_verify")


def _scalar(text: str):
    text = text.strip()
    if text in ("true", "false"):
        return text == "true"
    if text in ("null", "~", ""):
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def read_data_yaml(text: str):
    """Parse the flat YAML of a BLS vector: nested mappings and lists of
    scalars, a list's items at or below its key's indentation."""
    lines = []
    for raw in text.splitlines():
        body = raw.split(" #", 1)[0].rstrip()
        if body.strip() and not body.lstrip().startswith("#"):
            lines.append((len(body) - len(body.lstrip()), body.strip()))

    def block(i: int, indent: int):
        if lines[i][1].startswith("-"):
            items = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
                items.append(_scalar(lines[i][1][1:]))
                i += 1
            return items, i
        out = {}
        while i < len(lines) and lines[i][0] == indent and not lines[i][1].startswith("-"):
            key, _, rest = lines[i][1].partition(":")
            i += 1
            nested = i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-")))
            if rest.strip() or not nested:
                out[key.strip()] = _scalar(rest)
            else:
                out[key.strip()], i = block(i, lines[i][0])
        return out, i

    if not lines:
        return None
    value, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unparsed YAML from line {end}: {lines[end][1]!r}")
    return value


def _bytes(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr[2:])


def _sig(hexstr: str):
    return bls.Signature.deserialize(_bytes(hexstr))


def _pk(hexstr: str):
    return bls.PublicKey.deserialize(_bytes(hexstr))


def _decode(handler: str, inp):
    """The vector's input as the arguments of its API call. Raises
    ValueError (serde.DecodeError among them) on a malformed point, an
    infinity pubkey or a malformed signature set."""
    if handler == "aggregate":
        return ([_sig(s) for s in inp],)
    if handler == "verify":
        return _pk(inp["pubkey"]), _bytes(inp["message"]), _sig(inp["signature"])
    if handler in ("fast_aggregate_verify", "eth_fast_aggregate_verify"):
        return [_pk(p) for p in inp["pubkeys"]], _bytes(inp["message"]), _sig(inp["signature"])
    if handler == "aggregate_verify":
        return ([_pk(p) for p in inp["pubkeys"]], [_bytes(m) for m in inp["messages"]],
                _sig(inp["signature"]))
    return ([bls.SignatureSet(_sig(s), (_pk(p),), _bytes(m))
             for p, m, s in zip(inp["pubkeys"], inp["messages"], inp["signatures"])],)


def run_case(handler: str, data: dict) -> bool:
    """True when the port's BLS API gives the vector's expected output.

    Only decoding the input may fail quietly (the vector then expects null
    or false); an exception from the API call itself propagates."""
    if handler not in HANDLERS:
        raise ValueError(f"unknown bls handler {handler}")
    inp, expect = data["input"], data["output"]
    if handler == "sign":
        sk = bls.SecretKey(int(inp["privkey"], 16))
        return "0x" + bls.sign(sk, _bytes(inp["message"])).serialize().hex() == expect
    try:
        args = _decode(handler, inp)
    except ValueError:
        return expect is (None if handler == "aggregate" else False)
    if handler == "aggregate":
        return "0x" + bls.AggregateSignature.aggregate(args[0]).serialize().hex() == expect
    fn = {"verify": bls.verify, "batch_verify": bls.verify_signature_sets}.get(handler)
    return (fn or getattr(bls, handler))(*args) == expect


def vector_cases(root) -> list[tuple[str, str, Path]]:
    """(handler, case, data.yaml path) of every BLS vector under `root`
    (the .../general/phase0/bls directory), sorted."""
    root = Path(root)
    return [(p.parts[-4], p.parts[-2], p)
            for p in sorted(root.glob("*/bls_tests/*/data.yaml")) if p.parts[-4] in HANDLERS]


def run_vector(path) -> bool:
    path = Path(path)
    return run_case(path.parts[-4], read_data_yaml(path.read_text()))
