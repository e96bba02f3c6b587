"""Embedded network configurations (eth2_network_config analog).

Parity surface: lighthouse/common/eth2_network_config/src/lib.rs and
its built_in_network_configs/ — named network presets (mainnet, sepolia,
holesky, and the gnosis family) resolved to a runtime ChainSpec, plus
config.yaml parsing so operators can load custom networks
(consensus/types/src/chain_spec.rs Config::from_yaml analog). Genesis
states are NOT embedded (the reference ships multi-MB SSZ blobs or
checkpoint-sync URLs; here genesis comes from checkpoint sync, an SSZ file
path, or interop genesis).

All numbers below are the public network parameters from the upstream
configs (fork versions/epochs, deposit contract data, churn constants)."""

from __future__ import annotations

import dataclasses

from .spec import ChainSpec, FAR_FUTURE_EPOCH, MAINNET_PRESET, MINIMAL_PRESET


def mainnet_config() -> ChainSpec:
    return ChainSpec()   # the defaults ARE mainnet


def sepolia_config() -> ChainSpec:
    return ChainSpec(
        config_name="sepolia",
        genesis_fork_version=bytes.fromhex("90000069"),
        altair_fork_version=bytes.fromhex("90000070"),
        altair_fork_epoch=50,
        bellatrix_fork_version=bytes.fromhex("90000071"),
        bellatrix_fork_epoch=100,
        capella_fork_version=bytes.fromhex("90000072"),
        capella_fork_epoch=56832,
        deneb_fork_version=bytes.fromhex("90000073"),
        deneb_fork_epoch=132608,
        electra_fork_version=bytes.fromhex("90000074"),
        electra_fork_epoch=None,
        min_genesis_time=1655647200,
        genesis_delay=86400,
        min_genesis_active_validator_count=1300,
        deposit_chain_id=11155111,
        deposit_network_id=11155111,
        deposit_contract_address=bytes.fromhex(
            "7f02c3e3c98b133055b8b348b2ac625669ed295d"
        ),
        terminal_total_difficulty=17000000000000000,
    )


def holesky_config() -> ChainSpec:
    return ChainSpec(
        config_name="holesky",
        genesis_fork_version=bytes.fromhex("01017000"),
        altair_fork_version=bytes.fromhex("02017000"),
        altair_fork_epoch=0,
        bellatrix_fork_version=bytes.fromhex("03017000"),
        bellatrix_fork_epoch=0,
        capella_fork_version=bytes.fromhex("04017000"),
        capella_fork_epoch=256,
        deneb_fork_version=bytes.fromhex("05017000"),
        deneb_fork_epoch=29696,
        electra_fork_version=bytes.fromhex("06017000"),
        electra_fork_epoch=None,
        min_genesis_time=1695902100,
        genesis_delay=300,
        min_genesis_active_validator_count=16384,
        deposit_chain_id=17000,
        deposit_network_id=17000,
        deposit_contract_address=bytes.fromhex(
            "4242424242424242424242424242424242424242"
        ),
        terminal_total_difficulty=0,
        ejection_balance=28 * 10**9,
    )


def gnosis_config() -> ChainSpec:
    return ChainSpec(
        config_name="gnosis",
        genesis_fork_version=bytes.fromhex("00000064"),
        altair_fork_version=bytes.fromhex("01000064"),
        altair_fork_epoch=512,
        bellatrix_fork_version=bytes.fromhex("02000064"),
        bellatrix_fork_epoch=385536,
        capella_fork_version=bytes.fromhex("03000064"),
        capella_fork_epoch=648704,
        deneb_fork_version=bytes.fromhex("04000064"),
        deneb_fork_epoch=889856,
        electra_fork_version=bytes.fromhex("05000064"),
        electra_fork_epoch=None,
        seconds_per_slot=5,
        min_genesis_time=1638968400,
        genesis_delay=6000,
        min_genesis_active_validator_count=4096,
        churn_limit_quotient=4096,
        deposit_chain_id=100,
        deposit_network_id=100,
        deposit_contract_address=bytes.fromhex(
            "0b98057ea310f4d31f2a452b414647007d1645d9"
        ),
        terminal_total_difficulty=8626000000000000000000058750000000000000000000,
    )


def minimal_config() -> ChainSpec:
    from .spec import minimal_spec

    return minimal_spec()


BUILT_IN_CONFIGS = {
    "mainnet": mainnet_config,
    "sepolia": sepolia_config,
    "holesky": holesky_config,
    "gnosis": gnosis_config,
    "minimal": minimal_config,
}


def get_network_config(name: str) -> ChainSpec:
    try:
        return BUILT_IN_CONFIGS[name]()
    except KeyError:
        raise ValueError(
            f"unknown network {name!r}; built-in: {sorted(BUILT_IN_CONFIGS)}"
        ) from None


# ------------------------------------------------------------ config.yaml

_FIELD_MAP = {
    # config.yaml key -> ChainSpec attribute (spec-cased names)
    "PRESET_BASE": None,
    "CONFIG_NAME": "config_name",
    "GENESIS_FORK_VERSION": "genesis_fork_version",
    "ALTAIR_FORK_VERSION": "altair_fork_version",
    "ALTAIR_FORK_EPOCH": "altair_fork_epoch",
    "BELLATRIX_FORK_VERSION": "bellatrix_fork_version",
    "BELLATRIX_FORK_EPOCH": "bellatrix_fork_epoch",
    "CAPELLA_FORK_VERSION": "capella_fork_version",
    "CAPELLA_FORK_EPOCH": "capella_fork_epoch",
    "DENEB_FORK_VERSION": "deneb_fork_version",
    "DENEB_FORK_EPOCH": "deneb_fork_epoch",
    "ELECTRA_FORK_VERSION": "electra_fork_version",
    "ELECTRA_FORK_EPOCH": "electra_fork_epoch",
    "SECONDS_PER_SLOT": "seconds_per_slot",
    "MIN_GENESIS_TIME": "min_genesis_time",
    "GENESIS_DELAY": "genesis_delay",
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": "min_genesis_active_validator_count",
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": "min_validator_withdrawability_delay",
    "SHARD_COMMITTEE_PERIOD": "shard_committee_period",
    "EJECTION_BALANCE": "ejection_balance",
    "MIN_PER_EPOCH_CHURN_LIMIT": "min_per_epoch_churn_limit",
    "CHURN_LIMIT_QUOTIENT": "churn_limit_quotient",
    "MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT": "max_per_epoch_activation_churn_limit",
    "MIN_PER_EPOCH_CHURN_LIMIT_ELECTRA": "min_per_epoch_churn_limit_electra",
    "MAX_PER_EPOCH_ACTIVATION_EXIT_CHURN_LIMIT": "max_per_epoch_activation_exit_churn_limit",
    "INACTIVITY_SCORE_BIAS": "inactivity_score_bias",
    "INACTIVITY_SCORE_RECOVERY_RATE": "inactivity_score_recovery_rate",
    "DEPOSIT_CHAIN_ID": "deposit_chain_id",
    "DEPOSIT_NETWORK_ID": "deposit_network_id",
    "DEPOSIT_CONTRACT_ADDRESS": "deposit_contract_address",
    "TERMINAL_TOTAL_DIFFICULTY": "terminal_total_difficulty",
    "TERMINAL_BLOCK_HASH": "terminal_block_hash",
    "TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH": "terminal_block_hash_activation_epoch",
    "ATTESTATION_SUBNET_COUNT": "attestation_subnet_count",
    "MAX_BLOBS_PER_BLOCK": "max_blobs_per_block",
    "MAX_BLOBS_PER_BLOCK_ELECTRA": "max_blobs_per_block_electra",
    "MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS": "min_epochs_for_blob_sidecars_requests",
}


def config_from_yaml(text: str) -> ChainSpec:
    """Build a ChainSpec from a standard config.yaml (unknown keys are
    ignored, like the reference's serde(default) behavior). Read without
    PyYAML (utils/yaml_lite.py): a config.yaml is one flat mapping."""
    from ..utils.yaml_lite import read_yaml

    raw = read_yaml(text) or {}
    preset = MINIMAL_PRESET if raw.get("PRESET_BASE") == "minimal" else MAINNET_PRESET
    kwargs = {"preset": preset}
    byte_widths = {"_version": 4, "_address": 20, "_hash": 32}
    for key, attr in _FIELD_MAP.items():
        if attr is None or key not in raw:
            continue
        val = raw[key]
        if isinstance(val, str):
            if val.startswith("0x"):
                val = bytes.fromhex(val[2:])
            elif val.isdigit():
                val = int(val)
        width = next((w for suf, w in byte_widths.items() if attr.endswith(suf)), None)
        if width is not None and isinstance(val, int):
            # PyYAML parses unquoted 0x literals as ints; recover the bytes
            val = val.to_bytes(width, "big")
        if attr.endswith("_epoch") and isinstance(val, int) and val >= FAR_FUTURE_EPOCH:
            val = None
        kwargs[attr] = val
    return ChainSpec(**kwargs)


def config_to_yaml(spec: ChainSpec) -> str:
    """Inverse of config_from_yaml for the /eth/v1/config/spec endpoint and
    round-trip tests."""
    out = {}
    out["PRESET_BASE"] = spec.preset.name
    for key, attr in _FIELD_MAP.items():
        if attr is None:
            continue
        val = getattr(spec, attr)
        if val is None:
            val = FAR_FUTURE_EPOCH
        if isinstance(val, bytes):
            val = "0x" + val.hex()
        out[key] = val
    # the flat mapping as yaml.safe_dump writes it (sorted keys, strings
    # that would read as other types single-quoted), without PyYAML
    lines = []
    for key in sorted(out):
        val = out[key]
        if isinstance(val, str) and (val.startswith("0x") or val.isdigit()):
            val = f"'{val}'"
        lines.append(f"{key}: {val}")
    return "\n".join(lines) + "\n"
