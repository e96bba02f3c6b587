"""Loadgen: deterministic mainnet-shaped traffic scenarios.

The port's copy of lighthouse_tpu/loadgen/. So far it holds the scenario
catalog (scenarios.py: pure data), the state_root scenario (state_root.py:
seeded mutate-and-reroot churn over a validator-scale BeaconState through
the tree-hash router, conservation-checked), the fault injectors
(faults.py: a stalling device lane, a slow host verify; storefaults.py:
torn writes, CRC flips, crash points over the native store's log format)
and the runner (runner.py: `run_scenario` and `run_crash_restart`, gossip
through the InProcessGossipRouter into a real BeaconProcessor behind an
AdmissionController). The mesh lane (`mesh=True`) needs meshsim.py, and
the multi-node harness the network; neither is ported yet, and
scenarios.py imports `netfaults` and `fleet` only inside the functions
that build those families.
"""

# Lazy re-exports (PEP 562), as the reference's: of its names, only those
# whose modules the port holds.
_EXPORTS = {
    "DeviceStallError": ".faults",
    "FaultInjector": ".faults",
    "StallingBackend": ".faults",
    "FaultPlan": ".storefaults",
    "FaultyKVStore": ".storefaults",
    "SimulatedCrash": ".storefaults",
    "StoreCrashed": ".storefaults",
    "run_scenario": ".runner",
    "SCENARIOS": ".scenarios",
    "Scenario": ".scenarios",
    "get_scenario": ".scenarios",
    "smoke_variant": ".scenarios",
    "traffic_schedule": ".scenarios",
    "MultiNodeScenario": ".scenarios",
    "get_multinode_scenario": ".scenarios",
    "is_multinode": ".scenarios",
    "multinode_smoke_variant": ".scenarios",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
