"""The port's loadgen runner and fault injectors (loadgen/{runner,faults,
storefaults}.py) on the CPU against the JAX package's.

- run_scenario on the smoke scenario and on device_stall's smoke variant,
  and run_crash_restart on crash_restart's smoke variant at 3 slots: the
  same report cores (everything but the walls, the verify rates and the
  datadir paths) on both packages. Both runners drive the gossip router,
  a BeaconProcessor behind an AdmissionController, the capacity scheduler
  and the breaker over a StallingBackend (fake semantics by design: loadgen
  measures QoS, not pairings, so no kernel runs);
- StallingBackend and FaultInjector: the same verdicts and firings;
- a scenario with mesh=True raises ImportError for loadgen.meshsim, which
  the port does not hold yet, and nothing else.

Tolerance: exact. No JAX compile.
"""

import dataclasses
import importlib

import pytest

PACKAGES = ("lighthouse_tpu", "lighthouse_tpu_torch")


def loadgen(package: str):
    return importlib.import_module(f"{package}.loadgen")


def report_core(report: dict) -> dict:
    """A report without its walls, verify rates and paths, and without the
    flight recorder's event count: the recorder is process-wide and also
    takes the WARN lines of every thread in the process (a test worker's
    other tests' threads too), so only the incidents it raised compare."""
    out = {k: v for k, v in report.items() if k != "elapsed_secs"}
    out["slo"] = {k: v for k, v in report["slo"].items()
                  if k not in ("incident_dir", "flight_recorder_events")}
    if "verify_observations" in report:
        out["verify_observations"] = {"device_batches":
                                      report["verify_observations"]["device_batches"]}
    if "crash" in report:
        out["crash"] = {k: v for k, v in report["crash"].items() if k != "datadir"}
    return out


def run(package: str, case: str, tmp_path) -> dict:
    lg = loadgen(package)
    if case == "smoke":
        return lg.run_scenario(lg.get_scenario("smoke"))
    if case == "device_stall":
        return lg.run_scenario(lg.smoke_variant(lg.get_scenario("device_stall")))
    runner = importlib.import_module(f"{package}.loadgen.runner")
    return runner.run_crash_restart(
        lg.smoke_variant(lg.get_scenario("crash_restart", slots=3)),
        datadir=str(tmp_path / package))


@pytest.mark.parametrize("case", ["smoke", "device_stall", "crash_restart"])
def test_report_core_matches_jax(case, tmp_path):
    want, got = (report_core(run(p, case, tmp_path)) for p in PACKAGES)
    assert got == want
    if case == "crash_restart":
        assert got["crash"]["resumed_from_persisted_head"] and got["conservation"]["ok"]
    else:
        assert got["processed"]["gossip_attestation"] > 0
        assert got["breaker_transitions"][0] == "closed" and "open" in got["breaker_transitions"]


def test_stalling_backend_and_injector_match_jax():
    def step(lg):
        dev = lg.StallingBackend(wait_secs=0.01)
        out = [dev.verify_signature_sets([None], [1])]
        dev.stall()
        for call in (lambda: dev.verify_signature_sets([None], [1]),
                     lambda: dev.verify_signature_sets_async([None], [1]).result()):
            try:
                out.append(call())
            except lg.DeviceStallError as e:
                out.append(type(e).__name__)
        dev.release()
        out += [dev.verify_signature_sets([None], [1]), dev.stall_hits]
        fired = []
        inj = lg.FaultInjector()
        inj.at(2, lambda: fired.append("a")).at(4, lambda: fired.append("b"))
        counts = [inj.on_slot(0), inj.on_slot(3), inj.on_slot(3)]
        inj.at(1, lambda: fired.append("late"))
        counts += [inj.on_slot(3), inj.on_slot(10)]
        return out, counts, fired

    want, got = (step(loadgen(p)) for p in PACKAGES)
    assert got == want
    assert got[0] == [True, "DeviceStallError", "DeviceStallError", True, 2]


def test_mesh_scenario_needs_meshsim():
    lg = loadgen("lighthouse_tpu_torch")
    sc = dataclasses.replace(lg.smoke_variant(lg.get_scenario("smoke")), mesh=True)
    with pytest.raises(ImportError) as err:
        lg.run_scenario(sc)
    assert err.value.name == "lighthouse_tpu_torch.loadgen.meshsim"
