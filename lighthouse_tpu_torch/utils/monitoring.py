"""Remote monitoring pusher + system health snapshot.

Parity surface: lighthouse/common/monitoring_api/src/ (periodic POST
of process/system health JSON to a remote monitoring endpoint, the
beaconcha.in client-stats format) and lighthouse/common/system_health
(sysinfo snapshot). Host metrics come from /proc (no psutil in the image).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request

from .metrics import REGISTRY

VERSION = "lighthouse-tpu-torch/0.2.0"

# outcome-labeled delivery counter: a scrape shows whether the remote
# monitoring endpoint is reachable without grepping logs. result="retried"
# counts attempts that failed but were retried within the same tick;
# "ok"/"error" count each tick's FINAL outcome exactly once.
_POSTS = REGISTRY.counter_vec(
    "monitoring_posts_total",
    "remote monitoring POST attempts, by outcome",
    ("result",),
)


def system_health() -> dict:
    """CPU/memory/disk snapshot from /proc + os (system_health analog)."""
    out: dict = {"os": os.uname().sysname.lower()}
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                k, v = line.split(":", 1)
                mem[k] = int(v.strip().split()[0]) * 1024
        out["sys_virt_mem_total"] = mem.get("MemTotal", 0)
        out["sys_virt_mem_available"] = mem.get("MemAvailable", 0)
        out["sys_virt_mem_used"] = (
            mem.get("MemTotal", 0) - mem.get("MemAvailable", 0)
        )
    except OSError:
        pass
    try:
        out["sys_loadavg_1"], out["sys_loadavg_5"], out["sys_loadavg_15"] = os.getloadavg()
    except OSError:
        pass
    try:
        st = os.statvfs("/")
        out["disk_node_bytes_total"] = st.f_blocks * st.f_frsize
        out["disk_node_bytes_free"] = st.f_bavail * st.f_frsize
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["process_mem_rss"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    out["pid"] = os.getpid()
    return out


class MonitoringService:
    """Periodic POST of {beacon_node, validator, system} health blobs to a
    remote endpoint (monitoring_api lib.rs analog). `chain` and `vc` are
    optional sources; either side can run standalone."""

    def __init__(self, endpoint: str, chain=None, vc_store=None,
                 period: float = 60.0, post_fn=None,
                 max_retries: int = 2, backoff_base: float = 0.25,
                 sleep_fn=None, rng=None):
        self.endpoint = endpoint
        self.chain = chain
        self.vc_store = vc_store
        self.period = period
        # bounded retry inside one tick: a transient endpoint blip must not
        # drop the datapoint (exponential backoff + jitter, interruptible
        # by stop() so shutdown never waits out a backoff)
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self._sent = 0
        self._errors = 0
        self._post = post_fn or self._http_post
        self._stop = threading.Event()
        self._sleep = sleep_fn or self._stop.wait
        self._rng = rng or random.Random()
        self._thread: threading.Thread | None = None
        self._supervisor = None

    # sent/errors are read-only per-INSTANCE views (two services must not
    # read each other's counts); tick() additionally feeds the process-
    # global `monitoring_posts_total{result}` family for scrapes
    @property
    def sent(self) -> int:
        return self._sent

    @property
    def errors(self) -> int:
        return self._errors

    def _http_post(self, payload: list) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10):
            pass

    def collect(self) -> list:
        now_ms = int(time.time() * 1000)
        out = [
            {
                "version": 1,
                "timestamp": now_ms,
                "process": "system",
                **system_health(),
            }
        ]
        if self.chain is not None:
            fc = self.chain.fork_choice.store
            rec = {
                "version": 1,
                "timestamp": now_ms,
                "process": "beaconnode",
                "client_name": VERSION,
                "sync_beacon_head_slot": int(self.chain.head_state().slot),
                "sync_eth2_synced": True,
                "slasher_active": getattr(self.chain, "slasher", None)
                is not None,
                "justified_epoch": fc.justified_checkpoint[0],
                "finalized_epoch": fc.finalized_checkpoint[0],
            }
            # QoS overload signals from this node's beacon processor:
            # qos_shed_total = EVERY lost work item (same semantics as the
            # Prometheus qos_shed_total family total, so the two cross-
            # check), qos_expired_total = its deadline-expired subset —
            # remote monitoring sees overload events without scraping
            # /metrics (qos)
            proc = getattr(
                getattr(self.chain, "_network_node", None), "processor", None
            )
            if proc is not None:
                totals = proc.qos_totals()
                rec["qos_shed_total"] = int(totals["shed"])
                rec["qos_expired_total"] = int(totals["expired"])
            # slot-level SLO headline (observability/slo.py): the remote
            # monitor sees "is this node meeting its slot deadlines" and
            # the current burn rate without scraping /metrics
            try:
                from ..observability import slo as obs_slo

                short = obs_slo.ACCOUNTANT.window_summary("slot_5")
                rec["slo_deadline_hit_ratio"] = short["deadline_hit_ratio"]
                rec["slo_burn_rate"] = short["burn_rate"]
            except Exception:  # noqa: BLE001 — monitoring must never fail
                pass
            out.append(rec)
        if self.vc_store is not None:
            out.append(
                {
                    "version": 1,
                    "timestamp": now_ms,
                    "process": "validator",
                    "client_name": VERSION,
                    "validator_total": len(self.vc_store.validators),
                    "validator_active": sum(
                        1
                        for v in self.vc_store.validators.values()
                        if v.doppelganger_safe
                    ),
                }
            )
        return out

    def tick(self) -> bool:
        try:
            payload = self.collect()
        except Exception:  # noqa: BLE001 — monitoring must never kill the node
            self._errors += 1
            _POSTS.labels("error").inc()
            return False
        for attempt in range(self.max_retries + 1):
            try:
                self._post(payload)
                self._sent += 1
                _POSTS.labels("ok").inc()
                return True
            except Exception:  # noqa: BLE001
                if attempt >= self.max_retries or self._stop.is_set():
                    break
                _POSTS.labels("retried").inc()
                delay = self.backoff_base * (2.0 ** attempt)
                delay *= 1.0 + 0.25 * (2.0 * self._rng.random() - 1.0)
                self._sleep(delay)
        self._errors += 1
        _POSTS.labels("error").inc()
        return False

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.period):
                self.tick()

        # supervised: a crash of the LOOP (tick never raises; this guards
        # the plumbing around it) restarts with backoff instead of silently
        # ending remote monitoring (utils/supervisor.py)
        from .supervisor import Supervisor

        self._supervisor = Supervisor(name="monitoring")
        self._thread = self._supervisor.spawn(loop, "monitoring_post_loop")

    def stop(self) -> None:
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.stop(timeout=1.0)
