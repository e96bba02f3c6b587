"""Metrics: process-global Prometheus-style registry.

Parity surface: lighthouse/common/lighthouse_metrics/src/lib.rs (global
registry, int/float gauges, counters, histograms with explicit buckets and
start_timer guards, *_vec labeled families) and beacon_node/http_metrics
(the /metrics text exposition). Pure stdlib; the exposition format is
Prometheus 0.0.4 text.

Labeled families (CounterVec/GaugeVec/HistogramVec) mirror the reference's
`register_int_counter_vec!` idiom: one registered family name, per-label-set
child series materialized on first `labels(...)` call. Hot paths should
resolve children once and keep the reference (a child inc is then a plain
attribute op, no dict lookup) — see chain/beacon_processor.py.
"""

from __future__ import annotations

import threading
import time


def escape_label_value(v: str) -> str:
    """Prometheus 0.0.4 label-value escaping: backslash, double-quote and
    newline must be escaped inside the quoted value."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_pairs(labelnames, labelvalues) -> str:
    return ",".join(
        f'{n}="{escape_label_value(str(v))}"'
        for n, v in zip(labelnames, labelvalues)
    )


def _fmt(v: float) -> str:
    """Sample-value formatting: integral values print EXACT (a byte
    counter past 1e6 must not quantize to %g's 6 significant digits —
    rate() over a quantized counter reads zero between jumps), floats
    keep the compact %g form."""
    if float(v).is_integer() and abs(v) < 2**63:
        return str(int(v))
    return f"{v:g}"


class _Metric:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_):
        super().__init__(name, help_)
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount

    def expose(self, labels: str = "") -> list[str]:
        if labels:
            return [f"{self.name}{{{labels}}} {_fmt(self.value)}"]
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_):
        super().__init__(name, help_)
        self.value = 0.0

    def set(self, v: float):
        with self._lock:
            self.value = v

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        with self._lock:
            self.value -= amount

    def expose(self, labels: str = "") -> list[str]:
        if labels:
            return [f"{self.name}{{{labels}}} {_fmt(self.value)}"]
        return [f"{self.name} {_fmt(self.value)}"]


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float):
        with self._lock:
            self.total += v
            self.n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    class _Timer:
        def __init__(self, hist):
            self.hist = hist

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.hist.observe(time.perf_counter() - self.t0)

    def start_timer(self) -> "_Timer":
        return self._Timer(self)

    def expose(self, labels: str = "") -> list[str]:
        # the `le` label goes LAST, after any family labels
        pre = f"{labels}," if labels else ""
        suf = f"{{{labels}}}" if labels else ""
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{self.name}_bucket{{{pre}le="{b:g}"}} {cum}')
        cum += self.counts[-1]
        out.append(f'{self.name}_bucket{{{pre}le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum{suf} {_fmt(self.total)}")
        out.append(f"{self.name}_count{suf} {self.n}")
        return out


# ---------------------------------------------------------------- families


class _MetricVec(_Metric):
    """A labeled metric family: one exposition TYPE block, one child metric
    per distinct label-value tuple. Children are created on first use and
    exposed in creation order (stable scrape diffs)."""

    _child_cls: type = None  # set by subclasses

    def __init__(self, name, help_, labelnames):
        super().__init__(name, help_)
        if not labelnames:
            raise ValueError(f"labeled family {name!r} needs label names")
        for ln in labelnames:
            if ln == "le":
                raise ValueError("'le' is reserved for histogram buckets")
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Metric] = {}

    def _make_child(self) -> _Metric:
        return self._child_cls(self.name, self.help)

    def labels(self, *values, **kw) -> _Metric:
        """Child metric for one label-value set: positionally or by name
        (`family.labels(kind="gossip_block")`)."""
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kw[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"missing label {e} for family {self.name!r}"
                ) from None
            if len(kw) != len(self.labelnames):
                raise ValueError(f"unknown labels for family {self.name!r}")
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"family {self.name!r} takes {len(self.labelnames)} label "
                f"values, got {len(key)}"
            )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def children(self) -> list[tuple[tuple, _Metric]]:
        """Snapshot of (label-values, child) pairs in creation order — the
        public read surface for snapshot builders (observability/pipeline)."""
        with self._lock:
            return list(self._children.items())

    def expose(self, labels: str = "") -> list[str]:
        out = []
        for key, child in self.children():
            out.extend(child.expose(_label_pairs(self.labelnames, key)))
        return out


class CounterVec(_MetricVec):
    kind = "counter"
    _child_cls = Counter


class GaugeVec(_MetricVec):
    kind = "gauge"
    _child_cls = Gauge


class HistogramVec(_MetricVec):
    kind = "histogram"

    def __init__(self, name, help_, labelnames, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return Histogram(self.name, self.help, self.buckets)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                # same-name re-registration returns the original — but a
                # kind or shape clash is a programming error, not a dedupe
                if existing.kind != metric.kind or (
                    isinstance(existing, _MetricVec)
                    != isinstance(metric, _MetricVec)
                ) or (
                    isinstance(existing, _MetricVec)
                    and existing.labelnames != metric.labelnames
                ):
                    raise ValueError(
                        f"metric {metric.name!r} already registered with a "
                        f"different kind/shape ({existing.kind})"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_="") -> Counter:
        return self._register(Counter(name, help_))

    def gauge(self, name, help_="") -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name, help_="", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, buckets))

    def counter_vec(self, name, help_="", labelnames=()) -> CounterVec:
        return self._register(CounterVec(name, help_, labelnames))

    def gauge_vec(self, name, help_="", labelnames=()) -> GaugeVec:
        return self._register(GaugeVec(name, help_, labelnames))

    def histogram_vec(
        self, name, help_="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> HistogramVec:
        return self._register(HistogramVec(name, help_, labelnames, buckets))

    def all_metrics(self) -> list[_Metric]:
        """Snapshot of registered metrics/families (scripts/lint_metrics.py)."""
        with self._lock:
            return list(self._metrics.values())

    def expose_text(self) -> str:
        lines = []
        for m in self.all_metrics():
            body = m.expose()
            if isinstance(m, _MetricVec) and not body:
                continue  # a family with no children yet has nothing to say
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(body)
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# core metrics (metric name parity with beacon_chain/src/metrics.rs themes)
BLOCK_PROCESSING_TIME = REGISTRY.histogram(
    "beacon_block_processing_seconds", "Full block import latency"
)
SIGNATURE_BATCH_SIZE = REGISTRY.histogram(
    "bls_batch_verify_sets", "Signature sets per device batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)
SIGNATURE_VERIFY_TIME = REGISTRY.histogram(
    "bls_batch_verify_seconds", "Device batch verification latency"
)
ATTESTATION_BATCHES = REGISTRY.counter(
    "gossip_attestation_batches_total", "Coalesced attestation batches"
)
HEAD_SLOT = REGISTRY.gauge("beacon_head_slot", "Canonical head slot")
BLOCK_OBSERVED_TO_IMPORT = REGISTRY.histogram(
    "beacon_block_observed_to_import_seconds",
    "Gossip arrival to import latency (BlockTimesCache)",
)
BLOCK_OBSERVED_TO_HEAD = REGISTRY.histogram(
    "beacon_block_observed_to_head_seconds",
    "Gossip arrival to becoming head (BlockTimesCache)",
)


def metrics_http_server(host="127.0.0.1", port=0, registry=REGISTRY,
                        allow_origin=None):
    """/metrics scrape endpoint (http_metrics analog)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading as _t

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def end_headers(self):
            if allow_origin:
                self.send_header("Access-Control-Allow-Origin", allow_origin)
            super().end_headers()

        def do_GET(self):
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = registry.expose_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    thread = _t.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]
