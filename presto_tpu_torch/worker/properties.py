"""Properties-file configuration layer.

The port of presto_tpu/worker/properties.py.  The reference boots from an
etc/ directory of Java .properties files: config.properties (server keys,
presto_cpp/main/common/Configs.h:162 and ConfigPropertyMetadata),
node.properties (node.id / node.environment, NodeConfig), and
catalog/*.properties (one connector mount per file, connector.name
selects the plugin -- presto_cpp/main/PrestoServer.cpp registerConnectors
/ java CatalogManager).  This module parses that layout and maps the keys
onto WorkerServer and ExecutionConfig arguments exactly as the reference
does.  Keys the reference ignores, the port ignores; a key the reference
maps onto a field or server argument the port lacks raises
NotImplementedError naming the key, so an etc directory written for the
reference worker means the same thing here or refuses to boot.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from ..exec.pipeline import ExecutionConfig, tuned_config
from .protocol import (PortOverrides, config_fields, parse_data_size,
                       parse_duration)


def load_properties(path: str) -> Dict[str, str]:
    """Parse a Java .properties file: key=value (or key:value), # / !
    comments, backslash line continuation, whitespace-trimmed keys."""
    props: Dict[str, str] = {}

    def store(line: str) -> None:
        # earliest separator wins (java.util.Properties: '=' and ':' are
        # equivalent; the first unescaped one terminates the key)
        idxs = [i for i in (line.find("="), line.find(":")) if i >= 0]
        if idxs:
            i = min(idxs)
            props[line[:i].strip()] = line[i + 1:].strip()
        else:
            props[line] = ""

    with open(path) as f:
        pending = ""
        for raw in f:
            line = pending + raw.strip()
            pending = ""
            if not line or line[0] in "#!":
                continue
            if line.endswith("\\") and not line.endswith("\\\\"):
                pending = line[:-1]
                continue
            store(line)
        if pending:  # trailing continuation with no following line
            store(pending)
    return props


def _bool(v: str) -> bool:
    return str(v).strip().lower() == "true"


def execution_config_from_properties(props: Dict[str, str],
                                     base: Optional[ExecutionConfig] = None
                                     ) -> ExecutionConfig:
    """config.properties keys -> ExecutionConfig (the worker-side subset
    of Configs.h / SystemSessionProperties)."""
    import dataclasses
    cfg = base or ExecutionConfig()
    kw = PortOverrides(config_fields(cfg), props, "config key",
                       "ExecutionConfig")
    props = kw.source
    if "query.max-memory-per-node" in props:
        kw["memory_budget_bytes"] = parse_data_size(
            props["query.max-memory-per-node"])
    if "query.max-memory" in props:
        kw["memory_max_query_bytes"] = parse_data_size(
            props["query.max-memory"])
    if "memory.max-query-bytes" in props:      # byte-count alias
        kw["memory_max_query_bytes"] = int(props["memory.max-query-bytes"])
    if "experimental.spill-enabled" in props:
        kw["spill_enabled"] = _bool(props["experimental.spill-enabled"])
    if "experimental.spiller-max-used-space" in props:
        kw["spill_budget_bytes"] = parse_data_size(
            props["experimental.spiller-max-used-space"])
    if "spill.host-budget-bytes" in props:     # byte-count alias
        kw["spill_budget_bytes"] = int(props["spill.host-budget-bytes"])
    if props.get("experimental.spiller-spill-path"):
        kw["spill_path"] = props["experimental.spiller-spill-path"]
    if props.get("spill.path"):                # short alias
        kw["spill_path"] = props["spill.path"]
    if "spill.async-staging" in props:
        kw["spill_async_staging"] = _bool(props["spill.async-staging"])
    if "exchange.compression-enabled" in props:
        kw["exchange_compression"] = _bool(
            props["exchange.compression-enabled"])
    if "exchange.compression-codec" in props:
        codec = props["exchange.compression-codec"].upper()
        from ..common.compression import supported_codecs
        if codec not in supported_codecs():
            raise ValueError(
                f"unsupported exchange.compression-codec {codec!r}")
        kw["exchange_compression_codec"] = codec
    if "task.batch-rows" in props:
        kw["batch_rows"] = int(props["task.batch-rows"])
    if "task.max-drivers-per-task" in props:
        kw["task_concurrency"] = int(props["task.max-drivers-per-task"])
    if "task.fuse-pipelines" in props:
        kw["fuse_pipelines"] = _bool(props["task.fuse-pipelines"])
    if "task.grouped-lifespans" in props:
        kw["grouped_lifespans"] = int(props["task.grouped-lifespans"])
    if "task.grouped-prefetch-depth" in props:
        kw["grouped_prefetch_depth"] = int(
            props["task.grouped-prefetch-depth"])
    if "task.grouped-lifespan-sharding" in props:
        kw["grouped_lifespan_sharding"] = _bool(
            props["task.grouped-lifespan-sharding"])
    if "exchange.max-error-duration" in props:
        kw["exchange_max_error_duration_s"] = parse_duration(
            props["exchange.max-error-duration"])
    if "exchange.client-threads" in props:
        n = int(props["exchange.client-threads"])
        if n < 1:
            raise ValueError(f"exchange.client-threads must be >= 1, got {n}")
        kw["exchange_client_threads"] = n
    if "exchange.max-buffer-size" in props:
        kw["exchange_max_buffer_bytes"] = parse_data_size(
            props["exchange.max-buffer-size"])
    if "exchange.fabric" in props:
        from ..parallel.fabric import FABRICS
        fabric = props["exchange.fabric"].strip().lower()
        if fabric not in FABRICS:
            raise ValueError(
                f"exchange.fabric must be one of {FABRICS}, got {fabric!r}")
        kw["exchange_fabric"] = fabric
    if "exchange.ici-chunk-rows" in props:
        # an EXPLICIT property pins the chunk size and must be a real
        # row count; auto-tuning is requested by OMITTING the key (the
        # ExecutionConfig default of 0)
        n = int(props["exchange.ici-chunk-rows"])
        if n < 1:
            raise ValueError(
                f"exchange.ici-chunk-rows must be >= 1, got {n}")
        kw["ici_chunk_rows"] = n
    if "scan.kernel" in props:
        from ..exec.pipeline import SCAN_KERNEL_MODES
        mode = props["scan.kernel"].strip().lower()
        if mode not in SCAN_KERNEL_MODES:
            raise ValueError(
                f"scan.kernel must be one of {SCAN_KERNEL_MODES}, "
                f"got {mode!r}")
        kw["scan_kernel"] = mode
    if "scan.kernel-dma" in props:
        from ..exec.pipeline import SCAN_KERNEL_DMA_MODES
        mode = props["scan.kernel-dma"].strip().lower()
        if mode not in SCAN_KERNEL_DMA_MODES:
            raise ValueError(
                f"scan.kernel-dma must be one of {SCAN_KERNEL_DMA_MODES}, "
                f"got {mode!r}")
        kw["scan_kernel_dma"] = mode
    if "exchange.max-response-size" in props:
        kw["exchange_max_response_bytes"] = parse_data_size(
            props["exchange.max-response-size"])
    if "task.remote-task-retry-attempts" in props:
        kw["remote_task_retry_attempts"] = int(
            props["task.remote-task-retry-attempts"])
    if "task.fault-injection-probability" in props:
        p = float(props["task.fault-injection-probability"])
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"task.fault-injection-probability must be in [0, 1], "
                f"got {p}")
        kw["fault_injection_probability"] = p
    if "task.plan-validation" in props:
        mode = props["task.plan-validation"].strip().lower()
        from ..analysis import VALIDATION_MODES
        if mode not in VALIDATION_MODES:
            raise ValueError(
                f"task.plan-validation must be one of {VALIDATION_MODES}, "
                f"got {mode!r}")
        kw["plan_validation"] = mode
    if "debug.lock-validation" in props:
        kw["lock_validation"] = _bool(props["debug.lock-validation"])
    if "telemetry.profile-dir" in props:
        kw["profile_dir"] = props["telemetry.profile-dir"]
    if "retry-policy" in props:
        from ..exec.pipeline import RETRY_POLICY_MODES
        mode = props["retry-policy"].strip().lower()
        if mode not in RETRY_POLICY_MODES:
            raise ValueError(
                f"retry-policy must be one of {RETRY_POLICY_MODES}, "
                f"got {mode!r}")
        kw["retry_policy"] = mode
    if "query.max-execution-time" in props:
        kw["query_max_execution_time_s"] = parse_duration(
            props["query.max-execution-time"])
    if props.get("spool.path"):
        kw["spool_path"] = props["spool.path"]
    if "spool.staging-budget-bytes" in props:
        kw["spool_staging_budget_bytes"] = parse_data_size(
            props["spool.staging-budget-bytes"])
    if "failure-detector.heartbeat-timeout" in props:
        kw["failure_detector_heartbeat_timeout_s"] = parse_duration(
            props["failure-detector.heartbeat-timeout"])
    return dataclasses.replace(cfg, **kw) if kw else cfg


class SystemConfig:
    """Typed accessors over config.properties — the shape of the native
    worker's SystemConfig (presto_cpp/main/common/Configs.h:162: every key
    is a named constant with a typed default; unknown keys are tolerated).
    Defaults mirror Configs.cpp where the key has a reference default.

    Keys the engine acts on are ALSO mapped into ExecutionConfig /
    WorkerServer kwargs (execution_config_from_properties /
    server_kwargs_from_etc); this accessor is the full config surface a
    deployment reads and the /v1/info plumbing reports."""

    # (key, type, default) — Configs.h:164-420 names
    KEYS = [
        ("presto.version", str, "presto-tpu-0.1"),
        ("http-server.http.port", int, 8080),
        ("http-server.reuse-port", bool, False),
        ("http-server.bind-to-node-internal-address-only-enabled",
         bool, False),
        ("http-server.https.port", int, 8443),
        ("http-server.https.enabled", bool, False),
        ("https-cert-path", str, ""),
        ("https-key-path", str, ""),
        ("internal-communication.https.trust-store-path", str, ""),
        ("discovery.uri", str, ""),
        ("coordinator", bool, False),
        ("node.environment", str, "test"),
        ("node.id", str, ""),
        ("node.location", str, ""),
        ("node.pool", str, "DEFAULT"),               # NodePoolType.java
        ("task.max-drivers-per-task", int, 16),
        ("task.concurrent-lifespans-per-task", int, 1),
        ("task.writer-count", int, 1),
        ("task.partitioned-writer-count", int, 1),
        ("task.max-partial-aggregation-memory", str, "16MB"),
        ("task.batch-rows", int, 1 << 16),
        ("task.fuse-pipelines", bool, True),
        ("task.grouped-lifespans", int, 0),
        ("task.grouped-prefetch-depth", int, 1),
        ("task.grouped-lifespan-sharding", bool, True),
        ("task.remote-task-retry-attempts", int, 2),
        # fault-tolerant execution: task-granular retry over the durable
        # spooled exchange (worker/spooling.py)
        ("retry-policy", str, "query"),          # query | task
        ("query.max-execution-time", str, ""),   # "" = unbounded
        ("spool.path", str, ""),                 # "" = spill.path
        ("spool.staging-budget-bytes", str, "16MB"),
        ("failure-detector.heartbeat-timeout", str, ""),  # "" = streak only
        ("task.fault-injection-probability", float, 0.0),
        ("task.plan-validation", str, "on"),
        # runtime lock-order validation (common/locks.py): worker-wide
        # base flag; sessions compose per-query scopes on top
        ("debug.lock-validation", bool, False),
        ("shutdown-onset-sec", int, 10),
        ("system-memory-gb", int, 16),               # HBM per chip
        ("system-mem-limit-gb", int, 16),
        ("system-mem-pushback-enabled", bool, False),
        ("query.max-memory-per-node", str, ""),
        ("query.max-memory", str, ""),           # typed EXCEEDED_MEMORY_LIMIT
        ("memory.max-query-bytes", str, ""),     # byte-count alias of above
        ("experimental.spill-enabled", bool, True),
        ("experimental.spiller-spill-path", str, ""),
        ("experimental.spiller-max-used-space", str, "8GB"),
        ("spill.path", str, ""),                 # alias of spiller-spill-path
        ("spill.host-budget-bytes", str, ""),    # alias of max-used-space
        ("spill.async-staging", bool, True),
        ("exchange.compression-enabled", bool, False),
        ("exchange.compression-codec", str, "LZ4"),
        ("exchange.http-client.request-timeout", str, "10s"),
        ("exchange.max-error-duration", str, "1m"),
        ("exchange.client-threads", int, 4),
        ("exchange.max-buffer-size", str, "32MB"),
        ("exchange.max-response-size", str, "1MB"),
        # shuffle fabric selection + ICI chunk granularity
        # (parallel/fabric.py; exec/scheduler.py _ici_exchange)
        ("exchange.fabric", str, "auto"),
        # 0 = auto-tune from the observed compute/collective overlap
        # (parallel/fabric.py IciChunkTuner); explicit values pin it
        ("exchange.ici-chunk-rows", int, 0),
        # Pallas fused scan kernel selection (exec/kernels): also
        # gates the in-kernel join probe (kernels/join.py) and the
        # prefix-scan window kernel (kernels/window.py)
        ("scan.kernel", str, "auto"),
        # kernel block staging: single (BlockSpec streaming) or double
        # (manually double-buffered make_async_copy prefetch)
        ("scan.kernel-dma", str, "single"),
        ("announcement-interval-ms", int, 1000),
        ("heartbeat-interval-ms", int, 1000),
        ("async-data-cache-enabled", bool, False),
        ("enable-serialized-page-checksum", bool, True),
        ("native-sidecar", bool, False),
        ("worker-overloaded-threshold-mem-gb", int, 0),
        ("worker-overloaded-threshold-cpu-pct", int, 0),
        ("worker-overloaded-task-queuing-enabled", bool, False),
        ("register-test-functions", bool, False),
        ("system-metrics-collection-enabled", bool, False),
        ("internal-communication.shared-secret", str, ""),
        ("internal-communication.jwt.enabled", bool, False),
        ("internal-communication.jwt.expiration-seconds", int, 300),
        # serving tier (coordinator role): canonical plan/executable cache
        # and fair-share admission (presto_tpu/serving/)
        ("serving.plan-cache-entries", int, 128),
        ("serving.total-concurrency", int, 0),       # 0 = per-group only
        ("serving.admission-headroom-fraction", float, 0.8),
        # micro-batched point-query execution (serving/batching.py):
        # concurrent same-template EXECUTEs collapse into one launch
        ("serving.batch-window-ms", float, 3.0),
        ("serving.max-batch-size", int, 16),         # 1 = batching off
        # persistent executable cache (serving/persist.py): XLA
        # compilation cache dir + plan-cache sidecar for warm restarts
        ("serving.compilation-cache-dir", str, ""),
        ("serving.plan-cache-path", str, ""),
        # telemetry export pipeline + query history + device profiler
        # (presto_tpu/telemetry/)
        ("telemetry.sink", str, "none"),         # none|jsonl|http|collector
        ("telemetry.path", str, ""),             # jsonl sink spool file
        ("telemetry.otlp-endpoint", str, ""),    # http sink collector base
        ("telemetry.flush-interval", str, "200ms"),
        ("telemetry.queue-bound", int, 256),
        ("telemetry.metrics-interval", str, "0s"),  # 0 = no self-scrape
        ("telemetry.history-path", str, ""),     # "" = in-memory history
        ("telemetry.history-max-count", int, 200),
        ("telemetry.history-max-age", str, ""),  # "" = no age bound
        ("telemetry.profile-dir", str, "/tmp/presto_tpu_profiles"),
    ]

    def __init__(self, props: Optional[Dict[str, str]] = None):
        self._props = dict(props or {})
        self._defaults = {k: d for k, _t, d in self.KEYS}
        self._types = {k: t for k, t, _d in self.KEYS}

    def known_keys(self):
        return sorted(self._defaults)

    def get(self, key: str):
        if key not in self._defaults:
            raise KeyError(f"unknown config key {key!r}")
        raw = self._props.get(key)
        if raw is None:
            return self._defaults[key]
        t = self._types[key]
        if t is bool:
            return _bool(raw)
        return t(raw)

    def to_dict(self) -> Dict[str, object]:
        return {k: self.get(k) for k in self.known_keys()}


def server_kwargs_from_etc(etc_dir: str) -> Tuple[dict, Dict[str, str]]:
    """etc/{config,node}.properties -> WorkerServer kwargs + raw props.

    Returns (kwargs, merged_props).  Catalog mounts are handled by
    register_catalogs_from_etc (import side effects live there)."""
    config_path = os.path.join(etc_dir, "config.properties")
    node_path = os.path.join(etc_dir, "node.properties")
    props: Dict[str, str] = {}
    if os.path.exists(config_path):
        props.update(load_properties(config_path))
    if os.path.exists(node_path):
        props.update(load_properties(node_path))

    kwargs = PortOverrides(_server_args(), props, "config key",
                           "WorkerServer")
    props = kwargs.source
    if "http-server.http.port" in props:
        kwargs["port"] = int(props["http-server.http.port"])
    if "node.id" in props:
        kwargs["node_id"] = props["node.id"]
    if "node.environment" in props:
        kwargs["environment"] = props["node.environment"]
    if "coordinator" in props:
        kwargs["coordinator"] = _bool(props["coordinator"])
    if "discovery.uri" in props:
        kwargs["discovery_uri"] = props["discovery.uri"]
    if "announcement-interval-ms" in props:
        kwargs["announce_interval_s"] = \
            int(props["announcement-interval-ms"]) / 1000.0
    if _bool(props.get("http-server.https.enabled", "false")):
        kwargs["https_cert_path"] = props.get("https-cert-path")
        kwargs["https_key_path"] = props.get("https-key-path")
        if not kwargs["https_cert_path"]:
            raise ValueError(
                "http-server.https.enabled requires https-cert-path")
    if props.get("internal-communication.https.trust-store-path"):
        # applied by WorkerServer.__init__ (a parse must not mutate
        # process-global SSL state)
        kwargs["internal_ca_path"] = \
            props["internal-communication.https.trust-store-path"]
    if _bool(props.get("internal-communication.jwt.enabled", "false")):
        kwargs["jwt_enabled"] = True
        kwargs["jwt_secret"] = props.get(
            "internal-communication.shared-secret", "")
        if "internal-communication.jwt.expiration-seconds" in props:
            kwargs["jwt_expiration_s"] = int(
                props["internal-communication.jwt.expiration-seconds"])
    if "serving.plan-cache-entries" in props:
        kwargs["plan_cache_entries"] = int(
            props["serving.plan-cache-entries"])
    if "serving.total-concurrency" in props:
        n = int(props["serving.total-concurrency"])
        kwargs["total_concurrency"] = n if n > 0 else None
    if "serving.admission-headroom-fraction" in props:
        f = float(props["serving.admission-headroom-fraction"])
        if not 0.0 < f <= 1.0:
            raise ValueError(
                "serving.admission-headroom-fraction must be in (0, 1], "
                f"got {f}")
        kwargs["admission_headroom_fraction"] = f
    if "serving.batch-window-ms" in props:
        w = float(props["serving.batch-window-ms"])
        if w < 0:
            raise ValueError(
                f"serving.batch-window-ms must be >= 0, got {w}")
        kwargs["batch_window_ms"] = w
    if "serving.max-batch-size" in props:
        n = int(props["serving.max-batch-size"])
        if n < 1:
            raise ValueError(
                f"serving.max-batch-size must be >= 1, got {n}")
        kwargs["max_batch_size"] = n
    if props.get("serving.compilation-cache-dir"):
        kwargs["compilation_cache_dir"] = \
            props["serving.compilation-cache-dir"]
    if props.get("serving.plan-cache-path"):
        kwargs["plan_cache_path"] = props["serving.plan-cache-path"]
    # telemetry export + history (presto_tpu/telemetry/)
    if "telemetry.sink" in props:
        kwargs["telemetry_sink"] = props["telemetry.sink"]
    if "telemetry.path" in props:
        kwargs["telemetry_path"] = props["telemetry.path"]
    if "telemetry.otlp-endpoint" in props:
        kwargs["telemetry_endpoint"] = props["telemetry.otlp-endpoint"]
    if "telemetry.flush-interval" in props:
        kwargs["telemetry_flush_interval_s"] = parse_duration(
            props["telemetry.flush-interval"])
    if "telemetry.queue-bound" in props:
        n = int(props["telemetry.queue-bound"])
        if n < 1:
            raise ValueError(
                f"telemetry.queue-bound must be >= 1, got {n}")
        kwargs["telemetry_queue_bound"] = n
    if "telemetry.metrics-interval" in props:
        kwargs["telemetry_metrics_interval_s"] = parse_duration(
            props["telemetry.metrics-interval"])
    if "telemetry.history-path" in props:
        kwargs["history_path"] = props["telemetry.history-path"]
    if "telemetry.history-max-count" in props:
        kwargs["history_max_count"] = int(
            props["telemetry.history-max-count"])
    if props.get("telemetry.history-max-age"):
        kwargs["history_max_age_s"] = parse_duration(
            props["telemetry.history-max-age"])
    # base on the server's tuned defaults (WorkerServer.__init__), not the
    # bare ExecutionConfig — file keys override, absence must not detune
    kwargs["config"] = execution_config_from_properties(
        props, base=tuned_config())
    return dict(kwargs), dict(props)


def _server_args() -> list:
    """The WorkerServer constructor arguments the port has."""
    import inspect
    from .server import WorkerServer
    return [p for p in inspect.signature(WorkerServer.__init__).parameters
            if p != "self"]


def register_catalogs_from_etc(etc_dir: str) -> Dict[str, str]:
    """Mount every etc/catalog/*.properties connector (CatalogManager
    analog): connector.name picks the connector; returns
    {catalog_name: connector.name} for what was mounted."""
    from ..connectors import catalog as registry
    catalog_dir = os.path.join(etc_dir, "catalog")
    mounted: Dict[str, str] = {}
    if not os.path.isdir(catalog_dir):
        return mounted
    for fn in sorted(os.listdir(catalog_dir)):
        if not fn.endswith(".properties"):
            continue
        name = fn[:-len(".properties")]
        props = load_properties(os.path.join(catalog_dir, fn))
        kind = props.get("connector.name", "")
        if kind in ("hive", "hive-hadoop2"):
            from ..connectors import hive
            warehouse = props.get("hive.warehouse.dir",
                                  os.path.join(etc_dir, "warehouse"))
            registry.register_connector(
                name, hive.HiveConnector(
                    warehouse,
                    storage_format=props.get("hive.storage-format",
                                             "PARQUET").upper()))
        elif kind == "memory":
            from ..connectors.memory import MemoryConnector
            registry.register_connector(name, MemoryConnector())
        elif kind == "blackhole":
            from ..connectors.memory import BlackholeConnector
            registry.register_connector(name, BlackholeConnector())
        elif kind in ("tpch", "tpcds"):
            pass  # built-in generated catalogs are always mounted
        else:
            raise ValueError(
                f"catalog {name}: unknown connector.name {kind!r}")
        mounted[name] = kind
    return mounted
