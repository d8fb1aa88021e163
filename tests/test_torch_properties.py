"""The port's etc-directory configuration against the reference's.

The cases of tests/test_events_config.py (properties parsing, the
ExecutionConfig and WorkerServer mappings, catalog mounts, the typed
SystemConfig) run through presto_tpu.worker.properties and
presto_tpu_torch.worker.properties on the same files: equal values on
every field the port has; a key the reference maps onto a field or server
argument the port lacks raises NotImplementedError naming the key."""
import dataclasses

import os

import pytest

from presto_tpu.worker import properties as jprops
from presto_tpu.worker import protocol as jproto
from presto_tpu_torch.worker import properties as tprops
from presto_tpu_torch.worker import protocol as tproto
from torch_threads import one_torch_thread  # noqa: F401


def _port_fields_equal(jcfg, tcfg):
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


PROPERTY_FILES = {
    "format": ("# comment\n! also comment\ncoordinator=true\n"
               "colon.key: colon value\nspaced.key =  trimmed  \n"
               "continued.key=one\\\ntwo\nbare-flag\n"),
    "trailing_continuation": "plugin.bundles=/a/b,\\",
    "colon_with_equals": "launcher.args: -Dfoo=bar\n",
}


@pytest.mark.parametrize("name", sorted(PROPERTY_FILES))
def test_load_properties_equal(tmp_path, name):
    p = tmp_path / "c.properties"
    p.write_text(PROPERTY_FILES[name])
    got = tprops.load_properties(str(p))
    assert got == jprops.load_properties(str(p))
    if name == "format":
        assert got["continued.key"] == "onetwo" and got["bare-flag"] == ""


# (properties, the port lacks one of the keys)
CONFIGS = [
    ({"query.max-memory-per-node": "512MB", "task.batch-rows": "8192",
      "coordinator-only.key": "ignored"}, None),
    ({"query.max-memory": "2GB", "task.plan-validation": "strict"}, None),
    ({"memory.max-query-bytes": "12345", "scan.kernel": "PALLAS",
      "scan.kernel-dma": "double"}, None),
    ({"scan.kernel": "xla", "scan.kernel-dma": "single"}, None),
    # the reference's mapping case (test_events_config.py:73)
    ({"query.max-memory-per-node": "512MB",
      "experimental.spill-enabled": "false",
      "exchange.compression-enabled": "true",
      "exchange.compression-codec": "zstd", "task.batch-rows": "8192",
      "coordinator-only.key": "ignored"}, None),
    # ported with the device exchange (parallel/exchange.py)
    ({"exchange.ici-chunk-rows": "4096"}, None),
    # the task plane's keys are ported with worker/task.py
    ({"task.fault-injection-probability": "0.1"}, None),
    # ExecutionConfig.profile_dir is a field since EXPLAIN ANALYZE's
    # profiler capture
    ({"telemetry.profile-dir": "/x"}, None),
    # ported with the distributed scheduler (parallel/fabric.py)
    ({"exchange.fabric": "http"}, None),
    ({"debug.lock-validation": "true"}, None),
    ({"retry-policy": "task", "spool.path": "/z",
      "query.max-execution-time": "30s"}, None),
    # ExecutionConfig.fuse_pipelines is a field since the torch chain
    ({"task.fuse-pipelines": "false", "task.batch-rows": "8192"}, None),
    # the spill fields are ported with execution under a memory budget
    ({"query.max-memory-per-node": "512MB",
      "experimental.spill-enabled": "false",
      "experimental.spiller-max-used-space": "2GB",
      "experimental.spiller-spill-path": "/x/spill",
      "spill.async-staging": "false"}, None),
    ({"spill.host-budget-bytes": "4096", "spill.path": "/y"}, None),
    # ported with the scan drivers and grouped lifespans
    ({"task.max-drivers-per-task": "4", "task.grouped-lifespans": "4",
      "task.grouped-prefetch-depth": "2"}, None),
    ({"task.grouped-lifespan-sharding": "false"}, None),
    ({"exchange.client-threads": "8", "exchange.fabric": "AUTO",
      "task.grouped-lifespan-sharding": "true"}, None),
]


@pytest.mark.parametrize("props,missing", CONFIGS,
                         ids=[f"case{i}" for i in range(len(CONFIGS))])
def test_execution_config_mapping(props, missing):
    jcfg = jprops.execution_config_from_properties(props)
    if missing is None:
        tcfg = tprops.execution_config_from_properties(props)
        _port_fields_equal(jcfg, tcfg)
    else:
        with pytest.raises(NotImplementedError, match=missing):
            tprops.execution_config_from_properties(props)


@pytest.mark.parametrize("props,match", [
    ({"exchange.compression-codec": "LZO"}, "LZO"),
    ({"scan.kernel": "kernel"}, "scan.kernel must be one of"),
    ({"scan.kernel-dma": "triple"}, "scan.kernel-dma must be one of"),
    ({"task.plan-validation": "loud"}, "task.plan-validation must be"),
    ({"task.batch-rows": "many"}, "invalid literal"),
    ({"exchange.fabric": "bogus"}, "exchange.fabric must be one of"),
    ({"exchange.client-threads": "0"},
     "exchange.client-threads must be >= 1"),
    ({"retry-policy": "sometimes"}, "retry-policy must be one of"),
])
def test_bad_values_raise_the_reference_errors(props, match):
    for mod in (jprops, tprops):
        with pytest.raises(ValueError, match=match):
            mod.execution_config_from_properties(props)


def _write_etc(tmp_path, config="", catalogs=(("tpch", "tpch"),)):
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "coordinator=true\nhttp-server.http.port=0\n"
        "query.max-memory-per-node=1GB\n" + config)
    (etc / "node.properties").write_text(
        "node.environment=staging\nnode.id=node-cfg-1\n")
    for name, kind in catalogs:
        (etc / "catalog" / f"{name}.properties").write_text(
            f"connector.name={kind}\n")
    return str(etc)


@pytest.mark.parametrize("extra", [
    "", "announcement-interval-ms=250\n",
    "scan.kernel=auto\nscan.kernel-dma=double\ntask.batch-rows=8192\n",
    "serving.plan-cache-entries=7\nserving.total-concurrency=3\n"
    "serving.admission-headroom-fraction=0.5\n",
    "internal-communication.jwt.enabled=true\n"
    "internal-communication.shared-secret=s3cret\n"
    "internal-communication.jwt.expiration-seconds=60\n",
    "discovery.uri=http://127.0.0.1:9\n"],
    ids=["base", "announce", "kernel", "serving", "jwt", "discovery"])
def test_server_kwargs_from_etc_equal(tmp_path, extra):
    etc = _write_etc(tmp_path, extra)
    jkw, jp = jprops.server_kwargs_from_etc(etc)
    tkw, tp = tprops.server_kwargs_from_etc(etc)
    assert tp == jp
    assert set(tkw) == set(jkw)
    for k in tkw:
        if k == "config":
            _port_fields_equal(jkw[k], tkw[k])
        else:
            assert tkw[k] == jkw[k], k
    assert tkw["node_id"] == "node-cfg-1" and tkw["coordinator"] is True
    assert tkw["config"].memory_budget_bytes == 1 << 30
    # the tuned defaults survive an etc dir without execution keys
    assert tkw["config"].batch_rows == (8192 if "batch-rows" in extra
                                        else 1 << 16)


@pytest.mark.parametrize("key,value", [
    ("serving.batch-window-ms", "2"), ("serving.max-batch-size", "4"),
    ("serving.compilation-cache-dir", "/tmp/cc"),
    ("serving.plan-cache-path", "/tmp/pc"), ("telemetry.sink", "jsonl"),
    ("telemetry.queue-bound", "8"), ("telemetry.history-path", "/tmp/h"),
    ("telemetry.history-max-count", "9")])
def test_server_keys_the_port_lacks_raise(tmp_path, key, value):
    etc = _write_etc(tmp_path, f"{key}={value}\n")
    jkw, _ = jprops.server_kwargs_from_etc(etc)
    if key.startswith(("serving.", "telemetry.")):
        # the serving plane and telemetry are ported since: their keys
        # map onto the server's arguments as the reference maps them
        tkw, _ = tprops.server_kwargs_from_etc(etc)
        assert set(tkw) == set(jkw)
        assert all(tkw[k] == jkw[k] for k in tkw if k != "config")
        return
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        tprops.server_kwargs_from_etc(etc)


def test_register_catalogs_from_etc(tmp_path):
    etc = _write_etc(tmp_path, catalogs=(("tpch", "tpch"),
                                         ("ds", "tpcds")))
    assert tprops.register_catalogs_from_etc(etc) == \
        jprops.register_catalogs_from_etc(etc) == \
        {"tpch": "tpch", "ds": "tpcds"}


def test_catalog_mounts(tmp_path):
    etc = _write_etc(tmp_path / "a", catalogs=(("bad", "not-a-connector"),))
    for mod in (jprops, tprops):
        with pytest.raises(ValueError, match="not-a-connector"):
            mod.register_catalogs_from_etc(etc)
    # the memory and hive connectors are ported since: they mount as the
    # reference's do
    etc = _write_etc(tmp_path / "b", catalogs=(("mem", "memory"),))
    try:
        assert tprops.register_catalogs_from_etc(etc) == \
            jprops.register_catalogs_from_etc(etc) == {"mem": "memory"}
    finally:
        from presto_tpu.connectors import catalog as jcatalog
        from presto_tpu_torch.connectors import catalog as tcatalog
        tcatalog.unregister_connector("mem")
        jcatalog.unregister_connector("mem")
    etc = _write_etc(tmp_path / "c", catalogs=(("h", "hive"),))
    with open(os.path.join(etc, "catalog", "h.properties"), "a") as f:
        f.write(f"hive.warehouse.dir={tmp_path / 'wh'}\n"
                "hive.storage-format=orc\n")
    from presto_tpu.connectors import catalog as jcatalog
    from presto_tpu_torch.connectors import catalog as tcatalog
    try:
        assert tprops.register_catalogs_from_etc(etc) == \
            jprops.register_catalogs_from_etc(etc) == {"h": "hive"}
        tconn, jconn = tcatalog.module("h"), jcatalog.module("h")
        assert (tconn.warehouse, tconn.storage_format) == \
            (jconn.warehouse, jconn.storage_format) == \
            (str(tmp_path / "wh"), "ORC")
    finally:
        tcatalog.unregister_connector("h")
        jcatalog.unregister_connector("h")


def test_system_config_typed_accessors():
    props = {"http-server.http.port": "9090",
             "experimental.spill-enabled": "false",
             "task.max-drivers-per-task": "8", "node.pool": "LEAF",
             "scan.kernel-dma": "double"}
    jc, tc = jprops.SystemConfig(props), tprops.SystemConfig(props)
    assert tc.to_dict() == jc.to_dict()
    assert tc.get("scan.kernel-dma") == "double"
    with pytest.raises(KeyError):
        tc.get("no.such.key")


SESSIONS = [
    ({"scan_kernel": "pallas", "task_batch_rows": "8192",
      "plan_validation": "off"}, None),
    ({"query_max_memory_per_node": "1GB", "query_max_memory": "2GB",
      "storage_zone_rows": "4096"}, None),
    ({"spill_enabled": "true"}, None),
    # ported with the task plane
    ({"exchange_compression": "true"}, None),
    ({"lock_validation": "on"}, None),
    # ported with the streaming join (its dynamic filter)
    ({"dynamic_filtering": "false",
      "dynamic_filtering_max_distinct_values": "64"}, None),
    ({"profile": "true"}, None),
    ({"analyze_unfused": "true"}, None),
    ({"spill_enabled": "false", "spill_partitions": "4",
      "spill_path": "/x", "spill_host_budget_bytes": "1024",
      "spill_async_staging": "false"}, None),
    # ported with grouped lifespans
    ({"grouped_lifespans": "3", "grouped_prefetch_depth": "0"}, None),
    # ported with the distributed scheduler
    ({"grouped_lifespan_sharding": "false"}, None),
    ({"exchange_client_threads": "2", "adaptive_exchange": "false"}, None),
    # the reference maps no exchange_fabric session property: both
    # packages leave the config's fabric as it is
    ({"exchange_fabric": "http"}, None),
    # ported with query history (telemetry/history.py)
    ({"adaptive_history_sizing": "true"}, None),
]


@pytest.mark.parametrize("session,missing", SESSIONS,
                         ids=[f"session{i}" for i in range(len(SESSIONS))])
def test_session_properties(session, missing):
    from presto_tpu.exec.pipeline import tuned_config as jtuned
    from presto_tpu_torch.exec.pipeline import tuned_config
    jcfg = jproto.apply_session_properties(jtuned(), session)
    if missing is None:
        _port_fields_equal(
            jcfg, tproto.apply_session_properties(tuned_config(), session))
    else:
        with pytest.raises(NotImplementedError, match=missing):
            tproto.apply_session_properties(tuned_config(), session)


@pytest.mark.parametrize("session,match", [
    ({"scan_kernel": "bogus"}, "scan_kernel must be one of"),
    ({"exchange_compression_codec": "LZO"}, "LZO"),
    ({"storage_zone_rows": "0"}, "storage_zone_rows must be >= 1"),
    ({"exchange_client_threads": "0"},
     "exchange_client_threads must be >= 1")])
def test_bad_session_values_raise_the_reference_errors(session, match):
    from presto_tpu.exec.pipeline import tuned_config as jtuned
    from presto_tpu_torch.exec.pipeline import tuned_config
    for proto, cfg in ((jproto, jtuned()), (tproto, tuned_config())):
        with pytest.raises(ValueError, match=match):
            proto.apply_session_properties(cfg, session)


@pytest.mark.parametrize("value", ["512MB", "1GB", "3kB", "17", 5])
def test_unit_parsers_equal(value):
    assert tproto.parse_data_size(value) == jproto.parse_data_size(value)
    dur = f"{value}".replace("MB", "ms").replace("GB", "s") \
        .replace("kB", "m")
    assert tproto.parse_duration(dur) == jproto.parse_duration(dur)
