"""Worker process entry point.

    python -m presto_tpu_torch.worker --etc-dir DIR [--device cuda|cpu]
    python -m presto_tpu_torch.worker --coordinator --http-port 8080

The port of presto_tpu/worker/__main__.py (the analog of the native
worker main, presto_cpp/main/PrestoServer.cpp:197): start the HTTP
server, announce to discovery, serve until interrupted.  Configuration
takes the reference's precedence: built-in defaults, then the etc
directory's file keys, then the flags given.  `--device` picks the device
every statement runs on ("cuda" by default: without CUDA the process
exits non-zero at start-up; the tests pass "cpu").
"""
from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="presto-tpu-torch-worker")
    # None defaults distinguish "not given" from "given at default value"
    # so explicit flags always beat etc-dir file keys
    parser.add_argument("--http-port", type=int, default=None)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--discovery-uri", default=None)
    parser.add_argument("--coordinator", action="store_const", const=True,
                        default=None,
                        help="also host the embedded discovery service")
    parser.add_argument("--environment", default=None)
    parser.add_argument("--hive-warehouse", default=None, metavar="DIR",
                        help="mount a Parquet warehouse directory as the "
                             "'hive' catalog (CREATE TABLE AS / INSERT)")
    parser.add_argument("--etc-dir", default=None, metavar="DIR",
                        help="boot from an etc/ directory of "
                             "config.properties / node.properties / "
                             "catalog/*.properties (the reference's file "
                             "configuration layout); command-line flags "
                             "override file keys")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device statements run on")
    args = parser.parse_args(argv)

    if args.hive_warehouse:
        from ..connectors import catalog, hive
        catalog.register_connector(
            "hive", hive.HiveConnector(args.hive_warehouse))

    # baseline defaults <- etc-dir file keys <- explicitly-given flags
    kwargs = dict(port=0, node_id=None, coordinator=False,
                  discovery_uri=None, environment="production")
    if args.etc_dir:
        from .properties import (register_catalogs_from_etc,
                                 server_kwargs_from_etc)
        file_kwargs, _props = server_kwargs_from_etc(args.etc_dir)
        register_catalogs_from_etc(args.etc_dir)
        kwargs.update(file_kwargs)
    for k, v in (("port", args.http_port), ("node_id", args.node_id),
                 ("coordinator", args.coordinator),
                 ("discovery_uri", args.discovery_uri),
                 ("environment", args.environment)):
        if v is not None:
            kwargs[k] = v
    if args.etc_dir:
        import os
        listener_path = os.path.join(args.etc_dir,
                                     "event-listener.properties")
        if os.path.exists(listener_path):
            from .events import EventListenerManager, FileEventListener
            from .properties import load_properties
            lp = load_properties(listener_path)
            name = lp.get("event-listener.name")
            if name != "file":
                # refuse to boot with a silently-dead audit log
                raise SystemExit(
                    f"unknown event-listener.name {name!r} in "
                    f"{listener_path}; supported: file")
            mgr = EventListenerManager()
            mgr.register(FileEventListener(
                lp.get("event-listener.path",
                       os.path.join(args.etc_dir, "events.jsonl"))))
            kwargs["events"] = mgr

    from .server import WorkerServer
    server = WorkerServer(device=args.device, **kwargs)
    print(f"presto-tpu-torch worker {server.node_id} listening on "
          f"{server.uri} (device {server.device})", flush=True)

    import threading
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
