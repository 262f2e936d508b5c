"""CLI: node lifecycle, interactive SQL shell, backup/restore, status
(port of snappydata_tpu/cli.py).

The reference's `bin/snappy` launcher + `snappy-sql` shell +
`snappy-start-all.sh` surface (cluster/bin, cluster/sbin; QuickLauncher
launcher/.../QuickLauncher.java:38-58; SnappyUtilLauncher backup/restore).

Usage:
  python -m snappydata_tpu_torch locator [--port P]
  python -m snappydata_tpu_torch server  --locator HOST:PORT [--data-dir D]
                                         [--device cuda|cpu]
  python -m snappydata_tpu_torch lead    --locator HOST:PORT [--data-dir D]
                                         [--device cuda|cpu]
  python -m snappydata_tpu_torch sql     --connect HOST:PORT [-e "SELECT ..."]
  python -m snappydata_tpu_torch sql     --locator HOST:PORT [-e "SELECT ..."]
  python -m snappydata_tpu_torch backup  --data-dir D --dest DIR
  python -m snappydata_tpu_torch restore --backup DIR --data-dir D
  python -m snappydata_tpu_torch status  --locator HOST:PORT
  python -m snappydata_tpu_torch rebalance --lead HOST:PORT

`--device` names the torch device a server's or a lead's session runs on:
`cuda` by default, which raises without a GPU (there is no silent CPU
fallback); `cpu` runs a member without one, as tests and CPU-only hosts
do.  The multi-host flags of `server` (`--coordinator`,
`--num-processes`, `--process-id`) join the process to a
torch.distributed world (parallel/multihost.py) before the session
starts, and the server then owns its rank's local slots as its submesh;
`--mesh-devices` names the submesh's global slot indices explicitly.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time


def _cmd_locator(args) -> int:
    from snappydata_tpu_torch.cluster import LocatorNode

    node = LocatorNode(host=args.host, port=args.port).start()
    print(f"locator running at {node.address}", flush=True)
    _wait_forever()
    return 0


def _session(args):
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    return SnappySession(catalog=None if args.data_dir else Catalog(),
                         data_dir=args.data_dir, device=args.device)


def _cmd_server(args) -> int:
    # the multi-host world first (flags override SNAPPY_COORDINATOR /
    # _NUM_PROCESSES / _PROCESS_ID): the slot list depends on it
    from snappydata_tpu_torch.parallel.multihost import (
        initialize_multihost, local_device_indices)

    multihost = initialize_multihost(coordinator=args.coordinator,
                                     num_processes=args.num_processes,
                                     process_id=args.process_id,
                                     device=args.device)
    from snappydata_tpu_torch.cluster import ServerNode

    mesh_devices = None
    if args.mesh_devices:
        mesh_devices = [int(x) for x in args.mesh_devices.split(",")]
    elif multihost:
        # a per-host server owns exactly its rank's local slots
        mesh_devices = local_device_indices(args.device)
    node = ServerNode(args.locator, _session(args), host=args.host,
                      flight_port=args.port,
                      mesh_devices=mesh_devices).start()
    extra = f", submesh {mesh_devices}" if mesh_devices else ""
    print(f"server {node.member_id} flight at {node.flight_address}"
          + extra, flush=True)
    _wait_forever()
    return 0


def _cmd_lead(args) -> int:
    from snappydata_tpu_torch.cluster import LeadNode

    node = LeadNode(args.locator, _session(args), host=args.host,
                    flight_port=args.port,
                    rest_port=args.rest_port).start(wait_for_primary=False)
    deadline = time.time() + 15
    while time.time() < deadline and not node.is_primary:
        time.sleep(0.1)
    role = "primary" if node.is_primary else "standby"
    print(f"lead {node.member_id} ({role}) flight at "
          f"{node.host}:{node.flight.port}"
          + (f", rest at {node.rest_address}" if node.rest_address else ""),
          flush=True)
    _wait_forever()
    return 0


def _cmd_sql(args) -> int:
    from snappydata_tpu_torch.cluster import SnappyClient

    client = SnappyClient(address=args.connect, locator=args.locator)
    if args.execute:
        _run_one(client, args.execute)
        return 0
    print("snappy-tpu SQL shell — end statements with ';', \\q to quit")
    buf = []
    while True:
        try:
            prompt = "snappy> " if not buf else "     -> "
            line = input(prompt)
        except EOFError:
            break
        if line.strip() in ("\\q", "exit", "quit"):
            break
        buf.append(line)
        joined = " ".join(buf)
        if joined.rstrip().endswith(";"):
            buf = []
            try:
                _run_one(client, joined.rstrip().rstrip(";"))
            except Exception as e:  # noqa: BLE001 - the shell keeps reading
                print(f"ERROR: {e}")
    return 0


def _run_one(client, sql: str) -> None:
    head = sql.lstrip().split(None, 1)[0].lower() if sql.strip() else ""
    if head in ("select", "values", "show", "describe"):
        table = client.sql(sql)
        names = table.column_names
        print(" | ".join(names))
        print("-+-".join("-" * len(n) for n in names))
        for row in zip(*(table.column(i).to_pylist()
                         for i in range(table.num_columns))):
            print(" | ".join(str(v) for v in row))
        print(f"({table.num_rows} rows)")
    else:
        out = client.execute(sql)
        print(json.dumps(out))


def _cmd_backup(args) -> int:
    """Offline/online backup = consistent copy of the disk store (ref:
    SnappyUtilLauncher backup)."""
    import os

    if not os.path.exists(f"{args.data_dir}/catalog.json"):
        print(f"no disk store at {args.data_dir}", file=sys.stderr)
        return 1
    if os.path.exists(args.dest):
        print(f"destination already exists: {args.dest}", file=sys.stderr)
        return 1
    shutil.copytree(args.data_dir, args.dest)
    print(f"backup written to {args.dest}")
    return 0


def _cmd_restore(args) -> int:
    import os

    if os.path.exists(args.data_dir):
        print(f"data dir already exists: {args.data_dir}", file=sys.stderr)
        return 1
    shutil.copytree(args.backup, args.data_dir)
    print(f"restored into {args.data_dir}")
    return 0


def _cmd_status(args) -> int:
    from snappydata_tpu_torch.cluster.locator import LocatorClient

    lc = LocatorClient(args.locator, "status-cli", "client")
    try:
        members = lc.members()
    finally:
        lc.close()
    for m in members:
        print(f"{m.role:8s} {m.member_id:24s} {m.host}:{m.port}")
    print(f"({len(members)} members)")
    return 0


def _cmd_rebalance(args) -> int:
    """Operator action: POST /rebalance on the primary lead (ref:
    CALL SYS.REBALANCE_ALL_BUCKETS())."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://{args.lead}/rebalance",
                                 data=b"{}", method="POST")
    if args.token:
        req.add_header("Authorization", f"Bearer {args.token}")
    try:
        with urllib.request.urlopen(req) as resp:
            out = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        # non-2xx still carries the JSON error payload
        try:
            out = json.loads(e.read().decode("utf-8"))
        except ValueError:
            out = {"error": str(e)}
    print(json.dumps(out, indent=2))
    return 0 if "error" not in out else 1


def _wait_forever() -> None:
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="snappydata_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("locator")
    lp.add_argument("--host", default="127.0.0.1")
    lp.add_argument("--port", type=int, default=10334)
    lp.set_defaults(fn=_cmd_locator)

    for role, fn in (("server", _cmd_server), ("lead", _cmd_lead)):
        rp = sub.add_parser(role)
        rp.add_argument("--locator", required=True)
        rp.add_argument("--host", default="127.0.0.1")
        rp.add_argument("--port", type=int, default=0)
        rp.add_argument("--data-dir", default=None)
        rp.add_argument("--device", default="cuda",
                        help="torch device of the member's session (cuda "
                             "raises without a GPU; cpu runs without one)")
        if role == "lead":
            rp.add_argument("--rest-port", type=int, default=5050)
        if role == "server":
            rp.add_argument("--mesh-devices", default=None,
                            help="comma-separated GLOBAL slot indices "
                                 "this server's submesh owns")
            rp.add_argument("--coordinator", default=None,
                            help="multi-host coordinator host:port (a "
                                 "torch.distributed tcp:// rendezvous)")
            rp.add_argument("--num-processes", type=int, default=None)
            rp.add_argument("--process-id", type=int, default=None)
        rp.set_defaults(fn=fn)

    sp = sub.add_parser("sql")
    sp.add_argument("--connect", default=None, help="host:port of a member")
    sp.add_argument("--locator", default=None)
    sp.add_argument("-e", "--execute", default=None)
    sp.set_defaults(fn=_cmd_sql)

    bp = sub.add_parser("backup")
    bp.add_argument("--data-dir", required=True)
    bp.add_argument("--dest", required=True)
    bp.set_defaults(fn=_cmd_backup)

    rp = sub.add_parser("restore")
    rp.add_argument("--backup", required=True)
    rp.add_argument("--data-dir", required=True)
    rp.set_defaults(fn=_cmd_restore)

    st = sub.add_parser("status")
    st.add_argument("--locator", required=True)
    st.set_defaults(fn=_cmd_status)

    rb = sub.add_parser("rebalance")
    rb.add_argument("--lead", required=True,
                    help="host:port of the primary lead's REST endpoint")
    rb.add_argument("--token", default=None)
    rb.set_defaults(fn=_cmd_rebalance)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
