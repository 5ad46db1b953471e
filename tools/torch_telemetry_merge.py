#!/usr/bin/env python3
"""Fold a directory of the port's per-process telemetry shards into one
snapshot and one chrome trace.

    python3 tools/torch_telemetry_merge.py <dir> [--out merged.json]
        [--chrome trace.json] [--json]

The CLI of ``tools/telemetry_merge.py`` over the port's
``mxnet_tpu_torch.telemetry.merge`` and ``merge_chrome_trace``, with the
same flags. Every process of a drill, a bench worker or a world of ranks
writes ``telemetry-r<rank>-p<pid>.jsonl`` under ``MXNET_TELEMETRY_DIR``
(``engine.waitall()`` and the preemption drain flush it). The fold sums
cumulative and time counters across processes, keeps gauges per process,
and gives the chrome trace one lane a process, with the spans of a
request that crossed processes linked into one flow by ``trace_id``.
``python -m mxnet_tpu_torch.telemetry merge <dir>`` is the same fold with
the report table. Exits 1 when the directory holds no shard.
"""
import argparse
import json
import os
import sys
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="MXNET_TELEMETRY_DIR shard directory")
    ap.add_argument("--out", default=None,
                    help="write the merged snapshot JSON here")
    ap.add_argument("--chrome", default=None,
                    help="write the merged per-process chrome trace here")
    ap.add_argument("--json", action="store_true", dest="emit_json",
                    help="print the whole merge to stdout as JSON")
    a = ap.parse_args(argv)

    from mxnet_tpu_torch import telemetry

    merged = telemetry.merge(a.dir)
    if not merged["shards"]:
        print(f"torch_telemetry_merge: no telemetry-*.jsonl shards under "
              f"{a.dir}", file=sys.stderr)
        return 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(merged, f, default=str)
    if a.chrome:
        with open(a.chrome, "w") as f:
            json.dump(telemetry.merge_chrome_trace(a.dir, merged), f)
    if a.emit_json:
        print(json.dumps(merged, default=str))
    else:
        print(f"torch_telemetry_merge: {len(merged['shards'])} shard(s), "
              f"{len(merged['counters'])} summed counters, "
              f"{len(merged['events'])} events, "
              f"{len(merged['spans'])} spans"
              + (f", {merged['skipped_lines']} torn line(s) skipped"
                 if merged["skipped_lines"] else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
