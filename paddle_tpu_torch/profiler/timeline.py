"""Timeline merge tool (port of paddle_tpu/profiler/timeline.py;
≈ the reference's tools/timeline.py).

The reference converts profiler.proto dumps from several trainers into one
Chrome trace (`--profile_path trainer1=f1,trainer2=f2`, timeline.py:25-36).
Here profiles are the Chrome-trace jsons written by
`profiler.save_profile` (host spans) — `merge_profiles` re-pids each
process's events into a single trace viewable in chrome://tracing or
perfetto. Device captures (`<host>.<pid>.trace.json.gz` under a
trace dir) are already Chrome traces: perfetto opens several at once.

    python -m paddle_tpu_torch.profiler.timeline \\
        --profile_path trainer1=t1.json,trainer2=t2.json \\
        --timeline_path merged.json
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


class Timeline:
    """Accumulates events from named profiles into one Chrome trace."""

    def __init__(self):
        self._events: List[dict] = []
        self._pid = 0

    def add_profile(self, name: str, profile: dict) -> None:
        pid = self._pid
        self._pid += 1
        self._events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        for ev in profile.get("traceEvents", []):
            # the source's process_name is superseded by `name`, but
            # thread_name rows (e.g. the request tracer's "req N"
            # labels) must survive the merge
            if ev.get("ph") == "M" and ev.get("name") != "thread_name":
                continue
            ev = dict(ev)
            ev["pid"] = pid
            self._events.append(ev)

    def trace(self) -> dict:
        return {"traceEvents": self._events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace(), f)


def merge_profiles(profile_paths: Dict[str, str],
                   output_path: Optional[str] = None) -> dict:
    """Merge `{process_name: chrome_trace_json_path}` into one trace.

    ≈ timeline.py's `--profile_path trainer1=f1,trainer2=f2` CLI.
    """
    tl = Timeline()
    for name, path in profile_paths.items():
        with open(path) as f:
            tl.add_profile(name, json.load(f))
    if output_path:
        tl.save(output_path)
    return tl.trace()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="merge paddle_tpu profiles")
    p.add_argument("--profile_path", required=True,
                   help="name1=path1,name2=path2,...")
    p.add_argument("--timeline_path", required=True)
    args = p.parse_args(argv)
    paths = dict(kv.split("=", 1) for kv in args.profile_path.split(","))
    merge_profiles(paths, args.timeline_path)


if __name__ == "__main__":
    main()
