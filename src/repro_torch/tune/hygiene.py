"""Plan-cache hygiene: validate a persisted port plan cache (twin of
``repro.tune.hygiene``).  Checks:

* **schema** — the file declares ``CACHE_SCHEMA`` (2) and carries the
  per-format registry stamps that retire stale plans;
* **key anatomy** — every key has the 9 segments
  ``dev|op|MNK|tile|formats|ratioA|ratioB|ratioC|struct`` with a
  format-set segment at index 4 (a ratio there is a key of the layout
  before format sets);
* **live formats** — every format a key names is stamped and registered
  in this process (``PlanCache`` would keep such an entry on disk but
  never serve it);
* **canonical ordering** — the file is its own ``indent=1,
  sort_keys=True`` dump (what ``PlanCache.save`` writes);
* **round trip** — loading through :class:`repro_torch.tune.search.
  PlanCache` and saving again keeps every plan, its meta and every
  stamp.

CLI::

    python -m repro_torch.tune.hygiene ~/.cache/repro-torch-tune/plans.json
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile

from repro_torch.core.formats import registry_signatures
from repro_torch.tune.search import CACHE_SCHEMA, PlanCache, cache_path

#: segment count of a plan key
KEY_SEGMENTS = 9
_RATIO_SEG = re.compile(r"^\d+D\d+S(\d+Q)?$")
_MNK_SEG = re.compile(r"^M\d+N\d+K\d+$")
_TILE_SEG = re.compile(r"^t\d+$")


def _canonical(payload: dict) -> str:
    return json.dumps(payload, indent=1, sort_keys=True)


def validate_cache(path: str) -> list[str]:
    """Human-readable problems of the cache file at ``path`` (empty ==
    clean)."""
    if not os.path.exists(path):
        return [f"{path}: missing"]
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError as e:
        return [f"{path}: invalid JSON ({e})"]

    problems: list[str] = []
    schema = payload.get("schema", 1)
    if schema != CACHE_SCHEMA:
        problems.append(f"schema is {schema!r}, expected {CACHE_SCHEMA}")
    stamps = payload.get("formats")
    if not isinstance(stamps, dict) or not stamps:
        problems.append("missing per-format registry stamps ('formats')")
        stamps = {}
    live = registry_signatures()

    plans = payload.get("plans", {})
    for key, ent in plans.items():
        segs = key.split("|")
        if len(segs) != KEY_SEGMENTS:
            problems.append(f"key has {len(segs)} segments (v1-era?): "
                            f"{key}")
            continue
        if not _MNK_SEG.match(segs[2]) or not _TILE_SEG.match(segs[3]):
            problems.append(f"malformed shape/tile segments: {key}")
        if _RATIO_SEG.match(segs[4]):
            problems.append(f"stale v1 key (ratio where the format-set "
                            f"segment belongs): {key}")
            continue
        names = segs[4].split("+")
        unstamped = [n for n in names if n not in stamps]
        if unstamped:
            problems.append(f"key references unstamped formats "
                            f"{unstamped}: {key}")
        unregistered = [n for n in names if n not in live]
        if unregistered:
            problems.append(
                f"key names format(s) {unregistered} not registered in "
                f"this process (PlanCache would keep the entry and never "
                f"serve it): {key}")
        missing = [f for f in ("path", "bm", "bn", "bk") if f not in ent]
        if missing:
            problems.append(f"entry missing fields {missing}: {key}")

    if text.rstrip("\n") != _canonical(payload):
        problems.append("file is not its own canonical dump "
                        "(indent=1, sort_keys) — non-deterministic writer?")

    if not problems:
        cache = PlanCache(path)
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            cache.save_as(tmp)
            with open(tmp) as f:
                rt = json.load(f)
            if rt.get("plans") != plans:
                changed = sorted(k for k in set(plans) | set(rt["plans"])
                                 if plans.get(k) != rt["plans"].get(k))
                problems.append(f"round trip changed the plan set: "
                                f"{changed}")
            for name, stamp in stamps.items():
                if rt.get("formats", {}).get(name, stamp) != stamp:
                    problems.append(f"round trip changed stamp for {name}")
        finally:
            os.unlink(tmp)
    return problems


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    path = args[0] if args else cache_path()
    problems = validate_cache(path)
    if problems:
        print(f"{path}: {len(problems)} problem(s)", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    with open(path) as f:
        n = len(json.load(f).get("plans", {}))
    print(f"{path}: clean ({n} plans, schema {CACHE_SCHEMA})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
