"""JSONL manifest loading (the port's copy of
speech2text_tpu/data/manifest.py).

Each line: {"audio_filepath": ..., "duration": seconds, "text": ...,
optional "spk_id", optional "offset"/"segment" fields}. Entries outside
[dur_min_filter, dur_max_filter] are dropped.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List


def load_manifest(
    path: str,
    dur_min_filter: float = 0.0,
    dur_max_filter: float = float("inf"),
) -> List[Dict[str, Any]]:
    entries: List[Dict[str, Any]] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = json.loads(line)
            dur = float(item.get("duration", 0.0))
            if dur_min_filter <= dur <= dur_max_filter:
                entries.append(item)
    return entries


def iter_text(entries: List[Dict[str, Any]]) -> Iterator[str]:
    for e in entries:
        if "text" in e:
            yield e["text"]
