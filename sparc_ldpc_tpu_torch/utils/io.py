"""Structured jsonl results and the restartable campaign journal (port of
sparc_ldpc_tpu/utils/io.py).

Every sweep point appends one json line {ebno_db, ber, fer, trials, ...};
every executed block appends one journal line, so a restarted campaign
replays the finished blocks instead of running them and ends with the
same counters.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def read_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class CampaignState:
    """Restartable per-point counters keyed by (point_idx, block_idx).

    The journal is append-only jsonl; on restart, completed blocks are
    replayed into counters and skipped by the driver, so a crash mid-block
    costs only that block.

    A block run with a section axis (section_shards > 1) has its own draws
    and decode (no in-kernel noise, the sharded loop), so its journal line
    carries `section_shards`, and `check_resume` refuses to mix blocks of
    another section axis into this run.  Lines of S = 1 are the
    reference's.

    A block's draws also depend on the device type of its generator: a CUDA
    and a CPU torch.Generator seeded alike draw different bits and noise
    (utils/rng.py).  With draw_device given ("cuda" or "cpu"), each line
    records it as `draw_device`, and `check_resume` refuses a line of
    another device type.  Lines without the field (the reference's, and
    the port's before it recorded one) resume as before.
    """

    def __init__(self, journal_path: Optional[str], section_shards: int = 1,
                 draw_device: Optional[str] = None):
        self.journal_path = journal_path
        self.section_shards = section_shards
        self.draw_device = draw_device
        self.done: Dict[tuple, Dict[str, Any]] = {}
        if journal_path:
            for rec in read_jsonl(journal_path):
                if rec.get("kind") == "block":
                    self.done[(rec["point"], rec["block"])] = rec

    def check_resume(self) -> None:
        """Raise if a journaled block was run with another section axis or
        drew on another device type than this run."""
        for (point, block), rec in sorted(self.done.items()):
            where = f"journal {self.journal_path}: point {point} block {block}"
            s = rec.get("section_shards", 1)
            if s != self.section_shards:
                raise ValueError(
                    f"{where} ran with section_shards={s}, this run has "
                    f"{self.section_shards}; its draws and decode differ, "
                    f"so resume with the same section shards or start a "
                    f"new journal")
            d = rec.get("draw_device")
            if (d is not None and self.draw_device is not None
                    and d != self.draw_device):
                raise ValueError(
                    f"{where} drew on draw_device={d!r}, this run draws on "
                    f"{self.draw_device!r}; a {d} and a {self.draw_device} "
                    f"generator draw different bits and noise from one "
                    f"seed, so resume on a {d} device or start a new "
                    f"journal")

    def is_done(self, point: int, block: int) -> bool:
        return (point, block) in self.done

    def block_record(self, point: int, block: int) -> Dict[str, Any]:
        return self.done[(point, block)]

    def record_block(self, point: int, block: int,
                     counters: Dict[str, Any]) -> None:
        rec = dict(kind="block", point=point, block=block, **counters)
        if self.section_shards != 1:
            rec["section_shards"] = self.section_shards
        if self.draw_device is not None:
            rec["draw_device"] = self.draw_device
        self.done[(point, block)] = rec
        if self.journal_path:
            append_jsonl(self.journal_path, rec)
