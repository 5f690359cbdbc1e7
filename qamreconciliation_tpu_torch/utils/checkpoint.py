"""Resumable sweep state.

Every completed SNR point is appended to a JSONL sidecar; on restart with
``--resume`` the completed points are skipped and the final CSV still comes
out identical.
"""

from __future__ import annotations

import json
import os

__all__ = ["SweepState"]


class SweepState:
    """Append-per-point sweep journal next to the output CSV."""

    def __init__(self, out_csv: str, resume: bool = False):
        self.path = out_csv + ".partial.jsonl"
        self.rows: dict[float, dict] = {}
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    self.rows[float(row["point"])] = row
        elif os.path.exists(self.path):
            os.remove(self.path)

    def done(self, point: float) -> dict | None:
        return self.rows.get(float(point))

    def record(self, point: float, values: dict):
        row = {"point": float(point), **values}
        self.rows[float(point)] = row
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def cleanup(self):
        if os.path.exists(self.path):
            os.remove(self.path)
