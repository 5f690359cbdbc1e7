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
    """Append-per-point sweep journal next to the output CSV.

    ``writer=False`` (a rank other than 0 of a mesh) reads the journal on
    ``resume`` and never writes or removes it."""

    def __init__(self, out_csv: str, resume: bool = False,
                 writer: bool = True):
        self.path = out_csv + ".partial.jsonl"
        self.writer = writer
        self.rows: dict[float, dict] = {}
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    self.rows[float(row["point"])] = row
        elif writer and os.path.exists(self.path):
            os.remove(self.path)

    def done(self, point: float) -> dict | None:
        return self.rows.get(float(point))

    def record(self, point: float, values: dict):
        row = {"point": float(point), **values}
        self.rows[float(point)] = row
        if not self.writer:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def cleanup(self):
        if self.writer and os.path.exists(self.path):
            os.remove(self.path)
