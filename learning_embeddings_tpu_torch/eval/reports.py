"""Markdown report writer: the port of
``learning_embeddings_tpu/eval/reports.py`` (the reference's
``Summarize``): per-epoch/phase ``summary.md`` files with headings,
tables, images and text under ``<exp>/stats/<phase><epoch>/``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

__all__ = ["Summarize"]


class Summarize:
    def __init__(self, directory: str, filename: str = "summary.md"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        # truncate on open, append per call (the reference opens per write)
        open(self.path, "w").close()

    def _write(self, text: str) -> None:
        with open(self.path, "a") as f:
            f.write(text)

    def make_heading(self, text: str, heading_level: int = 1) -> None:
        self._write(f"\n{'#' * heading_level} {text}\n\n")

    def make_text(self, text: str, bullet: bool = False) -> None:
        self._write(f"- {text}\n" if bullet else f"{text}\n\n")

    def make_hrule(self) -> None:
        self._write("\n---\n\n")

    def make_image(self, path: str, alt_text: str = "") -> None:
        self._write(f"![{alt_text}]({path})\n\n")

    def make_table(self, data: Sequence[Sequence], x_labels: Sequence,
                   y_labels: Optional[Sequence] = None) -> None:
        """data: rows; x_labels: column headers; y_labels: row headers."""
        def fmt(v):
            if isinstance(v, float):
                return f"{v:.4f}"
            return str(v)

        header = [""] + [str(x) for x in x_labels] if y_labels else \
            [str(x) for x in x_labels]
        lines = ["| " + " | ".join(header) + " |",
                 "|" + "---|" * len(header)]
        for i, row in enumerate(data):
            cells = [fmt(v) for v in row]
            if y_labels:
                cells = [str(y_labels[i])] + cells
            lines.append("| " + " | ".join(cells) + " |")
        self._write("\n".join(lines) + "\n\n")
