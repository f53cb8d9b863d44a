"""Runtime options threaded through the pipelines (utils.nim:119-127).

Defaults are part of the behavioral contract (SURVEY.md §5):
proportion_repeat 0.8, min_mapq 40, min_support 5, min_clip/min_clip_total 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Options:
    median_fragment_length: int = 0
    proportion_repeat: float = 0.8
    min_mapq: int = 40
    min_support: int = 5
    min_clip: int = 0
    min_clip_total: int = 0
    window: int = 0
    targets: list = field(default_factory=list)
