"""The work a step or a frame needs, counted by the benchmark from its own
inputs, and the least time the card could take for it (``least_time``).
The kernel names the trace is sorted by (``kernels.json``) and the card's
published peaks (``peaks.json``) are data beside the code."""
import json
from pathlib import Path

_HERE = Path(__file__).resolve().parent
with open(_HERE / "kernels.json") as _f:
    KERNELS = json.load(_f)
with open(_HERE / "peaks.json") as _f:
    PEAKS = json.load(_f)
