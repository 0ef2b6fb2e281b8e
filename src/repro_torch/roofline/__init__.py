"""The roofline on one H100 (port of :mod:`repro.roofline`):
:mod:`repro_torch.roofline.analysis` (the card's peaks, the three terms,
the link formulas, each hand-written kernel's cost) and
:mod:`repro_torch.roofline.count` (the meta-device count of a step)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, RooflineReport, analyze, collective_bytes, kernel_bound, kernel_cost)
