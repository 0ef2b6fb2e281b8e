"""Deterministic synthetic data (port of :mod:`repro.data`)."""
from repro_torch.data.synthetic import (  # noqa: F401
    CharLMTask, TeacherTask, char_lm_stream, make_worker_streams)
