"""Exchange telemetry (port of :mod:`repro.telemetry`): so far only the
delivery, lateness and corruption counters the simulator's history reads
(:mod:`repro_torch.telemetry.counters`)."""
