"""The paper's RPS exchange (port of :mod:`repro.core`): masks, the
exchange plan, the wire pipeline and the global-view exchange."""
