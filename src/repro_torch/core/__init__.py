"""The paper's RPS exchange (port of :mod:`repro.core`): masks, the
exchange plan, the wire pipeline, the global-view exchange and the
collective path (one process per RPS worker).

The JAX package's ``repro.core`` names are exported here, resolved when
first used: ``core.rps`` imports the kernels' wrappers, which import
``core.quant``, so importing it with the package would make a cycle.
"""
import importlib

_EXPORTS = {
    "ExchangePlan": "plan", "make_plan": "plan", "per_leaf_plan": "plan",
    "single_bucket_plan": "plan",
    "reliable_average": "rps", "rps_exchange": "rps",
    "rps_exchange_flat": "rps", "rps_exchange_global": "rps",
    "rps_exchange_leaf": "rps", "rps_exchange_plan": "rps",
    "sample_masks": "rps",
    "Recovery": "wire", "WireCodec": "wire", "canon_wire_dtype": "wire",
    "canon_wire_name": "wire", "init_ef_state": "wire",
    "make_codec": "wire", "make_recovery": "wire",
}
__all__ = sorted(_EXPORTS) + ["theory", "wmatrix"]


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in ("theory", "wmatrix"):
        return importlib.import_module(f"repro_torch.core.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
