"""The query layer of the port, with the exports of
``sublinear_tpu/queries/__init__.py``."""
from .estimate import EntryEstimate, estimate_entries, estimate_entry, estimate_functional
from .temporal import (
    prove_temporal_lead,
    calculate_light_travel,
    demonstrate_temporal_lead,
    light_travel_ms,
    predict_with_temporal_advantage,
    validate_temporal_advantage,
)

__all__ = [
    "EntryEstimate",
    "estimate_entry",
    "estimate_entries",
    "estimate_functional",
    "predict_with_temporal_advantage",
    "validate_temporal_advantage",
    "calculate_light_travel",
    "demonstrate_temporal_lead",
    "light_travel_ms",
    "prove_temporal_lead",
]
