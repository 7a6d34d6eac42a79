"""ECG-as-a-service: operator registry, warm-start cache, request batching
(port of ``repro.serve``).

The serving layer for the many-clients / few-operators regime — see
:mod:`repro_torch.serve.server` for the model.

    from repro_torch.serve import ECGServer, ServeConfig
"""

from repro_torch.serve.batching import RequestQueue, ServeOverloaded, Ticket, payload_key
from repro_torch.serve.cache import WarmStartCache, config_digest, mesh_tag
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.fingerprint import fingerprint_csr, operator_nbytes
from repro_torch.serve.packing import (
    PackingConfig,
    WidthPacker,
    host_csr,
    latency_percentiles,
    true_relres,
)
from repro_torch.serve.registry import OperatorRegistry
from repro_torch.serve.server import ECGServer

__all__ = [
    "ECGServer",
    "OperatorRegistry",
    "PackingConfig",
    "RequestQueue",
    "ServeConfig",
    "ServeOverloaded",
    "Ticket",
    "WarmStartCache",
    "WidthPacker",
    "config_digest",
    "fingerprint_csr",
    "host_csr",
    "latency_percentiles",
    "mesh_tag",
    "operator_nbytes",
    "payload_key",
    "true_relres",
]
