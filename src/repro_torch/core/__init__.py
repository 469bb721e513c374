"""Decision layer of the port (counterpart of ``repro/core``): verbatim
copies of the framework-free numpy modules (profiles, cascade replay, LP,
gears, scheduling, simulators, planner and its submodules, admission,
tenancy, scenarios), the execution backends with the port's
``EngineBackend``, and the certainty estimators in torch.

The package exports only the names that verbatim code imports from it
(``launch/serve.py`` ``parse_tenants``)."""
from repro_torch.core.tenancy import TenantSpec

__all__ = ["TenantSpec"]
