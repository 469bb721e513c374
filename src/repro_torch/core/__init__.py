"""Decision layer of the port (counterpart of ``repro/core``): verbatim
copies of the framework-free numpy modules (profiles, cascade replay, LP,
gears, scheduling, simulators, planner and its submodules), the execution
backends with the port's ``EngineBackend``, and the certainty estimators
in torch."""
