"""Decision layer of the port (counterpart of ``repro/core``): trimmed
copies of the framework-free modules the serving path needs, and the
certainty estimators in torch."""
