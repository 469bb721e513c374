"""Serving engines of the port (counterpart of ``repro/serving``)."""
