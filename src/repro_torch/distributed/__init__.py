"""Distributed layer of the port (counterpart of ``repro/distributed``):
so far the elastic fleet and fault tolerance, a verbatim numpy copy. The
reference's package also exports its mesh context and sharding rules,
which the port does not have yet."""
