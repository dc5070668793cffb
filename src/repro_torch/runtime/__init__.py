"""Runtime scaffolding (port of ``repro.runtime``): so far only the
batch rebalancing the serving router's autoscaler resizes with."""
