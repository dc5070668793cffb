"""Runtime scaffolding (port of ``repro.runtime``): fault tolerance, and
elastic scaling (``reshard_state`` onto a degraded mesh, the batch
rebalancing the serving router's autoscaler also resizes with)."""
