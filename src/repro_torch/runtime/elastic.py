"""Elastic resizing (port of ``rebalance_batch_size`` from
``repro/runtime/elastic.py``).

The reference module also re-shards training state onto a degraded mesh
(``reshard_state``); that needs a mesh and comes with the sharding rules
(ROADMAP slice G).  The serving
router's autoscaler resizes its per-replica admission cap with the same
keep-the-global-batch rule training elasticity uses.
"""

from __future__ import annotations


def rebalance_batch_size(global_batch: int, old_data: int, new_data: int,
                         *, allow_shrink: bool = False) -> tuple[int, int]:
    """Keep the global batch; per-replica batch grows on the survivors.

    Returns ``(per_replica, adjusted_global)``.  When ``global_batch``
    does not divide evenly over ``new_data`` replicas the only way to
    keep per-replica batches equal is to shrink the global batch to the
    largest divisible value — a change the caller must opt into with
    ``allow_shrink=True``; otherwise this raises ``ValueError``.
    """
    if new_data <= 0:
        raise ValueError(f"new_data must be positive, got {new_data}")
    adjusted = global_batch
    if adjusted % new_data:
        if not allow_shrink:
            raise ValueError(
                f"global batch {global_batch} does not divide over "
                f"{new_data} replicas (was {old_data}); pass "
                f"allow_shrink=True to shrink to the largest divisible "
                f"global batch")
        adjusted = (adjusted // new_data) * new_data
    return adjusted // new_data, adjusted
