from repro_torch.sharding.rules import (  # noqa: F401
    AxisRules,
    DECODE_SEQ_CACHE_RULES,
    DEFAULT_RULES,
    PartitionSpec,
    SEQUENCE_PARALLEL_RULES,
    distribute,
    logical_to_spec,
    placements,
    shard_constraint,
    spec_for,
)
