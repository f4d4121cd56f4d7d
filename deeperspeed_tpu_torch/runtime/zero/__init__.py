from .sharding import Region, ZeroPartitionPlan, build_partition_plan  # noqa: F401
