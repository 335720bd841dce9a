"""Utilities of the port: the metrics registry, the scheduling
strategies, placement groups and the actor pool."""
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group)

__all__ = ["PlacementGroup", "placement_group", "remove_placement_group",
           "placement_group_table"]
