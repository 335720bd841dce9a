from ray_tpu_torch.util.accelerators.gpu import (slice_bundles,
                                                 slice_placement_group)

__all__ = ["slice_bundles", "slice_placement_group"]
