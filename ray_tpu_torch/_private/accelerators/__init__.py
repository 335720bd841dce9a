from ray_tpu_torch._private.accelerators.gpu import (GPUAcceleratorManager,
                                                     detect_num_gpus)

__all__ = ["GPUAcceleratorManager", "detect_num_gpus"]
