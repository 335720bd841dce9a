"""flash_bwd_roofline.train: the flash backward kernels' (dK/dV and dQ)
roofline share at the training shape (%)."""
from gpubench.readers import flash_bwd_roofline as read  # noqa: F401
