"""Ops of the port: each kernel wrapper beside its plain PyTorch version
(the exports of `ray_tpu/ops/__init__.py`), ring attention, and the
kernels on local shards under a mesh (`ops/sharded.py`)."""
from ray_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    mha_reference,
)
from ray_tpu_torch.ops.losses import softmax_cross_entropy  # noqa: F401
from ray_tpu_torch.ops.norms import layer_norm, rms_norm  # noqa: F401
from ray_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies  # noqa: F401
