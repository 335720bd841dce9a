"""Model zoo of the port: the Llama-family decoder on the port's ops."""
from ray_tpu_torch.models.config import TransformerConfig  # noqa: F401
from ray_tpu_torch.models.decode import (cache_page_bytes,  # noqa: F401
                                         decode_step, init_paged_cache,
                                         prefill)
from ray_tpu_torch.models.transformer import Transformer  # noqa: F401
