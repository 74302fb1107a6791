"""Model assembly of the port.

Float32 products on the card must not run in TF32: the port is held
against the float32 reference, and TF32 keeps about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .lm import (init_model, apply_model, init_paged_cache,  # noqa: E402
                 supports_paged_cache, params_from_jax,
                 to_device)
