"""Model assembly of the port.

Float32 products on the card must not run in TF32: the port is held
against the float32 reference, and TF32 keeps about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .lm import (init_model, apply_model, mtp_logits,  # noqa: E402
                 init_cache, init_paged_cache, reset_cache,
                 supports_paged_cache,
                 layer_stages, layer_kinds,
                 supports_ragged_mask, params_from_jax,
                 to_device, to_reference_layout,
                 from_reference_layout, tree_from_reference,
                 stack_layers, unstack_layers, train_state_from_jax)
from .registry import input_specs, runnable  # noqa: E402
