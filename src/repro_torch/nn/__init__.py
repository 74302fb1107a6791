"""Functional NN primitives of the port (params are nested dicts of
tensors, per layer).

Float32 products on the card must not run in TF32: the port is held
against the float32 reference, and TF32 keeps about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
