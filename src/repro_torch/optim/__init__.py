"""Optimizers, LR schedule, gradient clipping and int8 gradient
compression (port of ``repro/optim``)."""
from .optimizers import adamw, adafactor, sgd, make_optimizer
from .schedule import warmup_cosine
from .clip import clip_by_global_norm, global_norm
from .compression import compress_int8, decompress_int8
