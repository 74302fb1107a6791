"""Self-describing array trees on disk (port of the array-tree part of
``repro/ckpt``; step checkpoints wait for training)."""
from .checkpoint import save_array_tree, load_array_tree
