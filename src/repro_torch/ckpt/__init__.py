"""Step checkpoints and self-describing array trees on disk (port of
``repro/ckpt``)."""
from .checkpoint import (save_array_tree, load_array_tree, save_checkpoint,
                         async_save_checkpoint, latest_step,
                         restore_checkpoint)
