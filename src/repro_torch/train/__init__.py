"""Training: the train step and its losses (port of ``repro/train``)."""
from .trainer import init_train_state, make_train_step, params_of
from .losses import lm_loss
