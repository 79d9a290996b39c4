"""Small host utilities (timers): the reference's Utilities.h timers."""

from toyrenderer_tpu_torch.utils.timing import ScopedTimer, Timer
