"""Engine layer: camera View, render settings, the frame."""

from toyrenderer_tpu_torch.engine.frame import (
    RenderSettings, default_frame_inputs, init_carry, make_render_fn,
    pack_frame_inputs, render_frame, unpack_frame_inputs)
from toyrenderer_tpu_torch.engine.view import View
