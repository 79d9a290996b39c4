"""One frame, or a batch of views, over several devices.

Counterpart of toyrenderer_tpu/parallel/: a device `Mesh` with named
axes (mesh.py), one frame's raster sharded by tile rows over an 'sp'
axis (sp_raster.py: each band binned and filled by K1 on its device),
and the renderers (sharding.py): one view with its raster and rays over
'sp', a batch of views over a ('dp', 'sp') mesh.
"""

from toyrenderer_tpu_torch.parallel.mesh import Mesh
from toyrenderer_tpu_torch.parallel.sharding import (
    make_sp_frame_renderer, make_view_batch_renderer, replicate_scene)
from toyrenderer_tpu_torch.parallel.sp_raster import raster_frame_sp
