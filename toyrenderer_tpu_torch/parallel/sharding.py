"""Frame renderers over a device mesh.

Counterpart of toyrenderer_tpu/parallel/sharding.py.  PyTorch has no
`vmap` over a whole frame and no GSPMD, so:

* the view batch is a loop over views, each rendered on its 'dp' row's
  first device with its raster sharded over that row's 'sp' devices
  (render_frame(sp_mesh=...)); the images gather onto the mesh's first
  device;
* a view's screen-space tail (GBuffer resolve, lighting, post) runs on
  that view's first device.  The reference row-shards the tail too, by
  a GSPMD constraint on the image; that changes no pixel, and is later
  work (ROADMAP, held for later).
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.engine.frame import make_render_fn
from toyrenderer_tpu_torch.parallel.mesh import Mesh, gather, run_on, to_device
from toyrenderer_tpu_torch.parallel.sp_raster import shard_config


def replicate_scene(scene, mesh: Mesh) -> dict:
    """The scene on every device of the mesh: {device: copy} (one copy
    per distinct device, kept by the mesh).  The renderers below take it
    or a scene on one device, which they copy the same way."""
    return {d: mesh.put(scene, d) for d in mesh.devices.reshape(-1)}


def _on(mesh: Mesh, obj, device: torch.device):
    """`obj` on `device`: its entry of a replicate_scene dict, else the
    mesh's copy (Mesh.put)."""
    if isinstance(obj, dict) and device in obj:
        return obj[device]
    return mesh.put(obj, device)


def make_sp_frame_renderer(mesh: Mesh, settings, ddgi_volume=None,
                           axis: str = 'sp', **cfg_kw):
    """One view's renderer with its raster sharded over `axis` tile rows
    (parallel/sp_raster.py) and its rays over the same devices
    (bvh_cuda.traverse_auto(sp_mesh=)).  The frame runs on the mesh's
    first device.  cfg_kw: make_render_fn's raster_cfg /
    mask_raster_cfg / trans_raster_cfg.  Raises unless the raster's
    tiles_y divides by mesh.shape[axis] (sharding.py:55).  Returns
    fn(scene, pair_inst, pair_meshlet, frame_inputs, carry, **kw) ->
    (image, new_carry, aux); kw as make_render_fn's (rt_static, ...)."""
    shard_config(cfg_kw.get('raster_cfg') or settings.raster_config(),
                 mesh.shape[axis])
    dev = mesh.first
    render = make_render_fn(settings, device=dev, **cfg_kw)

    def step(scene, pair_inst, pair_meshlet, frame_inputs, carry, **kw):
        if ddgi_volume is not None:
            kw.setdefault('ddgi_volume', ddgi_volume)
        return render(_on(mesh, scene, dev), pair_inst, pair_meshlet,
                      frame_inputs, carry, sp_mesh=(mesh, axis), **kw)
    return step


def make_view_batch_renderer(mesh: Mesh, settings, ddgi_volume=None,
                             **cfg_kw):
    """A renderer of a batch of views over a ('dp', 'sp') mesh
    (sharding.py:14-43): the B views split into mesh.shape['dp'] equal
    runs, run r on row r (its first device renders; its raster and rays
    shard over the row's 'sp' devices).  Returns fn(scene, pair_inst,
    pair_meshlet, fi_batch, carry_batch, **kw) -> (images (B, H, W, 3) u8
    on the mesh's first device, the new carries): fi_batch a sequence of
    B frame inputs (host numpy, as make_render_fn takes them),
    carry_batch a sequence of B carries (moved to their row's device
    when elsewhere); kw as make_render_fn's, copied to each row's device
    once (Mesh.put)."""
    n_dp = mesh.shape['dp']
    rows = [mesh.sub('sp', dp=r) for r in range(n_dp)]
    for row in rows:
        shard_config(cfg_kw.get('raster_cfg') or settings.raster_config(),
                     row.shape['sp'])
    renders = [make_render_fn(settings, device=row.first, **cfg_kw)
               for row in rows]

    def step(scene, pair_inst, pair_meshlet, fi_batch, carry_batch, **kw):
        b = len(fi_batch)
        if b % n_dp or len(carry_batch) != b:
            raise ValueError(f"{b} views and {len(carry_batch)} carries "
                             f"over dp={n_dp}")
        if ddgi_volume is not None:
            kw.setdefault('ddgi_volume', ddgi_volume)
        per_row = b // n_dp
        images, carries = [], []
        for k, (fi, carry) in enumerate(zip(fi_batch, carry_batch)):
            r = k // per_row
            row, dev = rows[r], rows[r].first
            with run_on(dev):
                img, new_carry, _ = renders[r](
                    _on(mesh, scene, dev), mesh.put(pair_inst, dev),
                    mesh.put(pair_meshlet, dev), fi, to_device(carry, dev),
                    sp_mesh=(row, 'sp'),
                    **{k2: mesh.put(v, dev) for k2, v in kw.items()})
            images.append(img[None])
            carries.append(new_carry)
        return gather(images, mesh.first, 0), carries
    return step
