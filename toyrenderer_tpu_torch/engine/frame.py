"""The deferred visibility-buffer frame.

Counterpart of toyrenderer_tpu/engine/frame.py for the passes this port
has: UpdateInstanceConsts -> GBuffer (raster through the fused
fill+resolve kernel, textured resolve; with `enable_culling`, the
GPU-driven 2-phase frame: instance and meshlet culling, screen-error LOD
and HZB occlusion; with `use_bruteforce_raster`, every triangle tested
at every pixel) -> the alpha-masked set, peeled `alpha_layers` times
(per layer, or in one peel fill and a compact merge with
`peel_merge_frac` > 0) -> the RT tree (refit from `rt_static`, or a
per-frame morton rebuild) -> the sun shadow map (for map shadows and for
the probe hits' sun taps) -> sun shadows (ray-traced through the
traversal kernel, or sampled from the map; temporal + spatial denoise)
-> DDGI (on update frames: the GI tree's refit, the probe rays and the
probe update; every frame: the probe field sampled at half resolution)
-> ReSTIR DI (emissive triangles as lights, one visibility ray a pixel
through the main tree) -> GTAO (half-resolution horizons, a depth-aware
blur) -> deferred lighting + sky -> the blend set, depth-peeled
`oit_layers` times, shaded and composited back to front -> the probe
overlay -> bloom, auto-exposure, TAA -> tonemap, or a debug view of the
GBuffer.  With `pack_gbuffer` every resolve writes the packed 4 x u32
GBuffer, the only medium the passes read; otherwise float shading planes.

Cross-frame state (transforms, HZB, exposure, TAA and shadow histories,
the DDGI probes, ReSTIR's reservoir, and the caches below) lives in an
explicit `carry` dict, as in the reference package (a FrameCarry: the
same keys, and beside them the attribute `host`, a HostMirror of what
the frame decides on the host).
The caches that init_carry adds when it is given the frame's static
topologies (the refit RT tree, the GI tree with its shade records and
pair tables) and, with `cache_sun_map`, the sun map, are served unless
an instance or the sun moved since they were built; "moved" is decided
on the host, from the host copies of the node transforms and of the sun
that pack_frame_inputs and make_render_fn keep beside the frame inputs
(inputs with no host copy count as moved).  A cache changes no pixel.
Whether a GI frame updates the probes is decided on the host too: the
previous frame's convergence test, copied to the host without blocking,
is waited for at the branch, so the frame reads no device value.  Every
RenderSettings field of the reference runs; the frame never silently
skips a pass.  Each pass runs in a profiler range named with the
reference's pass labels (PASS_LABELS; tools/passes.py reads them).
`pack_frame_inputs` turns the small per-frame inputs into one
host-to-device copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.mathlib.transforms import normalize
from toyrenderer_tpu_torch.ops import bloom as bloom_mod
from toyrenderer_tpu_torch.ops import culling as cull_mod
from toyrenderer_tpu_torch.ops import ddgi as ddgi_mod
from toyrenderer_tpu_torch.ops import exposure as exposure_mod
from toyrenderer_tpu_torch.ops import geometry as geo_mod
from toyrenderer_tpu_torch.ops import hzb as hzb_mod
from toyrenderer_tpu_torch.ops import raster as raster_mod
from toyrenderer_tpu_torch.ops import restir as restir_mod
from toyrenderer_tpu_torch.ops import shadowmap
from toyrenderer_tpu_torch.ops import shadows as shadows_mod
from toyrenderer_tpu_torch.ops import sky as sky_mod
from toyrenderer_tpu_torch.ops.bvh import (
    build_bvh, refit_bvh, world_triangles)
from toyrenderer_tpu_torch.ops.bvh_sah import RtStaticSah, refit_sah
from toyrenderer_tpu_torch.ops.denoise import depth_aware_blur, denoise_shadow
from toyrenderer_tpu_torch.ops.gbuffer import (
    finish_gbuffer, masked_peel_merge_compact, pack_resolve_records,
    resolve_interpolants, unpack_gbuffer)
from toyrenderer_tpu_torch.ops.gtao import gtao
from toyrenderer_tpu_torch.ops.lighting import (
    debug_view, deferred_lighting, world_pos_from_depth)
from toyrenderer_tpu_torch.ops.peel_cuda import fill_peel_stream
from toyrenderer_tpu_torch.ops.rt_pairs import mt_tables
from toyrenderer_tpu_torch.ops.postprocess import compose_final
from toyrenderer_tpu_torch.ops.raster import RasterConfig
from toyrenderer_tpu_torch.ops.raster_cuda import (
    bin_pairs_with_budget, crop_image, fill_resolve_stream)
from toyrenderer_tpu_torch.ops.taa import taa_resolve
from toyrenderer_tpu_torch.ops.texture import _maxpool2, _quad_expand
from toyrenderer_tpu_torch.utils.timing import profiler_range


@dataclass(frozen=True)
class RenderSettings:
    """Render configuration: the reference package's RenderSettings,
    field for field and default for default (engine/frame.py:46-227
    there documents each knob).  `shadow_max_steps` is accepted and, as
    for the reference's traversal kernel, does not bound the shadow
    rays' walk: every ray visits every node it needs."""
    width: int = 1920
    height: int = 1080
    # pass toggles
    enable_shadows: bool = False
    shadow_technique: str = 'rt'
    shadow_map_resolution: int = 1024
    shadow_max_steps: int = 96
    shadow_ray_scale: int = 2
    shadow_checkerboard: bool = True
    enable_ao: bool = False
    ao_radius: float = 1.5
    ao_half_res: bool = True
    enable_gi: bool = False
    gi_max_steps: int = 64
    gi_convergence_skip: bool = True
    gi_variability_threshold: float = 0.002
    gi_min_var_samples: int = 16
    gi_update_phases: int = 1
    gi_update_mode: str = 'interval'
    gi_sample_scale: int = 2
    peel_merge_frac: float = 0.0          # 0 = dense per-layer masked set
    pack_gbuffer: bool = False
    cache_sun_map: bool = True
    gi_vis_scale: int = 2
    gi_half_res: bool = True
    gi_sun_technique: str = 'auto'
    show_gi_probes: bool = False
    enable_transparency: bool = False
    oit_layers: int = 1
    enable_alpha_test: bool = True        # alpha-masked cutout set
    alpha_layers: int = 2                 # depth-peel layers of that set
    enable_restir: bool = False
    restir_candidates: int = 8
    restir_spatial_taps: int = 4
    restir_spatial_radius: float = 16.0
    restir_max_lights: int = 256
    enable_bloom: bool = False
    enable_auto_exposure: bool = False
    enable_taa: bool = False
    enable_textures: bool = True
    texture_quad_taps: bool = True        # one atlas tap per 2x2 quad
    texture_aniso: int = 1
    enable_culling: bool = False
    enable_cone_culling: bool = True
    lod_error_px: float = 2.0
    forced_lod: int = -1
    late_capacity_frac: float = 0.25
    debug_mode: int = 0
    # raster tuning
    max_tris_per_tile: int = 2048         # K
    raster_chunk: int = 32                # pair-budget chunk
    max_big_tris: int = 2048              # B
    tile_batch: int = 32                  # tiles per plain-fill step
    tile_h: int = 16
    tile_w: int = 128
    bin_slots_y: int = 8
    bin_slots_x: int = 2
    bin_split: bool = True
    pair_capacity: int | None = None
    use_bruteforce_raster: bool = False
    use_pallas_fill: bool | None = None   # the reference's fill choice;
    #   the port has one fill (kernel for CUDA tensors, plain for CPU)
    # lighting / post
    manual_exposure: float = 1.0
    sky_model: str = 'hosek'              # 'hosek' | 'preetham'
    sky_turbidity: float = 2.5
    ambient_factor: float = 0.03
    bloom_mips: int = 6
    bloom_strength: float = 0.04

    def raster_config(self) -> RasterConfig:
        return RasterConfig(
            width=self.width, height=self.height,
            max_tris_per_tile=self.max_tris_per_tile,
            chunk=self.raster_chunk, max_big_tris=self.max_big_tris,
            tile_batch=self.tile_batch, tile_h=self.tile_h,
            tile_w=self.tile_w, bin_slots_y=self.bin_slots_y,
            bin_slots_x=self.bin_slots_x, bin_split=self.bin_split,
            pair_capacity=self.pair_capacity)


def check_settings(settings: RenderSettings):
    """Raise ValueError for a setting outside the reference's choices."""
    if settings.sky_model not in ('hosek', 'preetham'):
        raise ValueError(f"unknown sky_model {settings.sky_model!r}")
    if settings.shadow_technique not in ('rt', 'map'):
        raise ValueError(
            f"unknown shadow_technique {settings.shadow_technique!r}")
    if settings.gi_sun_technique not in ('auto', 'map', 'rt'):
        raise ValueError(
            f"unknown gi_sun_technique {settings.gi_sun_technique!r}")


# frame_inputs keys through which a streaming manager (engine/
# streaming.py) overrides the atlas's residency (reference package,
# engine/frame.py:528-537)
_RESIDENCY_KEYS = ('tex_texels', 'tex_desc', 'tex_min_mip', 'tex_tile_table')


def frame_atlas(scene, frame_inputs: dict) -> dict:
    """The sampler's atlas for this frame: the scene's, with any
    residency override of frame_inputs in its place.  An override keeps
    the records' encoding ('_enc') and turns the analytic descriptors
    off ('_analytic'): streaming rewrites the desc rows."""
    atlas = scene.atlas_dict()
    streamed = [k for k in _RESIDENCY_KEYS if k in frame_inputs]
    atlas.update({k: frame_inputs[k] for k in streamed})
    if streamed and atlas.get('_analytic'):
        atlas['_analytic'] = False
    return atlas


# the frame's profiler ranges, in frame order: the reference's pass
# labels (its tools/passes.py:28-56) where a pass maps to one.  Two open
# inside another pass: 'ShadowMap' (the sun map) in the pass that first
# reads it, 'RT(pair boxes)' (the pair route's box phase and pair list,
# ops/rt_pairs.py) in GI; the blend set has one range per depth-peeled
# layer, 'TransparentForward(layer i)' for i = 0 .. oit_layers - 1, and
# one for their composite
PASS_LABELS = ('UpdateInstanceConsts', 'GPUCulling', 'BasePass(fill+resolve)',
               'HZB(SPD)', 'GBufferResolve', 'AlphaMaskedPass',
               'RT(BVH build)', 'ShadowMap', 'ShadowMask', 'Denoise',
               'GI(DDGI)', 'RT(pair boxes)', 'ReSTIR', 'AmbientOcclusion',
               'DeferredLighting', 'TransparentForward(layer 0)',
               'TransparentForward(composite)', 'ProbeOverlay', 'Bloom',
               'AdaptLuminance', 'TAA', 'PostProcess')

# the carry's cache entries (reference package, frame.py:230-337), each
# beside the build it holds: the refit main tree, the GI tree with its
# shade records, the pair route's tables, the sun map
CACHE_KEYS = ('rt_bvh_cache', 'gi_bvh_cache', 'gi_shade_cache', 'gi_mt_cache',
              'sun_map_depth', 'sun_map_dropped', 'prev_sun_view_proj')


@dataclass(frozen=True, eq=False)
class HostMirror:
    """FrameCarry.host: what the frame decides on the host, so that no
    decision reads the device.

    frame_index mirrors carry['frame_index'].  version counts the frames
    on which the scene may have moved (an instance transform differs
    from the previous frame's, or is not known on the host); `built`
    maps each cache (CACHE_KEYS' 'rt', 'gi', 'mt', 'sm') to the version
    its contents were built at (absent: stale).  nodes: the node TRS host
    arrays of the carry's frame (None: unknown); sun_vp: the sun
    view-proj the cached sun map was rendered with.  With GI on, sun_sig
    mirrors carry['ddgi_sun_sig'], and `converged` holds the carry's
    convergence test (ddgi_convergence): a bool CPU tensor, pinned and
    filled by a non-blocking copy when the carry is on the card, valid
    once the CUDA event `ready` has completed (None: at once)."""
    frame_index: int
    version: int = 0
    built: dict = field(default_factory=dict)
    nodes: tuple | None = None
    sun_vp: np.ndarray | None = None
    sun_sig: np.ndarray | None = None
    converged: torch.Tensor | None = None
    ready: object = None

    def is_converged(self) -> bool:
        """The carry's convergence test: waits for its copy to land (the
        previous frame's end of GI on the card), reads no device value."""
        if self.ready is not None:
            self.ready.synchronize()
        return bool(self.converged)

    @classmethod
    def of_carry(cls, carry: dict, settings: RenderSettings):
        """The mirror of a carry that has none (built by carry_from_numpy
        or loaded from a snapshot): read from the device once, every
        cache stale."""
        conv = sig = None
        if settings.enable_gi and 'ddgi_sun_sig' in carry:
            sig = carry['ddgi_sun_sig'].detach().cpu().numpy().astype(
                np.float32)
            conv = ddgi_convergence(carry['ddgi_var_samples'],
                                    carry['ddgi_var_ring'], settings).cpu()
        return cls(frame_index=int(carry['frame_index']), sun_sig=sig,
                   converged=conv)


class FrameCarry(dict):
    """The carry: a dict of the cross-frame state with the reference's
    keys, and its host mirror as the attribute `host` (a HostMirror; None
    on a carry built elsewhere, e.g. by weights.carry_from_numpy: the
    frame then reads one from the device)."""
    host: HostMirror | None = None


def ddgi_convergence(var_samples, ring, settings: RenderSettings):
    """The reference's convergence test (GIRenderer.cpp:162-179) of a
    sample count and variability ring: the std-dev of the last 16
    variability samples under the threshold, after more than
    gi_min_var_samples samples; a bool tensor (False without
    gi_convergence_skip)."""
    dev = ring.device
    if not settings.gi_convergence_skip:
        return torch.zeros((), dtype=torch.bool, device=dev)
    n_valid = torch.clamp(var_samples, max=float(ddgi_mod.VAR_WINDOW))
    vmask = torch.arange(ddgi_mod.VAR_WINDOW, device=dev) < n_valid
    nn = torch.clamp(n_valid, min=1.0)
    ring_mean = torch.sum(torch.where(vmask, ring, 0.0)) / nn
    ring_std = torch.sqrt(torch.clamp(torch.sum(torch.where(
        vmask, (ring - ring_mean) ** 2, 0.0)) / nn, min=0.0))
    return ((var_samples > float(settings.gi_min_var_samples))
            & (ring_std < settings.gi_variability_threshold))


def _to_host(flag: torch.Tensor):
    """(a CPU copy of the bool `flag`, a CUDA event after which it holds
    the value, or None): on the card the copy lands in pinned memory
    without blocking the host."""
    if flag.device.type != 'cuda':
        return flag.clone(), None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _tree_needs(settings: RenderSettings, rt_static_gi):
    """(rays for the sun shadows, GI has its own tree, the main tree is
    needed, the probe hits' sun taps read the sun map, the frame reads
    the sun map)."""
    needs_rays = settings.enable_shadows and settings.shadow_technique == 'rt'
    gi_own_tree = settings.enable_gi and rt_static_gi is not None
    needs_rt = (needs_rays or settings.enable_restir
                or (settings.enable_gi and not gi_own_tree))
    gi_sun_map = settings.enable_gi and (
        settings.gi_sun_technique == 'map'
        or (settings.gi_sun_technique == 'auto' and not needs_rays))
    uses_map = ((settings.enable_shadows and not needs_rays) or gi_sun_map)
    return needs_rays, gi_own_tree, needs_rt, gi_sun_map, uses_map


def _pair_streams(pair_inst, pair_meshlet, rt_static, rt_static_gi,
                  rt_pair_inst, rt_pair_meshlet, gi_pair_inst,
                  gi_pair_meshlet, mask_pair_inst, mask_pair_meshlet):
    """(the main tree's pair stream, the GI tree's): each pair list with
    the masked pairs its tree was built over appended."""
    base_pi = pair_inst if rt_pair_inst is None else rt_pair_inst
    base_pm = pair_meshlet if rt_pair_meshlet is None else rt_pair_meshlet
    rt = _rt_streams(base_pi, base_pm, rt_static, mask_pair_inst,
                     mask_pair_meshlet)
    gi = _rt_streams(base_pi if gi_pair_inst is None else gi_pair_inst,
                     base_pm if gi_pair_meshlet is None else gi_pair_meshlet,
                     rt_static_gi, mask_pair_inst, mask_pair_meshlet)
    return rt, gi


def _refit_tree(rts, inst_world):
    """A tree refit from its topology, SAH or complete (reference
    package, frame.py:420-427): the main tree's and the GI tree's."""
    if isinstance(rts, RtStaticSah):
        return refit_sah(rts, inst_world)
    return refit_bvh(rts, inst_world)


def _gi_build(scene, rts_gi, streams, inst_world):
    """(the GI tree, its shade records): payloads index the GI pair
    stream."""
    tree = _refit_tree(rts_gi, inst_world)
    v0, v1, v2, _ = world_triangles(scene, inst_world, *streams)
    shade = ddgi_mod.build_shade_records(scene, *streams, v0, v1, v2)
    return tree, shade


def _zeros_like(x):
    """x with every tensor zeroed: a tensor, a tuple of them or a tree."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    if isinstance(x, tuple):
        return tuple(_zeros_like(v) for v in x)
    return replace(x, **{k: torch.zeros_like(v) for k, v in vars(x).items()
                         if isinstance(v, torch.Tensor)})


def init_carry(scene, settings: RenderSettings, ddgi_volume=None,
               rt_static=None, rt_static_gi=None, pair_inst=None,
               pair_meshlet=None, rt_pair_inst=None, rt_pair_meshlet=None,
               gi_pair_inst=None, gi_pair_meshlet=None, mask_pair_inst=None,
               mask_pair_meshlet=None) -> dict:
    """Initial cross-frame state, on the scene's device; with GI on, the
    probes of `ddgi_volume` (ddgi.init_probes); with ReSTIR on, its zero
    reservoir; as a FrameCarry with its host mirror.

    The caches (reference package, frame.py:230-337): with
    cache_sun_map and a frame that reads the sun map, `sun_map_depth`,
    `sun_map_dropped` and `prev_sun_view_proj`; given the frame's
    rt_static / rt_static_gi and the pair streams render_frame will get,
    `rt_bvh_cache` (when the frame traces the main tree), `gi_bvh_cache`
    and `gi_shade_cache` (GI's own tree) and, under TR_GI_PAIRS=1,
    `gi_mt_cache`: zero-filled, of the shapes of what they cache, and
    stale until a frame builds them (frame 0 always does).  A frame then
    refits a tree, rebuilds the shade records or re-renders the sun map
    only when an instance or the sun moved since they were built; the
    pair tables are rebuilt by the first frame on the pair route after
    that (a frame off the route leaves them stale)."""
    dev = scene.device
    n_inst = scene.inst_node.shape[0]
    carry = FrameCarry(
        prev_inst_world=torch.eye(4, device=dev).expand(n_inst, 4, 4)
        .contiguous(),
        prev_depth=torch.zeros((settings.height, settings.width),
                               device=dev),
        exposure=torch.tensor(settings.manual_exposure, device=dev),
        frame_index=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    hw = (settings.height, settings.width)
    if settings.enable_taa:
        carry['taa_history'] = torch.zeros(hw + (3,), device=dev)
        carry['taa_valid'] = torch.zeros((), device=dev)
    if settings.enable_culling:
        carry['hzb'] = hzb_mod.init_hzb(settings.width, settings.height,
                                        device=dev)
    if settings.enable_shadows:
        carry['shadow_history'] = torch.ones(hw, device=dev)
        carry['shadow_valid'] = torch.zeros((), device=dev)
    _, gi_own_tree, needs_rt, _, uses_map = _tree_needs(settings,
                                                        rt_static_gi)
    if settings.cache_sun_map and uses_map:
        sm_res = settings.shadow_map_resolution
        carry['sun_map_depth'] = torch.zeros((sm_res, sm_res), device=dev)
        carry['sun_map_dropped'] = torch.zeros((), dtype=torch.int32,
                                               device=dev)
        carry['prev_sun_view_proj'] = torch.zeros((4, 4), device=dev)
    host = HostMirror(frame_index=0)
    if settings.enable_gi:
        if ddgi_volume is None:
            raise ValueError("enable_gi needs a ddgi_volume "
                             "(ddgi.volume_from_aabb)")
        carry.update(ddgi_mod.init_probes(ddgi_volume, dev))
        # the initial carry's test, on the host: no sample yet, an empty
        # ring (std-dev 0)
        conv = (settings.gi_convergence_skip
                and 0.0 > settings.gi_min_var_samples
                and 0.0 < settings.gi_variability_threshold)
        host = replace(host, sun_sig=np.full(7, np.inf, np.float32),
                       converged=torch.tensor(conv))
    if settings.enable_restir:
        # the zero reservoir: light 0, weight 0, no candidates
        carry['restir_reservoir'] = dict(
            li=torch.zeros(hw, dtype=torch.int32, device=dev),
            r1=torch.zeros(hw, device=dev), r2=torch.zeros(hw, device=dev),
            w=torch.zeros(hw, device=dev), m=torch.zeros(hw, device=dev))

    # the refit caches: shaped by one build at the identity transforms
    pairs_on = ddgi_mod._gi_pairs_enabled()
    eye = carry['prev_inst_world']
    if needs_rt and rt_static is not None:
        tree = _refit_tree(rt_static, eye)
        carry['rt_bvh_cache'] = _zeros_like(tree)
        if settings.enable_gi and not gi_own_tree and pairs_on:
            carry['gi_mt_cache'] = _zeros_like(mt_tables(tree))
    if gi_own_tree:
        _, g_streams = _pair_streams(
            pair_inst, pair_meshlet, rt_static, rt_static_gi, rt_pair_inst,
            rt_pair_meshlet, gi_pair_inst, gi_pair_meshlet, mask_pair_inst,
            mask_pair_meshlet)
        if g_streams[0] is None:
            raise ValueError("the GI caches need the GI pair stream "
                             "(gi_pair_inst, or rt_pair_inst / pair_inst)")
        tree, shade = _gi_build(scene, rt_static_gi, g_streams, eye)
        carry['gi_bvh_cache'] = _zeros_like(tree)
        carry['gi_shade_cache'] = torch.zeros_like(shade)
        if pairs_on:
            carry['gi_mt_cache'] = _zeros_like(mt_tables(tree))
    carry.host = host
    return carry


def _raster_stats(setup, bins):
    """Pipeline-statistics counters of a base-pass set, with the silent-
    drop telemetry of every bounded path (reference package,
    frame.py:401)."""
    out = dict(
        tris=torch.sum(setup['valid'].to(torch.int32)),
        binned_pairs=torch.sum(bins['counts']),
        big_tris=torch.sum((bins['big_list'] >= 0).to(torch.int32)))
    out['dropped'] = sum(bins['drop'].values())
    out.update(bins['drop'])
    return out


def _raster_with_records(scene, geo, cfg, inst_world, inst_adj,
                         prev_inst_world, prev_vp, sp_mesh=None, **fill_kw):
    """setup + bin + fused fill+resolve of one triangle set.  Returns
    (setup, records, depth, tri_id, interpolant planes, raster stats);
    fill_kw goes to fill_resolve_stream (init planes, emit_base,
    padded_io).  With sp_mesh = (mesh, axis), the tile rows shard over
    the axis (parallel.sp_raster.raster_frame_sp, reference package
    frame.py:359-369)."""
    setup = raster_mod.setup_triangles(geo, cfg)
    records = pack_resolve_records(setup, scene, inst_world, inst_adj,
                                   prev_inst_world, prev_vp)
    if sp_mesh is not None:
        from toyrenderer_tpu_torch.parallel.sp_raster import raster_frame_sp
        depth, tri_id, interp, stats = raster_frame_sp(
            setup, records, cfg, *sp_mesh, **fill_kw)
        return setup, records, depth, tri_id, interp, stats
    bins = bin_pairs_with_budget(setup, cfg)
    depth, tri_id, interp = fill_resolve_stream(setup, records, bins, cfg,
                                                **fill_kw)
    return setup, records, depth, tri_id, interp, _raster_stats(setup, bins)


class _LayerFill:
    """The peeled fills of one triangle set, binned once: `fill(peel)`
    is one fused fill + resolve behind the exclusive bound `peel` (None:
    the first layer), unpadded; `bins` the single device's pair stream
    (None on a mesh, whose bands bin their own)."""

    def __init__(self, setup, records, cfg, sp_mesh):
        self.setup, self.records, self.cfg = setup, records, cfg
        self.sp_mesh = sp_mesh
        self.bins = self.bands = None
        if sp_mesh is None:
            self.bins = bin_pairs_with_budget(setup, cfg)
        else:
            from toyrenderer_tpu_torch.parallel.sp_raster import shard_bands
            self.bands = shard_bands(setup, records, cfg, *sp_mesh)

    def stats(self) -> dict:
        if self.bands is None:
            return _raster_stats(self.setup, self.bins)
        from toyrenderer_tpu_torch.parallel.sp_raster import band_stats
        return band_stats(self.setup, self.bands, self.sp_mesh[0].first)

    def __call__(self, peel):
        if self.bands is None:
            return fill_resolve_stream(self.setup, self.records, self.bins,
                                       self.cfg, peel_depth=peel)
        from toyrenderer_tpu_torch.parallel.sp_raster import raster_frame_sp
        return raster_frame_sp(self.setup, self.records, self.cfg,
                               *self.sp_mesh, peel_depth=peel,
                               bands=self.bands)[:3]


def _gbuffer_two_phase(scene, inst_world, inst_adj, prev_inst_world,
                       frame_inputs, carry, pair_inst, cfg, settings, passes,
                       sp_mesh=None):
    """GPU-driven 2-phase occlusion-culled GBuffer pass (reference
    package, frame.py:1311-1401).

    Early: instances that pass the frustum AND were visible against the
    PREVIOUS frame's HZB (tested with the previous transforms,
    gpuculling.hlsl:143-146) render first, and an HZB is built from
    their depth.  Late: the early-occluded candidates re-test against
    that HZB with the current transforms, and the newly visible ones
    render on top, continuing the early planes.  The final depth's HZB
    culls the next frame.  The pair lists' capacities are Python ints
    (pair_inst only sets the early one), so nothing here waits on the
    device.  `passes` opens each step's profiler range; sp_mesh shards
    both fills' tile rows (_raster_with_records).  Returns (interp
    planes, depth, tri_id, aux, new_hzb)."""
    planes = frame_inputs['cull_frustum_planes']
    cam = frame_inputs['cull_cam_pos']
    psc = frame_inputs['proj_scale_px']
    w, h = settings.width, settings.height
    cap1 = pair_inst.shape[0]
    cap2 = max(int(cap1 * settings.late_capacity_frac), 64)
    prev_vp = frame_inputs['prev_view_proj_nojitter']
    vp_nojit = frame_inputs['view_proj_nojitter']
    lod_kw = dict(error_threshold_px=settings.lod_error_px,
                  forced_lod=settings.forced_lod)

    # EARLY: cull against the previous HZB and transforms
    passes.begin('GPUCulling')
    cull1 = cull_mod.cull_instances(
        scene, inst_world, planes, cam, psc, w, h, hzb=carry['hzb'],
        hzb_view_proj=prev_vp, hzb_inst_world=prev_inst_world, **lod_kw)
    pi1, pm1, pv1, total1 = cull_mod.build_pairs(
        scene, cull1['visible'], cull1['lod'], cap1)
    pv1 = cull_mod.cull_meshlets(
        scene, pi1, pm1, pv1, inst_world, planes, cam, w, h,
        cone_cull=settings.enable_cone_culling)
    passes.begin('BasePass(fill+resolve)')
    geo1 = geo_mod.meshlet_clip_triangles(
        scene, inst_world, frame_inputs['view_proj'], pi1, pm1, pv1)
    setup1, _, depth1, tid1, interp1, rs1 = _raster_with_records(
        scene, geo1, cfg, inst_world, inst_adj, prev_inst_world, prev_vp,
        sp_mesh=sp_mesh, padded_io=True)
    passes.begin('HZB(SPD)')
    hzb_mid = hzb_mod.build_hzb(crop_image(depth1, cfg), w, h)

    # LATE: re-test the early-occluded candidates against the fresh HZB
    passes.begin('GPUCulling')
    cull2 = cull_mod.cull_instances(
        scene, inst_world, planes, cam, psc, w, h, hzb=hzb_mid,
        hzb_view_proj=vp_nojit, hzb_inst_world=inst_world, **lod_kw)
    late_mask = cull1['occluded_candidate'] & cull2['visible']
    pi2, pm2, pv2, total2 = cull_mod.build_pairs(
        scene, late_mask, cull2['lod'], cap2)
    pv2 = cull_mod.cull_meshlets(
        scene, pi2, pm2, pv2, inst_world, planes, cam, w, h, hzb=hzb_mid,
        hzb_view_proj=vp_nojit, cone_cull=settings.enable_cone_culling)
    passes.begin('BasePass(fill+resolve)')
    geo2 = geo_mod.meshlet_clip_triangles(
        scene, inst_world, frame_inputs['view_proj'], pi2, pm2, pv2)
    _, _, depth, tri_id, interp, rs2 = _raster_with_records(
        scene, geo2, cfg, inst_world, inst_adj, prev_inst_world, prev_vp,
        sp_mesh=sp_mesh, init_depth=depth1, init_tri_id=tid1,
        init_rec=interp1, emit_base=setup1['valid'].shape[0],
        padded_io=True)

    interp = crop_image(interp, cfg)
    depth = crop_image(depth, cfg)
    tri_id = crop_image(tri_id, cfg)
    passes.begin('HZB(SPD)')
    new_hzb = hzb_mod.build_hzb(depth, w, h)
    aux = dict(
        early_instances=torch.sum(cull1['visible'].to(torch.int32)),
        late_instances=torch.sum(late_mask.to(torch.int32)),
        early_pairs=total1, late_pairs=total2,
        # pair-list capacity overflow (bounded amplification drops)
        early_pair_dropped=torch.clamp(total1 - cap1, min=0),
        late_pair_dropped=torch.clamp(total2 - cap2, min=0),
        early_meshlets=torch.sum(pv1.to(torch.int32)),
        late_meshlets=torch.sum(pv2.to(torch.int32)),
        **{f'early_{k}': v for k, v in rs1.items()},
        **{f'late_{k}': v for k, v in rs2.items()})
    return interp, depth, tri_id, aux, new_hzb


def _shadow_raw(bvh, normal, depth, frame_inputs, carry, settings,
                sp_mesh=None):
    """The raw 1-spp sun visibility (H, W) of the ShadowMask pass
    (reference package, frame.py:830-887).  With shadow_ray_scale = sc
    (a power of two dividing the frame), rays trace at 1/sc resolution
    from each sc x sc quad's nearest surface (reverse-Z max depth; the
    quad's mean normal for the bias), on the checkerboard half of that
    grid when shadow_checkerboard is on (alternating with the frame's
    parity); the result expands back to full resolution.  sp_mesh
    shards the rays (trace_shadow_mask)."""
    h, w = depth.shape
    inv_vp = frame_inputs['inv_view_proj']
    to_light = -frame_inputs['sun_direction']
    trace = dict(frame_index=carry['frame_index'],
                 max_steps=settings.shadow_max_steps, sp_mesh=sp_mesh)
    sc = max(settings.shadow_ray_scale, 1)
    if not (sc > 1 and h % sc == 0 and w % sc == 0 and (sc & (sc - 1)) == 0):
        wp = world_pos_from_depth(depth, inv_vp, w, h)
        return shadows_mod.trace_shadow_mask(bvh, wp, normal, depth > 0.0,
                                             to_light, **trace)
    hs, ws = h // sc, w // sc
    d_h = depth.reshape(hs, sc, ws, sc).amax(dim=(1, 3))
    wp_h = world_pos_from_depth(d_h, inv_vp, ws, hs)
    n_h = normalize(normal.reshape(hs, sc, ws, sc, 3).sum(dim=(1, 3))
                    * (1.0 / (sc * sc)))
    if settings.shadow_checkerboard and ws % 2 == 0:
        par = carry['frame_index'] % 2
        d_c, wp_c, n_c = shadows_mod.checkerboard_pack((d_h, wp_h, n_h), par)
        raw_c = shadows_mod.trace_shadow_mask(bvh, wp_c, n_c, d_c > 0.0,
                                              to_light, **trace)
        raw = shadows_mod.checkerboard_unpack(raw_c, par)
    else:
        raw = shadows_mod.trace_shadow_mask(bvh, wp_h, n_h, d_h > 0.0,
                                            to_light, **trace)
    raw = raw[..., None]
    for _ in range(sc.bit_length() - 1):          # log2(sc) doublings
        raw = _quad_expand(raw)
    return raw[..., 0]


def _ambient_occlusion(depth, normal, frame_inputs, frame_index,
                       radius: float, half_res: bool):
    """The AmbientOcclusion pass (reference package, frame.py:1125-1157):
    GTAO, at half resolution when `half_res` and the frame's sides are
    even (each quad's nearest depth, its mean normal; the result
    expanded 2x), then the depth-aware blur at full resolution."""
    h, w = depth.shape
    args = (frame_inputs['cam_pos'], frame_inputs['inv_view_proj'],
            frame_index)
    if half_res and h % 2 == 0 and w % 2 == 0:
        n_h = normalize(normal.reshape(h // 2, 2, w // 2, 2, 3).sum(
            dim=(1, 3)) * 0.25)
        ao_h = gtao(_maxpool2(depth), n_h, *args, radius=radius)
        ao = _quad_expand(ao_h[..., None])[..., 0]
    else:
        ao = gtao(depth, normal, *args, radius=radius)
    return depth_aware_blur(ao, depth, radius=2)


_GI_KEYS = ('ddgi_irradiance', 'ddgi_distance', 'ddgi_offset', 'ddgi_state',
            'ddgi_variability', 'ddgi_var_ring', 'ddgi_var_accum')
_SUN_KEYS = ('sun_direction', 'sun_color', 'sun_intensity')


def _host_sun_sig(fh):
    """The sun signature (direction, colour, intensity; f32) of the
    frame's host inputs, or None when they hold no copy of the sun."""
    if fh is None or not all(k in fh for k in _SUN_KEYS):
        return None
    return np.concatenate([np.asarray(fh[k], np.float32).reshape(-1)[:n]
                           for k, n in zip(_SUN_KEYS, (3, 3, 1))])


def _gi_pass(volume, trace_inputs, depth, wp, normal, frame_inputs, carry,
             host: HostMirror, settings, sky_fn, sun_vis_fn=None,
             sp_mesh=None):
    """The GI pass (reference package, frame.py:898-1105): the
    convergence test, the probe update on update frames, and the probe
    field sampled per pixel.  `trace_inputs()` gives (tree, shade
    records, pair tables or None) on update frames; `sun_vis_fn(points)`,
    when given, the probe hits' sun visibility (the sun map's taps) in
    place of their any-hit rays; sp_mesh shards the probe rays
    (trace_probe_block).

    The reference holds the probes through a device-side branch (hold
    frames: 3 of every 4 with gi_update_phases=4 in interval mode, and
    every frame once the probes converge).  Here the branch is taken on
    the host, from what it knows before the frame runs: this frame's
    converged = no sun change (host sun vectors against the mirror's)
    and the carry's convergence test, which the previous frame copied to
    the host without blocking (HostMirror.is_converged waits for that
    copy only when the branch needs it); cycle_end comes from the
    mirror's frame index.  So hold frames launch nothing of the update
    and the frame reads no device value (a frame whose inputs hold no
    host copy of the sun reads the device's sun test instead).  Returns
    (irradiance (H, W, 3), the probe carry, aux, the mirror's GI
    fields)."""
    fi = frame_inputs
    dev = depth.device
    frame_index = carry['frame_index']
    sun_sig = torch.cat([fi['sun_direction'].reshape(-1)[:3],
                         fi['sun_color'].reshape(-1)[:3],
                         fi['sun_intensity'].reshape(-1)[:1]])
    # a sun change restarts the convergence count
    sun_changed = torch.any(torch.abs(sun_sig - carry['ddgi_sun_sig'])
                            > 1e-6)
    var_samples = torch.where(sun_changed, 0.0, carry['ddgi_var_samples'])
    converged = ddgi_convergence(var_samples, carry['ddgi_var_ring'],
                                 settings)
    phases = max(settings.gi_update_phases, 1)
    cycle_end = torch.remainder(frame_index, phases) == phases - 1
    # interval mode: the whole volume on the cycle's last frame, the
    # carry held on the others
    interval = settings.gi_update_mode == 'interval' and phases > 1

    # the same branch on the host
    sig_h = _host_sun_sig(fi.get('host'))
    if sig_h is None:
        sun_changed_h = bool(sun_changed)
        sig_h = sun_sig.detach().cpu().numpy()
    else:
        with np.errstate(invalid='ignore'):
            sun_changed_h = bool(np.any(np.abs(sig_h - host.sun_sig)
                                        > np.float32(1e-6)))

    def converged_h():
        return (settings.gi_convergence_skip and not sun_changed_h
                and host.is_converged())
    cycle_end_h = host.frame_index % phases == phases - 1
    updated = not ((not cycle_end_h or converged_h()) if interval
                   else converged_h())

    gi_carry = {k: carry[k] for k in _GI_KEYS}
    if updated:
        gi_bvh, shade_rec, tables = trace_inputs()
        trace_phases = 1 if interval else settings.gi_update_phases
        radiance, ray_dist, ray_dirs, blk, lifecycle = \
            ddgi_mod.trace_probe_block(
                volume, gi_bvh, shade_rec, carry['ddgi_irradiance'],
                -fi['sun_direction'], fi['sun_color'], fi['sun_intensity'],
                frame_index, sky_fn, trace_phases,
                max_steps=settings.gi_max_steps,
                probe_offset=carry['ddgi_offset'],
                probe_state=carry['ddgi_state'], sun_vis_fn=sun_vis_fn,
                pair_tables=tables, sp_mesh=sp_mesh)
        gic = ddgi_mod.update_probe_block(
            volume, dict(carry, ddgi_var_samples=var_samples), radiance,
            ray_dist, ray_dirs, blk,
            first_frame=frame_index < settings.gi_update_phases,
            lifecycle=lifecycle,
            cycle_end=(torch.ones((), dtype=torch.bool, device=dev)
                       if interval else cycle_end),
            num_phases=trace_phases)
        gi_carry = {k: gic[k] for k in _GI_KEYS}
    gi_carry['ddgi_var_samples'] = torch.where(
        converged, var_samples, var_samples + cycle_end.to(torch.float32))
    gi_carry['ddgi_sun_sig'] = sun_sig
    # the next frame's branch: this carry's test, on its way to the host
    conv_next, ready = _to_host(ddgi_convergence(
        gi_carry['ddgi_var_samples'], gi_carry['ddgi_var_ring'], settings))
    mirror = dict(sun_sig=sig_h, converged=conv_next, ready=ready)

    # the probe field sampled at 1/gi_sample_scale resolution (it is low
    # frequency), expanded, then smoothed by two separable [1 2 1] / 4
    # taps (the raw blocks beat against the probe grid otherwise)
    h, w = depth.shape
    sc = max(settings.gi_sample_scale, 1) if settings.gi_half_res else 1
    sample = dict(probe_offset=gi_carry['ddgi_offset'],
                  vis_pool=max(settings.gi_vis_scale, 1))
    irr, dist = gi_carry['ddgi_irradiance'], gi_carry['ddgi_distance']
    if sc > 1 and h % sc == 0 and w % sc == 0:
        gi_h = ddgi_mod.sample_irradiance_visibility(
            volume, irr, dist, ddgi_mod.mean_pool(wp, sc),
            normalize(ddgi_mod.mean_pool(normal, sc)), **sample)
        gi = gi_h.repeat_interleave(sc, 0).repeat_interleave(sc, 1)
        for ax in (0, 1):
            n_ax = gi.shape[ax]
            lo = torch.cat([gi.narrow(ax, 0, 1), gi.narrow(ax, 0, n_ax - 1)],
                           dim=ax)
            hi = torch.cat([gi.narrow(ax, 1, n_ax - 1),
                            gi.narrow(ax, n_ax - 1, 1)], dim=ax)
            gi = 0.25 * lo + 0.5 * gi + 0.25 * hi
    else:
        gi = ddgi_mod.sample_irradiance_visibility(volume, irr, dist, wp,
                                                   normal, **sample)
    gi = torch.where((depth > 0)[..., None], gi, 0.0)
    aux = dict(ddgi_variability=gi_carry['ddgi_variability'],
               ddgi_active_probes=torch.sum(gi_carry['ddgi_state']),
               ddgi_converged=converged, ddgi_updated=updated)
    return gi, gi_carry, aux, mirror


def _rt_streams(base_pi, base_pm, rts, mask_pair_inst, mask_pair_meshlet):
    """A tree's pair stream: its pair list, with the masked pairs it was
    built over appended (its payloads index this stream)."""
    nm = getattr(rts, 'n_mask_pairs', 0)
    if nm > 0 and mask_pair_inst is not None:
        return (torch.cat([base_pi, mask_pair_inst[:nm]]),
                torch.cat([base_pm, mask_pair_meshlet[:nm]]))
    return base_pi, base_pm



class _Passes:
    """The frame's profiler ranges (utils/timing.profiler_range):
    `begin(label)` closes the open range and opens the next, `end()`
    closes it; a pass that runs inside another opens its own nested
    range.  Outside a profiler a range is a no-op."""

    def __init__(self):
        self._open = None

    def begin(self, label: str):
        self.end()
        self._open = profiler_range(label)
        self._open.__enter__()

    def end(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def render_frame(scene, pair_inst, pair_meshlet, frame_inputs: dict,
                 carry: dict, settings: RenderSettings,
                 mask_pair_inst=None, mask_pair_meshlet=None,
                 raster_cfg: RasterConfig | None = None,
                 mask_raster_cfg: RasterConfig | None = None,
                 rt_static=None, rt_pair_inst=None, rt_pair_meshlet=None,
                 ddgi_volume=None, rt_static_gi=None, gi_pair_inst=None,
                 gi_pair_meshlet=None, trans_pair_inst=None,
                 trans_pair_meshlet=None,
                 trans_raster_cfg: RasterConfig | None = None,
                 sp_mesh=None):
    """One frame.

    frame_inputs (tensors on the scene's device, see
    weights.frame_inputs_from_numpy, or unpack_frame_inputs of a packed
    set): view_proj, view_proj_nojitter,
    prev_view_proj_nojitter, inv_view_proj, cam_pos, jitter,
    cull_frustum_planes, cull_cam_pos, proj_scale_px, node_translation /
    rotation / scale, sun_direction, sun_color, sun_intensity,
    sun_view_proj, sky_params; optionally 'host', the host copies (f32
    numpy) of the node TRS arrays, the sun's fields and sun_view_proj
    from which the frame decides on the host whether the scene or the
    sun moved (host_frame_inputs; pack_frame_inputs and make_render_fn
    add it), and the residency overrides of a streaming
    manager (engine/streaming.py update(): tex_texels, tex_desc,
    tex_min_mip, tex_tile_table), which the sampler reads in place of
    the scene's atlas through the descriptor rows.  Under
    `enable_culling` the frame builds its own pair lists, and pair_inst
    only sets the early list's capacity.
    raster_cfg: a content-sized RasterConfig (engine/capacity.py) in
    place of settings.raster_config(), for the same width and height;
    mask_raster_cfg / trans_raster_cfg: the masked set's and the blend
    set's, each sized for its set (default: raster_cfg).
    rt_static: the static RT topology over the RT pair list, the masked
    set appended -- the complete tree of ops/bvh.build_rt_static or the
    SAH tree of ops/bvh_sah.build_rt_static_sah (both from
    bvh_sah.build_rt_static_auto, by TR_RT_SAH) --, for RT shadows, ReSTIR's
    visibility rays and GI when it has no tree of its own; the frame
    refits it (with the carry's rt_bvh_cache: only when an instance
    moved).  Without it those rebuild the tree every frame
    (bvh.build_bvh over the RT pair list, no masked set).  rt_pair_inst /
    rt_pair_meshlet: that RT pair list (its payloads index it; default
    pair_inst / pair_meshlet); ReSTIR's lights are its emissive
    triangles.  The sun map (map shadows; the probe hits' sun taps
    when gi_sun_technique is 'map', or 'auto' without RT shadows) draws
    the RT pair stream, its masked pairs through rt_static's coverage
    keep; it is rendered at its first use in a frame, or served from the
    carry's sun_map_depth when neither the sun nor an instance moved
    since it was rendered.
    ddgi_volume: the probe grid GI needs (ddgi.volume_from_aabb);
    rt_static_gi: GI's own frozen topology (ops/bvh_sah.
    build_rt_static_gi: the SAH tree, or the complete one) over
    gi_pair_inst / gi_pair_meshlet (default: the RT pair list), the
    masked set appended; refit with its shade records on a GI update
    frame (with the carry's gi_bvh_cache: on the first update frame
    after an instance moved).
    trans_pair_inst / trans_pair_meshlet: the blend set (alpha mode
    BLEND), drawn with enable_transparency.
    sp_mesh: (parallel.Mesh, axis), the frame over that axis's devices
    (reference package, frame.py:344-369, 564-650, 869-887, 1021,
    1185-1200): every fill of the opaque, masked and blend sets with its
    tile rows sharded (parallel.sp_raster.raster_frame_sp; the masked
    set then takes one fused fill per layer, without the compact merge
    and its K2 fill, as the reference does), the shadow rays and the
    probe rays in slices (bvh_cuda.traverse_auto); the rest of the frame
    runs on the scene's device, the mesh's first.  Unlike the
    reference's, each band keeps the peel bound and reports its drops.
    Returns (image_u8 (H, W, 3), new_carry, aux dict).  aux holds the
    opaque set's raster counters as `raster_*` (`raster_dropped` sums its
    drop counters, as the reference's does) or, culled, the reference's
    `early_*` / `late_*` counters; when the masked set is drawn, the same
    raster counters of that set as `raster_mask_*`, and of the blend set
    as `raster_trans_*`; and, with their
    passes on, `shadow` (the denoised mask), `ao`, the probes'
    `ddgi_variability` / `ddgi_active_probes` / `ddgi_converged` and
    `ddgi_updated` (a Python bool: this frame updated the probes),
    `shadow_map_dropped` (the sun map's summed drop counters, on the
    frames that read it), ReSTIR's `restir_lights` (the light count)
    and `restir` (its radiance, (H, W, 3)),
    `bloom`, exposure's `avg_luminance` / `target_exposure`, and, when
    the frame samples textures, the opaque set's sampler feedback:
    `tex_feedback` (per texture) and, with a tile table,
    `vt_tile_feedback` (per tile), the min desired mip, +inf unused.
    `rebuilt` lists the caches this frame built (of 'rt', 'gi', 'mt',
    'sm'; a frame without a cache builds what it uses and lists
    nothing).  With debug_mode != 0 the image is that debug view
    (lighting.debug_view) of the GBuffer, in u8.
    """
    passes = _Passes()
    try:
        return _frame(
            passes, scene, pair_inst, pair_meshlet, frame_inputs, carry,
            settings, mask_pair_inst=mask_pair_inst,
            mask_pair_meshlet=mask_pair_meshlet, raster_cfg=raster_cfg,
            mask_raster_cfg=mask_raster_cfg, rt_static=rt_static,
            rt_pair_inst=rt_pair_inst, rt_pair_meshlet=rt_pair_meshlet,
            ddgi_volume=ddgi_volume, rt_static_gi=rt_static_gi,
            gi_pair_inst=gi_pair_inst, gi_pair_meshlet=gi_pair_meshlet,
            trans_pair_inst=trans_pair_inst,
            trans_pair_meshlet=trans_pair_meshlet,
            trans_raster_cfg=trans_raster_cfg, sp_mesh=sp_mesh)
    finally:
        passes.end()


def _moved(host: HostMirror, fh) -> tuple[bool, tuple | None]:
    """(whether an instance transform may differ from the previous
    frame's, this frame's node TRS host arrays or None): decided on the
    host, by value; no host copy, or no previous one, counts as moved."""
    if fh is None or not all(k in fh for k in _FI_NODES):
        return True, None
    nodes = tuple(fh[k] for k in _FI_NODES)
    if host.nodes is None:
        return True, nodes
    return (not all(np.array_equal(a, b) for a, b in zip(nodes, host.nodes)),
            nodes)


def _frame(passes, scene, pair_inst, pair_meshlet, frame_inputs, carry,
           settings, *, mask_pair_inst, mask_pair_meshlet, raster_cfg,
           mask_raster_cfg, rt_static, rt_pair_inst, rt_pair_meshlet,
           ddgi_volume, rt_static_gi, gi_pair_inst, gi_pair_meshlet,
           trans_pair_inst, trans_pair_meshlet, trans_raster_cfg, sp_mesh):
    """render_frame's body: its arguments, with the ranges `passes`,
    which render_frame closes whether or not the frame raises."""
    check_settings(settings)
    needs_rays, gi_own_tree, needs_rt, gi_sun_map, _ = _tree_needs(
        settings, rt_static_gi)
    if settings.enable_gi and ddgi_volume is None:
        raise ValueError("enable_gi needs a ddgi_volume "
                         "(ddgi.volume_from_aabb)")
    cfg = settings.raster_config() if raster_cfg is None else raster_cfg
    cfg_m = cfg if mask_raster_cfg is None else mask_raster_cfg
    cfg_t = cfg if trans_raster_cfg is None else trans_raster_cfg
    for name, c in (('raster_cfg', cfg), ('mask_raster_cfg', cfg_m),
                    ('trans_raster_cfg', cfg_t)):
        if (c.width, c.height) != (settings.width, settings.height):
            raise ValueError(f"{name} is {c.width}x{c.height}, the "
                             f"settings {settings.width}x{settings.height}")
    # the packed GBuffer is the only medium between passes, or the float
    # planes are
    emit = not settings.pack_gbuffer

    # the host's view of the frame: whether the scene moved, which caches
    # are current (a carry without a mirror gets one read from the device)
    host = getattr(carry, 'host', None)
    if host is None:
        host = HostMirror.of_carry(carry, settings)
    fh = frame_inputs.get('host')
    moved, nodes = _moved(host, fh)
    version = host.version + 1 if moved else host.version
    built = dict(host.built)
    rebuilt = []

    def current(key: str, cache_key: str) -> bool:
        return cache_key in carry and built.get(key) == version

    def mark(key: str, cache_key: str):
        if cache_key in carry:
            built[key] = version
            rebuilt.append(key)

    # -- UpdateInstanceConsts ------------------------------------------------
    passes.begin('UpdateInstanceConsts')
    world = geo_mod.node_world_matrices(
        scene, frame_inputs['node_translation'],
        frame_inputs['node_rotation'], frame_inputs['node_scale'])
    inst_world, inst_adj = geo_mod.instance_transforms(scene, world)
    prev_inst_world = carry['prev_inst_world']
    prev_vp = frame_inputs['prev_view_proj_nojitter']

    # -- Geometry + raster (GBuffer pass) -------------------------------------
    new_hzb = None
    if settings.enable_culling and not settings.use_bruteforce_raster:
        interp, depth, tri_id, raster_aux, new_hzb = _gbuffer_two_phase(
            scene, inst_world, inst_adj, prev_inst_world, frame_inputs,
            carry, pair_inst, cfg, settings, passes, sp_mesh=sp_mesh)
    else:
        passes.begin('BasePass(fill+resolve)')
        geo = geo_mod.meshlet_clip_triangles(
            scene, inst_world, frame_inputs['view_proj'], pair_inst,
            pair_meshlet)
        if settings.use_bruteforce_raster:
            # the oracle: every triangle at every pixel, then the plain
            # per-pixel resolve (reference package, frame.py:509-514)
            setup, depth, tri_id = raster_mod.rasterize_bruteforce(geo, cfg)
            interp = resolve_interpolants(
                pack_resolve_records(setup, scene, inst_world, inst_adj,
                                     prev_inst_world, prev_vp),
                depth, tri_id, cfg)
            raster_aux = {}
        else:
            _, _, depth, tri_id, interp, rstats = _raster_with_records(
                scene, geo, cfg, inst_world, inst_adj, prev_inst_world,
                prev_vp, sp_mesh=sp_mesh)
            raster_aux = {f'raster_{k}': v for k, v in rstats.items()}
    mstats = {}     # the masked set's counters, when it is drawn
    tstats = {}     # the blend set's

    atlas = None
    if settings.enable_textures and scene.num_textures > 0:
        atlas = frame_atlas(scene, frame_inputs)

    def gbuffer(planes, d, t, feedback=True):
        return finish_gbuffer(planes, d, t, frame_inputs['jitter'], cfg,
                              atlas=atlas, num_textures=scene.num_textures,
                              quad_taps=settings.texture_quad_taps,
                              aniso=settings.texture_aniso,
                              feedback=feedback, emit_planes=emit)
    passes.begin('GBufferResolve')
    gb = gbuffer(interp, depth, tri_id)

    # -- Alpha-masked set (basepass.hlsl ALPHA_MASK_MODE parity): depth-
    #    peeled `alpha_layers` times, nearest first; per pixel the FIRST
    #    layer whose alpha passes the cutoff wins --------------------------
    if (settings.enable_alpha_test and mask_pair_inst is not None
            and mask_pair_inst.shape[0] > 0):
        passes.begin('AlphaMaskedPass')
        geo_m = geo_mod.meshlet_clip_triangles(
            scene, inst_world, frame_inputs['view_proj'], mask_pair_inst,
            mask_pair_meshlet)
        # setup/records/bins are layer-invariant: each layer is one fill
        setup_m = raster_mod.setup_triangles(geo_m, cfg_m)
        records_m = pack_resolve_records(
            setup_m, scene, inst_world, inst_adj, prev_inst_world, prev_vp)
        fill_m = _LayerFill(setup_m, records_m, cfg_m, sp_mesh)
        mstats = fill_m.stats()
        n_layers = max(settings.alpha_layers, 1)
        # the merged channels: the packed words or the float planes, and
        # uv when a debug view may read it
        if settings.pack_gbuffer:
            merge_scalar = ('gbuffer0', 'gbuffer1', 'gbuffer2', 'gbuffer3')
            merge_vec = ['motion']
        else:
            merge_scalar = ('rough_f', 'metal_f')
            merge_vec = ['motion', 'albedo_f', 'normal_f', 'emissive_f']
        if settings.debug_mode != 0:
            merge_vec.append('uv')
        h0, w0 = depth.shape

        def merge(passes_px, gb_m, depth_m, tid_m):
            for k in merge_scalar:
                gb[k] = torch.where(passes_px, gb_m[k], gb[k])
            for k in merge_vec:
                gb[k] = torch.where(passes_px[..., None], gb_m[k], gb[k])
            # ids of those pixels index the MASKED setup (aux only)
            return (torch.where(passes_px, depth_m, depth),
                    torch.where(passes_px, tid_m, tri_id))

        if (sp_mesh is None and settings.peel_merge_frac > 0
                and h0 % 2 == 0 and w0 % 2 == 0):
            # every layer in ONE occluder-seeded peel fill (K2), then
            # resolve + texture at compact rate, only on the quads a
            # fragment reaches (reference package, frame.py:598-640)
            depth_l, tid_l = fill_peel_stream(
                setup_m, fill_m.bins, cfg_m, layers=n_layers,
                occluder_depth=depth)
            cap_q = max(int((h0 // 2) * (w0 // 2)
                            * settings.peel_merge_frac), 256)
            gb_m = masked_peel_merge_compact(
                records_m, depth_l, tid_l, frame_inputs['jitter'], cfg_m,
                cap_q, atlas=atlas, quad_taps=settings.texture_quad_taps,
                aniso=settings.texture_aniso,
                channels=set(merge_scalar) | set(merge_vec),
                emit_planes=emit)
            depth, tri_id = merge(gb_m['passes'], gb_m, gb_m['depth'],
                                  gb_m['tri_id'])
        else:
            # dense: one fill+resolve per layer, peeled behind the last
            chosen = torch.zeros_like(depth, dtype=torch.bool)
            peel = None
            for _layer in range(n_layers):
                depth_m, tid_m, rec_m = fill_m(peel)
                gb_m = gbuffer(rec_m, depth_m, tid_m, feedback=False)
                won = ((gb_m['alpha'] >= gb_m['alpha_cutoff'])
                       & (depth_m > depth) & (depth_m > 0.0) & ~chosen)
                depth, tri_id = merge(won, gb_m, depth_m, tid_m)
                chosen = chosen | won
                peel = depth_m
        gb['depth'] = depth

    passes.begin('GBufferResolve')
    shadow_mask = None
    new_carry = FrameCarry(prev_inst_world=inst_world, prev_depth=depth,
                           frame_index=carry['frame_index'] + 1)
    # the caches ride on unless a pass below rebuilds them
    new_carry.update({k: carry[k] for k in CACHE_KEYS if k in carry})
    m_gb = unpack_gbuffer(gb)
    normal = m_gb['normal']
    (rt_pi, rt_pm), g_streams = _pair_streams(
        pair_inst, pair_meshlet, rt_static, rt_static_gi, rt_pair_inst,
        rt_pair_meshlet, gi_pair_inst, gi_pair_meshlet, mask_pair_inst,
        mask_pair_meshlet)
    wp = None
    if settings.enable_gi or settings.enable_restir:
        wp = world_pos_from_depth(depth, frame_inputs['inv_view_proj'],
                                  settings.width, settings.height)

    # -- the RT tree: refit from rt_static (from the carry's cache when no
    #    instance moved since its refit), or rebuilt every frame without
    #    rt_static ------------------------------------------------------------
    bvh = tris = None
    if needs_rt:
        passes.begin('RT(BVH build)')
    if needs_rt and rt_static is not None:
        if current('rt', 'rt_bvh_cache'):
            bvh = carry['rt_bvh_cache']
        else:
            bvh = _refit_tree(rt_static, inst_world)
            mark('rt', 'rt_bvh_cache')
            if 'rt_bvh_cache' in carry:
                new_carry['rt_bvh_cache'] = bvh
    elif needs_rt:
        tris = world_triangles(scene, inst_world, rt_pi, rt_pm)
        bvh = build_bvh(*tris)

    # -- the sun shadow map, for map shadows and the probe hits' sun taps:
    #    at its first use in the frame (so every frame with map shadows and
    #    only the GI update frames without them), rendered, or served from
    #    the carry's cache when neither the sun nor an instance moved since
    #    it was rendered (reference package, frame.py:786-806) ------------
    sm = {}
    sm_res = settings.shadow_map_resolution
    sun_vp = frame_inputs['sun_view_proj']
    sun_vp_h = (np.asarray(fh['sun_view_proj'], np.float32)
                if fh is not None and 'sun_view_proj' in fh else None)
    sm_cached = settings.cache_sun_map and 'sun_map_depth' in carry

    def sun_map():
        """The frame's sun map, quad-expanded; rendered once."""
        if sm:
            return sm['quads']
        with profiler_range('ShadowMap'):
            if (sm_cached and current('sm', 'sun_map_depth')
                    and sun_vp_h is not None and host.sun_vp is not None
                    and np.array_equal(sun_vp_h, host.sun_vp)):
                sm_depth, sm['dropped'] = (carry['sun_map_depth'],
                                           carry['sun_map_dropped'])
                sm['sun_vp'] = host.sun_vp
            else:
                keep = (rt_static.pair_keep
                        if rt_static is not None
                        and rt_static.n_mask_pairs > 0
                        and mask_pair_inst is not None else None)
                sm_depth, sm['dropped'] = shadowmap.render_shadow_map(
                    scene, inst_world, rt_pi, rt_pm, sun_vp,
                    shadowmap.shadow_map_config(sm_res), tri_keep=keep)
                sm['sun_vp'] = sun_vp_h
                if sm_cached:
                    mark('sm', 'sun_map_depth')
                    new_carry.update(sun_map_depth=sm_depth,
                                     sun_map_dropped=sm['dropped'],
                                     prev_sun_view_proj=sun_vp)
            sm['quads'] = shadowmap.quad_expand_map(sm_depth)
        return sm['quads']

    sun_vis_fn = None
    if gi_sun_map:
        def sun_vis_fn(points):
            return shadowmap.sample_shadow_map_points(
                sun_map(), sm_res, sun_vp, points)

    # -- ShadowMask: rays through the traversal kernel, or a tap of the
    #    sun map, then the temporal + spatial denoise -------------------------
    if settings.enable_shadows:
        passes.begin('ShadowMask')
        if needs_rays:
            raw = _shadow_raw(bvh, normal, depth, frame_inputs, carry,
                              settings, sp_mesh=sp_mesh)
        else:
            raw = shadowmap.sample_shadow_map(
                sun_map(), sm_res, sun_vp,
                world_pos_from_depth(depth, frame_inputs['inv_view_proj'],
                                     settings.width, settings.height),
                normal, -frame_inputs['sun_direction'], depth > 0.0,
                carry['frame_index'])
        passes.begin('Denoise')
        shadow_mask, new_carry['shadow_history'] = denoise_shadow(
            raw, gb['motion'], carry['shadow_history'],
            carry['shadow_valid'], depth, carry['prev_depth'])
        new_carry['shadow_valid'] = torch.ones_like(carry['shadow_valid'])

    to_light_sky = -frame_inputs['sun_direction']
    if settings.sky_model == 'hosek':
        def sky_fn(d):
            return sky_mod.sky_radiance_hosek(
                d, to_light_sky, frame_inputs['sky_params'],
                sun_intensity=frame_inputs['sun_intensity'])
    else:
        def sky_fn(d):
            return sky_mod.sky_radiance(
                d, to_light_sky, turbidity=settings.sky_turbidity,
                sun_intensity=frame_inputs['sun_intensity'])

    # -- GI: the probe update on update frames, the probe field sampled
    #    every frame.  GI's own tree, its shade records and pair tables
    #    come from the carry's cache unless an instance moved since they
    #    were built (the first update frame after a move rebuilds them,
    #    hold frames included: unlike the reference, whose update frames
    #    serve a cache that only a move on that same frame rebuilds) -----
    gi_irradiance = None
    gi_aux = {}
    mirror = {}
    if settings.enable_gi:
        passes.begin('GI(DDGI)')
        pairs_on = ddgi_mod._gi_pairs_enabled()

        def trace_inputs():
            """The GI tree, its shade records (payloads index the tree's
            pair stream) and, under TR_GI_PAIRS=1 with a cache for them,
            the pair route's tables (None: trace_probe_block builds
            them)."""
            if gi_own_tree:
                if current('gi', 'gi_bvh_cache'):
                    tree = carry['gi_bvh_cache']
                    shade = carry['gi_shade_cache']
                else:
                    tree, shade = _gi_build(scene, rt_static_gi, g_streams,
                                            inst_world)
                    if 'gi_bvh_cache' in carry:
                        mark('gi', 'gi_bvh_cache')
                        new_carry.update(gi_bvh_cache=tree,
                                         gi_shade_cache=shade)
            else:
                v0, v1, v2, _ = (tris if tris is not None else
                                 world_triangles(scene, inst_world, rt_pi,
                                                 rt_pm))
                tree, shade = bvh, ddgi_mod.build_shade_records(
                    scene, rt_pi, rt_pm, v0, v1, v2)
            # the pair tables are current on their own key: a frame with
            # the pair route off leaves them as they were
            tables = None
            if pairs_on and 'gi_mt_cache' in carry:
                if current('mt', 'gi_mt_cache'):
                    tables = carry['gi_mt_cache']
                else:
                    tables = new_carry['gi_mt_cache'] = mt_tables(tree)
                    mark('mt', 'gi_mt_cache')
            return tree, shade, tables
        gi_irradiance, gi_carry, gi_aux, mirror = _gi_pass(
            ddgi_volume, trace_inputs, depth, wp, normal, frame_inputs,
            carry, host, settings, sky_fn, sun_vis_fn, sp_mesh=sp_mesh)
        new_carry.update(gi_carry)

    # -- ReSTIR DI: the emissive triangles of the RT pair stream as lights,
    #    one visibility ray a pixel through the main tree (K3) -------------
    restir_light = None
    restir_aux = {}
    if settings.enable_restir:
        passes.begin('ReSTIR')
        if tris is None:
            tris = world_triangles(scene, inst_world, rt_pi, rt_pm)
        lights = restir_mod.collect_emissive_lights(
            scene, rt_pi, rt_pm, *tris[:3],
            max_lights=settings.restir_max_lights)
        restir_light, new_carry['restir_reservoir'] = restir_mod.restir_di(
            bvh, lights, wp, normal, m_gb['albedo'], depth > 0.0,
            carry['frame_index'],
            prev_reservoir=carry.get('restir_reservoir'),
            motion=gb['motion'], num_candidates=settings.restir_candidates,
            num_spatial=settings.restir_spatial_taps,
            spatial_radius=settings.restir_spatial_radius)
        restir_aux = dict(restir_lights=lights['count'], restir=restir_light)

    # -- AmbientOcclusion (GTAO) ----------------------------------------------
    ao = None
    if settings.enable_ao:
        passes.begin('AmbientOcclusion')
        ao = _ambient_occlusion(depth, normal, frame_inputs,
                                carry['frame_index'], settings.ao_radius,
                                settings.ao_half_res)

    # -- Deferred lighting + sky --------------------------------------------
    passes.begin('DeferredLighting')

    def lighting(g, **kw):
        return deferred_lighting(
            g, frame_inputs['cam_pos'], frame_inputs['inv_view_proj'],
            frame_inputs['sun_direction'], frame_inputs['sun_color'],
            frame_inputs['sun_intensity'], sky_fn,
            ambient_factor=settings.ambient_factor,
            gi_irradiance=gi_irradiance, **kw)
    hdr = lighting(gb, shadow_mask=shadow_mask, ao=ao)
    if restir_light is not None:
        hdr = hdr + torch.where((depth > 0)[..., None], restir_light, 0.0)

    # -- TransparentForward: the blend set, depth-peeled `oit_layers`
    #    times (layer 0 unbounded, each later one past the last), each
    #    layer shaded without shadow or AO, composited back to front over
    #    the pixels where it lies in front of the opaque depth (reference
    #    package, frame.py:1170-1232) --------------------------------------
    if (settings.enable_transparency and trans_pair_inst is not None
            and trans_pair_inst.shape[0] > 0):
        passes.begin('TransparentForward(layer 0)')
        geo_t = geo_mod.meshlet_clip_triangles(
            scene, inst_world, frame_inputs['view_proj'], trans_pair_inst,
            trans_pair_meshlet)
        setup_t = raster_mod.setup_triangles(geo_t, cfg_t)
        records_t = pack_resolve_records(
            setup_t, scene, inst_world, inst_adj, prev_inst_world, prev_vp)
        fill_t = _LayerFill(setup_t, records_t, cfg_t, sp_mesh)
        tstats = fill_t.stats()
        layers = []
        peel = None
        for layer in range(max(settings.oit_layers, 1)):
            if layer:
                passes.begin(f'TransparentForward(layer {layer})')
            depth_t, tid_t, rec_t = fill_t(peel)
            # the reference resolves these layers with the per-pixel
            # sampler (no quad taps)
            gb_t = finish_gbuffer(
                rec_t, depth_t, tid_t, frame_inputs['jitter'], cfg_t,
                atlas=atlas, num_textures=scene.num_textures,
                aniso=settings.texture_aniso, feedback=False,
                emit_planes=emit)
            layers.append((depth_t, lighting(gb_t), gb_t['alpha']))
            peel = depth_t
        passes.begin('TransparentForward(composite)')
        for depth_t, hdr_t, alpha_t in reversed(layers):
            front = (depth_t > depth) & (depth_t > 0.0)
            blend = torch.where(front, alpha_t, 0.0)[..., None]
            hdr = hdr * (1.0 - blend) + hdr_t * blend
    if settings.show_gi_probes and settings.enable_gi:
        passes.begin('ProbeOverlay')
        hdr = ddgi_mod.visualize_probes(
            hdr, depth, ddgi_volume, new_carry['ddgi_irradiance'],
            frame_inputs['view_proj_nojitter'], frame_inputs['cam_pos'],
            probe_offset=new_carry['ddgi_offset'])

    if new_hzb is not None:
        new_carry['hzb'] = new_hzb
    aux = dict(depth=depth, tri_id=tri_id, motion=gb['motion'], hdr=hdr,
               resolved_pixels=torch.sum((tri_id >= 0).to(torch.int32)),
               **raster_aux,
               **{f'raster_mask_{k}': v for k, v in mstats.items()},
               **{f'raster_trans_{k}': v for k, v in tstats.items()})
    if sm:
        aux['shadow_map_dropped'] = sm['dropped']
    if shadow_mask is not None:
        aux['shadow'] = shadow_mask
    if ao is not None:
        aux['ao'] = ao
    aux.update(gi_aux)
    aux.update(restir_aux)
    # the opaque set's sampler feedback (the masked set sends none)
    for k in ('tex_feedback', 'vt_tile_feedback'):
        if k in gb:
            aux[k] = gb[k]

    # -- HDR post, in the reference's pass order: bloom from the lighting
    #    output, exposure adapted on the device (frame 0 snaps to the
    #    target), TAA on HDR before the tonemap ---------------------------
    bloom_tex = None
    if settings.enable_bloom:
        passes.begin('Bloom')
        bloom_tex = bloom_mod.bloom(hdr, num_mips=settings.bloom_mips)
        aux['bloom'] = bloom_tex
    exposure = carry['exposure']
    if settings.enable_auto_exposure:
        passes.begin('AdaptLuminance')
        adapted, exp_aux = exposure_mod.adapt_exposure(hdr, exposure)
        exposure = torch.where(carry['frame_index'] == 0,
                               exp_aux['target_exposure'], adapted)
        aux.update(exp_aux)
    new_carry['exposure'] = exposure
    aa = hdr
    if settings.enable_taa:
        passes.begin('TAA')
        aa, new_carry['taa_history'] = taa_resolve(
            hdr, gb['motion'], carry['taa_history'], carry['taa_valid'])
        new_carry['taa_valid'] = torch.ones_like(carry['taa_valid'])
    passes.begin('PostProcess')
    if settings.debug_mode != 0:
        # the debug view in place of the lit image (reference package,
        # frame.py:1298-1305); the passes above still run and carry
        extras = dict(motion=gb['motion'], uv=gb['uv'],
                      tex_desired_mip=gb.get('tex_desired_mip'),
                      shadow=shadow_mask, ao=ao, tri_id=tri_id)
        dbg = debug_view(gb, settings.debug_mode, extras={
            k: v for k, v in extras.items() if v is not None})
        image = torch.clamp(dbg * 255.0 + 0.5, 0, 255).to(torch.uint8)
    else:
        image = compose_final(aa, exposure=exposure, bloom=bloom_tex,
                              bloom_strength=settings.bloom_strength)
    passes.end()
    aux['rebuilt'] = rebuilt
    new_carry.host = replace(
        host, frame_index=host.frame_index + 1, version=version,
        built=built, nodes=nodes,
        sun_vp=sm['sun_vp'] if 'sun_vp' in sm else host.sun_vp, **mirror)
    return image, new_carry, aux


def default_frame_inputs(scene_host, view_matrices: dict,
                         sky_turbidity: float = 2.5) -> dict:
    """frame_inputs as host numpy arrays from the host scene and
    View.matrices(); sky_params are this frame's Hosek coefficients
    (evaluated on the host, SkyRenderer.cpp:55-128)."""
    from toyrenderer_tpu_torch.ops.shadowmap import sun_ortho_matrix
    f32 = np.float32
    sun = np.asarray(scene_host.sun_direction, dtype=float)
    out = dict(
        sky_params=np.asarray(sky_mod.hosek_sky_params(sky_turbidity, -sun),
                              f32),
        node_translation=np.asarray(scene_host.node_translation, f32),
        node_rotation=np.asarray(scene_host.node_rotation, f32),
        node_scale=np.asarray(scene_host.node_scale, f32),
        sun_direction=np.asarray(scene_host.sun_direction, f32),
        sun_color=np.asarray(scene_host.sun_color, f32),
        sun_intensity=np.asarray(scene_host.sun_intensity, f32),
        sun_view_proj=sun_ortho_matrix(scene_host.world_aabb,
                                       scene_host.sun_direction),
    )
    for k in ('view_proj', 'view_proj_nojitter', 'prev_view_proj_nojitter',
              'inv_view_proj', 'cam_pos', 'cull_frustum_planes',
              'cull_cam_pos', 'proj_scale_px', 'jitter'):
        out[k] = np.asarray(view_matrices[k], f32)
    return out


# -- packed frame inputs --------------------------------------------------
#
# The per-frame inputs are ~14 small arrays; uploading them one by one
# costs one host-to-device copy each.  pack_frame_inputs lays them into
# ONE f32 vector on the host (the reference's _FI_PACK order, reference
# package frame.py:1416-1485), copies it once, without blocking, from
# pinned memory, and unpack_frame_inputs hands the frame views of it.
# The node TRS arrays (their shape is the scene's) are uploaded once per
# host object: the rest pose once, an animation's fresh arrays each frame.

_FI_PACK = (
    ('sky_params', (10, 3)),
    ('view_proj', (4, 4)),
    ('view_proj_nojitter', (4, 4)),
    ('prev_view_proj_nojitter', (4, 4)),
    ('inv_view_proj', (4, 4)),
    ('cam_pos', (3,)),
    ('cull_frustum_planes', (5, 4)),
    ('cull_cam_pos', (3,)),
    ('proj_scale_px', ()),
    ('jitter', (2,)),
    ('sun_direction', (3,)),
    ('sun_color', (3,)),
    ('sun_intensity', ()),
    ('sun_view_proj', (4, 4)),
)
_FI_NODES = ('node_translation', 'node_rotation', 'node_scale')
_FI_SIZES = [int(np.prod(s)) if s else 1 for _, s in _FI_PACK]
_FI_TOTAL = sum(_FI_SIZES)

_node_dev_cache: dict = {}

# the fields whose host copies decide, on the host, whether the scene or
# the sun moved
_FI_HOST = _FI_NODES + ('sun_view_proj',) + _SUN_KEYS


def host_frame_inputs(fi: dict) -> dict:
    """frame_inputs' 'host' entry: f32 copies of the node TRS arrays, the
    sun's fields and sun_view_proj that `fi` holds on the host (numpy, or
    CPU tensors).  A field on the card has no host copy: the frame then
    counts the scene or the sun as moved."""
    out = {}
    for k in _FI_HOST:
        v = fi.get(k)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            if v.device.type != 'cpu':
                continue
            v = v.detach().numpy()
        out[k] = np.array(v, np.float32)
    return out


def _dev_cached(key: str, v, device):
    """The device tensor of a host array, cached by the array's identity
    (the cache holds the array, so an id cannot be reused while its
    entry lives); tensors pass through, moved to `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    ck = (key, id(v), str(device))
    hit = _node_dev_cache.get(ck)
    if hit is not None and hit[0] is v:
        return hit[1]
    if len(_node_dev_cache) > 64:
        _node_dev_cache.clear()
    t = torch.from_numpy(np.array(v, np.float32)).to(device)
    _node_dev_cache[ck] = (v, t)
    return t


def pack_frame_inputs(fi: dict, device=None) -> dict:
    """Host frame_inputs (numpy, e.g. default_frame_inputs) -> the packed
    set on `device` (default: the CUDA device): 'fi_vec', the small
    fields as one f32 vector copied in one transfer, the node TRS arrays
    through the identity cache, 'host' (host_frame_inputs), and any
    other key (a streaming manager's residency overrides) as it is,
    numpy converted as weights.frame_inputs_from_numpy converts it."""
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy
    dev = resolve_device(device)
    vec = np.empty(_FI_TOTAL, np.float32)
    off = 0
    for (name, _), size in zip(_FI_PACK, _FI_SIZES):
        vec[off:off + size] = np.asarray(fi[name], np.float32).reshape(-1)
        off += size
    host = torch.from_numpy(vec)
    if dev.type == 'cuda':
        # pinned, so the copy runs without blocking the host (the
        # caching host allocator keeps the buffer until it is done)
        host = host.pin_memory()
    out = {'fi_vec': host.to(dev, non_blocking=True)}
    for k in _FI_NODES:
        out[k] = _dev_cached(k, fi[k], dev)
    out['host'] = host_frame_inputs(fi)
    known = {n for n, _ in _FI_PACK} | set(_FI_NODES) | {'host'}
    rest = {k: v for k, v in fi.items() if k not in known}
    out.update({k: v for k, v in rest.items() if isinstance(v, torch.Tensor)})
    out.update(frame_inputs_from_numpy(
        {k: v for k, v in rest.items() if not isinstance(v, torch.Tensor)},
        dev))
    return out


def unpack_frame_inputs(packed: dict) -> dict:
    """The packed set -> frame_inputs: views of 'fi_vec' (no copy), the
    other keys as they are."""
    vec = packed['fi_vec']
    fi = {k: v for k, v in packed.items() if k != 'fi_vec'}
    off = 0
    for (name, shape), size in zip(_FI_PACK, _FI_SIZES):
        v = vec[off:off + size]
        fi[name] = v.view(shape) if shape else v[0]
        off += size
    return fi


def make_render_fn(settings: RenderSettings, device=None,
                   raster_cfg: RasterConfig | None = None,
                   mask_raster_cfg: RasterConfig | None = None,
                   trans_raster_cfg: RasterConfig | None = None):
    """Frame function for `settings` on `device` (default: the CUDA
    device; raises when there is none), with the content-sized
    `raster_cfg` / `mask_raster_cfg` / `trans_raster_cfg` when given
    (see render_frame).  Accepts frame_inputs as host numpy arrays or
    tensors, or packed (pack_frame_inputs: the same frame, bit for bit),
    and passes its keyword arguments (mask_pair_*, trans_pair_*,
    rt_static, rt_pair_*, ddgi_volume, rt_static_gi, gi_pair_*) to
    render_frame; returns render_frame's result."""
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy
    check_settings(settings)
    dev = resolve_device(device)

    def render(scene, pair_inst, pair_meshlet, frame_inputs, carry, **kw):
        if scene.device != dev:
            raise ValueError(f"scene is on {scene.device}, the render "
                             f"function on {dev}")
        if 'fi_vec' in frame_inputs:
            fi = unpack_frame_inputs(frame_inputs)
            if fi['view_proj'].device != dev:
                raise ValueError(f"packed frame inputs on "
                                 f"{fi['view_proj'].device}, the render "
                                 f"function on {dev}")
        else:
            fi = frame_inputs_from_numpy(
                {k: v for k, v in frame_inputs.items() if k != 'host'}, dev)
            fi['host'] = host_frame_inputs(frame_inputs)
        return render_frame(scene, pair_inst, pair_meshlet, fi, carry,
                            settings, raster_cfg=raster_cfg,
                            mask_raster_cfg=mask_raster_cfg,
                            trans_raster_cfg=trans_raster_cfg, **kw)
    return render
