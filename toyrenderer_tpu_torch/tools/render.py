"""Headless renderer CLI: load a glTF scene, render N frames, write a PNG.

Counterpart of toyrenderer_tpu/tools/render.py, with the reference's
flag names for what the port renders.  It runs on the card unless
--device says otherwise (`--device cpu` runs the plain versions).  The
main RT tree is built once at load for shadows, GI or ReSTIR by
`bvh_sah.build_rt_static_auto` (the complete tree, the reference's
default; the SAH tree with TR_RT_SAH=1) and refit when an instance
moved; GI
traces its own LOD-reduced SAH tree (`bvh_sah.build_rt_static_gi`; the
complete tree with TR_GI_SAH=0).  Raster capacities are sized from the
first view's content (engine/capacity.py).  `--vtstream mip|tile`
streams the atlas through engine/streaming.py's managers (pool budget
`--vtpool`); `--scene stress` renders the procedural textured scene.
`--transparency` draws the blend set (`--oitlayers` depth-peeled
layers) and splits it from the opaque set, `--restir` adds ReSTIR DI,
`--debugview N` writes debug view N, `--showprobes` the probe overlay
(with `--gi`), `--animate` plays the scene's glTF animation at 60 fps
steps, `--orbit R` turns the camera R radians a frame, `--aniso N`
samples N anisotropic taps, `--forcedlod L` draws every instance at LOD
L, `--customscenescale S` scales the scene at load.  Each frame's inputs
go to the device in one copy (engine/frame.pack_frame_inputs); the carry
holds the frame's caches (the refit trees, the GI shade records, the sun
map).  `--passtable` renders one more frame under the profiler and
prints its per-pass device-ms table (tools/passes.py).

Usage:
  python -m toyrenderer_tpu_torch.tools.render \\
      --scene resources/courtyard.glb --displayresolution 1920x1080 \\
      --culling --shadows --shadowtechnique map --output out.png
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scene", default="resources/cornell.gltf",
                   help="a glTF file, or 'stress' for the procedural "
                        "textured stress scene")
    p.add_argument("--displayresolution", default="1280x720",
                   help="WxH render resolution")
    p.add_argument("--customscenescale", type=float, default=1.0,
                   help="scale the scene by this factor at load")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--output", default=str(Path(tempfile.gettempdir())
                                           / "toyrenderer_out.png"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--nocache", action="store_true",
                   help="bypass the scene build cache")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--bloom", action="store_true")
    p.add_argument("--autoexposure", action="store_true")
    p.add_argument("--taa", action="store_true")
    p.add_argument("--culling", action="store_true",
                   help="2-phase GPU-driven occlusion culling + LOD")
    p.add_argument("--shadows", action="store_true",
                   help="denoised sun shadows")
    p.add_argument("--shadowtechnique", choices=("map", "rt"), default="rt",
                   help="sun shadows: BVH rays (rt) | raster sun map (map)")
    p.add_argument("--ao", action="store_true", help="GTAO")
    p.add_argument("--gi", action="store_true", help="DDGI probe GI")
    p.add_argument("--giraysperprobe", type=int, default=64)
    p.add_argument("--bruteforceraster", action="store_true",
                   help="every triangle at every pixel (the oracle)")
    p.add_argument("--stats", default=None,
                   help="write per-frame stats JSON to this path")
    p.add_argument("--vtstream", choices=("off", "mip", "tile"),
                   default="off",
                   help="virtual-texture streaming: per-mip residency "
                        "or 64x64-texel tiles with spatial feedback")
    p.add_argument("--vtpool", type=int, default=64,
                   help="tile-pool budget (tiles) / mip-pool budget "
                        "(x64K texel rows) for --vtstream")
    p.add_argument("--debugview", type=int, default=0,
                   help="0=lit, 1=albedo, 2=normal, 6=depth, 11=meshlet, "
                        "... 14=texture mip (ops/lighting.DEBUG_*)")
    p.add_argument("--showprobes", action="store_true",
                   help="GI probe visualization overlay (with --gi)")
    p.add_argument("--restir", action="store_true", help="ReSTIR DI")
    p.add_argument("--transparency", action="store_true",
                   help="the blend set, depth-peeled and composited")
    p.add_argument("--oitlayers", type=int, default=1,
                   help="depth-peeled OIT layers of the blend set")
    p.add_argument("--animate", action="store_true",
                   help="play the scene's animations at 60 fps frame steps")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="turn the camera by this many radians a frame")
    p.add_argument("--aniso", type=int, default=1,
                   help="anisotropic filtering taps (1 = off; >1 uses "
                        "the per-pixel sampler instead of quad taps)")
    p.add_argument("--forcedlod", type=int, default=-1,
                   help="draw every instance at this LOD (-1: by screen "
                        "error)")
    p.add_argument("--passtable", action="store_true",
                   help="print the per-pass device-ms table of one more "
                        "frame, rendered under the profiler")
    return p.parse_args(argv)


def build(args, dev, stress=(64, 16), pair_frac=None, settings_kw=None,
          norefit=False, log=print):
    """The frame the CLI's flags ask for, on `dev`: a namespace of the
    host scene (`host`), its device copy (`scene`), the opaque pair list
    (`pairs`), the content-sized settings and raster configs
    (`settings`, `cfg_kw`), render_frame's keyword arguments (`kw`),
    init_carry's (`carry_kw`: the caches' topologies and pair streams),
    the render function (`render`) and the first view (`view`).
    `stress`: the stress scene's objects and sphere resolution;
    `pair_frac`: under --culling, the early pair list's share of LOD0
    (the reference bench's 0.6), else every pair; `settings_kw`: further
    RenderSettings fields; `norefit`: no static RT topology (the frame
    builds its tree every frame)."""
    from types import SimpleNamespace

    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs, make_render_fn)
    from toyrenderer_tpu_torch.engine import capacity
    from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

    w, h = (int(x) for x in args.displayresolution.split("x"))
    t0 = time.time()
    if args.scene == "stress":
        # the procedural textured scene (no assets): texture, VT and
        # culling demos
        from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
        host = make_stress_scene(n_objects=stress[0], sphere_res=stress[1],
                                 textured=True)
    else:
        host = load_scene(args.scene, scale=args.customscenescale,
                          use_cache=not args.nocache)
    log(f"[scene] {args.scene}: {host.num_vertices} verts, "
        f"{host.num_meshlets} meshlets, {host.num_instances} instances "
        f"({time.time() - t0:.2f}s)")
    scene = host.to_device(dev)
    mk_i, mk_m = static_meshlet_pairs(host, 'mask')
    has_mask = len(mk_i) > 0
    # the alpha-mode split of the base pass (reference render.py:114-138)
    if has_mask and args.transparency:
        opaque_filter = 'opaque_strict'     # masked and blend split out
    elif has_mask:
        opaque_filter = 'not_mask'          # masked split out, blend drawn
    elif args.transparency:
        opaque_filter = 'opaque'            # blend split out
    else:
        opaque_filter = 'all'
    pi, pm = static_meshlet_pairs(host, opaque_filter)
    if args.culling and pair_frac is not None:
        cap = max(int(len(pi) * pair_frac), 256)
        pi, pm = pi[:cap], pm[:cap]

    def on(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    pair_inst, pair_meshlet = on(pi), on(pm)
    mask_kw = {}
    if has_mask:
        mask_kw = dict(mask_pair_inst=on(mk_i), mask_pair_meshlet=on(mk_m))
        log(f"[alpha-test] {len(mk_i)} masked pairs")
    trans_kw = {}
    if args.transparency:
        ti, tm = static_meshlet_pairs(host, 'blend')
        trans_kw = dict(trans_pair_inst=on(ti), trans_pair_meshlet=on(tm))
        log(f"[transparency] {len(ti)} blend pairs")

    settings = RenderSettings(
        width=w, height=h, debug_mode=args.debugview,
        manual_exposure=args.exposure,
        enable_bloom=args.bloom, enable_auto_exposure=args.autoexposure,
        enable_taa=args.taa, enable_culling=args.culling,
        enable_shadows=args.shadows, shadow_technique=args.shadowtechnique,
        enable_ao=args.ao, enable_gi=args.gi, show_gi_probes=args.showprobes,
        enable_restir=args.restir, enable_transparency=args.transparency,
        oit_layers=args.oitlayers, forced_lod=args.forcedlod,
        texture_aniso=args.aniso,
        use_bruteforce_raster=args.bruteforceraster, **(settings_kw or {}))

    # content-sized raster capacities from the first view
    view = View.from_scene(host, w, h)
    fi0 = frame_inputs_from_numpy(default_frame_inputs(host, view.matrices()),
                                  dev)
    mask_pairs = ((mask_kw['mask_pair_inst'], mask_kw['mask_pair_meshlet'])
                  if has_mask else None)
    blend_pairs = ((trans_kw['trans_pair_inst'],
                    trans_kw['trans_pair_meshlet'])
                   if trans_kw and len(trans_kw['trans_pair_inst']) else None)
    if args.culling:
        counts = capacity.culled_pair_counts(scene, fi0, settings,
                                             len(pi), mask_pairs,
                                             blend_pairs)
        settings = capacity.sized_culled_settings(settings, counts)
    else:
        sets = {"opaque": (pair_inst, pair_meshlet)}
        if has_mask:
            sets["masked"] = mask_pairs
        if blend_pairs is not None:
            sets["blend"] = blend_pairs
        counts = capacity.tile_pair_counts(scene, fi0, settings, sets)
        settings = capacity.sized_settings(settings, counts)
    prefix = {'opaque': '', 'masked': 'mask_', 'blend': 'trans_'}
    cfg_kw = {f"{prefix[k]}raster_cfg":
              capacity.sized_raster_config(settings, {k: v})
              for k, v in counts.items()}
    log(f"[capacity] K={settings.max_tris_per_tile} "
        f"B={settings.max_big_tris} pair_capacity="
        f"{settings.pair_capacity}")

    kw = dict(mask_kw, **trans_kw)
    volume = None
    if args.gi:
        from toyrenderer_tpu_torch.ops.ddgi import volume_from_aabb
        volume = volume_from_aabb(*host.world_aabb,
                                  rays_per_probe=args.giraysperprobe)
        kw['ddgi_volume'] = volume
        log(f"[gi] probe grid {volume.counts}, {volume.num_probes} probes "
            f"x {volume.rays_per_probe} rays")
    if (args.gi or args.shadows or args.restir) and not norefit:
        # built for 'map' shadows too: the sun map draws the masked set
        # through the tree's coverage keep
        from toyrenderer_tpu_torch.ops.bvh_sah import (
            RtStaticSah, build_rt_static_auto)
        t0 = time.time()
        kw['rt_static'] = build_rt_static_auto(
            host, pi, pm, mask_pair_inst=mk_i if has_mask else None,
            mask_pair_meshlet=mk_m if has_mask else None, device=dev)
        kind = ('sah' if isinstance(kw['rt_static'], RtStaticSah)
                else 'complete')
        log(f"[rt] static topology ({kind}): "
            f"{kw['rt_static'].payload.shape[0]} tri slots "
            f"({time.time() - t0:.2f}s)")
    if args.gi and 'rt_static' in kw:
        from toyrenderer_tpu_torch.ops.bvh_sah import (
            build_rt_static_gi, gi_sah_wanted)
        t0 = time.time()
        gi_sah = gi_sah_wanted()
        gi_static, g_pi, g_pm, gi_lod = build_rt_static_gi(
            host, opaque_filter,
            mask_pair_inst=mk_i if has_mask else None,
            mask_pair_meshlet=mk_m if has_mask else None, sah=gi_sah,
            device=dev)
        kw.update(rt_static_gi=gi_static, gi_pair_inst=g_pi,
                  gi_pair_meshlet=g_pm)
        log(f"[rt] GI topology ({'sah' if gi_sah else 'complete'}, "
            f"LOD{gi_lod}): "
            f"{gi_static.payload.shape[0]} tri slots "
            f"({time.time() - t0:.2f}s)")
    # init_carry's caches: the topologies and the pair streams the frame
    # gets
    carry_kw = {k: v for k, v in kw.items()
                if k in ('rt_static', 'rt_static_gi', 'gi_pair_inst',
                         'gi_pair_meshlet', 'mask_pair_inst',
                         'mask_pair_meshlet')}
    carry_kw.update(pair_inst=pair_inst, pair_meshlet=pair_meshlet)
    return SimpleNamespace(
        host=host, scene=scene, pairs=(pair_inst, pair_meshlet),
        settings=settings, cfg_kw=cfg_kw, kw=kw, carry_kw=carry_kw,
        volume=volume, view=view,
        render=make_render_fn(settings, dev, **cfg_kw))


def main(argv=None) -> int:
    """Parse argv, render, write the PNG (and the stats JSON; with
    --passtable the pass table of one more frame); returns 0."""
    from toyrenderer_tpu_torch.device import resolve_device
    from toyrenderer_tpu_torch.engine import (
        default_frame_inputs, init_carry, pack_frame_inputs)
    from toyrenderer_tpu_torch.scene.png import encode_png

    args = parse_args(argv)
    dev = resolve_device(args.device)
    f = build(args, dev)
    host, scene, view, render, kw = f.host, f.scene, f.view, f.render, f.kw
    pair_inst, pair_meshlet = f.pairs
    w, h = f.settings.width, f.settings.height
    carry = init_carry(scene, f.settings, f.volume, **f.carry_kw)

    # virtual-texture streaming: the residency overrides ride
    # frame_inputs from frame 0, and each frame's feedback drives the
    # next update (TextureFeedbackManager.cpp loop)
    stream_mgr = None
    overrides = {}
    if args.vtstream != "off" and host.num_textures > 0:
        from toyrenderer_tpu_torch.engine import streaming
        atlas = streaming.scene_atlas(host)
        if args.vtstream == "mip":
            stream_mgr = streaming.TextureStreamingManager(
                atlas, pool_texels=args.vtpool << 16, device=dev)
            overrides = stream_mgr.update(np.full(host.num_textures, np.inf))
        else:
            stream_mgr = streaming.TileStreamingManager(
                atlas, pool_tiles=args.vtpool, device=dev)
            overrides = stream_mgr.update(
                np.full(stream_mgr.table_size, np.inf))
        print(f"[vt] {args.vtstream}-granularity streaming, pool budget "
              f"{args.vtpool}")
    player = None
    if args.animate:
        from toyrenderer_tpu_torch.scene.animation import AnimationPlayer
        player = AnimationPlayer(host.animation_data())
        print(f"[anim] {player.data.num_channels} channels, "
              f"{player.data.duration:.2f}s")
    fb_key = 'vt_tile_feedback' if args.vtstream == 'tile' else 'tex_feedback'

    def frame_inputs(i, mats):
        fi = default_frame_inputs(host, mats)
        if player is not None and player.enabled:
            t, r, s = player.evaluate(i / 60.0, host.node_translation,
                                      host.node_rotation, host.node_scale)
            fi.update(node_translation=np.asarray(t, np.float32),
                      node_rotation=np.asarray(r, np.float32),
                      node_scale=np.asarray(s, np.float32))
        fi = pack_frame_inputs(fi, dev)
        fi.update(overrides)
        return fi

    rows = []
    for i in range(args.frames):
        mats = view.matrices()
        fi = frame_inputs(i, mats)
        t0 = time.time()
        image, carry, aux = render(scene, pair_inst, pair_meshlet, fi, carry,
                                   **kw)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        dt = (time.time() - t0) * 1000
        view.advance(mats)
        if args.orbit:
            view.rotate_yaw_pitch(args.orbit, 0.0)
        label = "build+run" if i == 0 else "frame"
        print(f"[frame {i}] {label}: {dt:.2f} ms")
        if stream_mgr is not None:
            t0 = time.time()
            overrides = stream_mgr.update(aux[fb_key])
            print(f"[vt] update {(time.time() - t0) * 1000:.2f} ms, "
                  f"{stream_mgr.last_upload_bytes} B uploaded, "
                  f"{stream_mgr.stats}")
        if args.stats:
            rec = dict(frame=i, ms=round(dt, 3),
                       coverage=round(float((aux['tri_id'] >= 0).float()
                                            .mean()), 4),
                       exposure=float(carry['exposure']))
            if dev.type == 'cuda':
                rec['hbm_mb'] = round(torch.cuda.memory_allocated(dev)
                                      / 2 ** 20)
                rec['hbm_peak_mb'] = round(
                    torch.cuda.max_memory_allocated(dev) / 2 ** 20)
            for k in ('early_instances', 'late_instances',
                      'early_meshlets', 'late_meshlets'):
                if k in aux:
                    rec[k] = int(aux[k])
            rows.append(rec)

    img = image.cpu().numpy()
    Path(args.output).write_bytes(encode_png(img))
    print(f"[out] wrote {args.output} ({img.shape[1]}x{img.shape[0]})")
    npx = int((aux['tri_id'] >= 0).sum())
    print(f"[stats] covered pixels: {npx}/{w * h} "
          f"({100.0 * npx / (w * h):.1f}%)")
    if args.stats:
        Path(args.stats).write_text(json.dumps(rows, indent=1))
        print(f"[stats] wrote {args.stats}")
    if args.passtable:
        # the per-pass device-ms table (the reference's per-renderer HUD
        # table, Scene.cpp:530-562): one more frame under the profiler
        from toyrenderer_tpu_torch.tools import passes
        mats = view.matrices()
        fi = frame_inputs(args.frames, mats)
        table, (_, carry, _) = passes.profile(
            lambda: render(scene, pair_inst, pair_meshlet, fi, carry, **kw),
            dev)
        for line in passes.table_lines(table):
            print(f"[passes] {line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
