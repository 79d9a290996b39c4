"""Interactive shell: a browser viewer with a live HUD and camera input.

Counterpart of toyrenderer_tpu/tools/shell.py.  The reference renderer
is an interactive windowed program -- WinMain message pump, WASD/mouse
camera, an ImGui HUD with per-renderer ms, FPS and pipeline statistics
(source/Engine.cpp:259-353, Scene.cpp:530-562).  A GPU host without a
display has no swapchain, so the shell is a small HTTP server: the
render loop streams JPEG frames (scene/jpeg_encode.py, quality 88, as
the reference's Pillow encode) to a browser page that sends camera and
input events back and shows the HUD (frame ms, cull/raster counters,
exposure, device memory) beside the image.

Endpoints: `/` the page, `/frame.jpg` the newest frame, `/stats.json`
the HUD's stats, toggles and properties, and `POST /input` a JSON event:
`keys` (held keys: WASD move, QE up/down, arrows look), `look` ([yaw,
pitch] radians), `debug` (a debug view, 0-9), `toggle` (one of shadows
ao gi taa bloom culling autoexposure) or `set` ({property: value}: sun
azimuth and elevation, sun intensity, exposure, forced LOD, shadow
technique).  A toggle or a static property builds the frame's settings,
carry and render function anew before the next frame.

The reference compiles the one-toggle neighbours of the current settings
in the background (its shell.py:293-320), so a toggle pays no compile.
Eager PyTorch compiles nothing per settings (the kernels build once, at
their first launch), so the port has no prewarm.

Usage:
  python -m toyrenderer_tpu_torch.tools.shell --scene resources/cornell.gltf \
      --displayresolution 960x540 --port 8787 [--device cpu]
then open http://localhost:8787/ (--port 0 takes a free port, printed
in the `[shell] serving` line).  `--max-frames N` stops after N frames.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>toyrenderer_tpu_torch shell</title><style>
 body { margin:0; background:#14151a; color:#d8dbe2;
        font:13px/1.45 system-ui, sans-serif; display:flex; }
 #view { flex:1; display:flex; align-items:center; justify-content:center; }
 #frame { max-width:100%; image-rendering:pixelated; outline:none; }
 #hud  { width:300px; padding:14px 16px; background:#1b1d24;
         border-left:1px solid #2a2d36; overflow-y:auto; }
 h1 { font-size:14px; margin:0 0 10px; color:#fff; }
 table { border-collapse:collapse; width:100%; margin-bottom:12px; }
 td { padding:1px 4px; border-bottom:1px solid #262933; }
 td.v { text-align:right; font-variant-numeric:tabular-nums; }
 .k { color:#8a8fa3; }
 button { background:#2a2d36; color:#d8dbe2; border:1px solid #3a3e4a;
          border-radius:4px; margin:2px; padding:3px 8px; cursor:pointer; }
 button.on { background:#3d5afe33; border-color:#3d5afe; }
 #help { color:#666c7e; font-size:11px; margin-top:10px; }
</style></head><body>
<div id=view><img id=frame tabindex=0></div>
<div id=hud><h1>toyrenderer_tpu_torch</h1>
 <table id=stats></table>
 <div id=toggles></div>
 <div id=props></div>
 <div id=help>WASD move &middot; QE up/down &middot; drag or arrows look
 &middot; 0&ndash;9 debug view &middot; toggles rebuild the frame's
 settings</div>
</div>
<script>
const img = document.getElementById('frame');
let seq = 0;
function tick() {
  img.src = '/frame.jpg?x=' + (seq++);
}
img.onload = () => setTimeout(tick, 16);
img.onerror = () => setTimeout(tick, 250);
tick();
function send(o) { fetch('/input', {method:'POST', body:JSON.stringify(o)}); }
const held = new Set();
window.addEventListener('keydown', e => {
  if (e.repeat) return;
  if (e.key >= '0' && e.key <= '9') send({debug:+e.key});
  else held.add(e.key.toLowerCase());
});
window.addEventListener('keyup', e => held.delete(e.key.toLowerCase()));
setInterval(() => { if (held.size) send({keys:[...held]}); }, 50);
let drag = null;
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  send({look:[(e.clientX-drag[0])*0.004, (e.clientY-drag[1])*0.004]});
  drag = [e.clientX, e.clientY];
});
const TOGGLES = ['shadows','ao','gi','taa','bloom','culling','autoexposure'];
let propsInit = false;
async function hud() {
  try {
    const s = await (await fetch('/stats.json')).json();
    const rows = Object.entries(s.stats).map(
      ([k,v]) => `<tr><td class=k>${k}</td><td class=v>${v}</td></tr>`);
    document.getElementById('stats').innerHTML = rows.join('');
    document.getElementById('toggles').innerHTML = TOGGLES.map(t =>
      `<button class="${s.toggles[t]?'on':''}"
        onclick='send({toggle:"${t}"})'>${t}</button>`).join('');
    if (!propsInit) {      // property grid (Scene.cpp:528-660 parity)
      propsInit = true;
      const P = s.props;
      document.getElementById('props').innerHTML = `
       <table>
        <tr><td class=k>sun azim</td><td><input type=range min=-3.14
         max=3.14 step=0.02 value=${P.sun_az} id=p_sun_az></td></tr>
        <tr><td class=k>sun elev</td><td><input type=range min=0.05
         max=1.5 step=0.02 value=${P.sun_el} id=p_sun_el></td></tr>
        <tr><td class=k>sun inten</td><td><input type=range min=0 max=20
         step=0.25 value=${P.sun_intensity} id=p_sun_intensity></td></tr>
        <tr><td class=k>exposure</td><td><input type=range min=-10 max=2
         step=0.1 value=${Math.log2(P.exposure)} id=p_exposure></td></tr>
        <tr><td class=k>forced lod</td><td><select id=p_forced_lod>
         ${[-1,0,1,2,3].map(v=>`<option ${v==P.forced_lod?'selected':''}
          value=${v}>${v<0?'auto':v}</option>`).join('')}
        </select></td></tr>
        <tr><td class=k>shadow tech</td><td><select id=p_shadowtech>
         ${['map','rt'].map(v=>`<option ${v==P.shadowtech?'selected':''}
          value=${v}>${v}</option>`).join('')}
        </select></td></tr>
       </table>`;
      for (const id of ['sun_az','sun_el','sun_intensity','exposure',
                        'forced_lod','shadowtech']) {
        document.getElementById('p_'+id).addEventListener('change', e => {
          let v = e.target.value;
          if (id == 'exposure') v = Math.pow(2, +v);
          send({set:{[id]: id=='shadowtech' ? v : +v}});
        });
      }
    }
  } catch (e) {}
  setTimeout(hud, 500);
}
hud();
</script></body></html>"""


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.jpeg = b""
        self.stats = {}
        self.toggles = {}
        self.props = {}
        self.inputs = []          # pending input events


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                with state.lock:
                    body = state.jpeg
                if not body:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/jpeg", body)
            elif self.path.startswith("/stats.json"):
                with state.lock:
                    body = json.dumps(dict(stats=state.stats,
                                           toggles=state.toggles,
                                           props=state.props))
                self._send(200, "application/json", body.encode())
            else:
                self._send(200, "text/html", _PAGE.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                ev = {}
            with state.lock:
                state.inputs.append(ev)
            self._send(200, "text/plain", b"ok")
    return Handler


TOGGLES = ('shadows', 'ao', 'gi', 'taa', 'bloom', 'culling', 'autoexposure')


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="resources/cornell.gltf")
    p.add_argument("--displayresolution", default="960x540")
    p.add_argument("--port", type=int, default=8787,
                   help="HTTP port (0: a free one)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--exposure", type=float, default=0.01)
    p.add_argument("--speed", type=float, default=None,
                   help="camera move speed (units/s); default scene-sized")
    p.add_argument("--max-frames", type=int, default=0,
                   help="exit after N frames (0 = run until killed)")
    return p.parse_args(argv)


def _memory_stats(dev) -> dict:
    """The HUD's device memory rows (the reference HUD's VRAM row,
    Engine.cpp:414-423): allocated and peak, MB; none on the CPU."""
    if dev.type != 'cuda':
        return {}
    return {'mem allocated': f"{torch.cuda.memory_allocated(dev) / 2**20:.0f} MB",
            'mem peak': f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MB"}


def main(argv=None, on_ready=None, on_frame=None) -> int:
    """Serve the viewer and render until --max-frames (or forever).
    on_ready(port), when given, runs once the server listens, before the
    first frame; on_frame(n, image), after frame n (1-based) is
    published, with that frame's (H, W, 3) u8 image; both on the render
    loop's thread, which waits for them (the server keeps answering
    meanwhile)."""
    args = _parse(argv)
    from toyrenderer_tpu_torch.device import resolve_device
    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs, init_carry,
        make_render_fn)
    from toyrenderer_tpu_torch.ops.ddgi import volume_from_aabb
    from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
    from toyrenderer_tpu_torch.ops.shadowmap import sun_ortho_matrix
    from toyrenderer_tpu_torch.ops.sky import hosek_sky_params
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.scene.jpeg_encode import encode_jpeg

    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.displayresolution.split("x"))
    scene_host = load_scene(args.scene)
    scene = scene_host.to_device(dev)
    pi_np, pm_np = static_meshlet_pairs(scene_host)
    pi, pm = (torch.from_numpy(a).to(dev) for a in (pi_np, pm_np))
    ext = float(np.linalg.norm(np.asarray(scene_host.world_aabb[1])
                               - np.asarray(scene_host.world_aabb[0])))
    speed = args.speed if args.speed else max(ext * 0.25, 1e-3)

    view = View.from_scene(scene_host, w, h)
    toggles = {k: False for k in TOGGLES}
    debug = [0]
    # the property grid (Scene.cpp:528-660): the sun and exposure are
    # frame inputs, forced LOD and the shadow technique settings
    sd = np.asarray(scene_host.sun_direction, dtype=float)
    props = dict(
        sun_az=float(np.arctan2(sd[0], sd[2])),
        sun_el=float(np.arcsin(np.clip(-sd[1], -1, 1))),
        sun_intensity=float(scene_host.sun_intensity),
        exposure=float(args.exposure), forced_lod=-1, shadowtech='map')

    def sun_dir():
        ce = np.cos(props['sun_el'])
        return np.asarray([np.sin(props['sun_az']) * ce,
                           -np.sin(props['sun_el']),
                           np.cos(props['sun_az']) * ce], np.float32)

    def make_settings():
        return RenderSettings(
            width=w, height=h, manual_exposure=props['exposure'],
            debug_mode=debug[0], enable_shadows=toggles['shadows'],
            shadow_technique=props['shadowtech'], enable_ao=toggles['ao'],
            enable_gi=toggles['gi'], enable_taa=toggles['taa'],
            enable_bloom=toggles['bloom'],
            enable_culling=toggles['culling'],
            enable_auto_exposure=toggles['autoexposure'],
            forced_lod=props['forced_lod'])

    ddgi_volume = volume_from_aabb(scene_host.world_aabb[0],
                                   scene_host.world_aabb[1])
    rt_box = {}

    def frame_kw(settings) -> dict:
        """render's keywords: the RT topology (built once, at the first
        frame that traces) and the probe volume, when the settings use
        them.  The shell draws every pair ('all'), so masked pairs are
        already in the RT list."""
        kw = {}
        if settings.enable_gi or (settings.enable_shadows
                                  and settings.shadow_technique == 'rt'):
            if 'rts' not in rt_box:
                from toyrenderer_tpu_torch.ops.bvh_sah import (
                    build_rt_static_auto)
                rt_box['rts'] = build_rt_static_auto(scene_host, pi_np,
                                                     pm_np, device=dev)
            kw['rt_static'] = rt_box['rts']
        if settings.enable_gi:
            kw['ddgi_volume'] = ddgi_volume
        return kw

    def rebuild():
        s = make_settings()
        return (s, init_carry(scene, s, ddgi_volume if s.enable_gi else None),
                make_render_fn(s, device=dev))

    state = _State()
    state.toggles = dict(toggles)
    state.props = dict(props)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 _make_handler(state))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"[shell] serving http://localhost:{port}/  ({w}x{h}, scene "
          f"extent {ext:.1f}, {dev})", flush=True)
    try:
        if on_ready is not None:
            on_ready(port)
        settings, carry, render = rebuild()
        ema_ms = None
        frames = 0
        last_t = time.time()
        while True:
            # -- input events ---------------------------------------------
            with state.lock:
                events, state.inputs = state.inputs, []
            dt = min(time.time() - last_t, 0.25)
            last_t = time.time()
            changed = False
            for ev in events:
                if 'keys' in ev:
                    k = set(ev['keys'])
                    step = speed * max(dt, 0.05)
                    view.move(forward=step * (('w' in k) - ('s' in k)),
                              right=step * (('d' in k) - ('a' in k)),
                              up=step * (('e' in k) - ('q' in k)))
                    look = 1.5 * max(dt, 0.05)
                    yaw = look * (('arrowright' in k) - ('arrowleft' in k))
                    pit = look * (('arrowdown' in k) - ('arrowup' in k))
                    if yaw or pit:
                        view.rotate_yaw_pitch(yaw, pit)
                if 'look' in ev:
                    view.rotate_yaw_pitch(float(ev['look'][0]),
                                          float(ev['look'][1]))
                if 'debug' in ev:
                    debug[0] = int(ev['debug'])
                    changed = True
                if ev.get('toggle') in toggles:
                    toggles[ev['toggle']] = not toggles[ev['toggle']]
                    changed = True
                for k, v in (ev.get('set') or {}).items():
                    if k not in props:
                        continue
                    props[k] = (v if isinstance(props[k], str)
                                else int(v) if k == 'forced_lod'
                                else float(v))
                    if k in ('forced_lod', 'shadowtech'):
                        changed = True
                    elif k == 'exposure':
                        carry['exposure'] = torch.tensor(
                            props['exposure'], dtype=torch.float32,
                            device=dev)
            if changed:
                settings, carry, render = rebuild()
            with state.lock:
                state.toggles = dict(toggles)
                state.props = dict(props)

            # -- one frame ------------------------------------------------
            mats = view.matrices()
            fi = default_frame_inputs(scene_host, mats)
            if abs(props['sun_az']) > 1e-6 or props['sun_el'] != 0.0:
                sdir = sun_dir()
                fi['sun_direction'] = sdir
                fi['sun_intensity'] = np.asarray(props['sun_intensity'],
                                                 np.float32)
                fi['sun_view_proj'] = np.asarray(sun_ortho_matrix(
                    scene_host.world_aabb, sdir), np.float32)
                fi['sky_params'] = np.asarray(hosek_sky_params(2.5, -sdir),
                                              np.float32)
            t0 = time.time()
            image, carry, aux = render(scene, pi, pm, fi, carry,
                                       **frame_kw(settings))
            image = image.cpu().numpy()            # waits for the frame
            ms = (time.time() - t0) * 1000.0
            view.advance(mats)
            ema_ms = (ms if ema_ms is None or ms > 4 * ema_ms
                      else 0.9 * ema_ms + 0.1 * ms)
            stats = {
                'frame ms': f"{ema_ms:.2f}",
                'fps': f"{1000.0 / max(ema_ms, 1e-3):.1f}",
                'resolution': f"{w}x{h}",
                'device': str(dev),
                'debug view': debug[0],
                'exposure': f"{float(carry['exposure']):.4f}",
                'covered px': int((aux['tri_id'] >= 0).sum()),
                **_memory_stats(dev)}
            for k in ('early_instances', 'late_instances', 'early_pairs',
                      'late_pairs', 'resolved_pixels', 'raster_tris',
                      'raster_binned_pairs', 'early_raster_binned_pairs',
                      'late_raster_binned_pairs'):
                if k in aux:
                    stats[k.replace('_', ' ')] = int(aux[k])
            jpeg = encode_jpeg(image, quality=88)
            with state.lock:
                state.jpeg = jpeg
                state.stats = stats
            frames += 1
            if on_frame is not None:
                on_frame(frames, image)
            if args.max_frames and frames >= args.max_frames:
                break
    finally:
        server.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
