"""The per-pass device-ms table of profiled frames.

Counterpart of toyrenderer_tpu/tools/passes.py (the reference's HUD
table, source/Scene.cpp:530-562).  render_frame opens one profiler range
per pass (engine/frame.PASS_LABELS, the reference's pass labels); here
the frames run under torch.profiler, and each device kernel, copy and
memset of the trace goes to the range that was open on the host when it
was launched: its correlation id names its launch call, whose host
timestamp lies in the innermost open range.  Work launched inside the
frame but outside every pass range counts as 'FrameGlue'; work whose
launch the trace did not keep, or that ran outside the frame, as
unattributed.  On the CPU (`--device cpu`) the "device" is the host: the
outermost operators of the trace stand for the kernels.

For each pass: its busy ms per frame and its share of the busy union.
Then the unattributed ms, the busy union of all device work, the
frame's ms by CUDA events around the same frames (the host's clock on
the CPU), and how many of the kernels launched the trace kept (traces
drop some: PERF.md section 7).  PASSES_DETAIL='GI(DDGI),ReSTIR' prints
the top operators of those passes.

Usage (card; add --device cpu for the plain versions):
  python -m toyrenderer_tpu_torch.tools.passes --scene resources/cornell.gltf \\
      --displayresolution 448x256 --frames 4 [--shadows|--full] [--json out.json]
  python -m toyrenderer_tpu_torch.tools.passes --stress \\
      --displayresolution 1920x1080 --full
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time
from pathlib import Path

import torch

FRAME_RANGE = 'Frame'
GLUE = 'FrameGlue'
UNATTRIBUTED = '(unattributed)'
# trace categories: device work, and the host calls that launch it
_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')
_LAUNCH = ('cuda_runtime', 'cuda_driver')


def trace(fn, device, frames: int = 1):
    """fn() called `frames` times under torch.profiler, inside a
    FRAME_RANGE range: (the last result, the trace's events, the frames'
    ms by CUDA events around the same calls -- on the CPU by the host's
    clock).  Every call is one frame."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(frames):
            with record_function(FRAME_RANGE):
                out = fn()
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    ms = start.elapsed_time(end) if cuda else wall
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())['traceEvents']
    return out, events, ms


def _innermost(ranges, t):
    """The label of the innermost range of `ranges` ((start, end, label),
    on one host thread) that holds time t, or None."""
    best = None
    for s, e, lab in ranges:
        if s <= t <= e and (best is None or s > best[0]
                            or (s == best[0] and e < best[1])):
            best = (s, e, lab)
    return None if best is None else best[2]


def _union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (ts in us)."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def _top_level(ops):
    """The operators of one host thread that no other one holds."""
    out, end = [], None
    for e in sorted(ops, key=lambda e: (e['ts'], -e['dur'])):
        if end is None or e['ts'] >= end:
            out.append(e)
            end = e['ts'] + e['dur']
    return out


def attribute(events, cuda: bool):
    """Each piece of device work of a trace with its pass: a list of
    (label, name, start us, duration us), and the counts (kernel events,
    kernel launch calls) of the trace."""
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation':
            ranges[(e['pid'], e['tid'])].append(
                (e['ts'], e['ts'] + e['dur'], e['name']))

    def label(key, t):
        lab = _innermost(ranges.get(key, ()), t)
        if lab is None:
            return UNATTRIBUTED
        return GLUE if lab == FRAME_RANGE else lab

    out = []
    if cuda:
        launch_at = {}
        n_launch = 0
        for e in events:
            if e.get('ph') == 'X' and e.get('cat') in _LAUNCH:
                c = (e.get('args') or {}).get('correlation')
                if c is not None:
                    launch_at[c] = ((e['pid'], e['tid']), e['ts'])
                if 'LaunchKernel' in e['name'] or 'LaunchCooperative' in \
                        e['name']:
                    n_launch += 1
        n_kernel = 0
        for e in events:
            if e.get('ph') != 'X' or e.get('cat') not in _WORK:
                continue
            n_kernel += e['cat'] == 'kernel'
            at = launch_at.get((e.get('args') or {}).get('correlation'))
            lab = UNATTRIBUTED if at is None else label(*at)
            out.append((lab, e['name'], e['ts'], e['dur']))
        return out, n_kernel, n_launch
    ops = collections.defaultdict(list)
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'cpu_op':
            ops[(e['pid'], e['tid'])].append(e)
    for key, lst in ops.items():
        for e in _top_level(lst):
            out.append((label(key, e['ts']), e['name'], e['ts'], e['dur']))
    return out, len(out), len(out)


def aggregate(events, cuda: bool, frames: int, frame_ms: float) -> dict:
    """The table of a trace of `frames` frames (ms per frame): 'passes'
    {label: busy ms}, 'ops' {label: {operator or kernel name: ms}},
    'unattributed_ms', 'attributed_ms', 'busy_ms' (the union of the
    device work's intervals), 'frame_ms', 'kernel_events' and
    'kernel_launches' (the trace's kernels against its launch calls)."""
    work, n_kernel, n_launch = attribute(events, cuda)
    per = collections.defaultdict(float)
    ops = collections.defaultdict(lambda: collections.defaultdict(float))
    for lab, name, _, dur in work:
        per[lab] += dur / 1e3 / frames
        ops[lab][name] += dur / 1e3 / frames
    unattributed = per.pop(UNATTRIBUTED, 0.0)
    return dict(
        device='cuda' if cuda else 'cpu', frames=frames,
        passes=dict(sorted(per.items(), key=lambda kv: -kv[1])),
        ops={lab: dict(sorted(v.items(), key=lambda kv: -kv[1]))
             for lab, v in ops.items()},
        unattributed_ms=unattributed, attributed_ms=sum(per.values()),
        busy_ms=_union_ms((s, s + d) for _, _, s, d in work) / frames,
        frame_ms=frame_ms / frames, kernel_events=n_kernel,
        kernel_launches=n_launch)


def profile(fn, device, frames: int = 1):
    """(the table of `frames` calls of fn() -- each one frame -- under the
    profiler, fn's last result)."""
    out, events, ms = trace(fn, device, frames)
    return aggregate(events, torch.device(device).type == 'cuda', frames,
                     ms), out


def table_lines(table: dict, detail=()) -> list[str]:
    """The table as text: one line per pass (busy ms per frame, share of
    the busy union), the unattributed ms, the busy union, the frame's ms
    and the kernels kept; then the top operators of each pass in
    `detail`."""
    busy = max(table['busy_ms'], 1e-12)
    width = max([len(k) for k in table['passes']] + [24]) + 2
    lines = [f"{'pass':<{width}} {'ms/frame':>10} {'share':>7}"]
    for k, v in table['passes'].items():
        lines.append(f"{k:<{width}} {v:10.3f} {v / busy:7.1%}")
    clock = 'CUDA events' if table['device'] == 'cuda' else 'host clock'
    lines += [
        f"{UNATTRIBUTED:<{width}} {table['unattributed_ms']:10.3f} "
        f"{table['unattributed_ms'] / busy:7.1%}",
        f"{'busy (union)':<{width}} {table['busy_ms']:10.3f}",
        f"{'frame (' + clock + ')':<{width}} {table['frame_ms']:10.3f}",
        (f"kernels in the trace: {table['kernel_events']} of "
         f"{table['kernel_launches']} launched"
         if table['device'] == 'cuda' else
         f"outermost operators in the trace: {table['kernel_events']}")]
    for lab in detail:
        lines.append(f"[detail {lab}]")
        for name, ms in list(table['ops'].get(lab, {}).items())[:14]:
            lines.append(f"   {ms:9.3f}  {name[:100]}")
    return lines


def parser(description: str) -> argparse.ArgumentParser:
    """The flags of passes and profile_frame (the reference's passes
    flags)."""
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scene", default="resources/cornell.gltf")
    p.add_argument("--displayresolution", default="448x256")
    p.add_argument("--frames", type=int, default=4,
                   help="profiled frames, after one warm-up frame")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--json", default=None, help="write the table here")
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--full", action="store_true",
                   help="everything on: shadows + GI + AO + TAA + bloom "
                        "+ auto exposure (GI in 4 interval phases)")
    p.add_argument("--stress", action="store_true",
                   help="the procedural stress scene (192 objects) with "
                        "2-phase culling (ignores --scene)")
    p.add_argument("--culling", action="store_true",
                   help="2-phase culling with the reference bench's 0.6 "
                        "early pair list")
    p.add_argument("--norefit", action="store_true",
                   help="rebuild the RT tree every frame instead of "
                        "refitting the static topology")
    p.add_argument("--peelmerge", type=float, default=0.0,
                   help="peel_merge_frac (0: the dense per-layer masked "
                        "set)")
    return p


def setup(args):
    """(the render CLI's frame for these flags, the device): the stress
    scene and culling with --stress, the all-on settings with --full,
    the carry with its caches."""
    from toyrenderer_tpu_torch.device import resolve_device
    from toyrenderer_tpu_torch.tools import render as cli
    flags = ["--scene", "stress" if args.stress else args.scene,
             "--displayresolution", args.displayresolution,
             "--exposure", "0.1" if args.stress else "0.01"]
    if args.stress or args.culling:
        flags.append("--culling")
    if args.shadows or args.full:
        flags.append("--shadows")
    if args.full:
        flags += ["--gi", "--ao", "--taa", "--bloom", "--autoexposure"]
    dev = resolve_device(args.device)
    f = cli.build(cli.parse_args(flags), dev, stress=(192, 24),
                  pair_frac=0.6 if (args.stress or args.culling) else None,
                  settings_kw=dict(peel_merge_frac=args.peelmerge,
                                   gi_update_phases=4 if args.full else 1),
                  norefit=args.norefit, log=lambda *_: None)
    return f, dev


def run(args):
    """One warm-up frame, then `args.frames` profiled ones with the
    carry threaded: the table."""
    from toyrenderer_tpu_torch.engine import (
        default_frame_inputs, init_carry, pack_frame_inputs)
    f, dev = setup(args)
    carry = init_carry(f.scene, f.settings, f.volume, **f.carry_kw)
    state = dict(carry=carry)

    def frame():
        mats = f.view.matrices()
        fi = pack_frame_inputs(default_frame_inputs(f.host, mats), dev)
        out = f.render(f.scene, *f.pairs, fi, state['carry'], **f.kw)
        state['carry'] = out[1]
        f.view.advance(mats)
        return out
    frame()         # kernels built, caches filled, outside the trace
    table, _ = profile(frame, dev, args.frames)
    return table


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    table = run(args)
    detail = [p for p in os.environ.get('PASSES_DETAIL', '').split(',') if p]
    for line in table_lines(table, detail):
        print(line)
    if args.json:
        Path(args.json).write_text(json.dumps(table, indent=1))
        print(f"[passes] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
