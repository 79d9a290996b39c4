"""The per-pass table (tools/passes.py), its per-pass operators
(tools/profile_frame.py) and the stage timer (tools/profile_stages.py) on
the CPU profiler, where the host's outermost operators stand for the
device's kernels.

Cornell at 96x64 with RT shadows, 1 warm-up and 2 profiled frames: the
table names the frame's passes (engine/frame.PASS_LABELS, every range it
opens for those settings) and nothing else; the passes and the
unattributed ms sum to the busy union (the outermost operators of one
thread do not overlap) within 2%, at most 1% of it unattributed, and
that union is no longer than the frames themselves.  With --full the
GI, AO and post passes appear too.
"""

import json

import pytest

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine.frame import PASS_LABELS
from toyrenderer_tpu_torch.tools import passes, profile_frame, profile_stages

SHADOWED = {'UpdateInstanceConsts', 'BasePass(fill+resolve)',
            'GBufferResolve', 'ShadowMask', 'Denoise', 'DeferredLighting',
            'PostProcess'}
FULL = SHADOWED | {'GI(DDGI)', 'AmbientOcclusion', 'Bloom',
                   'AdaptLuminance', 'TAA'}


def _table(flags):
    args = passes.parser("test").parse_args(
        ["--device", "cpu", "--displayresolution", "96x64", "--frames", "2",
         *flags])
    return passes.run(args)


@pytest.mark.parametrize("flags,want", [(["--shadows"], SHADOWED),
                                        (["--full"], FULL)])
def test_pass_table_names_the_frames_passes(flags, want):
    table = _table(flags)
    names = set(table['passes'])
    assert want <= names <= set(PASS_LABELS) | {passes.GLUE}
    # the profiled frames are still: the cached RT tree is not refit
    assert 'RT(BVH build)' not in names
    total = table['attributed_ms'] + table['unattributed_ms']
    assert abs(total - table['busy_ms']) <= 0.02 * table['busy_ms']
    assert table['unattributed_ms'] <= 0.01 * table['busy_ms']
    assert 0 < table['busy_ms'] <= table['frame_ms']
    assert all(v >= 0 for v in table['passes'].values())
    lines = passes.table_lines(table, detail=['ShadowMask'])
    assert lines[0].split()[0] == 'pass'
    assert any(ln.startswith('busy (union)') for ln in lines)
    assert '[detail ShadowMask]' in lines
    json.dumps(table)


def test_profile_frame_lists_each_pass_top_operators(capsys):
    assert profile_frame.main(["--device", "cpu", "--displayresolution",
                               "96x64", "--frames", "1", "--top", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    heads = [ln for ln in out if ln.startswith("== ")]
    assert any("BasePass(fill+resolve)" in h for h in heads)
    # at most --top operator lines under each pass
    runs, n = [], 0
    for ln in out:
        if ln.startswith("== "):
            runs.append(n)
            n = 0
        elif ln.startswith("   "):
            n += 1
    assert max(runs[1:] + [n]) <= 2


def test_profile_stages_runs_each_stage():
    rows = profile_stages.run(["--device", "cpu", "--objects", "4",
                               "--width", "128", "--height", "64",
                               "--reps", "1"])
    assert [r[0] for r in rows] == [
        "node_world_matrices", "instance_transforms", "meshlet_clip",
        "setup_triangles", "bin_triangles", "fill_visibility",
        "pack_resolve_records", "resolve_gbuffer", "deferred_lighting+sky",
        "postprocess"]
    assert all(ms >= 0 for _, ms, _ in rows)
    assert rows[5][2].startswith("coverage=")
