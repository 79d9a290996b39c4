"""The top operators of each pass of profiled frames.

Counterpart of toyrenderer_tpu/tools/profile_frame.py: the frames of
tools/passes.py (the same flags, the same trace and attribution), with
each pass's device time split by kernel or operator name: per pass its
busy ms per frame and share, then its `--top` names by ms.  The
reference buckets XLA ops by the Python source XLA recorded for them;
here each kernel goes to the pass range its launch fell in
(tools/passes.attribute).

Usage (card; add --device cpu for the plain versions):
  python -m toyrenderer_tpu_torch.tools.profile_frame --stress \\
      --displayresolution 1920x1080 --full --top 8
"""

from __future__ import annotations

import json
from pathlib import Path

from toyrenderer_tpu_torch.tools import passes


def top_lines(table: dict, top: int) -> list[str]:
    """Each pass (busy ms per frame, share of the busy union) with its
    `top` names by ms per frame."""
    busy = max(table['busy_ms'], 1e-12)
    lines = []
    order = list(table['passes']) + [passes.UNATTRIBUTED]
    for lab in order:
        ms = (table['passes'].get(lab) if lab != passes.UNATTRIBUTED
              else table['unattributed_ms'])
        if not ms:
            continue
        lines.append(f"== {lab}: {ms:.3f} ms ({ms / busy:.1%})")
        for name, v in list(table['ops'].get(lab, {}).items())[:top]:
            lines.append(f"   {v:9.3f} ms  {name[:100]}")
    lines.append(f"busy (union) {table['busy_ms']:.3f} ms, frame "
                 f"{table['frame_ms']:.3f} ms")
    return lines


def main(argv=None) -> int:
    p = passes.parser(__doc__)
    p.add_argument("--top", type=int, default=8,
                   help="names listed per pass")
    args = p.parse_args(argv)
    table = passes.run(args)
    for line in top_lines(table, args.top):
        print(line)
    if args.json:
        Path(args.json).write_text(json.dumps(table, indent=1))
        print(f"[json] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
