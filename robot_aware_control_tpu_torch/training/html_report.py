"""Static HTML run report: metric charts and the gif/png gallery of a run
directory (counterpart of `robot_aware_control_tpu/training/html_report.py`;
pure Python).

The reference views training through wandb dashboards (src/prediction/
trainer.py:70-84,767) and RoboNet's dominate-based result pages
(robonet/robonet/video_prediction/utils/html.py:1-62). This renders
`<run_dir>/metrics.jsonl` (training/logger.py) and the run's saved media
into one static `report.html`; `RunLogger.close()` builds it, and

    python -m robot_aware_control_tpu_torch.training.html_report <run_dir>

rebuilds it. Charts are single-series SVG polylines with hover points
(<title> tooltips), min/max/last labels and a table view of the raw tail.
"""


from __future__ import annotations

import html as _html
import json
import math
import os
from typing import Dict, List, Sequence, Tuple

# single-series palette (light / dark), validated against the chart
# surfaces; text never wears the series color
_CSS = """
:root {
  --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e;
  --series: #2a78d6; --grid: #e4e3e0;
}
@media (prefers-color-scheme: dark) {
  :root { --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7;
          --series: #3987e5; --grid: #3a3a38; }
}
body { background: var(--surface); color: var(--ink);
       font: 14px/1.45 system-ui, sans-serif; margin: 24px; }
h1, h2 { font-weight: 600; } h1 { font-size: 20px; } h2 { font-size: 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin: 12px 0 20px; }
.tile { border: 1px solid var(--grid); border-radius: 8px;
        padding: 10px 14px; min-width: 130px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .k { color: var(--ink2); font-size: 12px; }
.charts { display: flex; flex-wrap: wrap; gap: 16px; }
.chart { border: 1px solid var(--grid); border-radius: 8px; padding: 8px; }
.chart .k { color: var(--ink2); font-size: 12px; margin: 0 0 4px 2px; }
.chart .last { color: var(--ink); font-weight: 600; }
svg text { fill: var(--ink2); font-size: 10px; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
svg .line { stroke: var(--series); stroke-width: 2; fill: none;
            stroke-linejoin: round; stroke-linecap: round; }
svg .pt { fill: var(--series); opacity: 0; }
svg .pt:hover { opacity: 1; }
.media { display: flex; flex-wrap: wrap; gap: 12px; }
figure { margin: 0; } figcaption { color: var(--ink2); font-size: 12px; }
img { max-width: 320px; image-rendering: pixelated;
      border: 1px solid var(--grid); border-radius: 4px; }
details { margin: 16px 0; } summary { cursor: pointer; color: var(--ink2); }
table { border-collapse: collapse; font-size: 12px; }
td, th { border: 1px solid var(--grid); padding: 2px 8px; text-align: right; }
"""

_MEDIA_EXT = (".gif", ".png", ".jpg", ".jpeg", ".webp", ".mp4")


def parse_metrics(jsonl_path: str) -> Tuple[Dict[str, List[Tuple[float, float]]],
                                            List[Tuple[str, float, str]]]:
    """Split metrics.jsonl into scalar series {key: [(step, value), ...]}
    and media records [(key, step, relative_path), ...]."""
    series: Dict[str, List[Tuple[float, float]]] = {}
    media: List[Tuple[str, float, str]] = []
    if not os.path.isfile(jsonl_path):
        return series, media
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            step = rec.get("step", 0)
            try:
                step = float(step)
            except (TypeError, ValueError):
                step = 0.0
            for k, v in rec.items():
                if k == "step":
                    continue
                if isinstance(v, str):
                    if v.lower().endswith(_MEDIA_EXT):
                        media.append((k, step, v))
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                v = float(v)
                # a diverged run logs NaN/inf (json carries them): one such
                # value would poison the min/max scaling into 'nan' SVG
                # coordinates and blank the whole chart
                if not math.isfinite(v):
                    continue
                series.setdefault(k, []).append((step, v))
    return series, media


def _downsample(pts: Sequence[Tuple[float, float]], n: int = 240):
    if len(pts) <= n:
        return list(pts)
    stride = len(pts) / float(n)
    out = [pts[int(i * stride)] for i in range(n)]
    if out[-1] != pts[-1]:
        out.append(pts[-1])
    return out


def _fmt(v: float) -> str:
    a = abs(v)
    if a != 0 and (a < 1e-3 or a >= 1e5):
        return f"{v:.2e}"
    return f"{v:.4g}"


def svg_line_chart(key: str, pts: Sequence[Tuple[float, float]],
                   w: int = 320, h: int = 110) -> str:
    """One metric as one SVG polyline on a recessive 3-line grid, with an
    invisible hover-point layer carrying <title> tooltips."""
    pts = _downsample(sorted(pts))
    pad_l, pad_r, pad_t, pad_b = 8, 8, 6, 16
    iw, ih = w - pad_l - pad_r, h - pad_t - pad_b
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0

    def sx(x):
        return pad_l + (x - x0) / xr * iw

    def sy(y):
        return pad_t + (1.0 - (y - y0) / yr) * ih

    grid = "".join(
        f'<line class="axis" x1="{pad_l}" x2="{w - pad_r}" '
        f'y1="{pad_t + ih * g:.1f}" y2="{pad_t + ih * g:.1f}"/>'
        for g in (0.0, 0.5, 1.0)
    )
    line = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
    hover = "".join(
        f'<circle class="pt" cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="4">'
        f"<title>step {x:g}: {_fmt(y)}</title></circle>"
        for x, y in pts
    )
    labels = (
        f'<text x="{pad_l}" y="{h - 4}">{_fmt(y0)}</text>'
        f'<text x="{pad_l}" y="{pad_t + 8}">{_fmt(y1)}</text>'
        f'<text x="{w - pad_r}" y="{h - 4}" text-anchor="end">'
        f"step {x1:g}</text>"
    )
    return (f'<svg width="{w}" height="{h}" role="img" '
            f'aria-label="{_html.escape(key)}">'
            f'{grid}<polyline class="line" points="{line}"/>'
            f"{hover}{labels}</svg>")


_HEADLINE = ("eval/autoreg_psnr", "eval/autoreg_ssim", "train/loss",
             "eval/1step_psnr", "transfer/autoreg_psnr",
             "transfer/autoreg_world_loss")


def build_report(run_dir: str, out_name: str = "report.html") -> str:
    """Render `<run_dir>/metrics.jsonl` + saved media into one static HTML
    file; returns the written path."""
    series, media = parse_metrics(os.path.join(run_dir, "metrics.jsonl"))

    # media referenced by the logger, then any gif/png the run saved that
    # the jsonl never mentioned (e.g. plot.py strips written directly)
    seen = set()
    gallery: List[Tuple[str, float, str]] = []
    for key, step, path in media:
        # loggers record absolute paths, run-dir-relative paths, or (when
        # cfg.log_dir is relative) CWD-relative paths like
        # runs/job/eval_5.gif — try each reading before dropping the entry
        if os.path.isabs(path):
            cands = [os.path.relpath(path, run_dir)]
        else:
            cands = [path, os.path.relpath(path, run_dir),
                     os.path.basename(path)]
        rel = next((c for c in cands
                    if os.path.isfile(os.path.join(run_dir, c))), None)
        if rel is not None and rel not in seen:
            seen.add(rel)
            gallery.append((key, step, rel))
    for fn in sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []:
        if fn.lower().endswith(_MEDIA_EXT) and fn not in seen:
            seen.add(fn)
            gallery.append((os.path.splitext(fn)[0], -1, fn))

    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(os.path.basename(run_dir) or run_dir)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{_html.escape(os.path.basename(os.path.abspath(run_dir)))}</h1>",
    ]

    tiles = []
    for k in _HEADLINE:
        if k in series and series[k]:
            tiles.append((k, series[k][-1][1]))
    if tiles:
        parts.append("<div class='tiles'>")
        for k, v in tiles:
            parts.append(f"<div class='tile'><div class='v'>{_fmt(v)}</div>"
                         f"<div class='k'>{_html.escape(k)}</div></div>")
        parts.append("</div>")

    if series:
        parts.append("<h2>Metrics</h2><div class='charts'>")
        for k in sorted(series):
            pts = series[k]
            if len(pts) < 2:
                continue
            parts.append(
                "<div class='chart'><div class='k'>"
                f"{_html.escape(k)} · <span class='last'>"
                f"{_fmt(pts[-1][1])}</span></div>"
                + svg_line_chart(k, pts) + "</div>")
        parts.append("</div>")
        # table view so every number is reachable as text
        parts.append("<details><summary>table view (last 20 rows per "
                     "metric)</summary><table><tr><th>metric</th>"
                     "<th>step</th><th>value</th></tr>")
        for k in sorted(series):
            for step, v in series[k][-20:]:
                parts.append(f"<tr><td>{_html.escape(k)}</td>"
                             f"<td>{step:g}</td><td>{_fmt(v)}</td></tr>")
        parts.append("</table></details>")

    if gallery:
        parts.append("<h2>Media</h2><div class='media'>")
        for key, step, rel in sorted(gallery, key=lambda m: (m[0], m[1])):
            cap = _html.escape(key if step < 0 else f"{key} @ step {step:g}")
            src = _html.escape(rel)
            if rel.lower().endswith(".mp4"):
                parts.append(f"<figure><video src='{src}' controls muted "
                             f"loop></video><figcaption>{cap}"
                             "</figcaption></figure>")
            else:
                parts.append(f"<figure><img src='{src}' alt='{cap}'/>"
                             f"<figcaption>{cap}</figcaption></figure>")
        parts.append("</div>")

    if not series and not gallery:
        parts.append("<p>No metrics.jsonl entries or media found.</p>")
    parts.append("</body></html>")

    out = os.path.join(run_dir, out_name)
    with open(out, "w") as f:
        f.write("\n".join(parts))
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="run log dir containing metrics.jsonl")
    ap.add_argument("--out", default="report.html")
    args = ap.parse_args(argv)
    print(build_report(args.run_dir, args.out))


if __name__ == "__main__":
    main()
