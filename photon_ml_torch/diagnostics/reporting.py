"""Diagnostic report tree and its HTML and text renderers (the port's own
copy).

Counterpart of ``photon_ml_tpu/diagnostics/reporting.py``; reference
photon-diagnostics diagnostics/reporting/ — a logical report tree (chapters
-> sections -> items) rendered to HTML (HTMLRenderStrategy) or plain text;
tables and inline SVG line charts, no external dependencies. The renderers
are the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import html
from typing import Sequence


@dataclasses.dataclass
class Text:
    body: str


@dataclasses.dataclass
class Table:
    headers: Sequence[str]
    rows: Sequence[Sequence[object]]
    caption: str = ""


@dataclasses.dataclass
class LineChart:
    """Simple multi-series line chart rendered as inline SVG."""

    title: str
    x: Sequence[float]
    series: dict[str, Sequence[float]]
    x_label: str = ""
    y_label: str = ""


Item = Text | Table | LineChart


@dataclasses.dataclass
class Section:
    title: str
    items: list[Item] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Chapter:
    title: str
    sections: list[Section] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Report:
    title: str
    chapters: list[Chapter] = dataclasses.field(default_factory=list)


# --- text rendering ---------------------------------------------------------


def render_text(report: Report) -> str:
    out = [report.title, "=" * len(report.title), ""]
    for ci, chapter in enumerate(report.chapters, 1):
        out += [f"{ci}. {chapter.title}", "-" * (len(chapter.title) + 4), ""]
        for si, section in enumerate(chapter.sections, 1):
            out.append(f"{ci}.{si} {section.title}")
            for item in section.items:
                if isinstance(item, Text):
                    out.append("  " + item.body)
                elif isinstance(item, Table):
                    if item.caption:
                        out.append(f"  [{item.caption}]")
                    widths = [
                        max(len(str(h)), *(len(_fmt(r[i])) for r in item.rows))
                        if item.rows
                        else len(str(h))
                        for i, h in enumerate(item.headers)
                    ]
                    out.append(
                        "  " + " | ".join(str(h).ljust(w) for h, w in zip(item.headers, widths))
                    )
                    for row in item.rows:
                        out.append(
                            "  " + " | ".join(_fmt(v).ljust(w) for v, w in zip(row, widths))
                        )
                elif isinstance(item, LineChart):
                    out.append(f"  [chart: {item.title} — series {list(item.series)}]")
            out.append("")
    return "\n".join(out)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


# --- HTML rendering ---------------------------------------------------------

_CSS = """
body { font-family: sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { border-bottom: 1px solid #999; margin-top: 1.5em; }
table { border-collapse: collapse; margin: 0.8em 0; }
th, td { border: 1px solid #bbb; padding: 4px 10px; text-align: right; }
th { background: #eee; }
caption { caption-side: top; font-style: italic; text-align: left; }
svg { background: #fafafa; border: 1px solid #ddd; margin: 0.8em 0; }
"""

_PALETTE = ("#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e")


def _svg_chart(chart: LineChart, width: int = 560, height: int = 320) -> str:
    pad = 48
    xs = list(chart.x)
    all_y = [y for series in chart.series.values() for y in series if y == y]
    if not xs or not all_y:
        return "<p>(empty chart)</p>"
    x_min, x_max = min(xs), max(xs)
    y_min, y_max = min(all_y), max(all_y)
    if x_max == x_min:
        x_max = x_min + 1.0
    if y_max == y_min:
        y_max = y_min + 1.0

    def sx(x):
        return pad + (x - x_min) / (x_max - x_min) * (width - 2 * pad)

    def sy(y):
        return height - pad - (y - y_min) / (y_max - y_min) * (height - 2 * pad)

    parts = [
        f'<svg width="{width}" height="{height}" role="img" aria-label="{html.escape(chart.title)}">',
        f'<text x="{width/2:.0f}" y="18" text-anchor="middle" font-weight="bold">{html.escape(chart.title)}</text>',
        f'<line x1="{pad}" y1="{height-pad}" x2="{width-pad}" y2="{height-pad}" stroke="#333"/>',
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height-pad}" stroke="#333"/>',
        f'<text x="{width/2:.0f}" y="{height-8}" text-anchor="middle" font-size="11">{html.escape(chart.x_label)}</text>',
        f'<text x="14" y="{height/2:.0f}" text-anchor="middle" font-size="11" transform="rotate(-90 14 {height/2:.0f})">{html.escape(chart.y_label)}</text>',
        f'<text x="{pad}" y="{height-pad+14}" font-size="10" text-anchor="middle">{x_min:.3g}</text>',
        f'<text x="{width-pad}" y="{height-pad+14}" font-size="10" text-anchor="middle">{x_max:.3g}</text>',
        f'<text x="{pad-4}" y="{height-pad}" font-size="10" text-anchor="end">{y_min:.3g}</text>',
        f'<text x="{pad-4}" y="{pad+4}" font-size="10" text-anchor="end">{y_max:.3g}</text>',
    ]
    for i, (name, ys) in enumerate(chart.series.items()):
        color = _PALETTE[i % len(_PALETTE)]
        points = " ".join(
            f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys) if y == y
        )
        parts.append(
            f'<polyline fill="none" stroke="{color}" stroke-width="2" points="{points}"/>'
        )
        parts.append(
            f'<text x="{width-pad+6}" y="{pad + 16*i}" font-size="11" fill="{color}">{html.escape(name)}</text>'
        )
    parts.append("</svg>")
    return "".join(parts)


def render_html(report: Report) -> str:
    out = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(report.title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(report.title)}</h1>",
    ]
    for chapter in report.chapters:
        out.append(f"<h2>{html.escape(chapter.title)}</h2>")
        for section in chapter.sections:
            out.append(f"<h3>{html.escape(section.title)}</h3>")
            for item in section.items:
                if isinstance(item, Text):
                    out.append(f"<p>{html.escape(item.body)}</p>")
                elif isinstance(item, Table):
                    out.append("<table>")
                    if item.caption:
                        out.append(f"<caption>{html.escape(item.caption)}</caption>")
                    out.append(
                        "<tr>" + "".join(f"<th>{html.escape(str(h))}</th>" for h in item.headers) + "</tr>"
                    )
                    for row in item.rows:
                        out.append(
                            "<tr>" + "".join(f"<td>{html.escape(_fmt(v))}</td>" for v in row) + "</tr>"
                        )
                    out.append("</table>")
                elif isinstance(item, LineChart):
                    out.append(_svg_chart(item))
    out.append("</body></html>")
    return "".join(out)
