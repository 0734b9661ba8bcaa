"""Declarative UI component library: charts, tables and text as data.

Counterpart of deeplearning4j_tpu/ui/components.py (parity surface: the
reference's deeplearning4j-ui-components ChartLine, ChartScatter,
ChartHistogram, ChartStackedArea, ChartHorizontalBar, ChartTimeline,
ComponentTable, ComponentText and StyleChart). Each component is a small
Python object with a ``to_dict`` / ``to_json`` / ``from_json`` round trip
through the registry and a self-contained ``render_html`` (inline canvas,
no external assets). Host code only: the strings equal the JAX package's.
"""

from __future__ import annotations

import html as _html
import json


def _esc(s):
    return _html.escape(str(s))


def _jsafe(obj):
    """JSON for embedding inside a <script> block ('<' escaped so a
    '</script>' substring in user data cannot terminate the element)."""
    return json.dumps(obj).replace("<", "\\u003c")
from typing import Dict, List, Optional, Sequence

_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


class Style:
    """Common visual options (parity: ui/components/style/StyleChart.java —
    only the fields the renderer uses)."""

    def __init__(self, width: int = 640, height: int = 280,
                 margin: int = 40, series_colors: Optional[List[str]] = None):
        self.width = width
        self.height = height
        self.margin = margin
        self.series_colors = series_colors or [
            "#2a6cc4", "#c44", "#393", "#a63", "#939", "#07a"]

    def to_dict(self):
        return {"width": self.width, "height": self.height,
                "margin": self.margin, "seriesColors": self.series_colors}

    @staticmethod
    def from_dict(d):
        return Style(d.get("width", 640), d.get("height", 280),
                     d.get("margin", 40), d.get("seriesColors"))


class Component:
    """Base: JSON serde + HTML rendering."""

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps({"type": type(self).__name__, **self.to_dict()})

    @staticmethod
    def from_json(s: str) -> "Component":
        d = json.loads(s)
        cls = _REGISTRY.get(d.pop("type", None))
        if cls is None:
            raise ValueError(f"unknown component type in {s[:60]!r}")
        return cls._from_dict(d)

    def render_html(self) -> str:
        raise NotImplementedError


class Chart(Component):
    def __init__(self, title: str, style: Optional[Style] = None):
        self.title = title
        self.style = style or Style()
        self.series: List[dict] = []

    def _base_dict(self):
        return {"title": self.title, "style": self.style.to_dict(),
                "series": self.series}

    @classmethod
    def _from_dict(cls, d):
        c = cls(d["title"], Style.from_dict(d.get("style", {})))
        c.series = d.get("series", [])
        return c

    def _canvas(self, payload: dict, kind: str) -> str:
        st = self.style
        cid = f"c{id(self):x}_{kind}"
        return f"""<div class="dl4j-chart"><h3>{_esc(self.title)}</h3>
<canvas id="{cid}" width="{st.width}" height="{st.height}"></canvas>
<script>(function(){{
const d={_jsafe(payload)};
const c=document.getElementById({cid!r}), g=c.getContext('2d');
const M={st.margin}, W=c.width-2*M, H=c.height-2*M;
const xs=d.series.flatMap(s=>s.x), ys=d.series.flatMap(s=>s.y);
if(!xs.length) return;
const x0=Math.min(...xs), x1=Math.max(...xs), y0=Math.min(0,...ys),
      y1=Math.max(...ys);
const px=x=>M+(x-x0)/((x1-x0)||1)*W, py=y=>c.height-M-(y-y0)/((y1-y0)||1)*H;
g.strokeStyle='#999'; g.strokeRect(M,M,W,H);
g.fillStyle='#333'; g.font='11px sans-serif';
g.fillText(y1.toPrecision(4),2,M+8); g.fillText(y0.toPrecision(4),2,c.height-M);
const colors={json.dumps(st.series_colors)};
d.series.forEach((s,si)=>{{
  g.strokeStyle=g.fillStyle=colors[si%colors.length];
  if({json.dumps(kind)}==='scatter'){{
    s.x.forEach((x,i)=>{{g.beginPath();g.arc(px(x),py(s.y[i]),2.5,0,7);g.fill();}});
  }} else if({json.dumps(kind)}==='bar'){{
    const bw=W/s.x.length*0.8;
    s.x.forEach((x,i)=>g.fillRect(px(x)-bw/2,py(s.y[i]),bw,py(y0)-py(s.y[i])));
  }} else {{
    g.beginPath();
    s.x.forEach((x,i)=>i?g.lineTo(px(x),py(s.y[i])):g.moveTo(px(x),py(s.y[i])));
    g.stroke();
  }}
}});
}})();</script></div>"""


@_register
class ChartLine(Chart):
    """Parity: chart/ChartLine.java (Builder.addSeries)."""

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float]):
        if len(x) != len(y):
            raise ValueError(f"series '{name}': {len(x)} x vs {len(y)} y")
        self.series.append({"name": name, "x": list(map(float, x)),
                            "y": list(map(float, y))})
        return self

    def to_dict(self):
        return self._base_dict()

    def render_html(self):
        return self._canvas({"series": self.series}, "line")


@_register
class ChartScatter(ChartLine):
    """Parity: chart/ChartScatter.java."""

    def render_html(self):
        return self._canvas({"series": self.series}, "scatter")


@_register
class ChartHistogram(Chart):
    """Parity: chart/ChartHistogram.java — (lowerBound, upperBound, yValue)
    bins."""

    def add_bin(self, lower: float, upper: float, y: float):
        self.series.append({"lower": float(lower), "upper": float(upper),
                            "y": float(y)})
        return self

    def to_dict(self):
        return self._base_dict()

    def render_html(self):
        xs = [(b["lower"] + b["upper"]) / 2 for b in self.series]
        ys = [b["y"] for b in self.series]
        return self._canvas({"series": [{"name": "hist", "x": xs, "y": ys}]},
                            "bar")


@_register
class ChartStackedArea(ChartLine):
    """Parity: chart/ChartStackedArea.java — rendered as cumulative lines."""

    def render_html(self):
        acc = None
        stacked = []
        for s in self.series:
            ys = list(s["y"]) if acc is None else \
                [a + b for a, b in zip(acc, s["y"])]
            acc = ys
            stacked.append({"name": s["name"], "x": s["x"], "y": ys})
        return self._canvas({"series": stacked}, "line")


@_register
class ChartHorizontalBar(Chart):
    """Parity: chart/ChartHorizontalBar.java — category → value."""

    def add_value(self, name: str, value: float):
        self.series.append({"name": name, "value": float(value)})
        return self

    def to_dict(self):
        return self._base_dict()

    def render_html(self):
        xs = list(range(len(self.series)))
        ys = [s["value"] for s in self.series]
        return self._canvas({"series": [{"name": "bars", "x": xs, "y": ys}]},
                            "bar")


@_register
class ChartTimeline(Chart):
    """Parity: chart/ChartTimeline.java — lanes of (start, end, label)."""

    def add_lane(self, name: str, entries: Sequence[tuple]):
        self.series.append({"name": name,
                            "entries": [[float(a), float(b), str(lab)]
                                        for a, b, lab in entries]})
        return self

    def to_dict(self):
        return self._base_dict()

    def render_html(self):
        rows = "".join(
            f"<tr><td>{_esc(s['name'])}</td><td>" + " ".join(
                f"[{a:.3g}&ndash;{b:.3g}: {_esc(lab)}]"
                for a, b, lab in s["entries"])
            + "</td></tr>" for s in self.series)
        return (f"<div class='dl4j-chart'><h3>{_esc(self.title)}</h3>"
                f"<table>{rows}</table></div>")


@_register
class ComponentTable(Component):
    """Parity: table/ComponentTable.java."""

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence]):
        self.header = list(header)
        self.rows = [list(map(str, r)) for r in rows]

    def to_dict(self):
        return {"header": self.header, "rows": self.rows}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["header"], d["rows"])

    def render_html(self):
        head = "".join(f"<th>{_esc(h)}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in r) + "</tr>"
            for r in self.rows)
        return f"<table><tr>{head}</tr>{body}</table>"


@_register
class ComponentText(Component):
    """Parity: text/ComponentText.java."""

    def __init__(self, text: str):
        self.text = text

    def to_dict(self):
        return {"text": self.text}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["text"])

    def render_html(self):
        return f"<p>{_esc(self.text)}</p>"


@_register
class ComponentDiv(Component):
    """Parity: component/ComponentDiv.java — container of components."""

    def __init__(self, *children: Component):
        self.children = list(children)

    def to_dict(self):
        return {"children": [json.loads(c.to_json()) for c in self.children]}

    @classmethod
    def _from_dict(cls, d):
        return cls(*[Component.from_json(json.dumps(c))
                     for c in d.get("children", [])])

    def render_html(self):
        return ("<div>" + "".join(c.render_html() for c in self.children)
                + "</div>")


def render_page(*components: Component, title: str = "dl4j-tpu components"):
    """Standalone HTML document from components (the reference renders via
    its JS assets; here the components carry their own renderer)."""
    body = "".join(c.render_html() for c in components)
    return (f"<!DOCTYPE html><html><head><title>{title}</title><style>"
            "body{font-family:sans-serif;margin:20px}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:3px 8px}</style></head>"
            f"<body>{body}</body></html>")
