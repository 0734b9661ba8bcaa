"""Web UI server: the train overview, model, system, activations and
t-SNE pages and the remote stats receiver.

Counterpart of deeplearning4j_tpu/ui/server.py (parity surface: the
reference's PlayUIServer with its TrainModule pages, the activations page
of ConvolutionalIterationListener, the TsneModule and
RemoteReceiverModule's POST /remote). A stdlib ``ThreadingHTTPServer``;
each page is one self-contained HTML document (inline canvas charts,
fetch polling, no external assets). Every route and its JSON are the JAX
package's; /train/system/data names the CUDA device and backend (``cpu``
off the card).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlparse, parse_qs

from deeplearning4j_tpu_torch.ui.storage import StatsStorage, StatsReport

_PAGE = """<!DOCTYPE html>
<html><head><title>DL4J-TPU Training UI</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
h1{font-size:20px} h2{font-size:16px}
.card{background:#fff;border:1px solid #ddd;border-radius:6px;
      padding:12px;margin:10px 0}
canvas{width:100%;height:220px}
table{border-collapse:collapse;font-size:13px}
td,th{border:1px solid #ccc;padding:3px 8px;text-align:right}
th{background:#eee}
select{font-size:14px;padding:2px}
</style></head><body>
<h1>deeplearning4j_tpu &mdash; training overview</h1>
<p><a href="/train">overview</a> | <a href="/train/model">model</a>
 | <a href="/train/system">system</a>
 | <a href="/train/activations">activations</a>
 | <a href="/tsne">t-SNE</a></p>
<div class="card">Session: <select id="sess"></select>
 <span id="meta"></span></div>
<div class="card"><h2>Score vs iteration</h2><canvas id="score"></canvas></div>
<div class="card"><h2>Iteration time (ms)</h2><canvas id="time"></canvas></div>
<div class="card"><h2>Parameter norms (latest)</h2><div id="params"></div></div>
<script>
function line(id, xs, ys){
  const c=document.getElementById(id);
  c.width=c.clientWidth; c.height=c.clientHeight;
  const g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  if(ys.length<2) return;
  const fy=ys.filter(Number.isFinite);
  const ymin=Math.min(...fy), ymax=Math.max(...fy);
  const sx=(c.width-50)/(xs.length-1), sy=(c.height-30)/((ymax-ymin)||1);
  g.strokeStyle='#2a6cc4'; g.lineWidth=1.5; g.beginPath();
  ys.forEach((y,i)=>{const px=40+i*sx, py=c.height-20-(y-ymin)*sy;
    i?g.lineTo(px,py):g.moveTo(px,py);});
  g.stroke();
  g.fillStyle='#333'; g.font='11px sans-serif';
  g.fillText(ymax.toPrecision(4),2,12);
  g.fillText(ymin.toPrecision(4),2,c.height-22);
}
async function refresh(){
  const sel=document.getElementById('sess');
  const sids=await (await fetch('train/sessions')).json();
  if(sel.options.length!=sids.length){
    sel.innerHTML='';
    sids.forEach(s=>{const o=document.createElement('option');
      o.textContent=s; sel.appendChild(o);});
  }
  if(!sel.value) return;
  const ov=await (await fetch('train/overview?sid='+sel.value)).json();
  line('score', ov.iterations, ov.scores);
  line('time', ov.iterations, ov.iterationTimesMs);
  document.getElementById('meta').textContent=
    ` ${ov.iterations.length} updates, last score `+
    `${(ov.scores.at(-1)??NaN).toPrecision(5)}`;
  const ps=ov.latestParamStats||{};
  document.getElementById('params').innerHTML =
    '<table><tr><th>group</th><th>mean</th><th>std</th><th>norm</th></tr>'+
    Object.entries(ps).map(([k,v])=>
      `<tr><td>${k}</td><td>${v.mean.toPrecision(4)}</td>`+
      `<td>${v.std.toPrecision(4)}</td><td>${v.norm.toPrecision(4)}</td></tr>`)
      .join('')+'</table>';
}
setInterval(refresh, 2000); refresh();
</script></body></html>"""

_NAV = ('<p><a href="/train">overview</a> | <a href="/train/model">model</a>'
        ' | <a href="/train/system">system</a>'
        ' | <a href="/train/activations">activations</a>'
        ' | <a href="/tsne">t-SNE</a></p>')

_CHART_JS = """
function line(id, xs, ys, color){
  const c=document.getElementById(id);
  c.width=c.clientWidth; c.height=c.clientHeight;
  const g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  if(ys.length<2) return;
  const fy=ys.filter(Number.isFinite);
  if(!fy.length) return;
  const ymin=Math.min(...fy), ymax=Math.max(...fy);
  const sx=(c.width-50)/(xs.length-1), sy=(c.height-30)/((ymax-ymin)||1);
  g.strokeStyle=color||'#2a6cc4'; g.lineWidth=1.5; g.beginPath();
  ys.forEach((y,i)=>{const px=40+i*sx, py=c.height-20-(y-ymin)*sy;
    i?g.lineTo(px,py):g.moveTo(px,py);});
  g.stroke();
  g.fillStyle='#333'; g.font='11px sans-serif';
  g.fillText(ymax.toPrecision(4),2,12);
  g.fillText(ymin.toPrecision(4),2,c.height-22);
}
async function pickSession(){
  const sel=document.getElementById('sess');
  const sids=await (await fetch('/train/sessions')).json();
  if(sel.options.length!=sids.length){
    sel.innerHTML='';
    sids.forEach(s=>{const o=document.createElement('option');
      o.textContent=s; sel.appendChild(o);});
  }
  return sel.value;
}
"""

_STYLE = """<style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
h1{font-size:20px} h2{font-size:16px}
.card{background:#fff;border:1px solid #ddd;border-radius:6px;
      padding:12px;margin:10px 0}
canvas{width:100%;height:180px}
table{border-collapse:collapse;font-size:13px}
td,th{border:1px solid #ccc;padding:3px 8px;text-align:right}
th{background:#eee} select{font-size:14px;padding:2px}
img{image-rendering:pixelated;border:1px solid #ccc;margin:4px}
</style>"""

_MODEL_PAGE = f"""<!DOCTYPE html>
<html><head><title>DL4J-TPU Model</title>{_STYLE}</head><body>
<h1>model &mdash; per-layer parameters</h1>{_NAV}
<div class="card">Session: <select id="sess"></select></div>
<div id="layers"></div>
<script>{_CHART_JS}
async function refresh(){{
  const sid=await pickSession(); if(!sid) return;
  const d=await (await fetch('/train/model/data?sid='+sid)).json();
  const host=document.getElementById('layers');
  for(const [g, s] of Object.entries(d.series||{{}})){{
    const id='c_'+g.replace(/[^a-zA-Z0-9]/g,'_');
    if(!document.getElementById(id)){{
      const div=document.createElement('div'); div.className='card';
      div.innerHTML=`<h2>${{g}} &mdash; log10 update:param ratio</h2>
        <canvas id="${{id}}"></canvas>
        <h2 style="margin-top:8px">mean magnitude</h2>
        <canvas id="${{id}}_mm"></canvas>`;
      host.appendChild(div);
    }}
    line(id, s.iterations, s.logRatio, '#c44');
    line(id+'_mm', s.iterations, s.paramMeanMag, '#2a6cc4');
  }}
}}
setInterval(refresh, 3000); refresh();
</script></body></html>"""

_SYSTEM_PAGE = f"""<!DOCTYPE html>
<html><head><title>DL4J-TPU System</title>{_STYLE}</head><body>
<h1>system</h1>{_NAV}
<div class="card">Session: <select id="sess"></select>
 <span id="info"></span></div>
<div class="card"><h2>Host memory RSS (MB)</h2><canvas id="mem"></canvas></div>
<div class="card"><h2>Iteration time (ms)</h2><canvas id="it"></canvas></div>
<div class="card"><h2>Batches/sec</h2><canvas id="bps"></canvas></div>
<script>{_CHART_JS}
async function refresh(){{
  const sid=await pickSession(); if(!sid) return;
  const d=await (await fetch('/train/system/data?sid='+sid)).json();
  line('mem', d.iterations, d.memRssMb, '#393');
  line('it', d.iterations, d.iterationTimesMs);
  line('bps', d.iterations, d.batchesPerSec, '#c44');
  document.getElementById('info').textContent=
    ` device: ${{d.device||'?'}}, backend: ${{d.backend||'?'}}`;
}}
setInterval(refresh, 3000); refresh();
</script></body></html>"""

_TSNE_PAGE = f"""<!DOCTYPE html>
<html><head><title>DL4J-TPU t-SNE</title>{_STYLE}</head><body>
<h1>t-SNE embedding</h1>{_NAV}
<div class="card">Session: <select id="sess"></select>
 <span id="meta"></span></div>
<div class="card"><canvas id="sc" style="height:480px"></canvas></div>
<script>
async function refresh(){{
  const sel=document.getElementById('sess');
  const sids=await (await fetch('/tsne/sessions')).json();
  if(sel.options.length!=sids.length){{
    sel.innerHTML='';
    sids.forEach(s=>{{const o=document.createElement('option');
      o.textContent=s; sel.appendChild(o);}});
  }}
  if(!sel.value) return;
  const d=await (await fetch('/tsne/coords?sid='+sel.value)).json();
  const c=document.getElementById('sc');
  c.width=c.clientWidth; c.height=c.clientHeight;
  const g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  const pts=d.coords||[];
  if(!pts.length) return;
  document.getElementById('meta').textContent=` ${{pts.length}} points`;
  const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
  const x0=Math.min(...xs), x1=Math.max(...xs);
  const y0=Math.min(...ys), y1=Math.max(...ys);
  const px=x=>20+(x-x0)/((x1-x0)||1)*(c.width-40);
  const py=y=>c.height-20-(y-y0)/((y1-y0)||1)*(c.height-40);
  g.font='10px sans-serif';
  pts.forEach((p,i)=>{{
    g.fillStyle='#2a6cc4'; g.beginPath();
    g.arc(px(p[0]),py(p[1]),2.5,0,7); g.fill();
    if(d.labels&&d.labels[i]!=null){{
      g.fillStyle='#333'; g.fillText(d.labels[i],px(p[0])+4,py(p[1]));
    }}
  }});
}}
setInterval(refresh, 3000); refresh();
</script></body></html>"""

_ACTIVATIONS_PAGE = f"""<!DOCTYPE html>
<html><head><title>DL4J-TPU Activations</title>{_STYLE}</head><body>
<h1>convolutional activations</h1>{_NAV}
<div class="card">Session: <select id="sess"></select>
 <span id="meta"></span></div>
<div id="grids"></div>
<script>{_CHART_JS}
async function refresh(){{
  const sid=await pickSession(); if(!sid) return;
  const d=await (await fetch('/train/activations/data?sid='+sid)).json();
  document.getElementById('meta').textContent=
    d.iteration!=null?` iteration ${{d.iteration}}`:' (no captures yet)';
  const host=document.getElementById('grids');
  host.innerHTML=Object.entries(d.images||{{}}).map(([k,v])=>
    `<div class="card"><h2>${{k}}</h2>
     <img src="data:image/png;base64,${{v}}" width="60%"></div>`).join('');
}}
setInterval(refresh, 3000); refresh();
</script></body></html>"""


def _device_info() -> dict:
    """The device the process computes on: the card's name and "cuda",
    or "cpu" for both without one."""
    import torch
    if torch.cuda.is_available():
        return {"device": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "backend": "cuda"}
    return {"device": "cpu", "backend": "cpu"}


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4JTpuUI/1.0"

    def log_message(self, *args):  # silence request spam
        pass

    @property
    def storages(self) -> List[StatsStorage]:
        return self.server.ui.storages

    def _json(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _html(self, page: str):
        data = page.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        u = urlparse(self.path)
        if u.path in ("/", "/train", "/train/overview.html"):
            self._html(_PAGE)
            return
        if u.path == "/train/sessions":
            sids = []
            for st in self.storages:
                sids.extend(st.list_session_ids())
            self._json(sorted(set(sids)))
            return
        if u.path == "/train/overview":
            sid = parse_qs(u.query).get("sid", [None])[0]
            ups: List[StatsReport] = []
            for st in self.storages:
                ups.extend(st.get_all_updates(sid) if sid else [])
            ups.sort(key=lambda r: r.iteration)
            self._json({
                "iterations": [r.iteration for r in ups],
                "scores": [r.score for r in ups],
                "iterationTimesMs": [r.iteration_time_ms for r in ups],
                "latestParamStats": ups[-1].param_stats if ups else {},
            })
            return
        if u.path == "/train/model":
            sid = parse_qs(u.query).get("sid", [None])[0]
            if sid is None:                       # page; ?sid= keeps the
                self._html(_MODEL_PAGE)           # static-info JSON API
                return
            for st in self.storages:
                info = st.get_static_info(sid)
                if info:
                    self._json(info)
                    return
            self._json({}, 404)
            return
        if u.path == "/train/model/data":
            sid = parse_qs(u.query).get("sid", [None])[0]
            ups: List[StatsReport] = []
            for st in self.storages:
                ups.extend(st.get_all_updates(sid) if sid else [])
            ups.sort(key=lambda r: r.iteration)
            series = {}
            for r in ups:
                for g, ps in (r.param_stats or {}).items():
                    us = (r.update_stats or {}).get(g)
                    s = series.setdefault(g, {"iterations": [],
                                              "logRatio": [],
                                              "paramMeanMag": []})
                    s["iterations"].append(r.iteration)
                    pmm = ps.get("meanmag", ps.get("norm", 0.0))
                    s["paramMeanMag"].append(pmm)
                    if us and pmm > 0:
                        umm = us.get("meanmag", us.get("norm", 0.0))
                        import math
                        s["logRatio"].append(
                            math.log10(umm / pmm) if umm > 0 else float("nan"))
                    else:
                        s["logRatio"].append(float("nan"))
            self._json({"series": series})
            return
        if u.path == "/train/system":
            self._html(_SYSTEM_PAGE)
            return
        if u.path == "/train/system/data":
            sid = parse_qs(u.query).get("sid", [None])[0]
            ups = []
            for st in self.storages:
                ups.extend(st.get_all_updates(sid) if sid else [])
            ups.sort(key=lambda r: r.iteration)
            out = {
                "iterations": [r.iteration for r in ups],
                "memRssMb": [r.mem_rss / 1e6 for r in ups],
                "iterationTimesMs": [r.iteration_time_ms for r in ups],
                "batchesPerSec": [r.batches_per_sec for r in ups],
            }
            out.update(_device_info())
            self._json(out)
            return
        if u.path == "/tsne":
            self._html(_TSNE_PAGE)
            return
        if u.path == "/tsne/sessions":
            self._json(sorted(self.server.ui.tsne_sessions))
            return
        if u.path == "/tsne/coords":
            sid = parse_qs(u.query).get("sid", [None])[0]
            self._json(self.server.ui.tsne_sessions.get(sid, {"coords": []}))
            return
        if u.path == "/train/activations":
            self._html(_ACTIVATIONS_PAGE)
            return
        if u.path == "/train/activations/data":
            sid = parse_qs(u.query).get("sid", [None])[0]
            for st in self.storages:
                info = st.get_static_info(f"{sid}/activations")
                if info:
                    self._json(info)
                    return
            self._json({"images": {}})
            return
        self._json({"error": "not found", "path": u.path}, 404)

    def do_POST(self):
        u = urlparse(self.path)
        if u.path == "/tsne/upload":
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n).decode())
                self.server.ui.upload_tsne(      # validates/normalizes
                    str(payload.get("sessionId", "default")),
                    payload.get("coords", []), payload.get("labels"))
            except Exception as e:  # noqa: BLE001 — bad payload → 400
                self._json({"error": f"invalid tsne payload: {e}"}, 400)
                return
            self._json({"status": "ok"})
            return
        if u.path != "/remote":
            self._json({"error": "not found"}, 404)
            return
        n = int(self.headers.get("Content-Length", 0))
        payload = json.loads(self.rfile.read(n).decode())
        target = self.server.ui.remote_storage
        if target is None:
            self._json({"error": "no remote storage attached"}, 503)
            return
        if payload.get("type") == "static":
            target.put_static_info(payload["sessionId"], payload["info"])
        elif payload.get("type") == "update":
            target.put_update(StatsReport.from_bytes(
                bytes.fromhex(payload["record"])))
        else:
            self._json({"error": "unknown type"}, 400)
            return
        self._json({"status": "ok"})


class UIServer:
    """Parity: PlayUIServer. ``UIServer.get_instance()`` starts (or returns)
    the singleton; ``attach(storage)`` adds a stats source;
    ``enable_remote_listener()`` makes POST /remote feed a storage."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self.storages: List[StatsStorage] = []
        self.remote_storage: Optional[StatsStorage] = None
        self.tsne_sessions: dict = {}     # sid -> {coords, labels}
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._httpd.ui = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port)
        return cls._instance

    def attach(self, storage: StatsStorage):
        if storage not in self.storages:
            self.storages.append(storage)
        return self

    def detach(self, storage: StatsStorage):
        if storage in self.storages:
            self.storages.remove(storage)
        return self

    def enable_remote_listener(self, storage: Optional[StatsStorage] = None,
                               attach: bool = True):
        from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
        self.remote_storage = storage or InMemoryStatsStorage()
        if attach:
            self.attach(self.remote_storage)
        return self.remote_storage

    def upload_tsne(self, session_id: str, coords, labels=None):
        """Register a 2-D embedding for the /tsne page (parity: the
        TsneModule's /tsne/upload + /tsne/coords routes; typically fed from
        plot/tsne.BarnesHutTsne output)."""
        import numpy as np
        coords = np.asarray(coords, float)
        self.tsne_sessions[session_id] = {
            "coords": coords[:, :2].tolist(),
            "labels": None if labels is None else [str(l) for l in labels]}
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None
