"""Minimal live viewer: frames over HTTP with browser-side orbit controls
(port of simlod_tpu/viewer.py).

The reference is an interactive GLFW window with ImGui stats and mouse orbit
controls (src/GLRenderer.cpp, include/OrbitControls.h:100-138). This environment
is headless, so the interactive equivalent serves rendered frames over HTTP:

  - `GET /`           a self-contained HTML page: canvas + mouse handlers that
                      mirror OrbitControls (drag = yaw/pitch, wheel = radius,
                      shift-drag = pan) and live stats readout,
  - `GET /frame?...`  renders one frame for the requested camera and streams it
                      as PNG (stdlib zlib encoder — no image library needed),
  - `GET /stats`      the engine's stats table as JSON (the ImGui stats window),
  - `GET /bench`      runs N timed frames under the render lock and returns the
                      reference-style copyable stats table (min/max/avg per
                      kernel — the "Benchmark" button + stats table of
                      main_progressive_octree.cpp:1254-1258, 1505-1556);
                      `?reset=1` re-opens the last file set first and times the
                      whole simultaneous load ("Reset + Benchmark").

The page also draws a scrolling frame-time graph with 60/120 FPS guide lines
(the reference's ImPlot plot, src/GLRenderer.cpp:307-350).

Camera state lives in the BROWSER and rides the query string, so the server is
stateless per request and any number of clients can orbit independently.

Start with `python -m simlod_tpu_torch.app --serve [--port 8642] cloud.las`
(app.py) against a loaded engine; construction continues between frames if the
stream still has batches (the reference's simultaneous update+render loop).
`bind()` binds the port (0 takes a free one; `port` then holds it),
`serve_forever()` serves, `shutdown()` stops it from another thread.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .render.render import image_to_rgba8


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (stdlib only)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_PAGE = """<!doctype html><html><head><title>simlod_tpu</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px;white-space:pre}
#set{position:fixed;top:8px;right:8px;background:#000a;padding:8px}
#set label{display:block;margin:2px 0}
#set input[type=range]{vertical-align:middle;width:110px}
canvas{display:block;cursor:grab}
</style></head><body>
<canvas id=c></canvas><div id=hud>loading...</div>
<div id=set>
 <b>settings</b>
 <label><input type=checkbox id=hqs checked> high-quality shading</label>
 <label><input type=checkbox id=edl checked> eye-dome lighting</label>
 <label>EDL strength <input type=range id=edls min=0 max=2 step=0.05 value=0.4>
  <span id=edlsv>0.4</span></label>
 <label>minNodeSize <input type=range id=mns min=32 max=1024 step=8 value=64>
  <span id=mnsv>64</span></label>
 <label>point size <input type=range id=psz min=1 max=10 step=1 value=1>
  <span id=pszv>1</span></label>
 <label>point budget <input type=range id=pbud min=0 max=4 step=0.25 value=1>
  <span id=pbudv>1</span></label>
 <label><input type=checkbox id=boxes> node boxes</label>
 <label><input type=checkbox id=freeze> freeze LOD cut</label>
 <label>color <select id=cmode><option value=0>rgb</option>
  <option value=1>by node</option><option value=2>by LOD</option>
  <option value=3>white</option></select></label>
 <button id=benchb>benchmark</button>
 <button id=benchrb>reset + benchmark</button>
 <button id=benchcp style="display:none">copy</button>
 <pre id=benchout style="max-width:360px;overflow:auto"></pre>
</div>
<canvas id=g width=260 height=74
 style="position:fixed;bottom:8px;left:8px;background:#000a"></canvas>
<script>
const cv=document.getElementById('c'),hud=document.getElementById('hud');
let yaw=%YAW%,pitch=%PITCH%,radius=%RADIUS%,tx=%TX%,ty=%TY%,tz=%TZ%;
let drag=null,busy=false,dirty=true;
cv.width=%W%;cv.height=%H%;
const el=id=>document.getElementById(id);
for(const id of['hqs','edl','edls','mns','psz','pbud','boxes','freeze','cmode'])
 el(id).oninput=()=>{el('edlsv').textContent=el('edls').value;
  el('mnsv').textContent=el('mns').value;
  el('pszv').textContent=el('psz').value;
  el('pbudv').textContent=el('pbud').value;dirty=true};
cv.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,pan:e.shiftKey||e.button==2};e.preventDefault()};
window.onmouseup=()=>drag=null;
cv.oncontextmenu=e=>e.preventDefault();
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=radius*0.001;  // OrbitControls pan scale
  tx+=-s*(dx*Math.cos(yaw)-dy*Math.sin(yaw)*Math.sin(pitch));
  ty+=-s*(-dx*Math.sin(yaw)-dy*Math.cos(yaw)*Math.sin(pitch));
  tz+=s*dy*Math.cos(pitch);}
 else{yaw+=dx*0.01;pitch+=dy*0.01;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));}
 dirty=true};
window.onwheel=e=>{radius*=e.deltaY>0?1.1:0.9;dirty=true};
// scrolling frame-time graph with 60/120 FPS guides (GLRenderer.cpp:307-350)
const gv=document.getElementById('g'),gx=gv.getContext('2d');let hist=[];
function drawGraph(){
 const W=gv.width,H=gv.height;gx.clearRect(0,0,W,H);
 const ymax=Math.max(33.4,...hist),y=ms=>H-4-ms/ymax*(H-16);
 for(const [ms,col] of [[16.7,'#4a4'],[8.3,'#aa4']]){
  gx.strokeStyle=col;gx.beginPath();gx.moveTo(0,y(ms));gx.lineTo(W,y(ms));gx.stroke();}
 gx.strokeStyle='#4af';gx.beginPath();
 hist.forEach((ms,i)=>{const px=W-(hist.length-i)*2;
  i?gx.lineTo(px,y(ms)):gx.moveTo(px,y(ms))});
 gx.stroke();gx.fillStyle='#ddd';
 if(hist.length)gx.fillText(hist[hist.length-1].toFixed(1)+' ms',4,10);}
async function runBench(reset){
 const out=el('benchout');out.textContent='benchmarking...';
 try{const r=await fetch('/bench?frames=50'+(reset?'&reset=1':''));
  const j=await r.json();out.textContent=j.table;
  const cp=el('benchcp');cp.style.display='inline';
  cp.onclick=()=>navigator.clipboard.writeText(j.table);dirty=true;
 }catch(e){out.textContent='error: '+e}}
el('benchb').onclick=()=>runBench(0);
el('benchrb').onclick=()=>runBench(1);
async function loop(){
 if(dirty&&!busy){dirty=false;busy=true;
  const q=`yaw=${yaw}&pitch=${pitch}&radius=${radius}&tx=${tx}&ty=${ty}&tz=${tz}`+
   `&hqs=${el('hqs').checked?1:0}&edl=${el('edl').checked?1:0}`+
   `&edls=${el('edls').value}&mns=${el('mns').value}&psz=${el('psz').value}`+
   `&boxes=${el('boxes').checked?1:0}&freeze=${el('freeze').checked?1:0}`+
   `&cmode=${el('cmode').value}&pbud=${el('pbud').value}`;
  try{
   const t0=performance.now();
   const r=await fetch('/frame?'+q);const b=await r.blob();
   const img=await createImageBitmap(b);
   cv.getContext('2d').drawImage(img,0,0);
   const s=await (await fetch('/stats')).json();
   hud.textContent=`frame ${(performance.now()-t0).toFixed(0)} ms  `+
    `nodes ${s.num_nodes}  points ${s.num_points}  voxels ${s.num_voxels_stored}\\n`+
    `visible pts ${s.num_visible_points} vox ${s.num_visible_voxels}`+
    (s.streaming?`\\nstreaming... ${s.num_points_processed} pts`:'');
   hist.push(s.render_ms||performance.now()-t0);
   if(hist.length>Math.floor(gv.width/2))hist.shift();
   drawGraph();
   if(s.streaming)dirty=true;   // keep refreshing while construction runs
  }catch(e){hud.textContent='error: '+e}
  busy=false}
 requestAnimationFrame(loop)}
loop();
</script></body></html>"""


class ViewerServer:
    """Serves an Engine's frames; single render lock (one device)."""

    def __init__(self, engine, width: int = 1280, height: int = 720,
                 port: int = 8642):
        self.engine = engine
        self.width, self.height = width, height
        self.port = port
        self._lock = threading.Lock()
        self._last_stats = {}
        self._httpd = None
        self._serving = threading.Event()

    def _render(self, q) -> bytes:
        eng = self.engine
        g = lambda k, d: float(q.get(k, [d])[0])
        with self._lock:
            o = eng.orbit
            o.yaw = g("yaw", o.yaw)
            o.pitch = g("pitch", o.pitch)
            o.radius = g("radius", o.radius)
            o.target = np.array([g("tx", o.target[0]), g("ty", o.target[1]),
                                 g("tz", o.target[2])], np.float64)
            eng.camera.world = o.world()
            # settings panel (reference ImGui widgets,
            # main_progressive_octree.cpp:1237-1368): the values ride Uniforms'
            # device scalars, the switches also its host flags
            s = eng.settings
            s.use_high_quality_shading = g("hqs", s.use_high_quality_shading) > 0
            s.enable_edl = g("edl", s.enable_edl) > 0
            s.edl_strength = g("edls", s.edl_strength)
            s.min_node_size = g("mns", s.min_node_size)
            s.point_size = min(int(g("psz", s.point_size)),
                               eng.cfg.max_point_size)
            # screen-budgeted decimation (render/drawpool.py): frame cost
            # tracks screen coverage; 0 restores exact reference semantics
            s.point_budget = g("pbud", s.point_budget)
            s.show_bounding_box = g("boxes", s.show_bounding_box) > 0
            s.do_update_visibility = g("freeze", 0) == 0
            cmode = int(g("cmode", 0))
            s.color_by_node = cmode == 1
            s.color_by_lod = cmode == 2
            s.color_white = cmode == 3
            t0 = time.perf_counter()
            if (eng.stream is not None and not eng.last_batch_finished):
                img, stats = eng.frame(self.width, self.height)   # simultaneous
            else:
                img, stats = eng.render(self.width, self.height)
            render_ms = (time.perf_counter() - t0) * 1e3
            # the engine's Stats already hold host values (one device read)
            self._last_stats = dataclasses.asdict(stats)
            self._last_stats["streaming"] = bool(
                eng.stream is not None and not eng.last_batch_finished)
            self._last_stats["render_ms"] = round(render_ms, 2)
        rgb = image_to_rgba8(img)[::-1, :, :3]
        return encode_png(np.ascontiguousarray(rgb))

    def _bench(self, q) -> dict:
        """N timed frames under the render lock -> reference-style stats table
        (min/max/avg per kernel, main_progressive_octree.cpp:1505-1556).
        `reset=1` re-opens the last file set first, so the timed frames cover
        the whole simultaneous build+render ("Reset + Benchmark",
        main_progressive_octree.cpp:1254-1258)."""
        eng = self.engine
        n = max(1, min(int(float(q.get("frames", ["50"])[0])), 500))
        reset = q.get("reset", ["0"])[0] == "1"
        samples = []
        with self._lock:
            if reset and getattr(eng, "_last_paths", None):
                eng.open(eng._last_paths)
            o = eng.orbit
            yaw0 = o.yaw
            i = 0
            # under reset, keep framing until the stream drains (the bench is
            # the load); otherwise exactly n frames
            while (i < n) or (reset and not eng.last_batch_finished):
                o.yaw = yaw0 + 0.005 * i
                eng.camera.world = o.world()
                t0 = time.perf_counter()
                if eng.stream is not None and not eng.last_batch_finished:
                    eng.frame(self.width, self.height)
                else:
                    eng.render(self.width, self.height)
                samples.append((time.perf_counter() - t0) * 1e3)
                i += 1
                if i >= 10000:   # stuck-stream guard
                    break
            o.yaw = yaw0
            rep = eng.report()
        rows = [("frame", dict(count=len(samples),
                               avg_ms=sum(samples) / len(samples),
                               min_ms=min(samples), max_ms=max(samples)))]
        rows += [(k, v) for k, v in rep.get("timings", {}).items()
                 if v.get("count")]
        lines = [f"{'kernel':<10}{'count':>7}{'avg ms':>10}{'min ms':>10}"
                 f"{'max ms':>10}"]
        for name, r in rows:
            lines.append(f"{name:<10}{r['count']:>7}{r['avg_ms']:>10.2f}"
                         f"{r['min_ms']:>10.2f}{r['max_ms']:>10.2f}")
        lines.append(f"nodes {rep.get('num_nodes')}  "
                     f"points {rep.get('num_points')}  "
                     f"voxels {rep.get('num_voxels_stored')}")
        return {"frames": len(samples), "timings": dict(rows),
                "table": "\n".join(lines)}

    def page(self) -> str:
        o = self.engine.orbit
        return (_PAGE.replace("%YAW%", f"{o.yaw}").replace("%PITCH%", f"{o.pitch}")
                .replace("%RADIUS%", f"{o.radius}")
                .replace("%TX%", f"{o.target[0]}").replace("%TY%", f"{o.target[1]}")
                .replace("%TZ%", f"{o.target[2]}")
                .replace("%W%", str(self.width)).replace("%H%", str(self.height)))

    def bind(self) -> int:
        """Bind the HTTP server to `port` (0: a free port) and return the
        bound port, which `port` then holds."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._send(200, "text/html",
                                   viewer.page().encode())
                    elif u.path == "/frame":
                        png = viewer._render(parse_qs(u.query))
                        self._send(200, "image/png", png)
                    elif u.path == "/stats":
                        self._send(200, "application/json",
                                   json.dumps(viewer._last_stats).encode())
                    elif u.path == "/bench":
                        out = viewer._bench(parse_qs(u.query))
                        self._send(200, "application/json",
                                   json.dumps(out).encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface render errors to the client
                    self._send(500, "text/plain", repr(e).encode())

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]
        return self.port

    def serve_forever(self):
        """Serve until `shutdown()` (binds first if `bind` was not called)."""
        if self._httpd is None:
            self.bind()
        print(f"viewer: http://localhost:{self.port}/ "
              f"({self.width}x{self.height})", flush=True)
        self._serving.set()
        self._httpd.serve_forever()

    def shutdown(self):
        """Stop serve_forever (from another thread) and close the socket."""
        if self._httpd is None:
            return
        if self._serving.is_set():   # shutdown() waits for the serve loop
            self._httpd.shutdown()
            self._serving.clear()
        self._httpd.server_close()
        self._httpd = None
