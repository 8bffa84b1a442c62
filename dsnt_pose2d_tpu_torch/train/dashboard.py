"""Live training dashboard (port of ``dsnt_pose2d_tpu/train/dashboard.py``,
its own copy: the port imports nothing of the JAX package).

A dependency-free stdlib HTTP server serves a single-page dashboard
straight out of the experiment directory:

- ``/``          self-contained HTML/JS page (no external assets) rendering
                 loss/PCKh/throughput charts from the metrics stream
- ``/metrics``   the experiment's metrics.jsonl (append-only event stream)
- ``/samples``   JSON list of sample render names
- ``/samples/x`` skeleton-overlay PNGs written at eval time

Start with ``--dashboard-port`` on the train CLI, or standalone:

    python -m dsnt_pose2d_tpu_torch.train.dashboard --dir out/<experiment> --port 6006
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dsnt-pose2d-tpu (PyTorch)</title>
<style>
body { font-family: system-ui, sans-serif; margin: 1.5rem; background: #111; color: #eee; }
h1 { font-size: 1.1rem; font-weight: 600; }
.grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(380px, 1fr)); gap: 1rem; }
canvas { background: #1a1a1a; border-radius: 8px; width: 100%; height: 220px; }
.samples img { height: 160px; margin: 0.25rem; border-radius: 6px; }
.muted { color: #888; font-size: 0.8rem; }
</style></head><body>
<h1>dsnt-pose2d-tpu (PyTorch) — live training</h1>
<div class="muted" id="status">loading…</div>
<div class="grid">
  <div><canvas id="loss"></canvas></div>
  <div><canvas id="pckh"></canvas></div>
  <div><canvas id="ips"></canvas></div>
</div>
<h1>latest samples</h1><div class="samples" id="samples"></div>
<script>
function draw(id, series, color, label) {
  const c = document.getElementById(id), ctx = c.getContext('2d');
  c.width = c.clientWidth * 2; c.height = 440;
  ctx.clearRect(0, 0, c.width, c.height);
  ctx.font = '24px system-ui'; ctx.fillStyle = '#aaa';
  ctx.fillText(label, 16, 34);
  if (!series.length) return;
  const xs = series.map(p => p[0]), ys = series.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs, x0 + 1);
  const y0 = Math.min(...ys), y1 = Math.max(...ys, y0 + 1e-9);
  ctx.strokeStyle = color; ctx.lineWidth = 3; ctx.beginPath();
  series.forEach((p, i) => {
    const x = 20 + (p[0] - x0) / (x1 - x0) * (c.width - 40);
    const y = c.height - 20 - (p[1] - y0) / (y1 - y0) * (c.height - 70);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  ctx.fillStyle = '#ddd';
  ctx.fillText(ys[ys.length-1].toPrecision(4), c.width - 140, 34);
}
async function refresh() {
  const r = await fetch('metrics'); const text = await r.text();
  const loss = [], pckh = [], ips = [];
  let n = 0;
  for (const line of text.split('\\n')) {
    if (!line.trim()) continue;
    let d; try { d = JSON.parse(line); } catch { continue; }
    n++;
    if ('train_loss' in d) loss.push([d.epoch, d.train_loss]);
    if ('val_pckh' in d) pckh.push([d.epoch, 100 * d.val_pckh]);
    if ('images_per_sec' in d) ips.push([d.epoch, d.images_per_sec]);
  }
  document.getElementById('status').textContent = n + ' events';
  draw('loss', loss, '#7aa2ff', 'train loss');
  draw('pckh', pckh, '#7dd87d', 'val PCKh@0.5 (%)');
  draw('ips', ips, '#ffb86b', 'images/sec');
  const s = await fetch('samples'); const names = await s.json();
  document.getElementById('samples').innerHTML =
    names.slice(-6).map(x => `<img src="samples/${x}">`).join('');
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    exp_dir = "."

    def log_message(self, *args):
        pass

    def _send(self, code, body, ctype="text/plain"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            return self._send(200, _PAGE.encode(), "text/html")
        if self.path == "/metrics":
            path = os.path.join(self.exp_dir, "metrics.jsonl")
            data = open(path, "rb").read() if os.path.exists(path) else b""
            return self._send(200, data, "application/jsonl")
        if self.path == "/samples":
            sdir = os.path.join(self.exp_dir, "samples")
            names = sorted(os.listdir(sdir)) if os.path.isdir(sdir) else []
            return self._send(200, json.dumps(names).encode(),
                              "application/json")
        if self.path.startswith("/samples/"):
            name = os.path.basename(self.path[len("/samples/"):])
            path = os.path.join(self.exp_dir, "samples", name)
            if os.path.exists(path):
                return self._send(200, open(path, "rb").read(), "image/png")
        return self._send(404, b"not found")


def serve(exp_dir: str, port: int = 6006, background: bool = True):
    """Serve the dashboard; returns the server (use .shutdown() to stop)."""
    handler = type("Handler", (_Handler,), {"exp_dir": exp_dir})
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    server.serve_forever()
    return server


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("dsnt-pose2d-tpu-torch dashboard")
    p.add_argument("--dir", required=True, help="experiment directory")
    p.add_argument("--port", type=int, default=6006)
    args = p.parse_args(argv)
    print(f"dashboard: http://localhost:{args.port}/ ({args.dir})")
    serve(args.dir, args.port, background=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
