"""Live render preview over HTTP — the headless-host equivalent of the
reference's egui/glow live window (ui_util.rs:56-168): the reference
streams the accumulating image to a native window; an accelerator host
is headless, so we stream it to the browser instead. Zero dependencies
beyond the stdlib; the renderer pushes frames via `update(target)`
(same cadence as the reference's per-batch texture upload).

    pv = LivePreview(port=8000)
    pv.start()
    renderer.render(update_hook=pv.update)

Serves:
  /         auto-refreshing page
  /frame    current image as PNG (vertical flip applied, like the
            reference's PNG writer)
"""
from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = b"""<!doctype html><html><head><title>raytrace live</title>
<style>body{background:#111;margin:0;display:flex;flex-direction:column;
align-items:center;color:#ccc;font:13px monospace}img{margin-top:8px;
image-rendering:pixelated;max-width:98vw}</style></head><body>
<div id=s>raytrace live preview</div><img id=v src=/frame>
<script>const v=document.getElementById('v');
setInterval(()=>{v.src='/frame?t='+Date.now()},1000);</script>
</body></html>"""


class LivePreview:
    """Tiny threaded HTTP server holding the latest encoded frame."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._png: Optional[bytes] = None
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def update(self, target) -> None:
        """Render-hook: accepts a render.target.RenderTarget (or any
        object with to_u8_rgba()) and re-encodes the current frame."""
        from .image import encode_png

        self._set_png(encode_png(target.to_u8_rgba()))

    def _set_png(self, data: bytes) -> None:
        with self._lock:
            self._png = data

    def start(self) -> None:
        preview = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.startswith("/frame"):
                    with preview._lock:
                        png = preview._png
                    if png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def log_message(self, *a):  # silence per-request spam
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
