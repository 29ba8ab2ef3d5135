"""Web demo, the JAX package's ``app.py`` (the reference's ``app.py:39-152``).

The sliding-window pipeline behind a browser UI with the reference's
controls (max length, target FPS, max resolution).  Two front ends share
``process_video``:

* ``construct_demo``: the reference's gradio UI, where gradio is installed
  (it is imported inside the function);
* ``serve``: a stdlib ``http.server`` (upload form → the input and depth
  videos), used when gradio is absent or ``--plain`` is given.

As in JAX, the model is built for each request.  The server answers one
request at a time on the card and prints, for each, the kernel launches it
made and the host paths that ran (``run.host_paths``).  Runs on the card
unless ``--device cpu``.

    python -m video_depth_anything_torch.app [--host 127.0.0.1] [--port 7860] \\
        [--checkpoint video_depth_anything_vits.pth] [--device cuda]
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional


def process_video(video_path: str, encoder: str = "vits", max_len: int = -1, target_fps: int = -1,
                  max_res: int = 1280, checkpoint: Optional[str] = None, random_init: bool = False,
                  output_dir: Optional[str] = None, input_size: Optional[int] = None,
                  device: str = "cuda"):
    """Video file → (input preview path, depth visualisation path).
    ``checkpoint`` is a torch ``.pth``; without one (or with
    ``random_init``) the weights are the seeded init."""
    from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.io.video import read_video_frames, save_video
    from video_depth_anything_torch.models.vda import VDAModel

    model = VDAModel(encoder, device=device)
    if random_init or checkpoint is None:
        model.init_params(seed=0)
    else:
        from video_depth_anything_torch.io.checkpoint import load_pth

        if not checkpoint.endswith(".pth"):
            raise ValueError(f"the port reads torch .pth checkpoints, got {checkpoint!r}")
        model.load_state_dict(load_pth(checkpoint), strict=True)

    frames, fps = read_video_frames(video_path, max_len, target_fps, max_res)
    pipe = VideoDepthPipeline(model, input_size=input_size or 518)
    depths, fps = pipe.infer_video_depth(frames, fps, progress=True)

    out_dir = output_dir or tempfile.mkdtemp(prefix="vda_demo_")
    base = os.path.splitext(os.path.basename(video_path))[0]
    in_path = os.path.join(out_dir, f"{base}_input.mp4")
    depth_path = os.path.join(out_dir, f"{base}_depth.mp4")
    save_video(frames, in_path, fps=fps)
    save_video(depths, depth_path, fps=fps, is_depths=True)
    return in_path, depth_path


def construct_demo(checkpoint: Optional[str] = None, device: str = "cuda"):
    import gradio as gr

    with gr.Blocks(title="Video Depth Anything (PyTorch)") as demo:
        gr.Markdown("# Video Depth Anything — PyTorch/CUDA")
        with gr.Row():
            inp = gr.Video(label="Input video")
            out_in = gr.Video(label="Preprocessed input")
            out_depth = gr.Video(label="Depth")
        with gr.Row():
            encoder = gr.Dropdown(["vits", "vitl"], value="vits", label="Encoder")
            max_len = gr.Slider(-1, 1000, value=500, step=1, label="Max frames (-1 = all)")
            target_fps = gr.Slider(-1, 30, value=15, step=1, label="Target FPS (-1 = source)")
            max_res = gr.Slider(480, 1920, value=1280, step=2, label="Max resolution")
        btn = gr.Button("Generate depth")

        def _go(video, encoder, max_len, target_fps, max_res):
            return process_video(video, encoder=encoder, max_len=int(max_len),
                                 target_fps=int(target_fps), max_res=int(max_res),
                                 checkpoint=checkpoint, random_init=checkpoint is None,
                                 device=device)

        btn.click(_go, [inp, encoder, max_len, target_fps, max_res], [out_in, out_depth])
    return demo


# -- stdlib UI -----------------------------------------------------------------

_FORM_HTML = """<!doctype html>
<html><head><title>Video Depth Anything</title></head>
<body style="font-family:sans-serif;max-width:640px;margin:2em auto">
<h1>Video Depth Anything — PyTorch/CUDA</h1>
<form method="post" action="/process" enctype="multipart/form-data">
  <p><input type="file" name="video" accept="video/*" required></p>
  <p>Encoder:
    <select name="encoder">
      <option value="vits" selected>vits</option>
      <option value="vitl">vitl</option>
    </select>
    Max frames: <input type="number" name="max_len" value="100" size="5">
    Target FPS: <input type="number" name="target_fps" value="15" size="4">
    Max res: <input type="number" name="max_res" value="1280" size="5">
    Input size: <input type="number" name="input_size" value="518" size="5">
  </p>
  <p><button type="submit">Generate depth</button></p>
</form></body></html>"""

_RESULT_HTML = """<!doctype html>
<html><head><title>Depth result</title></head>
<body style="font-family:sans-serif;max-width:900px;margin:2em auto">
<h1>Result</h1>
<p><a href="/">← process another video</a></p>
<div style="display:flex;gap:1em">
  <div><h3>Input</h3><video controls width="420" src="/files/{inp}"></video></div>
  <div><h3>Depth</h3><video controls width="420" src="/files/{dep}"></video></div>
</div></body></html>"""


def serve(host: str = "127.0.0.1", port: int = 7860, checkpoint: Optional[str] = None,
          input_size: Optional[int] = None, device: str = "cuda"):
    """The stdlib server: GET / serves the upload form, POST /process runs
    ``process_video``, GET /files/* serves the rendered videos.  Returns
    the ``ThreadingHTTPServer`` (the caller runs ``serve_forever``; tests
    drive it from a thread).  Requests are processed one at a time, and
    each prints a line ``[app] request <n> <encoder>: kernel launches {...}
    host paths {...}``."""
    import email.parser
    import email.policy
    import http.server
    import urllib.parse

    from video_depth_anything_torch.run import host_paths, kernel_launches

    out_root = tempfile.mkdtemp(prefix="vda_serve_")
    busy = threading.Lock()
    served = [0]

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path in ("/", "/index.html"):
                self._send(200, _FORM_HTML.encode(), "text/html; charset=utf-8")
                return
            if path.startswith("/files/"):
                full = os.path.join(out_root, os.path.basename(path[len("/files/"):]))
                if os.path.isfile(full):
                    with open(full, "rb") as f:
                        self._send(200, f.read(), "video/mp4")
                    return
            self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if urllib.parse.urlparse(self.path).path != "/process":
                self._send(404, b"not found", "text/plain")
                return
            raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
                b"Content-Type: " + self.headers["Content-Type"].encode() + b"\r\n\r\n" + raw)
            fields: dict = {}
            video_bytes, video_name = None, "upload.mp4"
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name == "video":
                    video_bytes = part.get_payload(decode=True)
                    video_name = part.get_filename() or video_name
                else:
                    fields[name] = part.get_content().strip()
            if not video_bytes:
                self._send(400, b"no video uploaded", "text/plain")
                return
            src = os.path.join(out_root, os.path.basename(video_name))
            with open(src, "wb") as f:
                f.write(video_bytes)
            encoder = fields.get("encoder", "vits")
            try:
                with busy:
                    before = kernel_launches()
                    in_path, depth_path = process_video(
                        src, encoder=encoder,
                        max_len=int(fields.get("max_len", -1) or -1),
                        target_fps=int(fields.get("target_fps", -1) or -1),
                        max_res=int(fields.get("max_res", 1280) or 1280),
                        checkpoint=checkpoint, random_init=checkpoint is None,
                        output_dir=out_root,
                        input_size=int(fields.get("input_size", 0) or 0) or input_size,
                        device=device)
                    after = kernel_launches()
                    served[0] += 1
                    print(f"[app] request {served[0]} {encoder}: kernel launches "
                          f"{json.dumps({k: after[k] - before[k] for k in after})} host paths "
                          f"{json.dumps(host_paths())}", flush=True)
            except Exception as e:  # noqa: BLE001 - surfaced to the browser
                self._send(500, f"processing failed: {e}".encode(), "text/plain")
                return
            body = _RESULT_HTML.format(inp=os.path.basename(in_path),
                                       dep=os.path.basename(depth_path)).encode()
            self._send(200, body, "text/html; charset=utf-8")

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--input_size", type=int, default=None,
                    help="model resolution override (stdlib UI default field)")
    ap.add_argument("--plain", action="store_true",
                    help="force the stdlib server even if gradio is installed")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default localhost; pass 0.0.0.0 to expose the demo to "
                         "the network explicitly)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    try:
        if a.plain:
            raise ImportError
        import gradio  # noqa: F401
    except ImportError:
        srv = serve(a.host, a.port, a.checkpoint, a.input_size, a.device)
        print(f"serving (stdlib UI) on http://{a.host}:{a.port}", flush=True)
        srv.serve_forever()
        return 0
    construct_demo(a.checkpoint, a.device).queue().launch(server_port=a.port, share=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
