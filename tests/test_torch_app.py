"""The port's demo server (``video_depth_anything_torch/app.py``) on the CPU:
the form page, a multipart upload processed into depth, the rendered videos
served back, the per-request launch line, and the depth video against the
JAX ``app.py``'s on the same clip and the same ``.pth`` of noised vits
weights.  Both run the model in bf16 (each app's default), so their depths
differ by bf16 rounding; the videos are compared after decoding."""

import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# Decoded depth-video pixels (0-255), port against JAX.  Both apps run bf16,
# and on these noised weights each side's bf16 depth lies 2.3-4.4 % of
# max|depth| from its own fp32 depth, while the two fp32 depths agree to
# 2.3e-6 (measured on this clip); the two bf16 depths differ by 3.9 %, which
# the inferno colours, each video normalised by its own min and max, and
# mp4v turn into a mean of 3.0 and a 99th percentile of 14 (measured).
# Bound: 1.5 times those.
MEAN_PIXEL_TOL = 4.5
P99_PIXEL_TOL = 21.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _upload(base, src, fields):
    boundary = "----vdaboundary"
    with open(src, "rb") as f:
        payload = f.read()
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n{val}\r\n"
             .encode() for name, val in fields]
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"video\"; "
                 f"filename=\"clip.mp4\"\r\nContent-Type: video/mp4\r\n\r\n".encode()
                 + payload + b"\r\n")
    req = urllib.request.Request(
        base + "/process", data=b"".join(parts) + f"--{boundary}--\r\n".encode(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read().decode()


def _decode(path):
    from video_depth_anything_torch.io.video import read_video_frames

    return read_video_frames(path)[0].astype(np.float32)


def test_serve_upload_roundtrip_matches_jax_app(tmp_path, capsys):
    import chip_smoke
    from video_depth_anything_torch import app
    from video_depth_anything_torch.io.video import save_video

    src = str(tmp_path / "clip.mp4")
    yy, xx = np.mgrid[0:48, 0:64]
    frames = np.stack([np.stack([(xx * 4 + 9 * i) % 256, (yy * 5) % 256,
                                 (xx + yy + 3 * i) % 256], -1) for i in range(8)])
    save_video(frames.astype(np.uint8), src, fps=8)
    ckpt = str(tmp_path / "vits.pth")
    chip_smoke.write_noised_pth("vits", ckpt)

    port = _free_port()
    srv = app.serve("127.0.0.1", port, checkpoint=ckpt, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert "Generate depth" in r.read().decode()
        html = _upload(base, src, (("encoder", "vits"), ("max_len", "6"), ("target_fps", "-1"),
                                   ("max_res", "1280"), ("input_size", "28")))
        assert "/files/" in html and "_depth.mp4" in html
        depth_name = html.split('src="/files/')[2].split('"')[0]
        with urllib.request.urlopen(base + "/files/" + depth_name, timeout=10) as r:
            data = r.read()
            assert r.headers["Content-Type"] == "video/mp4"
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(base + "/files/missing.mp4", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[app]"))
    assert line.startswith("[app] request 1 vits: kernel launches {") and "host paths" in line
    got_path = tmp_path / "served_depth.mp4"
    got_path.write_bytes(data)

    import app as jax_app

    os.makedirs(tmp_path / "jax")
    _, want_path = jax_app.process_video(src, encoder="vits", max_len=6, max_res=1280,
                                         checkpoint=ckpt, output_dir=str(tmp_path / "jax"),
                                         input_size=28)
    got, want = _decode(str(got_path)), _decode(want_path)
    assert got.shape == want.shape == (6, 48, 64, 3)
    diff = np.abs(got - want)
    assert diff.mean() < MEAN_PIXEL_TOL and np.percentile(diff, 99) < P99_PIXEL_TOL, (
        diff.mean(), np.percentile(diff, 99))
    assert os.path.exists(src)


def test_process_video_refuses_other_checkpoint_formats(tmp_path):
    from video_depth_anything_torch import app

    with pytest.raises(ValueError, match=".pth"):
        app.process_video(str(tmp_path / "clip.mp4"), checkpoint=str(tmp_path / "ckpt"),
                          device="cpu")
