"""Web demo for one-step restoration, the PyTorch port of ``interface.py``.

    python -m instarevive_tpu_torch.interface --config configs/tiny.yaml --random_init --port 7860

With gradio installed it shows an image input and the color-fix choice;
without it, a minimal stdlib HTTP server answers the same restoration as
``POST /restore`` with ``{"image": base64 png, "color_fix": "wavelet"}``,
one request at a time. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from http.server import BaseHTTPRequestHandler, HTTPServer


def parse_args(argv=None):
    from instarevive_tpu_torch.inference import add_model_args

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--port", type=int, default=7860)
    return p.parse_args(argv)


def build_restorer(args):
    """``restore(img, color_fix="wavelet")``: a PIL image through the pipeline
    built from ``args``, with the servers' resize and pad; returns a PIL image
    of the resized input's size."""
    from PIL import Image

    from instarevive_tpu_torch import serve
    from instarevive_tpu_torch.utils.image_io import prepare, to_uint8

    restore_batch = serve.build_restorer(args)

    def restore(img: "Image.Image", color_fix: str = "wavelet") -> "Image.Image":
        x, th, tw = prepare(img)
        return Image.fromarray(to_uint8(restore_batch(x[None], color_fix)[0, :th, :tw]))

    return restore


def make_server(restore, port: int = 7860) -> HTTPServer:
    """The stdlib server on 127.0.0.1 (``port`` 0 picks a free one)."""
    import numpy as np

    from instarevive_tpu_torch.serve import answer_restore

    def restore_image(payload, img):
        return np.asarray(restore(img, payload.get("color_fix", "wavelet")), dtype=np.float32) / 255.0

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            answer_restore(self, restore_image)

        def log_message(self, *a):
            pass

    return HTTPServer(("127.0.0.1", port), Handler)


def main(argv=None) -> None:
    args = parse_args(argv)
    restore = build_restorer(args)

    try:
        import gradio as gr
    except ImportError:
        gr = None
    if gr is not None:
        demo = gr.Interface(
            fn=restore,
            inputs=[gr.Image(type="pil"), gr.Radio(["wavelet", "adain", "none"], value="wavelet")],
            outputs=gr.Image(type="pil"),
            title="InstaRevive one-step restoration",
        )
        demo.launch(server_port=args.port)
        return

    server = make_server(restore, args.port)
    print(f"[interface] gradio unavailable; REST server on :{server.server_address[1]} (POST /restore)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
