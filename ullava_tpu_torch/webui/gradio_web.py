"""Gradio web demo of the port (counterpart of `webui/gradio_web.py`).

    python -m ullava_tpu_torch.webui.gradio_web --cfg_path <yaml> \
        [--server_name 0.0.0.0] [--server_port 7860] [--device cpu]

gradio is imported in `init_demo` only; where it is missing the script
exits with SystemExit naming it. `Chat.seg` (`gradio_chat.py`) is the
serving path either way. The model runs on the card unless `--device`
says otherwise.
"""

from __future__ import annotations

import argparse


def init_demo(cfg, device=None):
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment; use "
            "ullava_tpu_torch.webui.gradio_chat.Chat programmatically or the "
            "ullava_tpu_torch.inference_ullava CLI instead."
        )

    import numpy as np

    from ullava_tpu_torch.webui.gradio_chat import Chat

    chat = Chat(cfg, device=device)

    def inference(image, query, temperature, top_p, max_tokens):
        out = chat.seg(
            np.asarray(image), query, temperature=temperature,
            top_p=top_p or None, max_new_tokens=int(max_tokens),
        )
        overlays = []
        img = np.asarray(image)
        for m in out["masks"]:
            ov = img.copy()
            ov[m > 0] = ov[m > 0] * 0.5 + np.array([255, 0, 0]) * 0.5
            overlays.append(ov.astype(np.uint8))
        return out["text"], overlays

    with gr.Blocks(title="u-LLaVA") as demo:
        gr.Markdown("# u-LLaVA\nchat + segmentation + grounding")
        with gr.Row():
            with gr.Column():
                image = gr.Image(type="numpy", label="Image")
                query = gr.Textbox(label="Instruction")
                temperature = gr.Slider(0.0, 1.0, value=0.2, label="temperature")
                top_p = gr.Slider(0.0, 1.0, value=0.9, label="top_p")
                max_tokens = gr.Slider(8, 512, value=64, step=8, label="max new tokens")
                btn = gr.Button("Submit")
            with gr.Column():
                answer = gr.Textbox(label="Answer")
                gallery = gr.Gallery(label="Masks")
        btn.click(inference, [image, query, temperature, top_p, max_tokens],
                  [answer, gallery])
    return demo


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", required=True)
    parser.add_argument("--server_name", default="0.0.0.0")
    parser.add_argument("--server_port", type=int, default=7860)
    parser.add_argument("--device", default=None, help="default: the card")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from ullava_tpu_torch.config import Config
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)

    demo = init_demo(Config(args.cfg_path), device=args.device)
    demo.launch(server_name=args.server_name, server_port=args.server_port)


if __name__ == "__main__":
    main()
