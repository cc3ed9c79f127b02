"""The port's chat backend (`gradio_chat.Chat`) and its web demo
(`gradio_web`), counterparts of the root `webui/`."""
