"""Serving path of the port: batched inpainting functions and runners."""
