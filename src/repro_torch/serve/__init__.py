"""The LM serving path of the port: prefill, KV-cache decode and
generation (``decode``)."""
