"""Host tools of the port (counterparts of the root `tools/` that need no
benchmark): `convert_checkpoint` and `trace_summary`."""
