"""Host-side helpers: the PNG writer and the frame clock (copies of
`multivolumes_tpu/utils/png.py` and `steptimer.py`), the `--stats` line
and the scene checkpoints."""
