"""Host-side helpers of the app: the PNG writer and the frame clock
(copies of `multivolumes_tpu/utils/png.py` and `steptimer.py`)."""
