"""The plain reference that decides `correct`.

A frozen copy of the port's main-path modules (`multivolumes_tpu_torch`
at the commit the benchmark was written against), with the plain version
of each hand kernel in its place (`ops/*_plain`), the kernel launches,
the sharded frame step and the other settings' paths taken out, and the
engine's set-up (`engine.py`). It imports no module of the program or of
JAX, and takes nothing the program made: `replay.render_samples` starts
from the benchmark's own inputs. `precision.py` holds the control.
"""
