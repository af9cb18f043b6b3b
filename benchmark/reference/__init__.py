"""The plain reference that decides ``correct``: plain PyTorch, written
from the semantics of each env family and the learner, importing nothing
of ``gym_multigrid_tpu_torch`` (nor JAX).  Every function takes ``fdt``,
the float dtype the step's uniforms, thresholds and rewards are computed
in: float32 as the configurations state it, bfloat16 for the control."""
