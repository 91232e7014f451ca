"""The port's own copy of sparc_ldpc_tpu/design/__init__.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

Host-side, design-time numerics (NumPy float64).

State evolution and power allocation are *inputs* to both the NumPy oracle
and the TPU decode path — they define the code, so the two paths must share
them exactly (SURVEY.md §3.4: "result is a constant folded into decode
configs").  The decode paths themselves (oracle vs JAX/Pallas) remain
independent implementations for parity testing (SURVEY.md §4.1).
"""

from .power import power_allocation  # noqa: F401
from .se import se_trajectory, se_section_success  # noqa: F401
