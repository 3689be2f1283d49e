"""DVS event-camera simulation (the v2e subsystem) on PyTorch.

Port of the JAX package's ``events/``: the DVS pixel model steps frame by
frame on the device and produces dense per-iteration event maps (fixed
shapes); sparse (t, x, y, p) event lists exist only at the host IO edge
(``events/io.py``), matching the reference's CSV/AEDAT contracts.
"""

from .emulator import EmulatorConfig, EmulatorState, emulate_frame, emulate_sequence, init_state
from .renderer import ExposureMode, render_frames

# host-side recording formats: events/io.py (CSV, AEDAT2, h5),
# events/aedat4.py (AEDAT-4 flatbuffer + the native LZ4 codec),
# events/ddd20.py (DDD20 DAVIS hdf5) — imported where used
__all__ = ["EmulatorConfig", "EmulatorState", "emulate_frame", "emulate_sequence", "init_state",
           "render_frames", "ExposureMode"]
