"""detect_ms.fps: ``detect_ms`` (its reader, ``detect_ms.py``) in the cells where it moves
``frames_per_s``, as they report no ``clip_ms_p95``."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("detect_ms.py")))["read"]
